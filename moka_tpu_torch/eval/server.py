"""Minimal batched inference server over stdlib HTTP (port of
``moka_tpu/eval/server.py``).

POST /generate with {"prompt": ..., optional "image" (base64 of an image
file), "temperature", "top_k", "top_p", "max_new_tokens"} returns
{"output": text}; POST /generate_stream (continuous engine only) streams
one {"token": id} line per emitted token, then {"output": text}.  An image
is decoded with PIL and preprocessed as the VT benchmarks preprocess theirs
(``data/benchmarks._img_from_pil``: (3, 224, 224) float32, CLIP-normalized)
into the item's ``"image"``.  Two fronts: ``serve`` micro-batches requests
into one ``generate_fn`` call, ``serve_continuous`` feeds a
``DecodeEngine``.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

import numpy as np


class MicroBatcher:
    """Collect requests for up to ``max_wait_s`` or ``max_batch`` and run
    them through ``generate_fn(items) -> list[str]`` in one call."""

    def __init__(self, generate_fn: Callable, max_batch: int = 8,
                 max_wait_s: float = 0.05):
        self.generate_fn = generate_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.q: queue.Queue = queue.Queue()
        self._stop = False
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, item) -> "queue.Queue":
        done: queue.Queue = queue.Queue(maxsize=1)
        self.q.put((item, done))
        return done

    def _loop(self):
        while not self._stop:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=timeout))
                except queue.Empty:
                    break
            items = [b[0] for b in batch]
            try:
                outputs = self.generate_fn(items)
            except Exception as e:  # surface errors to every waiter
                outputs = [f"ERROR: {type(e).__name__}: {e}"] * len(items)
            for (_, done), out in zip(batch, outputs):
                done.put(out)

    def stop(self):
        self._stop = True


def make_handler(batcher):
    class Handler(BaseHTTPRequestHandler):
        def _read_item(self):
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            item = {"prompt": req["prompt"]}
            for k in ("temperature", "top_k", "top_p", "max_new_tokens"):
                if k in req:
                    item[k] = req[k]
            if req.get("image"):
                from PIL import Image
                from moka_tpu_torch.data.benchmarks import _img_from_pil
                img = Image.open(io.BytesIO(base64.b64decode(req["image"])))
                item["image"] = _img_from_pil(img)
            return item

        def do_POST(self):
            if self.path == "/generate_stream":
                return self._do_stream()
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                out = batcher.submit(self._read_item()).get(timeout=300)
                body = json.dumps({"output": out}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:
                self.send_error(400, str(e))

        def _do_stream(self):
            """ndjson token stream (continuous engine front only)."""
            if not hasattr(batcher, "submit_stream"):
                self.send_error(
                    501, "streaming requires the continuous engine front")
                return
            try:
                stream, done = batcher.submit_stream(self._read_item())
            except Exception as e:
                self.send_error(400, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            while True:
                tok = stream.get(timeout=300)
                if tok is None:
                    break
                self.wfile.write(
                    (json.dumps({"token": int(tok)}) + "\n").encode())
                self.wfile.flush()
            out = done.get(timeout=300)
            self.wfile.write((json.dumps({"output": out}) + "\n").encode())

        def log_message(self, *a):  # quiet
            pass

    return Handler


def serve(generate_fn: Callable, host: str = "0.0.0.0", port: int = 8000,
          max_batch: int = 8) -> ThreadingHTTPServer:
    batcher = MicroBatcher(generate_fn, max_batch=max_batch)
    server = ThreadingHTTPServer((host, port), make_handler(batcher))
    server.batcher = batcher
    return server


class _EngineFront:
    """MicroBatcher-shaped front for a ``DecodeEngine``: ``submit(item)``
    prepares one request (prep_fn -> (embeds, prompt_mask, masks)), hands
    it to the engine and returns a queue that resolves to decoded text."""

    def __init__(self, engine, prep_fn: Callable, decode_fn: Callable,
                 max_new_tokens: int = 128):
        self.engine = engine
        self.prep_fn = prep_fn
        self.decode_fn = decode_fn
        self.max_new_tokens = max_new_tokens
        engine.start()

    def _resolve(self, fut, out: "queue.Queue") -> None:
        toks = fut.get()
        try:
            out.put(self.decode_fn(toks))
        except Exception as e:
            out.put(f"ERROR: {type(e).__name__}: {e}")

    def submit(self, item) -> "queue.Queue":
        out: queue.Queue = queue.Queue(maxsize=1)
        try:
            embeds, prompt_mask, masks = self.prep_fn(item)
            fut = self.engine.submit(embeds, prompt_mask, masks,
                                     **self._gen_kwargs(item, prompt_mask))
        except Exception as e:
            out.put(f"ERROR: {type(e).__name__}: {e}")
            return out
        threading.Thread(target=self._resolve, args=(fut, out),
                         daemon=True).start()
        return out

    def _gen_kwargs(self, item, prompt_mask) -> dict:
        """Per-request generation settings from the HTTP body (greedy by
        default).  ``max_new_tokens`` is clamped so prompt + generation fit
        the engine's cache; a prompt that does not fit at all raises."""
        n_prompt = int(np.asarray(prompt_mask).sum())
        fit = self.engine.S - n_prompt
        if fit <= 0:
            raise ValueError(
                f"prompt ({n_prompt} tokens) does not fit the engine cache "
                f"capacity ({self.engine.S})")
        return {
            "max_new_tokens": min(int(item.get("max_new_tokens",
                                               self.max_new_tokens)), fit),
            "temperature": float(item.get("temperature", 0.0)),
            "top_k": int(item.get("top_k", 0)),
            "top_p": float(item.get("top_p", 1.0)),
        }

    def submit_stream(self, item):
        """Returns (token_queue, text_queue): token ids as emitted (None =
        end), then the decoded text."""
        stream: queue.Queue = queue.Queue()
        out: queue.Queue = queue.Queue(maxsize=1)
        embeds, prompt_mask, masks = self.prep_fn(item)
        fut = self.engine.submit(embeds, prompt_mask, masks, stream=stream,
                                 **self._gen_kwargs(item, prompt_mask))
        threading.Thread(target=self._resolve, args=(fut, out),
                         daemon=True).start()
        return stream, out

    def stop(self):
        self.engine.stop()


def serve_continuous(engine, prep_fn: Callable, decode_fn: Callable,
                     host: str = "0.0.0.0", port: int = 8000,
                     max_new_tokens: int = 128) -> ThreadingHTTPServer:
    """HTTP server over a continuous-batching ``DecodeEngine``: requests
    join free decode lanes at once."""
    front = _EngineFront(engine, prep_fn, decode_fn,
                         max_new_tokens=max_new_tokens)
    server = ThreadingHTTPServer((host, port), make_handler(front))
    server.batcher = front
    return server
