"""Port parity: the HTTP front's image branch (``eval/server.py``).  A
base64 image posted to /generate reaches ``generate_fn`` as the item's
``"image"``, array-equal to the JAX package's preprocessing of the same
bytes (``data/benchmarks._img_from_pil``), and the request answers 200
(the port answered 400 before the branch was ported); an undecodable
image still answers 400.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from moka_tpu.data.benchmarks import _img_from_pil as j_img_from_pil
from moka_tpu_torch.eval.server import serve


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture
def front():
    """A micro-batch front whose ``generate_fn`` records every item."""
    seen = []

    def generate(items):
        seen.extend(items)
        return [f"{it['prompt']} {it['image'].shape if 'image' in it else ''}"
                for it in items]

    server = serve(generate, host="127.0.0.1", port=0, max_batch=4)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server.server_address[1], seen
    server.shutdown()
    server.server_close()
    server.batcher.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("fmt, mode, size", [("PNG", "RGB", (40, 30)),
                                             ("PNG", "RGBA", (224, 224)),
                                             ("JPEG", "L", (300, 17))])
def test_image_request_matches_jax_preprocessing(front, fmt, mode, size):
    port, seen = front
    rng = np.random.default_rng(size[0])
    shape = (size[1], size[0]) + (() if mode == "L" else (len(mode),))
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, shape, np.uint8), mode).save(
        buf, format=fmt)
    raw = buf.getvalue()
    status, out = _post(port, {"prompt": "describe",
                               "image": base64.b64encode(raw).decode(),
                               "max_new_tokens": 3})
    assert status == 200 and out == {"output": "describe (3, 224, 224)"}
    (item,) = seen
    assert item["max_new_tokens"] == 3
    want = j_img_from_pil(Image.open(io.BytesIO(raw)))
    assert item["image"].dtype == want.dtype == np.float32
    np.testing.assert_array_equal(item["image"], want)


def test_text_request_and_bad_image(front):
    port, seen = front
    status, out = _post(port, {"prompt": "plain", "image": ""})
    assert status == 200 and out == {"output": "plain "}
    assert "image" not in seen[0]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(port, {"prompt": "x", "image": base64.b64encode(
            b"not an image").decode()})
    assert err.value.code == 400 and len(seen) == 1
