"""Video/image frontends (host-side; port of ``moka_tpu/data/video.py``).

Reference decodes with decord at 224x224 and runs CLIPImageProcessor on the
frames (``unified_dataset.py:156-171``); the package does not depend on
decord, so decoding goes through OpenCV with the same uniform-index
sampling (``np.arange(0, vlen, vlen/n)``), and the CLIP preprocessing
(bicubic resize shortest-edge 224 -> center crop -> rescale -> normalize)
is implemented directly."""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def uniform_frame_indices(vlen: int, n_frames: int) -> list[int]:
    """``np.arange(start, end, vlen / n_frms).astype(int)``
    (unified_dataset.py:160-162)."""
    n = min(n_frames, vlen)
    return np.arange(0, vlen, vlen / n).astype(int).tolist()


def read_video_frames(path: str, n_frames: int,
                      size: int = 224) -> np.ndarray:
    """Decode -> (t, H, W, 3) uint8 RGB frames at size x size."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    vlen = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if vlen <= 0:
        frames_all = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames_all.append(frame)
        vlen = len(frames_all)
        idxs = uniform_frame_indices(vlen, n_frames)
        out = [frames_all[i] for i in idxs]
    else:
        idxs = uniform_frame_indices(vlen, n_frames)
        out = []
        for i in idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = cap.read()
            if not ok:  # fall back to last good frame
                frame = out[-1][:, :, ::-1] if out else np.zeros(
                    (size, size, 3), np.uint8)
            out.append(frame)
    cap.release()
    frames = []
    for f in out:
        f = f[:, :, ::-1]  # BGR -> RGB
        if f.shape[0] != size or f.shape[1] != size:
            import cv2 as _cv2
            f = _cv2.resize(f, (size, size), interpolation=_cv2.INTER_LINEAR)
        frames.append(f)
    return np.stack(frames).astype(np.uint8)


def clip_preprocess(frames: np.ndarray, size: int = 224) -> np.ndarray:
    """(t, H, W, 3) uint8 RGB -> (t, 3, size, size) float32, CLIP-normalized
    (CLIPImageProcessor: bicubic shortest-edge resize, center crop, 1/255
    rescale, mean/std normalize)."""
    import cv2
    out = []
    for f in frames:
        h, w = f.shape[:2]
        if min(h, w) != size:
            scale = size / min(h, w)
            nh, nw = int(round(h * scale)), int(round(w * scale))
            f = cv2.resize(f, (nw, nh), interpolation=cv2.INTER_CUBIC)
            h, w = nh, nw
        top, left = (h - size) // 2, (w - size) // 2
        f = f[top:top + size, left:left + size]
        f = f.astype(np.float32) / 255.0
        f = (f - CLIP_MEAN) / CLIP_STD
        out.append(f.transpose(2, 0, 1))
    return np.stack(out)


def load_image(path: str, size: int = 224) -> np.ndarray:
    """Image file -> (3, size, size) CLIP-normalized (VT resizes to 224^2
    directly, train.py:165-166)."""
    from PIL import Image
    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BICUBIC)
    arr = np.asarray(img, np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    if not np.isfinite(arr).all():
        # the reference's NaN-pixel guard (train.py:171-172): fail the
        # sample loudly on the host instead of poisoning a jitted step
        raise ValueError(f"Invalid pixel values detected in image {path}")
    return arr.transpose(2, 0, 1)
