"""Image preprocessing: resize, shape-bucket padding (copy of ``ctpn_tpu.utils.image``).

Host-side analogue of the reference's two-stage resize
(`ctpn/demo.py:21-25` short-side SCALE capped at MAX_SCALE, then
`lib/fast_rcnn/test.py:7-31` short-side TEST.SCALES capped at MAX_SIZE) and
`lib/utils/blob.py:21-38` mean subtraction.

Resized images are padded into a small set of static buckets
(cfg.TPU.BUCKETS) with the true extent carried in ``im_info``, exactly as in
the JAX package, so both packages see the same pixels. Mean subtraction
happens on the device (``inference/pipeline.py::forward_features``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image, ImageOps

from ctpn_tpu_torch.config import cfg


def resize_factor(h: int, w: int, scale: int, max_scale: int = None) -> float:
    """Factor scaling the short side to ``scale``, capped so the long side
    stays <= ``max_scale`` (`demo.py:21-25` / `blob.py:26-31` contract)."""
    f = float(scale) / min(h, w)
    if max_scale is not None and f * max(h, w) > max_scale:
        f = float(max_scale) / max(h, w)
    return f


def resize_by_factor(im: np.ndarray, f: float) -> np.ndarray:
    """Bilinear resize by an explicit factor."""
    new_w = int(im.shape[1] * f)
    new_h = int(im.shape[0] * f)
    pil = Image.fromarray(im.astype(np.uint8))
    return np.asarray(pil.resize((new_w, new_h), Image.BILINEAR))


def resize_im(im: np.ndarray, scale: int, max_scale: int = None) -> Tuple[np.ndarray, float]:
    """Scale so the short side is ``scale``, capped so the long side stays
    <= ``max_scale``. Returns (resized, factor). Same contract as
    `demo.py:21-25`."""
    f = resize_factor(im.shape[0], im.shape[1], scale, max_scale)
    return resize_by_factor(im, f), f


def pick_bucket(h: int, w: int, buckets: Sequence[Sequence[int]] = None) -> Tuple[int, int]:
    """Smallest-area bucket containing (h, w); falls back to the largest."""
    buckets = buckets or cfg.TPU.BUCKETS
    fitting = [(bh * bw, bh, bw) for bh, bw in buckets if bh >= h and bw >= w]
    if fitting:
        _, bh, bw = min(fitting)
        return bh, bw
    _, bh, bw = max((bh * bw, bh, bw) for bh, bw in buckets)
    return bh, bw


def prep_image(
    im: np.ndarray,
    scale: int = None,
    max_scale: int = None,
    bucket: Tuple[int, int] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """RGB/BGR uint8 image -> (padded uint8 BGR image, im_info, top_pad).

    Returns (bucket_h, bucket_w, 3) uint8 (NOT mean-subtracted — float
    conversion and normalization fuse on device; uint8 is the wire format,
    4x less host->device traffic than float32), im_info
    [content_h, true_w, resize_factor], and the applied top pad in pixels.
    Input is expected BGR to match the reference's cv2 convention; callers
    loading via PIL should pass ``rgb_to_bgr`` first.

    ``cfg.TEST.TOP_PAD`` shifts the content down by up to that many pixels
    inside the bucket and fills the gap with the image's own reflected top
    rows, so the first feature row sees real context instead of the zero
    pad (frame-clipped text at y 0 is otherwise scored without any
    receptive-field support above it). The shift consumes bucket padding
    headroom only — the bucket choice and therefore the compiled program
    are unchanged — and is undone on the host via ``unscale_records``'s
    ``y_off``. im_info's content height includes the pad so on-device
    clipping covers the shifted content.
    """
    # defaults mirror the TEST-stage resize (`test.py:18-24`); the demo CLI
    # additionally applies the TEXT.SCALE/MAX_SCALE pre-resize first, like
    # the reference's demo.py -> test.py double resize
    scale = scale or cfg.TEST.SCALES[0]
    max_scale = max_scale or cfg.TEST.MAX_SIZE
    resized, f = resize_im(im, scale, max_scale)
    h, w = resized.shape[:2]
    # clip to the hard cap in case of fallback bucket
    bh, bw = bucket if bucket is not None else pick_bucket(h, w)
    h2, w2 = min(h, bh), min(w, bw)
    pad = max(0, min(int(cfg.TEST.TOP_PAD), bh - h2))
    out = np.zeros((bh, bw, 3), dtype=np.uint8)
    out[pad:pad + h2, :w2] = resized[:h2, :w2]
    if pad:
        # fill with the mean color of the top rows, NOT a reflection: a
        # mirror copies real glyphs into the pad band, and the classifier
        # + connector then hallucinate phantom lines there; a flat
        # scene-colored band gives the row-0/1 cells receptive-field
        # support without text-like structure
        top = min(h2, 2 * max(pad, 16))
        out[:pad, :w2] = resized[:top, :w2].mean(axis=(0, 1)).astype(np.uint8)
    im_info = np.array([h2 + pad, w2, f], dtype=np.float32)
    return out, im_info, pad


def rgb_to_bgr(im: np.ndarray) -> np.ndarray:
    return im[..., ::-1]


def load_image_bgr(path: str) -> np.ndarray:
    """uint8 BGR image from disk (reference uses cv2.imread -> BGR).

    EXIF orientation is applied, matching cv2.imread's default: the
    reference demo set includes a camera photo stored rotated
    (`data/demo/008.jpg`, orientation tag 6) whose golden outputs only
    make sense on the upright image.
    """
    with Image.open(path) as img:
        img = ImageOps.exif_transpose(img)
        arr = np.asarray(img.convert("RGB"))
    return rgb_to_bgr(arr)


def batch_images(
    images: List[np.ndarray], bucket: Tuple[int, int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prep + stack a list of BGR uint8 images into one bucket batch.

    All images share the largest needed bucket (callers group by bucket for
    efficiency — see data/pipeline.py). Returns (data, infos, top_pads);
    pass each image's pad to ``unscale_records``'s ``y_off``.
    """
    preps = [prep_image(im, bucket=bucket) for im in images]
    if bucket is None:
        bh = max(p[0].shape[0] for p in preps)
        bw = max(p[0].shape[1] for p in preps)
        preps = [prep_image(im, bucket=(bh, bw)) for im in images]
    data = np.stack([p[0] for p in preps])
    infos = np.stack([p[1] for p in preps])
    pads = np.array([p[2] for p in preps], dtype=np.int32)
    return data, infos, pads
