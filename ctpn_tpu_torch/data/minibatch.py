"""Minibatch assembly: roidb entries -> fixed-shape padded training batches
(port of ``ctpn_tpu.data.minibatch``).

Replaces `lib/roi_data_layer/layer.py` + `lib/roi_data_layer/minibatch.py` +
`lib/utils/blob.py`. The reference is hard-limited to ONE image per step
(`minibatch.py:26-27`) with dynamic shapes; here:

* any batch size, grouped by shape bucket (landscape/portrait aspect
  grouping, cfg.TRAIN.ASPECT_GROUPING) so one static shape per batch;
* images resized (short side TRAIN.SCALES[0], long capped TRAIN.MAX_SIZE,
  `blob.py:21-38` contract), padded into the bucket, gt boxes scaled by the
  same factor (`minibatch.py:38-39`);
* gt boxes / ishard / dontcare padded to cfg.TPU.MAX_GT / MAX_DONTCARE with
  validity masks — the device anchor-target layer consumes masks, not
  ragged arrays;
* epoch shuffle + cursor exactly like `layer.py:14-43`;
* ``TRAIN.RANDOM_DOWNSAMPLE`` draws its jitter from an explicit generator,
  the layer's own ``RandomState``, not from the global ``np.random``.

A batch leaves as CPU tensors sharing the numpy arrays' memory, or pinned
copies (``pin=True``) that the train loop uploads asynchronously.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ctpn_tpu_torch.config import cfg
from ctpn_tpu_torch.training.train_step import Batch
from ctpn_tpu_torch.utils.image import (
    load_image_bgr,
    pick_bucket,
    resize_by_factor,
    resize_factor,
)


def _load_entry_image(entry: dict) -> np.ndarray:
    im = load_image_bgr(entry["image"])
    if entry.get("flipped"):
        im = im[:, ::-1].copy()
    return im


def downsample_jitter(rng: np.random.RandomState) -> float:
    """One ``TRAIN.RANDOM_DOWNSAMPLE`` factor in [0.6, 1.0) (reference
    `blob.py:32-34`)."""
    return 0.6 + rng.rand() * 0.4


def sample_to_arrays(
    entry: dict, bucket: Tuple[int, int], scale: Optional[int] = None,
    max_size: Optional[int] = None, jitter: Optional[float] = None,
):
    """One roidb entry -> (padded image, im_info, gt arrays). With
    ``TRAIN.RANDOM_DOWNSAMPLE`` the resize factor is multiplied by
    ``jitter`` (a :func:`downsample_jitter` draw), which is then required."""
    scale = scale or cfg.TRAIN.SCALES[0]
    max_size = max_size or cfg.TRAIN.MAX_SIZE
    im = _load_entry_image(entry)
    f = resize_factor(im.shape[0], im.shape[1], scale, max_size)
    if cfg.TRAIN.RANDOM_DOWNSAMPLE:
        if jitter is None:
            raise ValueError("TRAIN.RANDOM_DOWNSAMPLE needs a jitter draw "
                             "(downsample_jitter of an explicit generator)")
        f *= jitter
    resized = resize_by_factor(im, f)
    bh, bw = bucket
    h = min(resized.shape[0], bh)
    w = min(resized.shape[1], bw)
    # uint8 wire format: float conversion happens on device (4x less H2D)
    img = np.zeros((bh, bw, 3), np.uint8)
    img[:h, :w] = resized[:h, :w]
    im_info = np.array([h, w, f], np.float32)

    max_gt = cfg.TPU.MAX_GT
    max_dc = cfg.TPU.MAX_DONTCARE
    # keep only gt of class > 0 (reference `minibatch.py:31-34`)
    sel = np.where(entry["gt_classes"] != 0)[0][:max_gt]
    gt = np.zeros((max_gt, 4), np.float32)
    gt_valid = np.zeros(max_gt, bool)
    ishard = np.zeros(max_gt, bool)
    gt[: len(sel)] = entry["boxes"][sel] * f
    gt_valid[: len(sel)] = True
    ishard[: len(sel)] = entry["gt_ishard"][sel].astype(bool)

    dc = np.zeros((max_dc, 4), np.float32)
    dc_valid = np.zeros(max_dc, bool)
    dca = entry.get("dontcare_areas", np.zeros((0, 4)))[:max_dc]
    dc[: len(dca)] = dca * f
    dc_valid[: len(dca)] = True
    return img, im_info, gt, gt_valid, ishard, dc, dc_valid


def assemble_batch(entries: List[dict], bucket: Tuple[int, int],
                   jitter: Optional[List[float]] = None, pin: bool = False) -> Batch:
    """Padded batch of CPU tensors; ``jitter`` gives one downsample factor
    per entry (``TRAIN.RANDOM_DOWNSAMPLE``)."""
    jitter = jitter or [None] * len(entries)
    parts = [sample_to_arrays(e, bucket, jitter=j) for e, j in zip(entries, jitter)]
    return Batch.from_numpy([np.stack([p[i] for p in parts]) for i in range(7)],
                            pin=pin)


class RoIDataLayer:
    """Epoch-shuffled batch iterator over a roidb (reference `layer.py`)."""

    def __init__(
        self,
        roidb: List[dict],
        batch_size: Optional[int] = None,
        bucket: Optional[Tuple[int, int]] = None,
        seed: Optional[int] = None,
    ):
        self._roidb = roidb
        self._batch = batch_size or cfg.TRAIN.IMS_PER_BATCH
        self._rng = np.random.RandomState(
            cfg.RNG_SEED if seed is None else seed
        )
        self._bucket = bucket  # None -> per-batch smallest fitting bucket
        self._shuffle()

    @staticmethod
    def _resized_dims(entry: dict) -> Tuple[int, int]:
        h, w = entry.get("height", 0), entry.get("width", 0)
        if not h or not w:
            return cfg.TRAIN.SCALES[0], cfg.TRAIN.SCALES[0]
        f = cfg.TRAIN.SCALES[0] / min(h, w)
        if f * max(h, w) > cfg.TRAIN.MAX_SIZE:
            f = cfg.TRAIN.MAX_SIZE / max(h, w)
        return int(h * f), int(w * f)

    def _batch_bucket(self, entries: List[dict]) -> Tuple[int, int]:
        if self._bucket is not None:
            return self._bucket
        dims = [self._resized_dims(e) for e in entries]
        return pick_bucket(max(d[0] for d in dims), max(d[1] for d in dims))

    def _shuffle(self) -> None:
        if cfg.TRAIN.ASPECT_GROUPING and len(self._roidb) > 1:
            widths = np.array([r.get("width", 0) for r in self._roidb])
            heights = np.array([r.get("height", 1) for r in self._roidb])
            horz = widths >= heights
            horz_inds = np.where(horz)[0]
            vert_inds = np.where(~horz)[0]
            inds = np.hstack(
                [self._rng.permutation(horz_inds), self._rng.permutation(vert_inds)]
            )
            # shuffle at batch granularity so batches stay aspect-pure
            nb = len(inds) // self._batch
            if nb > 0:
                head = inds[: nb * self._batch].reshape(-1, self._batch)
                head = head[self._rng.permutation(nb)].reshape(-1)
                inds = np.concatenate([head, inds[nb * self._batch :]])
            self._perm = inds
        else:
            self._perm = self._rng.permutation(len(self._roidb))
        self._cur = 0

    def _next_inds(self) -> np.ndarray:
        if self._cur + self._batch > len(self._perm):
            self._shuffle()
        inds = self._perm[self._cur : self._cur + self._batch]
        self._cur += self._batch
        return inds

    def next_entries(self):
        """Cheap sampling step: (entries, bucket, jitter), where jitter is
        one downsample factor per entry drawn from the layer's generator
        under ``TRAIN.RANDOM_DOWNSAMPLE``, else None. NOT thread-safe —
        callers serialize this and run :func:`assemble_batch` (the heavy IO)
        in parallel (see data/pipeline.py)."""
        entries = [self._roidb[i] for i in self._next_inds()]
        jitter = ([downsample_jitter(self._rng) for _ in entries]
                  if cfg.TRAIN.RANDOM_DOWNSAMPLE else None)
        return entries, self._batch_bucket(entries), jitter

    def forward(self) -> Batch:
        """Next padded batch (reference `layer.py:55-58`)."""
        return assemble_batch(*self.next_entries())

    def __iter__(self):
        while True:
            yield self.forward()
