#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: builds the kernels,
holds each against its plain PyTorch version, drives the main path and
checks what comes out.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: CUDA must be available; prints the card's name and power limit.
2. build: compiles every kernel of the path from ``ctpn_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, in parallel) and prints the build time.
3. kernels: each kernel against its plain version on the card, at the main
   path's shapes and on edge cases; the keep mask's prefix must be
   identical (tolerance 0: it is an integer output). Times both.
4. main path: ``CTPNPredictor(device="cuda")`` with the shipped weights
   (``data/artifacts/ctpn_synth_f16.npz``) runs ``detect_image`` on the five
   committed demo photos with launch counts zeroed just before; every
   kernel must have launched (the fused NMS exactly twice per image). The
   same detection with the plain NMS must pair one-to-one within 0.5 px,
   and the records must recover the committed reference results
   (``docs/demo_results/H/res_*.txt``). Then ``run_batch`` at batch 8 on
   the 608x912 bucket, timed.
5. prints one ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package ``ctpn_tpu``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
PHOTOS = [REPO / "docs" / "demo_results" / "H" / n
          for n in ("006.jpg", "007.jpg", "008.jpg", "009.jpg", "010.png")]

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# least float ops of one IoU pair test with per-box areas precomputed:
# 2 min + 2 max + 4 add/sub (sides), 2 max + 1 mul (inter), 2 add/sub +
# 1 max (union), 1 mul (t * union), 1 compare
IOU_PAIR_OPS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- NMS inputs


def proposal_like_boxes(rng, batch: int, k: int) -> torch.Tensor:
    """(batch, k, 4) score-sorted boxes shaped like the proposal layer's
    NMS input at 608x912: 16-px-wide anchors of the 38x57x10 grid with
    random y/h deltas, the top ``k`` by a random score."""
    from ctpn_tpu_torch.ops.anchors import shifted_anchors
    from ctpn_tpu_torch.ops.boxes import bbox_transform_inv, clip_boxes

    anchors = torch.from_numpy(shifted_anchors(38, 57).copy())
    out = []
    for _ in range(batch):
        deltas = torch.from_numpy(
            rng.uniform(-0.3, 0.3, (len(anchors), 4)).astype(np.float32))
        boxes = clip_boxes(bbox_transform_inv(anchors, deltas), 608.0, 912.0)
        order = np.argsort(rng.uniform(0, 1, len(anchors)), kind="stable")[::-1]
        out.append(boxes[torch.from_numpy(order[:k].copy())])
    return torch.stack(out)


def near_threshold_boxes(rng, n_pairs: int, t: float) -> torch.Tensor:
    """(1, 2*n_pairs, 4) isolated pairs whose IoU is ``t`` before rounding.

    Box b is box a shifted right by d = w(1-t)/(1+t), so IoU(a, b) = t in
    exact arithmetic; rounding the coordinates to f32 leaves each pair's
    ``inter >= t * union`` within a few rounding errors of equality. A pair
    spans less than 2w by h, and the grid step exceeds both with a margin,
    so no box meets a box of another pair: the greedy pass keeps each
    second box iff its own pair's test does not suppress it."""
    w_max, h_max = 120.0, 60.0
    step_x, step_y = 2 * w_max + 8, h_max + 8
    cols = int(np.ceil(np.sqrt(n_pairs * step_y / step_x)))  # square field
    rows = []
    for p in range(n_pairs):
        x = (p % cols) * step_x + rng.uniform(0, 4)
        y = (p // cols) * step_y + rng.uniform(0, 4)
        w = rng.uniform(20, w_max)
        h = rng.uniform(10, h_max)
        d = w * (1 - t) / (1 + t)
        a = [x, y, x + w - 1, y + h - 1]
        rows += [a, [a[0] + d, a[1], a[2] + d, a[3]]]
    return torch.tensor(np.asarray(rows, np.float32))[None]


def pair_tests(boxes: np.ndarray, t: float) -> dict:
    """Each pair's suppression test (second box by first), three ways.

    ``f32``: every step one rounded f32 operation in the kernel's order
    (what the kernel and the plain version must compute); ``f64``: the same
    formula in f64 on the same f32 inputs; ``fma``: f32 with the two
    contractions ``nvcc`` makes by default, ``area_a + area_b`` as
    fma(side, side, area_b) and ``... - inter`` as fma(-iw, ih, ...),
    each emulated with one rounding from f64."""
    f32, f64 = np.float32, np.float64
    a, b = boxes[0::2].astype(f32), boxes[1::2].astype(f32)
    t32 = f32(t)

    def parts(a, b, one):
        iw = np.maximum((np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0])) + one, 0)
        ih = np.maximum((np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1])) + one, 0)
        sides = [(a[:, 2] - a[:, 0]) + one, (a[:, 3] - a[:, 1]) + one,
                 (b[:, 2] - b[:, 0]) + one, (b[:, 3] - b[:, 1]) + one]
        return iw, ih, sides

    iw, ih, (sax, say, sbx, sby) = parts(a, b, f32(1))
    inter, area_a, area_b = iw * ih, sax * say, sbx * sby
    plain = inter >= t32 * np.maximum((area_a + area_b) - inter, f32(1e-10))
    s = (f64(sax) * f64(say) + f64(area_b)).astype(f32)
    uni = (f64(s) - f64(iw) * f64(ih)).astype(f32)
    fma = inter >= t32 * np.maximum(uni, f32(1e-10))
    iw, ih, (sax, say, sbx, sby) = parts(a.astype(f64), b.astype(f64), 1.0)
    inter = iw * ih
    exact = inter >= f64(t32) * np.maximum(sax * say + sbx * sby - inter, 1e-10)
    return {"f32": plain, "f64": exact, "fma": fma}


def clusters(rng, n: int, centers: int) -> torch.Tensor:
    c = rng.uniform(0, 800, (centers, 2))
    base = np.concatenate([c, c + rng.uniform(20, 120, (centers, 2))], 1)
    boxes = base[rng.randint(0, centers, n)] + rng.normal(0, 4, (n, 4))
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
    return torch.tensor(boxes.astype(np.float32))[None]


def keep_prefix_mismatch(kern: torch.Tensor, plain: torch.Tensor, cap) -> int:
    """Rows that differ within each image's first ``cap`` survivors (the
    kernel must stop at exactly min(cap, survivors))."""
    bad = 0
    for kr, pr in zip(kern.cpu().numpy(), plain.cpu().numpy()):
        ki, pi = np.flatnonzero(kr), np.flatnonzero(pr)
        m = len(pi) if cap is None else min(cap, len(pi))
        if len(ki) != m:
            return max(1, abs(len(ki) - m))
        bad += int((ki[:m] != pi[:m]).sum())
    return bad


def nms_pair_tests(valid: torch.Tensor, plain_keep: torch.Tensor, cap) -> int:
    """IoU pair tests that this data needs from the block walk: each visited
    512-block tests its valid rows against the boxes kept before it and
    against each other, and the walk stops once ``cap`` are kept."""
    total = 0
    for v, kp in zip(valid.cpu().numpy(), plain_keep.cpu().numpy()):
        kept = 0
        for lo in range(0, len(v), 512):
            if cap is not None and kept >= cap:
                break
            nv = int(v[lo:lo + 512].sum())
            total += nv * kept + nv * (nv - 1) // 2
            kept += int(kp[lo:lo + 512].sum())
    return total


def check_nms_kernel(dev) -> dict:
    from ctpn_tpu_torch.ops import nms_fused as NF

    def valid_of(b):
        return torch.ones(b.shape[:2], dtype=torch.bool, device=dev)

    rng = np.random.RandomState(0)
    main = proposal_like_boxes(rng, 1, 12000).to(dev)
    ones = torch.ones(main.shape[:2], dtype=torch.bool, device=dev)
    batch8 = proposal_like_boxes(rng, 8, 12000).to(dev)
    odd = proposal_like_boxes(rng, 1, 1300).to(dev)
    odd_valid = torch.from_numpy(rng.rand(1, 1300) > 0.3).to(dev)
    dense = clusters(rng, 3000, 12).to(dev)

    # the detector's input is the proposal call's first 1000 survivors
    kept = NF.nms_keep_sorted_fused_ref(main, ones, 0.7, max_keep=1000)
    det = main[:, kept[0]][:, :1000].contiguous()
    cases = [
        ("proposal (1,12000) t=0.7 cap=1000", main, ones, 0.7, 1000),
        ("detector (1,1000) t=0.2", det, valid_of(det), 0.2, None),
        ("batch 8 (8,12000) t=0.7 cap=1000", batch8, valid_of(batch8), 0.7, 1000),
        ("no cap (1,12000) t=0.7, kept list in global scratch", main, ones, 0.7, None),
        ("K=1300, 30% invalid, t=0.5", odd, odd_valid, 0.5, None),
        ("all invalid (1,700) cap=100", odd[:, :700].contiguous(),
         torch.zeros((1, 700), dtype=torch.bool, device=dev), 0.7, 100),
        ("clusters (1,3000) t=0.5", dense, valid_of(dense), 0.5, None),
    ]
    for t in (0.7, 0.2, 0.5):
        near = near_threshold_boxes(rng, 2000, t).to(dev)
        cases.append((f"near-threshold pairs (1,4000) t={t}", near,
                      valid_of(near), t, None))

    worst = 0
    for name, b, v, t, cap in cases:
        kern = NF.nms_keep_sorted_fused(b, v, t, max_keep=cap)
        torch.cuda.synchronize()
        plain = NF.nms_keep_sorted_fused_ref(b, v, t, max_keep=cap)
        bad = keep_prefix_mismatch(kern, plain, cap)
        log(f"  nms_fused {name}: kept {int(kern.sum())}, prefix mismatches {bad}")
        if bad:
            raise AssertionError(f"nms_fused disagrees with its plain version: {name}")
        worst = max(worst, bad)
        if name.startswith("near"):
            # isolated pairs: each second box follows its own pair's f32
            # test, and rounding must decide some pairs (f32 differs from
            # f64, or from the FMA-contracted version)
            tests = pair_tests(b[0].cpu().numpy(), t)
            pairs = kern[0].view(-1, 2).cpu().numpy()
            n_f64 = int((tests["f32"] != tests["f64"]).sum())
            n_fma = int((tests["f32"] != tests["fma"]).sum())
            log(f"    second box kept in {int(pairs[:, 1].sum())} of {len(pairs)} "
                f"pairs; f32 test differs from f64 in {n_f64}, from FMA in {n_fma}")
            if not pairs[:, 0].all() or (pairs[:, 1] == tests["f32"]).any():
                raise AssertionError("a near-threshold pair was not decided by "
                                     "its own f32 test")
            if pairs[:, 1].all() or not pairs[:, 1].any():
                raise AssertionError("near-threshold pairs did not straddle t")
            if n_f64 == 0 or n_fma == 0:
                raise AssertionError("rounding decided no near-threshold pair")

    shapes = []
    for name, b, v, t, cap in cases[:2]:
        ms = cuda_ms(lambda: NF.nms_keep_sorted_fused(b, v, t, max_keep=cap), 20)
        plain_ms = cuda_ms(
            lambda: NF.nms_keep_sorted_fused_ref(b, v, t, max_keep=cap), 3)
        plain = NF.nms_keep_sorted_fused_ref(b, v, t, max_keep=cap)
        n_bytes = b.numel() * 4 + v.numel() * 2  # boxes + flags in, keep out
        n_ops = nms_pair_tests(v, plain, cap) * IOU_PAIR_OPS
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / F32_OPS_PER_S * 1e3
        shapes.append({
            "call": name, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes, "operations": n_ops,
        })
        log(f"  nms_fused {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {max(bytes_ms, ops_ms) * 1e3:.3f} us "
            f"({n_ops} ops, {n_bytes} bytes)")
    head = shapes[0]
    return {
        "name": "nms_fused",
        "route": "cuda",
        "source": "ctpn_tpu_torch/ops/csrc/nms_fused.cu",
        "replaces": "ctpn_tpu/ops/nms_fused.py:67",
        "launches": None,  # filled from the main path's run
        "max_abs_err": float(worst),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,  # no single PyTorch call computes greedy NMS
        "shapes": shapes,
    }


# ---------------------------------------------------------------- main path


@contextlib.contextmanager
def plain_nms():
    """Route the NMS dispatch to the plain version, on the card."""
    from ctpn_tpu_torch.ops import nms_fused as NF

    kernel = NF.nms_keep_sorted_fused
    NF.nms_keep_sorted_fused = NF.nms_keep_sorted_fused_ref
    try:
        yield
    finally:
        NF.nms_keep_sorted_fused = kernel


def rows_match(a: np.ndarray, b: np.ndarray, atol: float) -> float:
    """One-to-one greedy pairing within ``atol``; returns the worst diff."""
    if a.shape != b.shape:
        raise AssertionError(f"record counts differ: {a.shape} vs {b.shape}")
    used = np.zeros(len(b), bool)
    worst = 0.0
    for row in a:
        d = np.abs(b - row[None]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        if d[j] > atol:
            raise AssertionError(f"record has no match within {atol}: {d[j]}")
        used[j] = True
        worst = max(worst, float(d[j]))
    return worst


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ix = np.minimum(a[:, None, 2], b[None, :, 2]) - np.maximum(a[:, None, 0], b[None, :, 0])
    iy = np.minimum(a[:, None, 3], b[None, :, 3]) - np.maximum(a[:, None, 1], b[None, :, 1])
    inter = np.clip(ix, 0, None) * np.clip(iy, 0, None)
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


def recall_vs_committed(recs: np.ndarray, photo: Path) -> tuple:
    """Reference lines (committed res_*.txt) matched at IoU >= 0.5."""
    ref = np.loadtxt(photo.parent / f"res_{photo.stem}.txt", delimiter=",",
                     ndmin=2).astype(np.float64)
    if len(recs) == 0:
        return 0, len(ref)
    xs, ys = recs[:, 0:8:2], recs[:, 1:8:2]
    boxes = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
    iou = iou_matrix(ref, boxes)
    return int((iou.max(axis=1) >= 0.5).sum()), len(ref)


def drive_main_path(dev, kernel_entry: dict) -> None:
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.ops import nms_fused as NF
    from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image
    from ctpn_tpu_torch.utils.weights import load_params

    pred = CTPNPredictor(load_params(str(ARTIFACT), device=dev), device=dev)
    log(f"  predictor: {cfg.TPU.COMPUTE_DTYPE}, mode {pred.mode}, "
        f"NMS_FUSED {cfg.TPU.NMS_FUSED}")
    pred.warmup((608, 912))
    images = [load_image_bgr(str(p)) for p in PHOTOS]

    NF.nms_keep_sorted_fused.LAUNCHES = 0  # counts of the main path only
    results = []
    for photo, im in zip(PHOTOS, images):
        before = NF.nms_keep_sorted_fused.LAUNCHES
        recs = pred.detect_image(im)
        torch.cuda.synchronize()
        step = NF.nms_keep_sorted_fused.LAUNCHES - before
        if recs.ndim != 2 or recs.shape[1] != 9 or not np.isfinite(recs).all():
            raise AssertionError(f"{photo.name}: bad records {recs.shape}")
        if step != 2:
            raise AssertionError(f"{photo.name}: nms_fused launched {step} times, not 2")
        hit, n_ref = recall_vs_committed(recs, photo)
        log(f"  {photo.name}: {len(recs)} lines, nms_fused launches +{step}, "
            f"committed reference lines matched at IoU 0.5: {hit}/{n_ref}")
        results.append((recs, hit, n_ref))
    launches = NF.nms_keep_sorted_fused.LAUNCHES
    kernel_entry["launches"] = launches
    total = sum(len(r) for r, _, _ in results)
    hits = sum(h for _, h, _ in results)
    n_ref = sum(n for _, _, n in results)
    if total == 0:
        raise AssertionError("no text lines on the demo photos")
    if launches == 0:
        raise AssertionError("nms_fused was never launched on the main path")
    if hits < 0.75 * n_ref:
        raise AssertionError(f"only {hits}/{n_ref} committed reference lines found")
    log(f"  main path: {total} lines on {len(PHOTOS)} photos, "
        f"nms_fused launches {launches}, reference recall {hits}/{n_ref}")

    with plain_nms():
        worst = 0.0
        for photo, im, (recs, _, _) in zip(PHOTOS, images, results):
            plain = pred.detect_image(im)
            worst = max(worst, rows_match(plain, recs, 0.5))
    if NF.nms_keep_sorted_fused.LAUNCHES != launches:
        raise AssertionError("the plain-NMS run launched the kernel")
    log(f"  kernel vs plain NMS end to end: records pair one-to-one, "
        f"worst diff {worst} px")

    preps = [prep_image(im, bucket=(608, 912)) for im in images]
    data = np.stack([p[0] for p in preps] + [preps[0][0]] * 3)
    infos = np.stack([p[1] for p in preps] + [preps[0][1]] * 3)

    def batch():
        _, lines = pred.run_batch(data, infos)
        lines.count.cpu()

    batch()
    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        batch()
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / iters
    log("  e2e " + json.dumps({
        "run_batch": "8x608x912 uint8", "ms_per_batch": sec * 1e3,
        "img_per_s": 8 / sec, "iters": iters}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ctpn_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1/5] device: {torch.cuda.get_device_name(0)} | {card} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build(["nms_fused"])
    log(f"[2/5] build: {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("[3/5] kernels against their plain versions")
    entry = check_nms_kernel(dev)

    log("[4/5] main path")
    drive_main_path(dev, entry)
    if not entry["launches"]:
        raise AssertionError("a kernel of the path was never launched")

    log("[5/5] result")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
