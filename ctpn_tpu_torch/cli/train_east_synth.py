"""Make EAST-VGG16's weights on the synthetic renders, then score them.

    python -m ctpn_tpu_torch.cli.train_east_synth --steps 40000 --max-seconds 900 \\
        --out data/artifacts/east_vgg16_synth_f16.npz
    python -m ctpn_tpu_torch.cli.train_east_synth --eval data/artifacts/east_vgg16_synth_f16.npz

The trunk is CTPN's shipped ``data/artifacts/ctpn_synth_f16.npz``
(``conv1_1``-``conv5_3``, VGG16 trained on the same renders), frozen: it
runs with gradients off in bfloat16 through the conv epilogue. The merge
branch and the heads train in float32 with Adam (the rate divided by 10
at 70 % and 90 % of the steps, or of ``--max-seconds``) on 512x512 crops
of a pool of seeded ``data/synth.py`` renders (900x600 scenes, rendered
once by spawned workers; each crop scaled by 0.8-2.0 and mirrored for
half, cut by forked workers), against the targets and loss of
``training/east_loss.py``.

The artifact holds the merge branch and the heads in float16 (the port's
``.npz`` format) and names the trunk's artifact beside it with its sha256
(``__trunk__``, ``__trunk_sha256__``), which ``utils/weights.py``'s
loader reads in; so the trunk is stored once.

The labels are text lines (:func:`join_lines`: the renderer's words of
one line joined, MSRA-TD500's line-level labels, on which the paper also
reports), not words: the trunk is CTPN's, trained to join a line's words
across their gaps, and with word labels the frozen trunk left the word
ends unseen (holdout precision 0.24 and recall 0.33 after 7,632 steps).

Scoring (``--eval``, and after training): the port's predictor on 32
held-out renders (scenes from seeds training never draws, resized to
1280x720 as the benchmark's inputs are), precision and recall of its
quads against the lines at polygon IoU 0.5, one to one; lines whose
shorter side is under 8 px are don't-care (neither missed nor matched).
Prints one JSON line per phase.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import os
import os.path as osp
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

TRUNK = "data/artifacts/ctpn_synth_f16.npz"
HOLDOUT_BASE = 2_000_000_000  # holdout scene seeds; training draws below
EVAL_SIZE = (1280, 720)
SCENE = (900, 600)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--scenes", type=int, default=2000, help="renders the crops are cut from")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--crop", type=int, default=512)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=7)
    p.add_argument("--trunk", default=TRUNK)
    p.add_argument("--out", default="data/artifacts/east_vgg16_synth_f16.npz")
    p.add_argument("--holdout", type=int, default=32)
    p.add_argument("--max-seconds", type=float, default=0.0,
                   help="end training after this many seconds (0: run every step)")
    p.add_argument("--save-every", type=int, default=500,
                   help="write the artifact every N steps too (0: at the end only)")
    p.add_argument("--eval", default=None, help="score this artifact and exit")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _render(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """A scene and its text lines (``join_lines`` of its words)."""
    from ctpn_tpu_torch.data.synth import render_image

    img, polys = render_image(np.random.RandomState(seed), width=SCENE[0], height=SCENE[1])
    return img, join_lines(np.asarray(polys, np.float64).reshape(-1, 8))


def _same_line(a: np.ndarray, b: np.ndarray) -> bool:
    """Whether word ``b`` follows word ``a`` on one line: the same
    direction, overlapping across it by half the smaller height, at most
    1.2 heights apart along it."""
    a, b = a.reshape(4, 2), b.reshape(4, 2)
    da, db = a[1] - a[0], b[1] - b[0]
    if not da.any() or not db.any():
        return False
    u = da / np.linalg.norm(da)
    if abs(float(np.cross(u, db / np.linalg.norm(db)))) > 0.05:
        return False
    v = np.array([-u[1], u[0]])
    pa, pb = a @ v, b @ v
    h = min(np.ptp(pa), np.ptp(pb))
    big = max(np.ptp(pa), np.ptp(pb))
    overlap = min(pa.max(), pb.max()) - max(pa.min(), pb.min())
    gap = (b @ u).min() - (a @ u).max()
    return overlap >= 0.5 * h and -0.5 * big <= gap <= 1.2 * big


def rect_along(points: np.ndarray, u: np.ndarray) -> np.ndarray:
    """(8,) TL, TR, BR, BL of the rectangle along ``u`` that holds
    ``points`` (n, 2)."""
    v = np.array([-u[1], u[0]])
    pu, pv = points @ u, points @ v
    corners = [(pu.min(), pv.min()), (pu.max(), pv.min()), (pu.max(), pv.max()),
               (pu.min(), pv.max())]
    return np.array([a * u + b * v for a, b in corners]).reshape(8)


def join_lines(words: np.ndarray) -> np.ndarray:
    """The words (n, 8) of each rendered line joined into the line's quad
    (the renderer lists a line's words in order): MSRA-TD500's line-level
    labels, on which the paper also reports."""
    groups: List[List[np.ndarray]] = []
    for w in words:
        if groups and _same_line(groups[-1][-1], w):
            groups[-1].append(w)
        else:
            groups.append([w])
    out = []
    for g in groups:
        d = g[0].reshape(4, 2)[1] - g[0].reshape(4, 2)[0]
        u = d / np.linalg.norm(d) if d.any() else np.array([1.0, 0.0])
        out.append(rect_along(np.concatenate([w.reshape(4, 2) for w in g]), u))
    return np.asarray(out, np.float64).reshape(-1, 8)


def _clip_to_frame(quad: np.ndarray, size: int) -> np.ndarray:
    """The part of a line quad inside the ``size`` square frame, as the
    rectangle along the line that holds it ((8,), or empty)."""
    pts = [tuple(p) for p in quad.reshape(4, 2)]
    for axis, lo in ((0, True), (0, False), (1, True), (1, False)):
        edge = 0.0 if lo else float(size)
        inside = (lambda p: p[axis] >= edge) if lo else (lambda p: p[axis] <= edge)
        out = []
        for i, cur in enumerate(pts):
            prev = pts[i - 1]
            if inside(cur) != inside(prev):
                t = (edge - prev[axis]) / (cur[axis] - prev[axis])
                out.append(tuple(prev[k] + t * (cur[k] - prev[k]) for k in range(2)))
            if inside(cur):
                out.append(cur)
        pts = out
        if not pts:
            return np.zeros(0)
    d = quad.reshape(4, 2)[1] - quad.reshape(4, 2)[0]
    return rect_along(np.array(pts), d / np.linalg.norm(d))


def _mirror(quads: np.ndarray, width: int) -> np.ndarray:
    """Quads of the mirrored image, still TL, TR, BR, BL."""
    q = quads.reshape(-1, 4, 2).copy()
    q[..., 0] = width - q[..., 0]
    return q[:, [1, 0, 3, 2]].reshape(-1, 8)


def _crop(img: np.ndarray, quads: np.ndarray, rng: np.random.RandomState, size: int):
    """A scaled, maybe mirrored, ``size`` square crop (zero padded) and its
    line quads: a line the frame cuts keeps the part inside, or is
    don't-care where that part is shorter than the line is high."""
    from PIL import Image

    s = rng.uniform(0.8, 2.0)
    h, w = img.shape[:2]
    nh, nw = max(int(h * s), 1), max(int(w * s), 1)
    im = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))
    q = quads * s
    if rng.rand() < 0.5:
        im, q = im[:, ::-1], _mirror(q, nw)
    y0 = rng.randint(0, max(nh - size, 0) + 1)
    x0 = rng.randint(0, max(nw - size, 0) + 1)
    out = np.zeros((size, size, 3), np.uint8)
    part = im[y0:y0 + size, x0:x0 + size]
    out[:part.shape[0], :part.shape[1]] = part
    q = q - np.tile([x0, y0], 4)
    kept, dontcare = [], []
    for line in q:
        xs, ys = line[0::2], line[1::2]
        if xs.max() < 0 or ys.max() < 0 or xs.min() >= size or ys.min() >= size:
            continue
        if xs.min() >= 0 and ys.min() >= 0 and xs.max() < size and ys.max() < size:
            kept.append(line)
            dontcare.append(False)
            continue
        part = _clip_to_frame(line, size)
        if part.size == 0:
            continue
        p = part.reshape(4, 2)
        kept.append(part)
        dontcare.append(np.linalg.norm(p[1] - p[0]) < np.linalg.norm(p[3] - p[0]))
    return out[..., ::-1], np.asarray(kept, np.float64).reshape(-1, 8), dontcare  # BGR


_POOL: List[Tuple[np.ndarray, np.ndarray]] = []  # the scenes, in each crop worker


def _keep_pool(pool) -> None:
    global _POOL
    _POOL = pool


def make_batch(args: Tuple[int, int, int]):
    """One training batch from seed ``seed``: crops of scenes drawn from
    the pool of renders."""
    from ctpn_tpu_torch.training.east_loss import rbox_targets

    seed, batch, size = args
    rng = np.random.RandomState(seed)
    ims, tgts = [], []
    for _ in range(batch):
        img, quads = _POOL[rng.randint(len(_POOL))]
        im, q, dc = _crop(img, quads, rng, size)
        ims.append(im)
        tgts.append(rbox_targets(list(q), list(dc), size, size))
    return (np.stack(ims),) + tuple(np.stack([t[k] for t in tgts]) for k in range(4))


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def build_model(trunk: str, device):
    import torch

    from ctpn_tpu_torch.models.east import EAST
    from ctpn_tpu_torch.utils.weights import load_params, params_from_jax

    model = EAST(dtype=torch.bfloat16, per_image_tail=False).to(device)
    state = {k: v for k, v in params_from_jax(load_params(trunk, device=device)).items()
             if k.startswith("trunk.")}
    missing = model.load_state_dict(state, strict=False).missing_keys
    assert all(not k.startswith("trunk.") for k in missing), missing
    return model


def export(model, trunk: str, out: str) -> str:
    from ctpn_tpu_torch.utils.weights import params_to_jax, _flatten

    state = {k: v for k, v in model.state_dict().items() if not k.startswith("trunk.")}
    flat = {k: np.asarray(v, np.float16) for k, v in _flatten(params_to_jax(state))}
    flat["__trunk__"] = np.array(osp.basename(trunk))
    flat["__trunk_sha256__"] = np.array(_sha256(trunk))
    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **flat)
    return out


def train(args: argparse.Namespace) -> dict:
    import torch

    from ctpn_tpu_torch.inference.pipeline import mean_subtracted
    from ctpn_tpu_torch.training.east_loss import east_loss

    t0 = time.perf_counter()
    rng = np.random.RandomState(args.seed)
    with mp.get_context("spawn").Pool(args.workers) as pool:
        scenes = pool.map(_render, rng.randint(0, HOLDOUT_BASE, args.scenes).tolist(),
                          chunksize=8)
    print(json.dumps({"scenes": len(scenes), "s": round(time.perf_counter() - t0, 1)}),
          flush=True)
    # the crop workers fork before the card is touched and share the scenes
    crops = mp.get_context("fork").Pool(args.workers, initializer=_keep_pool,
                                        initargs=(scenes,))
    dev = torch.device(args.device)
    torch.manual_seed(args.seed)
    model = build_model(args.trunk, dev)
    params = [p for n, p in model.named_parameters() if not n.startswith("trunk.")]
    for n, p in model.named_parameters():
        p.requires_grad_(not n.startswith("trunk."))
    opt = torch.optim.Adam(params, lr=args.lr)
    seeds = [(args.seed * 10**6 + i, args.batch, args.crop) for i in range(args.steps)]
    log = []
    t_train = time.perf_counter()
    wait = 0.0  # seconds the card's loop waited for the crop workers
    with crops:
        batches = crops.imap(make_batch, seeds, chunksize=2)
        for step in range(args.steps):
            t_wait = time.perf_counter()
            batch = next(batches)
            wait += time.perf_counter() - t_wait
            # the rate divided by 10 at 70 % and 90 % of the steps, or of
            # --max-seconds when that ends the run first
            done = step / args.steps
            if args.max_seconds:
                done = max(done, (time.perf_counter() - t_train) / args.max_seconds)
            for g in opt.param_groups:
                g["lr"] = args.lr * (0.1 if done >= 0.7 else 1.0) * (0.1 if done >= 0.9 else 1.0)
            x, ts, tg, ta, tm = (torch.from_numpy(np.ascontiguousarray(b)).to(dev) for b in batch)
            with torch.no_grad():
                taps = model.trunk_taps(mean_subtracted(x))
            # the merge branch trains in float32: bf16's bilinear backward
            # adds with emulated atomics, several times slower
            outs = model.head(model.merge([t.float() for t in taps]))
            loss, ls, lg = east_loss(outs.score, outs.geo, outs.angle, ts, tg, ta, tm)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            last = step == args.steps - 1 or done >= 1.0
            if step % 100 == 0 or last:
                row = {"step": step, "loss": float(loss.detach()), "score": float(ls),
                       "geo": float(lg.detach()), "s": round(time.perf_counter() - t0, 1),
                       "data_wait_s": round(wait, 1)}
                log.append(row)
                print(json.dumps(row), flush=True)
            if args.save_every and step and step % args.save_every == 0:
                export(model, args.trunk, args.out)  # a run cut short keeps its weights
            if last:
                break
    model.eval()
    export(model, args.trunk, args.out)
    return {"steps": step + 1, "batch": args.batch, "crop": args.crop, "lr": args.lr,
            "scenes": args.scenes,
            "train_s": round(time.perf_counter() - t0, 1), "final": log[-1],
            "artifact": args.out, "sha256": _sha256(args.out)}


def holdout(n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` held-out renders at 1280x720 (BGR) with their line quads."""
    from PIL import Image

    out = []
    sx, sy = EVAL_SIZE[0] / SCENE[0], EVAL_SIZE[1] / SCENE[1]
    for i in range(n):
        img, quads = _render(HOLDOUT_BASE + i)
        im = np.asarray(Image.fromarray(img).resize(EVAL_SIZE, Image.BILINEAR))
        out.append((np.ascontiguousarray(im[..., ::-1]), quads * np.tile([sx, sy], 4)))
    return out


def match(dets: np.ndarray, gts: np.ndarray, care: np.ndarray, iou: float = 0.5):
    """(matched, detections counted, lines counted): one-to-one, highest
    IoU first; detections matched to don't-care lines are not counted."""
    from ctpn_tpu_torch.plain.east import quad_iou

    if len(dets) == 0 or len(gts) == 0:
        return 0, len(dets), int(care.sum())
    m = quad_iou(dets[:, None, :8].astype(np.float32), gts[None].astype(np.float32))
    pairs = sorted(((m[i, j], i, j) for i, j in np.argwhere(m >= iou)), reverse=True)
    used_d, used_g, hit, dc = set(), set(), 0, 0
    for _, i, j in pairs:
        if i in used_d or j in used_g:
            continue
        used_d.add(i)
        used_g.add(j)
        if care[j]:
            hit += 1
        else:
            dc += 1
    return hit, len(dets) - dc, int(care.sum())


def score(artifact: str, n: int, device: str) -> dict:
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.training.east_loss import min_area_rect
    from ctpn_tpu_torch.utils.weights import load_params

    reset_cfg()
    cfg_from_list(["NET_NAME", "EAST_VGG16", "TPU.BUCKETS", [[736, 1280]],
                   "TEXT.SCALE", 720, "TEXT.MAX_SCALE", 1280,
                   "TEST.SCALES", [720], "TEST.MAX_SIZE", 1280])
    pred = CTPNPredictor(load_params(artifact, device=device), device=device)
    hit = ndet = ngt = 0
    for im, quads in holdout(n):
        care = np.array([min(min_area_rect(q)[1:3]) >= 8 for q in quads], bool)
        h, d, g = match(pred.detect_image(im), quads, care)
        hit, ndet, ngt = hit + h, ndet + d, ngt + g
    return {"holdout": n, "matched": hit, "detections": ndet, "lines": ngt,
            "precision": hit / max(ndet, 1), "recall": hit / max(ngt, 1)}


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.eval:
        print(json.dumps({"eval": score(args.eval, args.holdout, args.device)}), flush=True)
        return
    recipe = train(args)
    print(json.dumps({"trained": recipe}), flush=True)
    print(json.dumps({"eval": score(args.out, args.holdout, args.device)}), flush=True)


if __name__ == "__main__":
    main()
