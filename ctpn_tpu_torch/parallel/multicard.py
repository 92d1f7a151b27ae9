"""Multi-card certificate of the port: data-parallel training and detection
over the visible cards (counterpart of ``__graft_entry__.py::dryrun_multichip``).

    python -m ctpn_tpu_torch.parallel.multicard [--devices N]
    python -m ctpn_tpu_torch.parallel.multicard --device cpu --devices 2 --small

Four legs, every gate raising ``AssertionError``:

(a) training. The module starts the ranks itself, each as ``torchrun``
    starts one (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
    and ``MASTER_PORT`` in its environment): NCCL on cards, gloo with
    ``--device cpu``. Every rank steps through
    ``training/graphs.py::TrainGraphs``: on cards its first 11 steps run
    eagerly (PyTorch's DDP warm-up before a capture), the 11th captures
    the step with its NCCL all-reduces, and the later steps replay it; on
    the CPU every step is eager. The report says which step ran. Momentum
    steps on a fixed batch with fixed anchor-target draws (six on the CPU;
    on cards the 11 eager steps and five replayed ones), one image per
    rank, full VGG16 width at 608x912 in bf16, from ``init_params(3)``:
    the last loss below the first, the whole back half below the first,
    and on cards the last five steps replayed; the same steps taken again
    from a new DDP model on the same parameters give the same losses and
    parameters bit for bit (the step runs only reproducible kernels,
    ``train_step.reproducible``). Then one step at 2 ranks,
    2x256x384, f32 with TF32 off, against one process on the same global
    batch: loss and gradient norm within 1e-4 relative, the update within
    1e-3 * lr wherever the gradient exceeds 1e-6.
(b) detection. ``parallel/dp.py::shard_detect_fn`` over the devices, on
    the default route and the served route (``TPU.NMS_FUSED False
    TPU.FUSED_STEM True``), with the shipped weights, on the five committed
    overlays ``docs/demo_results/H/*`` plus three repeats in the 608x912
    bucket: equal bit for bit to one card's ``CTPNPredictor.run_batch`` run
    slice by slice (the batch each replica runs), and a second DP run equal
    to the first; counts equal to one card's ``run_batch`` on the whole
    batch, whose records are paired with the DP records and the worst pair
    reported (one card's records move with the batch size it runs: the
    same card at the per-replica batch is reported beside it); launches
    per card exactly 2 fused-NMS (default) or 2 bitmask, 2 resolve and 1
    stem (served) per replica on it, counted through the replays of the
    replicas' captured programs; on cards, no host sync while one
    replica's batch is issued; and, with each photo in its own bucket, at
    least 75 % of the 49 committed lines found.
(c) frozen. The default route exported with ``dp_devices`` at 8x608x912,
    loaded in a new process that cannot import ``ctpn_tpu_torch.models``:
    the launches per card from inside the programs as in (b), and outputs
    equal bit for bit to the live DP function's.
(d) readings on cards, not gated: DP detect img/s at global batch 8 and 32
    over 1, 2 and all cards (beside one card's captured program and its
    eager program called directly, and with several replicas also at a
    0.1 ms thread switch interval); the cards' kernel overlap in one DP
    call at global batch 32 over all cards (``kernel_overlap``);
    DDP ms per step at 2 images per rank over 1, 2 and all ranks, replayed
    (the eager warm-up steps timed beside it), with the NCCL kernels' share
    of a replayed step from ``torch.profiler``; the card line of
    ``nvidia-smi``.

With one card visible, (b) and (c) run two replicas on ``cuda:0`` (the
split, the worker threads and the gather still run) and (a) runs one NCCL
rank; the module says how many cards and replicas it used. ``--small``
takes ``dryrun_multichip``'s sizes (training and the parity step at 64x80,
detection of eight seeded synthetic renders at 128x160 with pre-NMS 256,
post-NMS 64 and 16 lines, f32): there the recall gate is replaced by lines
on at least half the images, as in ``dryrun_multichip``. On the CPU the
kernels' plain versions run and no launch is counted (every count must be
0), and (d) is not read.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import warnings
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ctpn_tpu_torch.ops import _kernel

REPO = Path(__file__).resolve().parents[2]
ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
COMMITTED = REPO / "docs" / "demo_results" / "H"
PHOTOS = [COMMITTED / n for n in ("006.jpg", "007.jpg", "008.jpg", "009.jpg", "010.png")]
SERVED_ROUTE = ["TPU.NMS_FUSED", "False", "TPU.FUSED_STEM", "True"]
DESCENT_STEPS = 6  # on the CPU; on cards the DDP warm-up and REPLAYED_STEPS
REPLAYED_STEPS = 5
# the warning of CUDA's sync debug mode at each synchronizing operation
SYNC_WARNING = "called a synchronizing CUDA operation"
RANK_TIMEOUT = 900  # seconds for one group of ranks

# bucket of each leg: (a) descent and timing, (a) parity, (b)-(d) detection
FULL = {"train": (608, 912), "parity": (256, 384), "detect": (608, 912)}
SMALL = {"train": (64, 80), "parity": (64, 80), "detect": (128, 160)}
SMALL_DETECT = ["TEST.RPN_PRE_NMS_TOP_N", "256", "TEST.RPN_POST_NMS_TOP_N", "64",
                "TPU.MAX_LINES", "16", "TPU.COMPUTE_DTYPE", "float32"]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out[0]


# ---------------------------------------------------------------- inputs


def scene_arrays(seed: int, n: int, bucket: tuple) -> list:
    """``n`` scenes of the port's synthetic renderer filling ``bucket``, with
    their ground truth cut into 16-px strips as ``ctpn-torch-prepare`` cuts
    it: the seven arrays of a training ``Batch``."""
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.data.prepare import split_polygon_to_strips
    from ctpn_tpu_torch.data.synth import render_image

    rng = np.random.RandomState(seed)
    h, w = bucket
    max_gt, max_dc = cfg.TPU.MAX_GT, cfg.TPU.MAX_DONTCARE
    images = np.zeros((n, h, w, 3), np.uint8)
    gt = np.zeros((n, max_gt, 4), np.float32)
    valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        strips = []
        while not strips:  # a scene may come out without text: draw again
            rgb, polys = render_image(rng, width=w, height=h)
            strips = [s for p in polys
                      for s in split_polygon_to_strips([int(v) for v in p], h, w)]
        images[i] = rgb[..., ::-1]  # BGR, as load_image_bgr gives
        strips = strips[:max_gt]
        gt[i, :len(strips)] = strips
        valid[i, :len(strips)] = True
    return [images, np.tile(np.array([h, w, 1.0], np.float32), (n, 1)), gt, valid,
            np.zeros((n, max_gt), bool), np.zeros((n, max_dc, 4), np.float32),
            np.zeros((n, max_dc), bool)]


def photo_batch(bucket=(608, 912)) -> tuple:
    """The five committed photos plus three repeats of the first, padded to
    ``bucket``: (uint8 images (8, h, w, 3), im_info (8, 3))."""
    from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image

    preps = [prep_image(load_image_bgr(str(p)), bucket=bucket) for p in PHOTOS]
    data = np.stack([p[0] for p in preps] + [preps[0][0]] * 3)
    infos = np.stack([p[1] for p in preps] + [preps[0][1]] * 3)
    return data, infos


def render_batch(bucket: tuple, n: int = 8) -> tuple:
    """``n`` seeded synthetic renders at ``bucket`` (``dryrun_multichip``'s
    detection input): (uint8 images, im_info)."""
    from ctpn_tpu_torch.data.synth import render_image

    h, w = bucket
    imgs = [render_image(np.random.RandomState(100 + i), width=w, height=h)[0][..., ::-1]
            for i in range(n)]
    return (np.ascontiguousarray(np.stack(imgs)).astype(np.uint8),
            np.tile(np.array([h, w, 1.0], np.float32), (n, 1)))


def pair_rows(a: np.ndarray, b: np.ndarray) -> float:
    """Greedy one-to-one pairing of the rows of ``a`` with those of ``b``;
    returns the largest difference of a pair (inf if the counts differ)."""
    if a.shape != b.shape:
        return float("inf")
    used = np.zeros(len(b), bool)
    worst = 0.0
    for row in a:
        d = np.abs(b - row[None]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        used[j] = True
        worst = max(worst, float(d[j]))
    return worst


def outputs_match(got: Sequence[np.ndarray], want: Sequence[np.ndarray], what: str,
                  atol: Optional[float] = 0.5) -> dict:
    """Flat ABI outputs (rois, roi_valid, roi_count, recs, line_valid,
    line_count) against a reference: counts exact, and (unless ``atol`` is
    None) line records paired one-to-one within ``atol`` px. Returns the
    counts, the worst pair and the largest float differences."""
    rois, _, roi_count, recs, _, line_count = got
    if not (np.array_equal(roi_count, want[2]) and np.array_equal(line_count, want[5])):
        raise AssertionError(f"{what}: counts differ: rois {roi_count.tolist()} vs "
                             f"{want[2].tolist()}, lines {line_count.tolist()} vs "
                             f"{want[5].tolist()}")
    per_image = [pair_rows(recs[i, :c], want[3][i, :c]) for i, c in enumerate(line_count)]
    if atol is not None and max(per_image, default=0.0) > atol:
        raise AssertionError(f"{what}: records not paired within {atol} px: worst pair "
                             f"per image {per_image}")
    return {"roi_counts": roi_count.tolist(), "line_counts": line_count.tolist(),
            "worst_pair_px": max(per_image, default=0.0),
            "worst_pair_px_per_image": per_image,
            "max_abs_diff_rois": float(np.abs(rois - want[0]).max()),
            "max_abs_diff_recs": float(np.abs(recs - want[3]).max())}


def equal_outputs(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> bool:
    return all(np.array_equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------- launch accounting


def epilogue_launches(route: str) -> int:
    """The conv epilogues of one program run under the cfg: one per conv
    of the trunk and ``rpn_conv`` in bf16 (13 + 1, the stem kernel running
    block 1's two on the served route), none in float32."""
    from ctpn_tpu_torch.config import cfg

    if cfg.TPU.COMPUTE_DTYPE != "bfloat16":
        return 0
    return 12 if route == "served" else 14


def counts_by_device(since: Optional[dict] = None) -> dict:
    """``{kernel: {device index: launches}}`` (indices as strings), less the
    counts of an earlier reading ``since``. The counts are only read, never
    reset: a caller may count a whole run around this module."""
    out = {}
    for name, fn in _kernel.wrappers().items():
        now = Counter({str(k): v for k, v in fn.LAUNCHES_BY_DEVICE.items()})
        now.subtract(Counter((since or {}).get(name, {})))
        out[name] = {k: v for k, v in sorted(now.items()) if v}
    return out


def expected_counts(devices: Sequence[torch.device], per_replica: dict) -> dict:
    """Launches per card of one DP call: ``per_replica`` times the replicas
    on each card; nothing on the CPU (the plain versions run there)."""
    on_card = Counter(d.index for d in devices if d.type == "cuda")
    return {name: {str(k): per_replica.get(name, 0) * r for k, r in sorted(on_card.items())
                   if per_replica.get(name, 0)}
            for name in _kernel.registry()}


def check_counts(devices, per_replica: dict, got: dict, what: str) -> None:
    want = expected_counts(devices, per_replica)
    if got != want:
        raise AssertionError(f"{what}: launches per card {got}, expected {want}")


# ------------------------------------------------------------ (a) training


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(world: int, spec: dict, work: Path) -> dict:
    """Start ``world`` rank processes of :func:`worker` on ``spec`` (as
    ``torchrun`` would start them, on localhost), wait for all, and return
    what rank 0 wrote."""
    spec_file = work / f"spec_{world}.json"
    out_file = work / f"ranks_{world}.json"
    spec = dict(spec, out=str(out_file), work=str(work))
    spec_file.write_text(json.dumps(spec))
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if spec["device"] == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ctpn_tpu_torch.parallel.multicard",
             "--worker", str(spec_file)],
            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs, failed = [], False
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
            failed |= p.returncode != 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        text = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{o[-4000:]}"
                         for r, (p, o) in enumerate(zip(procs, outs)))
        raise AssertionError(f"{world} rank(s) failed:\n{text}")
    return json.loads(out_file.read_text())


def _train_model(dev, dtype: str):
    """The training network from ``init_params(cfg.RNG_SEED)`` on ``dev``."""
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.models.factory import get_network, init_params
    from ctpn_tpu_torch.utils.weights import params_from_jax

    cfg.TPU.COMPUTE_DTYPE = dtype
    model = get_network("VGGnet_train", device=dev)
    model.load_state_dict(params_from_jax(init_params(cfg.RNG_SEED)))
    return model.train()


@contextlib.contextmanager
def no_tf32():
    """Float32 matmuls and convolutions without TF32, restored on exit."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _step_record(model, before: list, metrics: dict) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "delta": torch.cat([(p.detach() - b).flatten().cpu()
                                for p, b in zip(model.parameters(), before)]),
            "grad": torch.cat([p.grad.flatten().cpu() for p in model.parameters()])}


def _ddp_setup(bucket: tuple, dtype: str, n_global: int, seed: int, dev,
               rank: int, world: int):
    """A fresh DDP model, its state, its ``TrainGraphs`` and this rank's
    slice of a fixed global batch of ``n_global`` scenes (host memory,
    pinned on cards)."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.parallel.dp import shard_batch, wrap_model
    from ctpn_tpu_torch.training.graphs import TrainGraphs
    from ctpn_tpu_torch.training.train_step import Batch, create_train_state

    reset_cfg()
    cfg.TRAIN.SOLVER = "Momentum"
    model = _train_model(dev, dtype)
    ddp = wrap_model(model, dev)
    state = create_train_state(ddp)
    graphs = TrainGraphs(state, dev, rank, world)
    batch = Batch.from_numpy(scene_arrays(seed, n_global, bucket), pin=dev.type == "cuda")
    return model, state, graphs, shard_batch(batch, rank, world)


def _which_step(graphs) -> dict:
    """Which step the wrapper ran: its eager steps, whether it captured."""
    return {"eager_steps": graphs.eager_steps, "captured": bool(graphs.graphs),
            "step": "replayed" if graphs.graphs else "eager"}


def _task_descent(spec, dev, rank, world) -> dict:
    """Six steps on a fixed objective: the same batch and the same
    anchor-target draws every step (fresh draws resample the fg anchors of
    a scene with more than 150, and that noise outweighs six steps' gain).
    Then the same steps again, from a new DDP model on the same parameters:
    the losses and the final parameters of the two runs, compared."""
    from ctpn_tpu_torch.ops.anchor_target import num_anchors

    bucket = tuple(spec["train"])
    k = num_anchors(bucket[0] // 16, bucket[1] // 16)
    draws = torch.rand((2, world, k), generator=torch.Generator().manual_seed(24))
    draws = draws[:, rank:rank + 1]
    runs = []
    for _ in range(2):
        model, state, graphs, batch = _ddp_setup(bucket, spec["dtype"], world, 21, dev,
                                                 rank, world)
        n = DESCENT_STEPS if dev.type == "cpu" else graphs.warmup_steps + REPLAYED_STEPS
        losses = [float(graphs(batch, draws)["total_loss"]) for _ in range(n)]
        runs.append((losses, [p.detach().cpu() for p in model.parameters()],
                     {**_which_step(graphs), "replayed_steps": n - graphs.eager_steps}))
        del model, state, graphs
    (losses, params, which), (again, params_again, _) = runs
    return {"losses": losses, "bucket": list(bucket), "dtype": spec["dtype"],
            "images_per_rank": 1, **which, "rerun_losses": again,
            "rerun_params_max_abs_diff": max(float((a - b).abs().max())
                                             for a, b in zip(params, params_again))}


def _task_parity(spec, dev, rank, world) -> dict:
    bucket = tuple(spec["parity"])
    with no_tf32():
        model, state, graphs, batch = _ddp_setup(bucket, "float32", 2, 22, dev, rank,
                                                 world)
        before = [p.detach().clone() for p in model.parameters()]
        rec = _step_record(model, before, graphs(batch))
    if rank == 0:
        torch.save(rec, Path(spec["work"]) / f"parity_{world}.pt")
    return {"metrics": rec["metrics"], "bucket": list(bucket)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _task_timing(spec, dev, rank, world) -> dict:
    """ms per DDP step at 2 images per rank (bf16, the training bucket):
    the eager warm-up steps after the first two, then replayed steps once
    the wrapper has captured; then a profiled window of two replayed steps:
    the NCCL kernels' device time per step."""
    bucket = tuple(spec["train"])
    _, state, graphs, batch = _ddp_setup(bucket, "bfloat16", 2 * world, 23, dev,
                                         rank, world)
    for _ in range(2):
        graphs(batch)
    _sync(dev)
    # the eager steps before the one that captures
    t0, n_eager = time.perf_counter(), graphs.warmup_steps - graphs.eager_steps - 1
    for _ in range(n_eager):
        m = graphs(batch)
    if n_eager > 0:
        float(m["total_loss"])
    _sync(dev)
    eager_ms = (time.perf_counter() - t0) / n_eager * 1e3 if n_eager > 0 else None
    graphs(batch)  # the last eager step, and the capture
    iters = spec["timing_iters"]
    t0 = time.perf_counter()
    for _ in range(iters):
        m = graphs(batch)
    float(m["total_loss"])
    _sync(dev)
    ms = (time.perf_counter() - t0) / iters * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n_prof = 2
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            m = graphs(batch)
        float(m["total_loss"])
        _sync(dev)
        window_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    nccl_ms = sum(e.self_device_time_total for e in events
                  if "nccl" in e.key.lower()) / 1e3
    return {"ranks": world, "images_per_rank": 2, "bucket": list(bucket),
            **_which_step(graphs), "eager_ms_per_step": eager_ms,
            "ms_per_step": ms, "img_per_s": 2 * world / ms * 1e3, "iters": iters,
            "device_ms_per_step": dev_ms / n_prof, "nccl_ms_per_step": nccl_ms / n_prof,
            "nccl_share_of_step": nccl_ms / window_ms,
            "device_busy_share": dev_ms / window_ms}


TASKS = {"descent": _task_descent, "parity": _task_parity, "timing": _task_timing}


def worker(spec_file: str) -> None:
    """One rank: join the group, run the spec's tasks, rank 0 writes their
    results."""
    import torch.distributed as dist

    from ctpn_tpu_torch.parallel.dp import init_data_parallel

    spec = json.loads(Path(spec_file).read_text())
    if spec["device"] == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    rank, world = init_data_parallel(dev)
    out = {"world": world, "backend": dist.get_backend()}
    try:
        for task in spec["tasks"]:
            out[task] = TASKS[task](spec, dev, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        Path(spec["out"]).write_text(json.dumps(out))


def compare_updates(ref: dict, other: dict, lr: float, what: str) -> tuple:
    """The updates agree within 1e-3 * lr wherever the reference gradient
    exceeds 1e-6 (2 * lr where rounding noise decides it). Returns (worst,
    worst among the noisy, noisy count)."""
    noisy = ref["grad"].abs() <= 1e-6
    diff = (ref["delta"] - other["delta"]).abs()
    worst = float(diff[~noisy].max())
    worst_noisy = float(diff[noisy].max()) if noisy.any() else 0.0
    if worst > 1e-3 * lr or worst_noisy > 2 * lr:
        raise AssertionError(f"{what}: updates differ by {worst} (|g| > 1e-6), "
                             f"{worst_noisy} (|g| <= 1e-6), lr {lr}")
    return worst, worst_noisy, int(noisy.sum())


def parity_reference(bucket: tuple, dev) -> dict:
    """One process, one Momentum step on the parity leg's whole global batch
    (f32, TF32 off), from the same parameters and generator seed."""
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.training.train_step import (Batch, build_train_step,
                                                    create_train_state)

    reset_cfg()
    cfg.TRAIN.SOLVER = "Momentum"
    try:
        with no_tf32():
            model = _train_model(dev, "float32")
            batch = Batch.from_numpy(scene_arrays(22, 2, bucket)).to(dev)
            before = [p.detach().clone() for p in model.parameters()]
            step = build_train_step(model, bucket[0] // 16, bucket[1] // 16)
            return _step_record(model, before, step(create_train_state(model), batch))
    finally:
        reset_cfg()


def leg_training(dev_type: str, n_ranks: int, sizes: dict, work: Path,
                 timing: bool) -> dict:
    """(a): the descent at ``n_ranks``, the parity step at ``min(2,
    n_ranks)`` ranks against one process, and (with ``timing``) DDP steps
    over 1, 2 and ``n_ranks`` ranks. One group of rank processes per world
    size."""
    from ctpn_tpu_torch.config import cfg

    parity_world = min(2, n_ranks)
    worlds = sorted({1, 2, n_ranks} if timing else {parity_world, n_ranks})
    worlds = [w for w in worlds if w <= n_ranks]
    spec = {"device": dev_type, "train": sizes["train"], "parity": sizes["parity"],
            "dtype": "float32" if dev_type == "cpu" else "bfloat16", "timing_iters": 5}
    results = {}
    for w in worlds:
        tasks = (["descent"] * (w == n_ranks) + ["parity"] * (w == parity_world)
                 + ["timing"] * timing)
        if not tasks:
            continue
        t0 = time.perf_counter()
        results[w] = launch_ranks(w, dict(spec, tasks=tasks), work)
        log(f"  (a) {w} {results[w]['backend']} rank(s): {', '.join(tasks)} in "
            f"{time.perf_counter() - t0:.1f} s")

    losses = results[n_ranks]["descent"]["losses"]
    if not np.isfinite(losses).all():
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not decrease: {losses}")
    if not all(v < losses[0] for v in losses[len(losses) // 2:]):
        raise AssertionError(f"loss trajectory not decreasing: {losses}")
    descent = results[n_ranks]["descent"]
    if dev_type == "cuda" and not (descent["captured"]
                                   and descent["replayed_steps"] == REPLAYED_STEPS):
        raise AssertionError(f"the DDP step was not replayed: {descent}")
    log(f"  (a) descent, {n_ranks} rank(s), one image each at "
        f"{sizes['train'][0]}x{sizes['train'][1]}, {descent['eager_steps']} eager "
        f"then {descent['replayed_steps']} replayed steps ({descent['step']} step): "
        "loss " + " -> ".join(f"{v:.4f}" for v in losses))
    if descent["rerun_losses"] != losses or descent["rerun_params_max_abs_diff"] != 0.0:
        raise AssertionError(f"the same {len(losses)} DDP steps from one state differ: "
                             f"losses {losses} and {descent['rerun_losses']}, parameters "
                             f"by {descent['rerun_params_max_abs_diff']}")
    log(f"  (a) the same {len(losses)} steps again from the same state: losses and "
        "parameters equal bit for bit")

    dev = torch.device("cuda", 0) if dev_type == "cuda" else torch.device("cpu")
    ref = parity_reference(tuple(sizes["parity"]), dev)
    got = torch.load(work / f"parity_{parity_world}.pt")
    rel = {k: abs(got["metrics"][k] - ref["metrics"][k]) / abs(ref["metrics"][k])
           for k in ("total_loss", "model_loss", "grad_norm")}
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"{parity_world}-rank step against one process, relative "
                             f"differences {rel}")
    worst, worst_noisy, n_noisy = compare_updates(
        ref, got, cfg.TRAIN.LEARNING_RATE, f"{parity_world}-rank step")
    parity = {"ranks": parity_world, "bucket": sizes["parity"], "dtype": "float32, TF32 off",
              "rel_diff": rel, "update_max_abs_diff": worst,
              "noisy_update_max_abs_diff": worst_noisy, "elements_grad_le_1e-6": n_noisy,
              "total_loss": ref["metrics"]["total_loss"],
              "grad_norm": ref["metrics"]["grad_norm"]}
    log(f"  (a) parity: {parity_world} rank(s) against one process on 2x"
        f"{sizes['parity'][0]}x{sizes['parity'][1]}: relative differences {rel}, "
        f"update within {worst:.3g} (lr {cfg.TRAIN.LEARNING_RATE})")
    report = {"descent": results[n_ranks]["descent"], "parity": parity,
              "backend": results[n_ranks]["backend"], "ranks": n_ranks}
    if timing:
        report["ddp_steps"] = [results[w]["timing"] for w in worlds]
        for row in report["ddp_steps"]:
            log("  (d) ddp " + json.dumps(row))
    return report


# --------------------------------------------------------- (b) detection


def _set_route(sets: List[str], small: bool) -> None:
    from ctpn_tpu_torch.config import cfg_from_list, reset_cfg

    reset_cfg()
    cfg_from_list(sets + (SMALL_DETECT if small else []))


def _flat(props, lines) -> list:
    return [t.cpu().numpy() for t in (*props, *lines)]


def host_syncs(fn) -> dict:
    """The device-to-host syncs that ``fn()`` makes (CUDA's sync debug
    mode), in all and by the Python line that made them: a replica's
    issuing thread waits at each one for its card to drain. Only the
    mode's own warning counts ("called a synchronizing CUDA operation"),
    not the notice that the first ``set_sync_debug_mode`` of a process
    prints from ``torch/cuda/__init__.py``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                    if SYNC_WARNING in str(w.message))
    return {"count": sum(sites.values()), "sites": dict(sorted(sites.items()))}


def recall(detect, dev_count: int) -> tuple:
    """``detect(images, infos)`` (a DP function) on the five photos, each
    resized as ``detect_image`` resizes it and padded into its own bucket
    (one call per bucket, the batch padded to 8 with repeats): committed
    lines of ``docs/demo_results/H`` matched one-to-one at IoU >= 0.5 as
    ``ctpn-torch-eval`` counts them. Returns (hits, reference lines, lines)."""
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.eval import match_boxes, read_res_txt
    from ctpn_tpu_torch.inference.records import unscale_records
    from ctpn_tpu_torch.utils.image import load_image_bgr, prep_image, resize_im

    groups: Dict[tuple, list] = {}
    for photo in PHOTOS:
        resized, f1 = resize_im(load_image_bgr(str(photo)), cfg.TEXT.SCALE,
                                cfg.TEXT.MAX_SCALE)
        data, info, pad = prep_image(resized)
        groups.setdefault(data.shape[:2], []).append((photo, f1, data, info, pad))
    hits = n_ref = lines = 0
    for items in groups.values():
        n = max(8, -(-len(items) // dev_count) * dev_count)
        data = np.stack([it[2] for it in items] + [items[0][2]] * (n - len(items)))
        infos = np.stack([it[3] for it in items] + [items[0][3]] * (n - len(items)))
        _, out = detect(data, infos)
        for i, (photo, f1, _, info, pad) in enumerate(items):
            recs = unscale_records(out.recs[i].cpu().numpy(), int(out.count[i]), f1,
                                   info, y_off=pad)
            ref = read_res_txt(str(COMMITTED / f"res_{photo.stem}.txt"))
            xs, ys = recs[:, 0:8:2], recs[:, 1:8:2]
            boxes = np.trunc(np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1))
            hits += match_boxes(boxes.reshape(-1, 4), ref, 0.5)
            n_ref += len(ref)
            lines += len(recs)
    return hits, n_ref, lines


def leg_inference(devices: List[torch.device], small: bool) -> dict:
    """(b) on both routes. Returns the report, plus the default route's
    input batch and live DP outputs under the keys ``_data`` and ``_live``."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor, build_detect_fn
    from ctpn_tpu_torch.parallel.dp import replicate_model, shard_detect_fn
    from ctpn_tpu_torch.utils.weights import load_params

    sizes = SMALL if small else FULL
    data, infos = (render_batch(tuple(sizes["detect"])) if small
                   else photo_batch(tuple(sizes["detect"])))
    home = devices[0]
    params = load_params(str(ARTIFACT), device=home)
    report = {}
    for route, sets, per_replica in (
            ("default", [], {"nms_fused": 2, "successors": 1, "chain_walk": 1}),
            ("served", SERVED_ROUTE, {"nms_bitmask": 2, "nms_resolve": 2, "stem_fused": 1,
                                      "successors": 1, "chain_walk": 1})):
        _set_route(sets, small)
        per_replica = dict(per_replica, conv_epilogue=epilogue_launches(route))
        pred = CTPNPredictor(params, device=home)
        want = _flat(*pred.run_batch(data, infos))  # one card, the global batch
        per = len(data) // len(devices)
        slices = [_flat(*pred.run_batch(data[k * per:(k + 1) * per],
                                        infos[k * per:(k + 1) * per]))
                  for k in range(len(devices))]
        want_per = [np.concatenate([s[i] for s in slices]) for i in range(6)]
        replicas = replicate_model(pred.model, devices)
        detect = shard_detect_fn(lambda d: build_detect_fn(replicas[d]), devices)
        detect(data, infos)  # kernels built, cuDNN's choice made
        for d in devices:
            _sync(d)
        before = counts_by_device()
        got = _flat(*detect(data, infos))
        counts = counts_by_device(since=before)
        check_counts(devices, per_replica, counts, f"DP detect, {route} route")
        if not equal_outputs(got, _flat(*detect(data, infos))):
            raise AssertionError(f"{route} route: a second DP run differs from the first")
        if not equal_outputs(got, want_per):
            raise AssertionError(f"{route} route: DP detect differs from one card run "
                                 f"slice by slice (batch {per})")
        batch_effect = outputs_match(want_per, want, f"one card, batch {per} against "
                                     f"batch {len(data)}, {route} route", atol=None)
        match = outputs_match(got, want, f"DP detect against one card, {route} route",
                              atol=None)
        if home.type == "cuda":  # upload and replay of one replica's slice
            if host_syncs(lambda: torch.ones(1, device=home).item())["count"] != 1:
                raise AssertionError("host_syncs does not see the sync of .item()")
            row_syncs = host_syncs(lambda: pred.run_batch(data[:per], infos[:per]))
            if row_syncs["count"]:
                raise AssertionError(f"{route} route: a replica's batch makes host "
                                     f"syncs: {row_syncs}")
        row = {"launches_per_card": counts, "equal_to_one_card_per_slice": True,
               "per_replica_batch": per, **match,
               "one_card_batch_effect_worst_pair_px": batch_effect["worst_pair_px"]}
        if home.type == "cuda":
            row["host_syncs_per_replica_batch"] = row_syncs
        if small:
            lc = np.asarray(match["line_counts"])
            if not (lc.sum() > 0 and (lc > 0).mean() >= 0.5):
                raise AssertionError(f"{route} route: lines per image {lc.tolist()}")
        else:
            hits, n_ref, lines = recall(detect, len(devices))
            if hits < 0.75 * n_ref:
                raise AssertionError(f"{route} route: only {hits}/{n_ref} committed "
                                     "lines found")
            row["committed_recall"] = f"{hits}/{n_ref}"
            row["photo_lines"] = lines
        report[route] = row
        log(f"  (b) {route} route " + json.dumps(row))
        if route == "default":
            report["_live"], report["_data"] = got, (data, infos)
        detect.close()
        del pred, replicas
    _set_route([], small)
    return report


# ------------------------------------------------------------ (c) frozen


FROZEN_PROBE = r"""
import json, sys
import numpy as np
sys.modules["ctpn_tpu_torch.models"] = None  # the loader must not need model code
import torch
from ctpn_tpu_torch.inference.frozen import FrozenCTPN
from ctpn_tpu_torch.parallel import multicard

path, batch_file, out_file, device = sys.argv[1:5]
devices = sys.argv[5].split(",")
z = np.load(batch_file)
art = FrozenCTPN(path, device=device, devices=devices)
art.run_batch(z["data"], z["infos"])  # load the programs, warm up
before = multicard.counts_by_device()
out = [t.cpu().numpy() for t in art.run_batch(z["data"], z["infos"])]
np.savez(out_file, *out)
print(json.dumps({"launches_per_card": multicard.counts_by_device(since=before),
                  "devices": [str(d) for d in art.devices], "meta": art.meta,
                  "models_imported": any(m.startswith("ctpn_tpu_torch.models.")
                                         for m in sys.modules)}))
"""


def leg_frozen(devices: List[torch.device], inference: dict, small: bool,
               work: Path) -> dict:
    """(c): export the default route data parallel, load and run it in a
    process without model code, hold it to the live DP function."""
    from ctpn_tpu_torch.inference.frozen import export_frozen
    from ctpn_tpu_torch.utils.weights import load_params

    data, infos = inference["_data"]
    n, h, w = data.shape[:3]
    _set_route([], small)
    path = work / "frozen_dp.npz"
    t0 = time.perf_counter()
    export_frozen(load_params(str(ARTIFACT), device=devices[0]), str(path),
                  shapes=[(n, h, w)], dp_devices=len(devices), devices=devices,
                  device=devices[0].type)
    export_s = time.perf_counter() - t0
    batch_file, out_file = work / "frozen_batch.npz", work / "frozen_out.npz"
    np.savez(batch_file, data=data, infos=infos)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", FROZEN_PROBE, str(path), str(batch_file), str(out_file),
         devices[0].type, ",".join(str(d) for d in devices)],
        cwd=str(REPO), capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    if proc.returncode != 0:
        raise AssertionError(f"frozen probe failed:\n{proc.stdout}\n{proc.stderr}")
    probe = json.loads(proc.stdout.strip().splitlines()[-1])
    if probe["models_imported"]:
        raise AssertionError("the frozen loader imported ctpn_tpu_torch.models")
    if probe["meta"]["dp_devices"] != len(devices):
        raise AssertionError(f"meta dp_devices {probe['meta']['dp_devices']}")
    check_counts(devices, {"nms_fused": 2, "successors": 1, "chain_walk": 1,
                           "conv_epilogue": epilogue_launches("default")},
                 probe["launches_per_card"],
                 "frozen DP program, default route")
    with np.load(out_file) as z:
        got = [z[f"arr_{i}"] for i in range(6)]
    if not equal_outputs(got, inference["_live"]):
        match = outputs_match(got, inference["_live"], "frozen DP against live DP",
                              atol=None)
        raise AssertionError(f"the frozen DP program differs from the live DP "
                             f"function: {match}")
    match = outputs_match(got, inference["_live"], "frozen DP against live DP")
    row = {"equal_to_live_dp": True, "shape": [n, h, w], "dp_devices": len(devices), "export_s": export_s,
           "load_and_run_s": time.perf_counter() - t0, "MiB": path.stat().st_size / 2**20,
           "launches_per_card": probe["launches_per_card"], **match}
    log("  (c) frozen " + json.dumps(row))
    return row


# ---------------------------------------------------------- (d) readings


@contextlib.contextmanager
def switch_interval(seconds: Optional[float]):
    """The interpreter's thread switch interval set to ``seconds`` (None:
    left as it is), restored on exit."""
    prev = sys.getswitchinterval()
    if seconds is not None:
        sys.setswitchinterval(seconds)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)


def time_detect(detect, data, infos, devices, iters: int = 5) -> float:
    """Mean host seconds of one DP call ended by fetching its counts, after
    one warm-up call."""
    detect(data, infos)[1].count.cpu()
    for d in devices:
        _sync(d)
    t0 = time.perf_counter()
    for _ in range(iters):
        detect(data, infos)[1].count.cpu()
    return (time.perf_counter() - t0) / iters


def _merge(spans: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def kernel_overlap(fn, devices: List[torch.device]) -> dict:
    """Where the cards' kernels ran during one call of ``fn()``, from the
    device events of ``torch.profiler``: each card's busy ms (the union of
    its kernels' intervals), the ms in which any card and in which every
    card was busy, and the concurrency, the summed busy ms over the ms any
    card was busy (1 when the cards take turns, the card count when all
    run at once)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for d in devices:
        _sync(d)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        for d in devices:
            _sync(d)
    spans: Dict[int, list] = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            spans.setdefault(int(e.device_index), []).append(
                (e.time_range.start, e.time_range.end))
    merged = {k: _merge(v) for k, v in sorted(spans.items())}
    edges = sorted((t, step) for iv in merged.values() for lo, hi in iv
                   for t, step in ((lo, 1), (hi, -1)))
    any_us = all_us = 0.0
    busy, last = 0, None
    for t, step in edges:
        if last is not None:
            any_us += (t - last) * (busy > 0)
            all_us += (t - last) * (busy == len(merged) > 0)
        busy, last = busy + step, t
    busy_ms = {str(k): sum(hi - lo for lo, hi in iv) / 1e3 for k, iv in merged.items()}
    return {"cards_with_kernels": len(merged), "busy_ms_per_card": busy_ms,
            "any_card_busy_ms": any_us / 1e3, "all_cards_busy_ms": all_us / 1e3,
            "concurrency": (sum(busy_ms.values()) * 1e3 / any_us) if any_us else None}


def leg_readings(devices: List[torch.device], cards: int) -> dict:
    """(d): DP detect img/s on the default route at global batch 8 and 32
    over 1, 2 and all cards (and two replicas on one card when one card is
    visible), beside one card's captured program (what
    ``CTPNPredictor.run_batch`` runs) and its eager program, called
    directly; and the cards' kernel overlap in one DP call at global batch
    32 over all cards."""
    from ctpn_tpu_torch.inference.graphs import DetectGraphs
    from ctpn_tpu_torch.inference.pipeline import build_detect_fn
    from ctpn_tpu_torch.models.factory import get_network
    from ctpn_tpu_torch.parallel.dp import replicate_model, shard_detect_fn
    from ctpn_tpu_torch.utils.weights import load_params, params_from_jax

    _set_route([], False)
    model = get_network("VGGnet_test", devices[0])
    model.load_state_dict(params_from_jax(load_params(str(ARTIFACT), device=devices[0])))
    all_cards = [torch.device("cuda", i) for i in range(cards)]
    replicas = replicate_model(model, all_cards)
    lists = [all_cards[:k] for k in sorted({1, 2, cards}) if k <= cards]
    if cards == 1:
        lists.append(all_cards * 2)
    data, infos = photo_batch(tuple(FULL["detect"]))
    home, plain = all_cards[0], build_detect_fn(replicas[all_cards[0]])
    replayed = DetectGraphs(plain, home)  # what CTPNPredictor.run_batch runs

    def eager(x, info):  # the program issued op by op, pageable uploads
        return plain(torch.from_numpy(x).to(home), torch.from_numpy(info).to(home))

    rows = []
    for path, one_card in (("one card, replayed", replayed), ("one card, eager", eager)):
        for batch in (8, 32):
            reps = batch // len(data)
            sec = time_detect(one_card, np.concatenate([data] * reps),
                              np.concatenate([infos] * reps), [home])
            rows.append({"path": path, "cards": 1, "replicas": 1,
                         "global_batch": batch, "ms_per_batch": sec * 1e3,
                         "img_per_s": batch / sec, "iters": 5})
            log("  (d) dp detect " + json.dumps(rows[-1]))
    overlap = None
    # the replicas' threads share the interpreter lock: a thread back from
    # a host sync waits up to the switch interval (5 ms by default) for it,
    # so several replicas are also timed at a 0.1 ms interval
    for devs in lists:
        detect = shard_detect_fn(lambda d: build_detect_fn(replicas[d]), devs)
        for interval in (None, 1e-4) if len(devs) > 1 else (None,):
            for batch in (8, 32):
                reps = batch // len(data)
                with switch_interval(interval):
                    sec = time_detect(detect, np.concatenate([data] * reps),
                                      np.concatenate([infos] * reps), devs)
                rows.append({"path": "shard_detect_fn", "cards": len(set(devs)),
                             "replicas": len(devs),
                             "switch_interval_s": interval or sys.getswitchinterval(),
                             "global_batch": batch, "ms_per_batch": sec * 1e3,
                             "img_per_s": batch / sec, "iters": 5})
                log("  (d) dp detect " + json.dumps(rows[-1]))
        if devs is lists[-1]:  # every card (one card: its two replicas)
            x32, i32 = np.concatenate([data] * 4), np.concatenate([infos] * 4)
            overlap = {"replicas": len(devs), "cards": len(set(devs)), "global_batch": 32,
                       **kernel_overlap(lambda: detect(x32, i32)[1].count.cpu(), devs)}
            log("  (d) kernel overlap " + json.dumps(overlap))
        detect.close()
    return {"rows": rows, "kernel_overlap": overlap}


# ------------------------------------------------------------------ run


def run(n_devices: Optional[int] = None, device: str = "cuda", small: bool = False) -> dict:
    """All four legs; returns the report (raises ``AssertionError`` on a
    failed gate)."""
    from ctpn_tpu_torch.parallel.mesh import data_devices
    from ctpn_tpu_torch.utils.device import resolve_device

    dev_type = resolve_device(device).type
    if dev_type == "cuda":
        cards = len(data_devices(n_devices))
        devices = data_devices(cards)
        if cards == 1:
            devices = devices * 2  # one card: two replicas on it
    else:
        cards = 0
        devices = data_devices(n_devices or 2, "cpu")
    n_ranks = cards or len(devices)
    sizes = SMALL if small else FULL
    report = {"device": dev_type, "cards": cards, "replicas": len(devices),
              "ranks": n_ranks, "sizes": sizes}
    if dev_type == "cuda":
        report["card_line"] = card_line()
        report["device_name"] = torch.cuda.get_device_name(0)
        log(f"multicard: {cards} card(s) visible ({report['device_name']} | "
            f"{report['card_line']}); training over {n_ranks} NCCL rank(s), "
            f"detection over {len(devices)} replica(s) on {cards} card(s)")
    else:
        log(f"multicard: CPU only (no card): training over {n_ranks} gloo ranks, "
            f"detection over {len(devices)} replicas on the CPU")
    with tempfile.TemporaryDirectory(prefix="ctpn_multicard_") as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        report["training"] = leg_training(dev_type, n_ranks, sizes, work,
                                          timing=dev_type == "cuda")
        report["training_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        inference = leg_inference(devices, small)
        report["inference_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        report["frozen"] = leg_frozen(devices, inference, small, work)
        report["frozen_s"] = time.perf_counter() - t0
    report["inference"] = {k: v for k, v in inference.items() if not k.startswith("_")}
    if dev_type == "cuda":
        t0 = time.perf_counter()
        report["dp_detect"] = leg_readings(devices, cards)
        report["readings_s"] = time.perf_counter() - t0
    else:
        log("  (d) readings are taken on cards only")
    log(f"multicard: all legs passed on {cards} card(s), {len(devices)} replica(s), "
        f"{n_ranks} rank(s)")
    return report


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=None,
                   help="cards to use (default every visible card); with "
                        "--device cpu, gloo ranks and CPU replicas (default 2)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--small", action="store_true",
                   help="dryrun_multichip's sizes (64x80 training, 128x160 detection)")
    p.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args.worker)
        return
    report = run(args.devices, args.device, args.small)
    print("multicard " + json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
