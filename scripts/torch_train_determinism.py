#!/usr/bin/env python3
"""Is the PyTorch port's train step a function of its inputs on a CUDA card?
(ROADMAP D3.) From one state, with one batch and one set of anchor-target
draws, the eager step (``training/train_step.py::TrainStep``) is taken
three times on the caller's stream and three times on a side stream (the
kind of stream ``training/graphs.py::TrainGraphs`` and DDP run it on),
under three settings of the process's flags:

* ``default``: PyTorch's defaults, the step as it ran before
  ``train_step.reproducible`` existed;
* ``cudnn``: ``cudnn.deterministic`` on, ``cudnn.benchmark`` off;
* ``strict``: ``train_step.reproducible`` (the cuDNN flags and
  ``torch.use_deterministic_algorithms``), the step as it runs now.

    python3 scripts/torch_train_determinism.py [--before-tree DIR] [--out FILE]

At 2x256x384 in float32 with TF32 off (``chip_smoke.py`` phase 17's
setting) and 2x608x912 in bfloat16 (phase 12's), Adam. Prints one JSON
line per leg:

* ``run_to_run``: per setting and stream, each repeat against the first:
  whether the metrics, every gradient and the update are bit-equal, the
  parameters whose gradient differs in backward order (heads first) with
  the largest difference of each, and whether the anchor targets (whose
  ``ohem``-free path holds an int32 ``scatter_add_``) are equal; then the
  caller's stream against the side stream;
* ``kernels``: one profiled step under ``default`` and under ``strict``:
  the kernels that run under one and not the other, with device ms per
  step, and each setting's device ms per step;
* ``captured``: ``TrainGraphs`` from one state under ``default`` and
  ``strict``: the eager warm-up step, then the state rewound and the
  replayed step twice: bit-equal or the largest parameter difference;
* ``cost`` (with ``--before-tree``, a checkout of another commit):
  ``chip_smoke.time_captured_steps`` (phase 18: batch 1, 2, 8, ``TPU.REMAT``
  off and on) of that tree and of this one, each in a process of its own,
  in turns (before, after, after, before).

Every line carries the card's name and power limit as ``nvidia-smi`` prints
them. Needs a card: it exits 2 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from ctpn_tpu_torch.training import train_step as ts  # noqa: E402

REPEATS = 3
SHAPES = (  # (name, batch, bucket, compute dtype, TF32)
    ("phase17", 2, chip_smoke.TRAIN_PARITY_BUCKET, "float32", False),
    ("phase12", 2, chip_smoke.TRAIN_BUCKET, "bfloat16", True),
)


@contextlib.contextmanager
def cudnn_only():
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


STRICT = ts.reproducible
SETTINGS = {"default": contextlib.nullcontext, "cudnn": cudnn_only, "strict": STRICT}


@contextlib.contextmanager
def setting(name: str):
    """The train step's scope replaced by the setting's."""
    ts.reproducible = SETTINGS[name]
    try:
        yield
    finally:
        ts.reproducible = STRICT


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 off in matmuls and convolutions unless ``on`` (then PyTorch's
    defaults stand)."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    if not on:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def on_stream(stream, fn):
    """``fn()`` on ``stream`` (None: the caller's), ordered after and before
    the caller's work."""
    if stream is None:
        return fn()
    caller = torch.cuda.current_stream()
    stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        out = fn()
    caller.wait_stream(stream)
    return out


def setup(dev, n: int, bucket: tuple, dtype: str, seed: int):
    from ctpn_tpu_torch.config import cfg, reset_cfg
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.ops.anchor_target import num_anchors
    from ctpn_tpu_torch.training.train_step import Batch
    from ctpn_tpu_torch.utils.weights import params_from_jax

    reset_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TRAIN.SOLVER, cfg.TRAIN.LEARNING_RATE = "Adam", 1e-4
    h, w = bucket
    host = Batch.from_numpy(chip_smoke.train_arrays(seed, n, bucket), pin=dev.type == "cuda")
    draws = torch.rand((2, n, num_anchors(h // 16, w // 16)),
                       generator=torch.Generator().manual_seed(seed))
    return host, draws, params_from_jax(init_params(cfg.RNG_SEED))


def record(model, metrics: dict, targets=None) -> dict:
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": [p.grad.detach().clone() for p in model.parameters()],
           "params": [p.detach().clone() for p in model.parameters()]}
    if targets is not None:
        out["targets"] = [t.clone() for t in targets]
    return out


def compare(names: list, a: dict, b: dict) -> dict:
    """Bit-equality of two step records; the differing gradients in
    backward order (the model registers the heads last)."""
    grads = []
    for name, ga, gb in reversed(list(zip(names, a["grads"], b["grads"]))):
        if not torch.equal(ga, gb):
            grads.append([name, float((ga.float() - gb.float()).abs().max())])
    params = max(float((pa - pb).abs().max()) for pa, pb in zip(a["params"], b["params"]))
    out = {"metrics_equal": a["metrics"] == b["metrics"], "grads_equal": not grads,
           "params_max_abs_diff": params, "grads_differ_backward_order": grads[:12],
           "grads_differing": len(grads)}
    if "targets" in a:
        out["anchor_targets_equal"] = all(torch.equal(x, y)
                                          for x, y in zip(a["targets"], b["targets"]))
    return out


def run_to_run(dev, card: str) -> list:
    from ctpn_tpu_torch.ops.anchor_target import anchor_target_layer
    from ctpn_tpu_torch.training.train_step import (
        build_train_step,
        create_train_state,
        target_kwargs,
    )

    rows = []
    side = torch.cuda.Stream(dev)
    for shape, n, bucket, dtype, allow_tf32 in SHAPES:
        host, draws, state_dict = setup(dev, n, bucket, dtype, 31)
        batch = host.to(dev)
        h, w = bucket
        for name in SETTINGS:
            with setting(name), tf32(allow_tf32):
                model = chip_smoke.fresh_train_model(dev, state_dict)
                names = [k for k, _ in model.named_parameters()]
                state = create_train_state(model)
                step = build_train_step(model, h // 16, w // 16)
                saved = chip_smoke.keep(state)

                def one():
                    with ts.reproducible(), torch.no_grad():
                        targets = anchor_target_layer(
                            batch.gt_boxes, batch.gt_valid, batch.gt_ishard,
                            batch.dontcare, batch.dontcare_valid, batch.im_info,
                            draws[0].to(dev), draws[1].to(dev), h // 16, w // 16,
                            **target_kwargs())
                    return step(state, batch, draws), targets

                recs = {}
                for stream_name, stream in (("caller", None), ("side", side)):
                    recs[stream_name] = []
                    for _ in range(REPEATS):
                        chip_smoke.rewind(state, saved)
                        metrics, targets = on_stream(stream, one)
                        torch.cuda.synchronize()
                        recs[stream_name].append(record(model, metrics, targets))
                row = {"leg": "run_to_run", "shape": shape, "batch": n,
                       "bucket": list(bucket), "dtype": dtype, "tf32": allow_tf32,
                       "setting": name, "card": card}
                for stream_name, rs in recs.items():
                    row[stream_name] = [compare(names, rs[0], r) for r in rs[1:]]
                row["caller_vs_side"] = compare(names, recs["caller"][0], recs["side"][0])
                print(json.dumps(row), flush=True)
                rows.append(row)
                del model, state, step, saved, recs
                torch.cuda.empty_cache()
    return rows


def kernel_table(dev, fn) -> dict:
    """{kernel name: [calls, device ms]} over one call of ``fn`` (after
    one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: [e.count, e.self_device_time_total / 1e3] for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA}


def kernels(dev, card: str) -> list:
    from ctpn_tpu_torch.training.train_step import build_train_step, create_train_state

    rows = []
    for shape, n, bucket, dtype, allow_tf32 in SHAPES:
        host, draws, state_dict = setup(dev, n, bucket, dtype, 32)
        batch = host.to(dev)
        tables = {}
        for name in ("default", "strict"):
            with setting(name), tf32(allow_tf32):
                model = chip_smoke.fresh_train_model(dev, state_dict)
                state = create_train_state(model)
                step = build_train_step(model, bucket[0] // 16, bucket[1] // 16)
                tables[name] = kernel_table(dev, lambda: step(state, batch, draws))
                del model, state, step
                torch.cuda.empty_cache()
        only = {}
        for a, b in (("default", "strict"), ("strict", "default")):
            diff = {k: v for k, v in tables[a].items() if k not in tables[b]}
            top = sorted(diff.items(), key=lambda kv: -kv[1][1])[:15]
            only[f"only_{a}"] = [{"kernel": k[:160], "calls": c, "device_ms": ms}
                                 for k, (c, ms) in top]
            only[f"only_{a}_count"] = len(diff)
        row = {"leg": "kernels", "shape": shape, "batch": n, "dtype": dtype,
               **{f"{k}_device_ms": sum(v[1] for v in t.values()) for k, t in tables.items()},
               **{f"{k}_kernels": sum(v[0] for v in t.values()) for k, t in tables.items()},
               **only, "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def captured(dev, card: str) -> list:
    from ctpn_tpu_torch.training.graphs import TrainGraphs
    from ctpn_tpu_torch.training.train_step import create_train_state

    rows = []
    for shape, n, bucket, dtype, allow_tf32 in SHAPES:
        host, draws, state_dict = setup(dev, n, bucket, dtype, 33)
        for name in ("default", "strict"):
            with setting(name), tf32(allow_tf32):
                model = chip_smoke.fresh_train_model(dev, state_dict)
                names = [k for k, _ in model.named_parameters()]
                state = create_train_state(model)
                graphs = TrainGraphs(state, dev)
                saved = chip_smoke.keep(state)
                recs = []
                for _ in range(3):  # the eager warm-up (and the capture), two replays
                    chip_smoke.rewind(state, saved)
                    recs.append(record(model, graphs(host, draws)))
                torch.cuda.synchronize()
                row = {"leg": "captured", "shape": shape, "batch": n, "dtype": dtype,
                       "setting": name, "eager_steps": graphs.eager_steps,
                       "eager_vs_replay": compare(names, recs[0], recs[1]),
                       "replay_vs_replay": compare(names, recs[1], recs[2]), "card": card}
                print(json.dumps(row), flush=True)
                rows.append(row)
                del model, state, graphs, saved, recs
                torch.cuda.empty_cache()
    return rows


COST = r"""
import json, sys, torch
import chip_smoke
rows = chip_smoke.time_captured_steps(torch.device("cuda", 0))
keep = ("batch", "remat", "eager_ms_per_step", "replayed_ms_per_step",
        "device_ms_per_step", "eager_device_ms_per_step", "kernels_per_step",
        "replayed_device_busy_share", "first_call_peak_mib", "pool_mib")
print("COST " + json.dumps([{k: r[k] for k in keep} for r in rows]))
"""


def cost(before: Path, card: str) -> list:
    """Phase 18 of ``before`` and of this tree, each in its own process, in
    turns."""
    rows = []
    for tag, tree in (("before", before), ("after", REPO), ("after", REPO),
                      ("before", before)):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", COST], cwd=str(tree), text=True,
                             capture_output=True, timeout=900,
                             env=dict(os.environ, PYTHONPATH=str(tree)))
        if out.returncode:
            raise RuntimeError(f"{tag} ({tree}) failed:\n{out.stderr[-3000:]}")
        line = next(ln for ln in out.stdout.splitlines() if ln.startswith("COST "))
        row = {"leg": "cost", "tree": tag, "seconds": time.perf_counter() - t0,
               "steps": json.loads(line[5:]), "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--before-tree", type=Path, default=None,
                   help="a checkout of another commit, for the cost leg")
    p.add_argument("--out", type=Path, default=None, help="also write the lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_train_determinism: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    rows = run_to_run(dev, card) + kernels(dev, card) + captured(dev, card)
    if args.before_tree is not None:
        rows += cost(args.before_tree.resolve(), card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
