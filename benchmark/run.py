"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a run with the device
trace on. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` when
traced, and ``compared``: each number held against the reference, with its
limit); the compared numbers are also the last lines of standard error.
Exits 2, with no result, without CUDA or with fewer cards than the cell
needs, and 3 if a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.core import (BENCH_DIR, Run, card_name_and_limit,  # noqa: E402
                          forbidden_modules, load_module)


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def _guard(where: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"benchmark: {where}: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)


def _metric_names(bench: dict, section: str, workload: str):
    for m in bench[section]:
        if "workloads" not in m or workload in m["workloads"]:
            yield m


def reader_path(name: str) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    else the reader of its quantity, ``metrics/<base>.py`` with ``base``
    the part of the name before its first dot, which serves every split
    of a quantity by the end-to-end metric it moves (``mfu.offline``)."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.exists() else BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"


def result(run: Run) -> dict:
    """The result line of a finished run."""
    metrics = {}
    if run.trace:
        for m in _metric_names(run.bench, "per_layer", run.workload):
            reader = load_module(reader_path(m["name"]),
                                 "metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in _metric_names(run.bench, "end_to_end", run.workload):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu" if run.device == "cuda" else run.device,
              "kind": _kind(run), "count": run.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    trace = run.readings.get("trace")
    if trace:
        device["busy_s"] = trace["busy_s"]
        device["window_s"] = trace["window_s"]
    ok = run.attempted > 0 and all(
        math.isfinite(v) and v <= limit for v, limit in run.compared.values())
    out = {"correct": bool(ok), "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics, "device": device}
    if run.breakdown is not None:
        out["breakdown"] = run.breakdown
    out["compared"] = {k: {"value": v, "limit": limit}
                       for k, (v, limit) in run.compared.items()}
    return out


def _kind(run: Run) -> str:
    if run.device != "cuda":
        return run.device
    import torch

    return torch.cuda.get_device_name(0)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, root: Path, device: str = "cuda", overrides=None,
            fault=None) -> dict:
    """Run the cell; returns the result line's object. ``device="cpu"``,
    ``overrides`` and ``fault`` are for the tests only."""
    _guard("start-up")
    if str(root) not in sys.path:
        sys.path.insert(1, str(root))  # the program under test, from the checkout
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), root,
              device=device, overrides=overrides)
    run.fault = fault
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < run.chips:
            print(f"benchmark: {args.workload} needs {run.chips} CUDA card(s)",
                  file=sys.stderr, flush=True)
            raise SystemExit(2)
        run.log(f"{args.workload} seed {args.seed}: {card_name_and_limit()}")
    driver = load_module(BENCH_DIR / "drivers" / f"{run.traffic['driver']}.py",
                         "driver_" + run.traffic["driver"])
    driver.run(run)
    out = result(run)
    _guard("after the window")
    run.log("set-up parts: " + json.dumps(run.readings.get("setup_parts", {})))
    run.log("counts: " + json.dumps(run.notes))
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr,
              flush=True)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> None:
    args = parse(argv)
    root = Path.cwd()
    _cache_dirs(root)
    execute(args, root)


if __name__ == "__main__":
    main()
