"""Tiny sizes at which every cell runs on the CPU in seconds: the same
model widths and weights, float32, images of a few hundred pixels in small
buckets, few inputs. ``python benchmark/tests/tiny.py <workload> [trace]
[fault]`` runs one cell so and prints its result line."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

from harness.core import BENCH_DIR, load_json  # noqa: E402

def overrides(workload: str) -> dict:
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    program = dict(cfg["program"], **{"TPU.FUSED_STEM": False})  # a card kernel
    config = {"compute_dtype": "float32",
              "buckets": [[96, 96], [96, 128], [96, 160], [128, 96], [96, 144]],
              "TEXT": dict(cfg["TEXT"], SCALE=96, MAX_SCALE=160),
              "TEST": dict(cfg["TEST"], SCALES=[96], MAX_SIZE=160),
              "program": program}
    traffic = {"scenes": 2, "input_workers": 1, "sample": 8,
               "image": [144, 96], "bucket": [96, 144], "batch": 4, "distinct_batches": 2}
    return {"config": config, "traffic": traffic}


def fault_shift(props, lines):
    """An answer altered where it is produced: every box 24 px lower."""
    recs = lines.recs.clone()
    recs[..., 1:8:2] += 24.0
    rois = props.rois.clone()
    rois[..., 2:5:2] += 24.0
    return props._replace(rois=rois), lines._replace(recs=recs)


def fault_half(props, lines):
    """Half of the batch left out: every other slot answered with nothing."""
    count, pcount, valid = lines.count.clone(), props.count.clone(), props.valid.clone()
    count[1::2] = 0
    pcount[1::2] = 0
    valid[1::2] = False
    return props._replace(count=pcount, valid=valid), lines._replace(count=count)


FAULTS = {"shift": fault_shift, "half": fault_half}


def main(argv) -> None:
    import torch

    import run as R

    torch.set_num_threads(2)  # tests run side by side: no pool oversubscribes the host

    workload = argv[0]
    trace = argv[1] if len(argv) > 1 else "0"
    fault = FAULTS[argv[2]] if len(argv) > 2 else None
    args = R.parse(["--workload", workload, "--seed", "3000000019", "--seconds", "5",
                    "--trace", trace])
    R.execute(args, ROOT, device="cpu", overrides=overrides(workload), fault=fault)


if __name__ == "__main__":
    main(sys.argv[1:])
