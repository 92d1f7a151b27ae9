"""Readings that a cell's limits are set from, many seeds in one process.

    python3 benchmark/calibrate.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...] [--control-seeds <n> ...]

For each of ``--seeds`` it runs the cell as ``run.py`` does (a window of
``--seconds``, the program built once and kept between seeds), and for
each of ``--control-seeds`` the control (the reference in float8 in the
program's place, ``drivers/<driver>.py::control``). Prints one JSON line
per reading with its compared numbers and the stricter ones beside them,
then a summary: per number the largest reading of the program and the
smallest of the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from harness.core import BENCH_DIR, Run, load_module  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(1, str(root))
    from drivers import common

    common.KEEP_PREDICTOR = True
    readings = {"program": [], "control": []}
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            run = Run(args.workload, seed, args.seconds, False, root)
            driver = load_module(BENCH_DIR / "drivers" / f"{run.traffic['driver']}.py",
                                 "driver_" + run.traffic["driver"])
            if kind == "program":
                driver.run(run)
            else:
                driver.control(run)
            line = {"kind": kind, "seed": seed,
                    "compared": {k: v for k, (v, _) in run.compared.items()},
                    "notes": run.notes, "e2e": run.e2e}
            readings[kind].append(line)
            print(json.dumps(line), flush=True)
    summary = {}
    for kind, agg in (("program", max), ("control", min)):
        names = {k for line in readings[kind] for k in line["compared"]}
        names |= {f"beside:{k}" for line in readings[kind]
                  for k in line["notes"].get("beside", {})}
        for k in sorted(names):
            vals = [line["compared"][k] if not k.startswith("beside:")
                    else line["notes"]["beside"][k[7:]] for line in readings[kind]]
            summary[f"{kind} {k}"] = agg(vals)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
