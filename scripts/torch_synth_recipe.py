"""The round-5c fine-tune recipe (``docs/TRAINING.md``) through the PyTorch
port on one card, scored on the synthetic holdout before and after.

    python3 scripts/torch_synth_recipe.py [--root output/torch_ft5d] \
        [--out output/torch_ft5d_report] [--iters 1500]

Steps, each timed on the host clock:

1. ``train_synth.prepare_corpus``: 800 + 32 seeded synthetic images, strip
   labels, the VOC tree (the corpus-preparation seconds);
2. ``python -m ctpn_tpu_torch.cli.eval_holdout`` on the shipped artifact
   (the report before);
3. ``python -m ctpn_tpu_torch.cli.train_synth --images 800 --holdout 32
   --iters 1500 --batch 8 --lr 2e-5 --stepsize 1000 --init-artifact
   data/artifacts/ctpn_synth_f16.npz`` (the recipe as written; it reuses
   step 1's corpus), which trains, exports and scores;
4. ``eval_holdout`` on its export (the report after).

Writes ``metrics.jsonl``, each step's output and ``summary.json`` into
``--out``, and prints the summary: the card's name and power limit, ms per
step at batch 8 (steps 21 to the end, from the solver's running means),
the windowed model loss beside the JAX run's
(``docs/runs/synth_ft5d_1500_edgeclip_metrics.jsonl``) and the geometric and
connector reports at IoU 0.5 before and after.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
JAX_RUN = REPO / "docs" / "runs" / "synth_ft5d_1500_edgeclip_metrics.jsonl"
IMAGES, HOLDOUT = 800, 32


def run(args: list, log: Path) -> str:
    """``python -m <args>`` from the repo root; its output goes to ``log``."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=str(REPO),
                          capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"{args[0]} failed (exit {proc.returncode}); see {log}")
    return proc.stdout


def report(out: str) -> dict:
    lines = out.splitlines()
    i = lines.index("{")
    return json.loads("\n".join(lines[i:lines.index("}", i) + 1]))


def windows(rows: list, total: int, n: int = 10) -> list:
    """Mean model loss over ``n`` equal step windows of ``[0, total]``."""
    edges = np.linspace(0, total + 1, n + 1).astype(int)
    return [float(np.mean([r["model_loss"] for r in rows if lo <= r["step"] < hi]
                          or [np.nan])) for lo, hi in zip(edges, edges[1:])]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="output/torch_ft5d")
    p.add_argument("--out", default="output/torch_ft5d_report")
    p.add_argument("--iters", type=int, default=1500)
    args = p.parse_args(argv)
    root, out = Path(args.root).resolve(), Path(args.out).resolve()
    shutil.rmtree(root, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(REPO))
    from ctpn_tpu_torch.cli.train_synth import prepare_corpus

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    common = ["--root", str(root), "--images", str(IMAGES), "--holdout", str(HOLDOUT)]
    seconds = {}
    t0 = time.perf_counter()
    prepare_corpus(str(root), IMAGES, HOLDOUT)
    seconds["prepare"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    before = report(run(["ctpn_tpu_torch.cli.eval_holdout", "--artifact", str(ARTIFACT)]
                        + common, out / "eval_before.log"))
    seconds["eval_before"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run(["ctpn_tpu_torch.cli.train_synth", *common, "--iters", str(args.iters),
         "--batch", "8", "--lr", "2e-5", "--stepsize", "1000",
         "--init-artifact", str(ARTIFACT)], out / "train_synth.log")
    seconds["train_synth"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    after = report(run(["ctpn_tpu_torch.cli.eval_holdout", "--artifact",
                        str(root / "artifact.npz")] + common, out / "eval_after.log"))
    seconds["eval_after"] = time.perf_counter() - t0

    shutil.copy(root / "output" / "metrics.jsonl", out / "metrics.jsonl")
    rows = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    jax_rows = [json.loads(ln) for ln in JAX_RUN.read_text().splitlines()]
    by_step = {r["step"]: r["sec_per_iter"] for r in rows}
    last = rows[-1]["step"]
    # sec_per_iter is the running mean since the run began
    steady_ms = 1e3 * (last * by_step[last] - 20 * by_step[20]) / (last - 20)
    summary = {
        "card": card,
        "seconds": seconds,
        "ms_per_step_batch8_steps_21_on": steady_ms,
        "model_loss_windows": windows(rows, last),
        "jax_model_loss_windows": windows(jax_rows, jax_rows[-1]["step"]),
        "model_loss_first5_mean": float(np.mean([r["model_loss"] for r in rows[:5]])),
        "model_loss_last10_mean": float(np.mean([r["model_loss"] for r in rows[-10:]])),
        "model_loss_range": [min(r["model_loss"] for r in rows),
                             max(r["model_loss"] for r in rows)],
        "num_fg_mean": float(np.mean([r["num_fg"] for r in rows])),
        "finite": bool(np.isfinite([r["total_loss"] for r in rows]).all()),
        "logged_lines": len(rows),
        "checkpoint_mib": (root / "output" / "checkpoints" / str(last) / "state.pt")
        .stat().st_size / 2**20,
        "before": before,
        "after": after,
    }
    (out / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
