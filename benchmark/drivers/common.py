"""What the drivers share: the predictor from the configuration, the
window's loop helpers, and the comparison of answers with the reference."""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from harness import compare
from harness.core import Run, apply_program_config, weights_path


# calibrate.py keeps one predictor for all its seeds (one process)
KEEP_PREDICTOR = False
_kept: Dict[str, object] = {}


def predictor(run: Run, device=None):
    """The port's ``CTPNPredictor`` of the configuration on ``device``."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.utils.weights import load_params

    apply_program_config(run.config)
    dev = device or run.device
    key = f"{run.config['name']}@{dev}"
    if KEEP_PREDICTOR and key in _kept:
        run.readings.setdefault("setup_parts", {})["weights_s"] = 0.0
        return _kept[key]
    t0 = time.perf_counter()
    params = load_params(str(weights_path(run)), device=dev)
    pred = CTPNPredictor(params, device=dev)
    run.readings.setdefault("setup_parts", {})["weights_s"] = time.perf_counter() - t0
    if KEEP_PREDICTOR:
        _kept[key] = pred
    return pred


def reference(run: Run, quant=None):
    from reference import Reference

    return Reference(run.config, str(weights_path(run)), device=run.device, quant=quant)


def sample(rng_seed: int, n_total: int, n: int) -> List[int]:
    """``n`` of ``range(n_total)`` drawn from the seed, sorted."""
    from inputs.make import seed_words

    rng = np.random.RandomState(seed_words(rng_seed, 9))
    return sorted(rng.choice(n_total, size=min(n, n_total), replace=False).tolist())


def judge_padded(run: Run, prog: Sequence[Tuple[np.ndarray, np.ndarray]],
                 ref: Sequence[Dict[str, np.ndarray]]) -> None:
    """Numbers of answers in the bucket's pixels: per image the program's
    (proposals (M, 5), records (L, 9)) against the reference's."""
    min_score = run.config["TEXT"]["TEXT_PROPOSALS_MIN_SCORE"]
    props = compare.tally_props([(p, r["props"]) for (p, _), r in zip(prog, ref)],
                                run.limits["proposal_iou"], min_score)
    lines = compare.tally_lines([(p, r["recs"]) for (_, p), r in zip(prog, ref)],
                                run.limits["line_iou"])
    _report(run, {"proposals_unpaired_pct": props.unpaired_pct(),
                  "proposal_score_gap": props.score_gap(),
                  "proposal_edge_gap_px": props.edge_gap_px()}, lines)
    run.notes["proposals"] = props.counts()


def _report(run: Run, numbers: Dict[str, float], lines: compare.Tally) -> None:
    """The numbers that the cell's limits file names are compared; the
    others are printed beside them."""
    numbers.update(lines_unpaired_pct=lines.unpaired_pct(),
                   line_score_gap=lines.score_gap(),
                   line_edge_gap_px=lines.edge_gap_px(),
                   line_gap_px=lines.nearest_gap_px())
    run.notes["lines"] = lines.counts()
    limits = run.limits["compare"]
    for name, value in numbers.items():
        if name in limits:
            run.compared[name] = (value, limits[name])
        else:
            run.notes.setdefault("beside", {})[name] = value


def program_records(props, lines, n: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Host copies of the first ``n`` images' proposals and records."""
    rois = props.rois.cpu().numpy()
    pc = props.count.cpu().numpy()
    recs = lines.recs.cpu().numpy()
    lc = lines.count.cpu().numpy()
    return [(rois[i, :int(pc[i])], recs[i, :int(lc[i])]) for i in range(n)]


def free_card(run: Run) -> None:
    """Return the program's freed memory to the card before the reference
    runs (the peak was read already)."""
    import gc

    import torch

    gc.collect()
    if run.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
