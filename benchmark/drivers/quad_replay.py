"""Driver ``quad_replay``: EAST's captured detect program replayed on
batches already on the card (``device_replay``'s loop, for quads).

Set-up builds the predictor of the configuration (EAST, ``NET_NAME``
``EAST_VGG16``), renders the scene pool, makes ``distinct_batches``
batches of ``batch`` variants at ``image`` (w, h), pads them into
``bucket`` (the reference's own resize and pad), uploads them, and runs
each once through ``predictor.graphs`` (the warm-up run and the capture of
the one shape). The window replays them in turn with ``in_flight``
batches queued, fetching each batch's record counts and records, until the
first fetch that ends after the window's close; ``imgs_per_s`` is the
images of every fetch over the time from the window's start to the end of
that fetch. Every fetched answer must repeat the first answer of its
batch bit for bit (``repeat_mismatches``); no quad may pass the caps
(``cap_overflow``). After the window a seeded sample of the images is
judged against the reference (``reference/east.py``): merged quads and
records (``harness/compare_quads.py``). The notes hold, per image of the
distinct batches, the cells over the score threshold, the merged quads and
the records.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from drivers import common
from drivers.device_replay import padded_batches
from harness import compare_quads
from harness.core import weights_path
from harness.trace import Tracer


def fetch(recs):
    with torch.profiler.record_function("bench.fetch"):
        return recs.count.cpu().numpy(), recs.recs.cpu().numpy()


def reference(r, quant=None):
    from reference.east import ReferenceEAST

    return ReferenceEAST(r.config, str(weights_path(r)), device=r.device, quant=quant)


def answers(quads, recs, n: int):
    """Host copies of the first ``n`` images' (merged quads, records)."""
    rois, qc = quads.rois.cpu().numpy(), quads.count.cpu().numpy()
    rr, rc = recs.recs.cpu().numpy(), recs.count.cpu().numpy()
    return [(rois[i, :int(qc[i])], rr[i, :int(rc[i])]) for i in range(n)]


def judge(r, prog, ref) -> None:
    """The compared numbers of the program's answers against the
    reference's, per image ``(merged, records)``."""
    merged, recs = compare_quads.tally(
        [(p, (a["merged"], a["recs"])) for p, a in zip(prog, ref)], r.limits["quad_iou"])
    numbers = {"merged_unpaired_pct": merged.unpaired_pct(),
               "quads_unpaired_pct": recs.unpaired_pct(),
               "quad_score_gap": recs.score_gap(),
               "quad_gap_px": recs.nearest_gap_px()}
    limits = r.limits["compare"]
    for name, value in numbers.items():
        if name in limits:
            r.compared[name] = (value, limits[name])
        else:
            r.notes.setdefault("beside", {})[name] = value
    r.notes["merged"] = merged.counts()
    r.notes["records"] = recs.counts()


def run(r) -> None:
    t = r.traffic
    t0 = time.perf_counter()
    pred = common.predictor(r)
    if type(pred).__name__ != "EASTPredictor":
        raise RuntimeError("the configuration did not build EAST")
    x_host, info_host = padded_batches(r, r.seed)
    r.readings["setup_parts"]["inputs_s"] = time.perf_counter() - t0
    dev = pred.device
    xs = [torch.from_numpy(b).to(dev) for b in x_host]
    infos = [torch.from_numpy(i).to(dev) for i in info_host]
    t1 = time.perf_counter()
    first, outs = [], []
    for k in range(len(xs)):
        for _ in range(2):  # the warm-up run and capture, then a replay
            out = pred.graphs(xs[k], infos[k])
        if r.fault is not None:
            out = r.fault(*out)
        first.append(fetch(out[1]))
        outs.append(out)
    if r.device == "cuda":
        torch.cuda.synchronize()
    r.readings["setup_parts"]["warmup_capture_s"] = time.perf_counter() - t1
    per_image = {"cells": [], "merged": [], "records": []}
    overflow = 0
    for quads, recs in outs:
        per_image["cells"] += quads.cells.cpu().tolist()
        per_image["merged"] += quads.count.cpu().tolist()
        per_image["records"] += recs.count.cpu().tolist()
        overflow += int(quads.overflow.sum()) + int(recs.overflow.sum())
    r.notes["per_image"] = {k: {"mean": float(np.mean(v)), "max": int(max(v)),
                                "min": int(min(v))} for k, v in per_image.items()}
    del outs

    tracer = Tracer(r)
    tracer.prime()
    queue: deque = deque()
    last = {}
    images = wrong = 0
    k = 0
    r.start_window()
    end = r.window_end()
    while True:
        tracer.tick()
        with torch.profiler.record_function("bench.replay"):
            quads, recs = pred.graphs(xs[k % len(xs)], infos[k % len(xs)])
        if r.fault is not None:
            quads, recs = r.fault(quads, recs)
        queue.append((k % len(xs), quads, recs))
        k += 1
        if len(queue) < t["in_flight"]:
            continue
        b, quads, recs = queue.popleft()
        counts, rr = fetch(recs)
        last_t = time.perf_counter()
        images += len(counts)
        last[b] = (quads, recs)
        if not (np.array_equal(counts, first[b][0]) and np.array_equal(rr, first[b][1])):
            wrong += int(np.sum(np.any(rr != first[b][1], axis=(1, 2))
                                | (counts != first[b][0])))
        if last_t > end:
            break
    if r.device == "cuda":
        torch.cuda.synchronize()
    r.attempted = images
    r.compared["repeat_mismatches"] = (wrong, 0)
    r.compared["cap_overflow"] = (overflow, 0)
    r.e2e["imgs_per_s"] = images / max(last_t - r.window_start, 1e-9)
    r.readings["imgs_per_s"] = r.e2e["imgs_per_s"]
    tracer.finish([dev.index or 0] if dev.type == "cuda" else [0])
    r.read_memory_peak()

    n_b = t["batch"]
    picks = common.sample(r.seed, len(xs) * n_b, t["sample"])
    prog = []
    for b in range(len(xs)):
        prog += answers(*last[b], n_b) if b in last else [None] * n_b
    if r.trace and r.device == "cuda":
        r.readings["stage_ms_per_img"] = {
            k: v / n_b for k, v in stage_ms(pred, xs[0], infos[0]).items()}
    del pred, xs, infos, last, queue, quads, recs
    common.free_card(r)
    all_x, all_i = np.concatenate(list(x_host)), np.concatenate(list(info_host))
    ref = reference(r)
    judged = [i for i in picks if prog[i] is not None]
    r.failed += len(picks) - len(judged)
    res = ref.detect(all_x[judged], all_i[judged])
    judge(r, [prog[i] for i in judged], res)
    if r.trace:
        import flops_east

        w, h = t["image"]
        r.readings["flops_per_img"] = flops_east.model_flops(h, w, r.config["model"])
        r.readings.update(kernel_work(r, res, n_b))


def control(r, quant: str = "fp8") -> None:
    """The control in the program's place: the reference computed in
    ``quant`` on the cell's inputs and sample, judged as the program is."""
    x_host, info_host = padded_batches(r, r.seed)
    n = x_host.shape[0] * x_host.shape[1]
    picks = common.sample(r.seed, n, r.traffic["sample"])
    x = np.concatenate(list(x_host))[picks]
    info = np.concatenate(list(info_host))[picks]
    low = reference(r, quant=quant).detect(x, info)
    common.free_card(r)
    ref = reference(r).detect(x, info)
    judge(r, [(a["merged"], a["recs"]) for a in low], ref)


def kernel_work(r, res, batch: int) -> dict:
    """Least time of one program run's walk and quad bitmask
    (``flops_east``), on the reference's own cells, merged quads and IoU
    tests averaged over the judged images, per batch."""
    import flops_east

    mean = {k: float(np.mean([a[k] for a in res])) * batch
            for k in ("cells", "walk_tests", "nms_tests")}
    merged = float(np.mean([len(a["merged"]) for a in res])) * batch
    words = float(np.mean([flops_east.mask_words(len(a["merged"])) for a in res])) * batch
    return {"lanms_walk": {"bound_s_per_run": flops_east.lanms_bound_s(
                int(mean["cells"]), int(merged), int(mean["walk_tests"])),
                "launches_per_run": 1},
            "quad_bitmask": {"bound_s_per_run": flops_east.quad_bitmask_bound_s(
                words, merged, mean["nms_tests"]),
                "launches_per_run": 1}}


def stage_ms(pred, x, info) -> dict:
    """Device ms of each stage of the eager EAST program on one window
    batch, between CUDA events at its stage marks; a sleep queued first
    lets the host issue the whole program before the card starts it."""
    from ctpn_tpu_torch.inference.pipeline import build_east_detect_fn

    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    detect = build_east_detect_fn(pred.model, on_stage=mark)
    detect(x, info)  # warm the eager program's kernels
    torch.cuda.synchronize()
    events.clear()
    torch.cuda._sleep(int(2e9))
    mark("start")
    _, recs = detect(x, info)
    recs.count.cpu()
    torch.cuda.synchronize()
    return {events[i + 1][0]: events[i][1].elapsed_time(events[i + 1][1])
            for i in range(len(events) - 1)}
