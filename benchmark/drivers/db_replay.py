"""Driver ``db_replay``: DBNet's captured detect program replayed on
batches already on the card (``craft_replay``'s loop, for DB's map and
boxes).

Set-up builds the predictor of the configuration (DBNet, ``NET_NAME``
``DB_RESNET50_DCN``), renders the scene pool, makes ``distinct_batches``
batches of ``batch`` variants at ``image`` (w, h), resizes them by DB's
rule into ``bucket`` (the reference's own ``prep``), uploads them, and
runs each once through ``predictor.graphs`` (the warm-up run and the
capture of the one shape). The window replays them in turn with
``in_flight`` batches queued, fetching each batch's box counts and boxes,
until the first fetch that ends after the window's close; ``imgs_per_s``
is the images of every fetch over the time from the window's start to the
end of that fetch. Every fetched answer must repeat the first answer of
its batch bit for bit (``repeat_mismatches``); no component may pass the
cap (``cap_overflow``). After the window a seeded sample of the images is
judged against the reference (``reference/db.py``): the probability map
that the timed graph produced, over each image's resized extent
(``map_gap``), and the boxes in the original image's pixels
(``harness/compare_quads.py``). The notes hold, per image of the distinct
batches, the pixels on, the components labelled and taken, the boxes kept
and the overflow. A traced run reads the stages' device time from the
stage clock of the captured program (``craft_replay.stage_ms``), and the
deformable sites', the labelling's and the box kernel's least times
(``flops_db``).
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from drivers import common
from drivers.craft_replay import LABEL_KERNELS, fetch, stage_ms
from harness import compare_quads
from harness.core import weights_path
from harness.trace import Tracer
from inputs import make


def padded_batches(run, pool_seed: int):
    from reference.db import prep

    t = run.traffic
    w, h = t["image"]
    n = t["batch"] * t["distinct_batches"]
    imgs = make.variants(pool_seed, t["scenes"], [(w, h)] * n, t["input_workers"])
    config = dict(run.config, buckets=[t["bucket"]])
    preps = [prep(make.bgr(im), config) for im in imgs]
    x = np.stack([p[0] for p in preps]).reshape(t["distinct_batches"], t["batch"],
                                                *preps[0][0].shape)
    info = np.stack([p[1] for p in preps]).reshape(t["distinct_batches"], t["batch"], 4)
    return x, info


def reference(r, quant=None):
    from reference.db import ReferenceDB

    return ReferenceDB(r.config, str(weights_path(r)), device=r.device, quant=quant)


def answers(text, recs, infos, n: int):
    """Host copies of the first ``n`` images' (map inside the extent, boxes)."""
    maps = text.maps.cpu().numpy()
    rr, rc = recs.recs.cpu().numpy(), recs.count.cpu().numpy()
    return [(maps[i, :int(infos[i][0]), :int(infos[i][1])], rr[i, :int(rc[i])])
            for i in range(n)]


def judge(r, prog, ref) -> None:
    """The compared numbers of the program's answers ``(map, boxes)``
    against the reference's, per image."""
    boxes = compare_quads.QuadTally(r.limits["box_iou"])
    gaps = []
    for (maps, recs), want in zip(prog, ref):
        gaps.append(float(np.abs(maps.astype(np.float64) - want["maps"]).mean()))
        recs = np.asarray(recs).reshape(-1, 9)
        boxes.add(recs[:, :8], want["recs"][:, :8], recs[:, 8], want["recs"][:, 8])
    numbers = {"map_gap": float(np.mean(gaps)) if gaps else 0.0,
               "boxes_unpaired_pct": boxes.unpaired_pct(),
               "box_gap_px": boxes.nearest_gap_px(),
               "box_score_gap": boxes.score_gap()}
    limits = r.limits["compare"]
    for name, value in numbers.items():
        if name in limits:
            r.compared[name] = (value, limits[name])
        else:
            r.notes.setdefault("beside", {})[name] = value
    r.notes["boxes"] = boxes.counts()


def run(r) -> None:
    t = r.traffic
    t0 = time.perf_counter()
    pred = common.predictor(r)
    if type(pred).__name__ != "DBPredictor":
        raise RuntimeError("the configuration did not build DBNet")
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
    per_image = {"on": [], "labelled": [], "taken": [], "kept": []}
    overflow = 0
    for text, recs in outs:
        per_image["on"] += text.on.cpu().tolist()
        per_image["labelled"] += text.labelled.cpu().tolist()
        per_image["taken"] += text.count.cpu().tolist()
        per_image["kept"] += recs.count.cpu().tolist()
        overflow += int(text.overflow.sum())
    r.notes["per_image"] = {k: {"mean": float(np.mean(v)), "max": int(max(v)),
                                "min": int(min(v))} for k, v in per_image.items()}
    r.notes["per_image"]["overflow"] = overflow
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
            text, recs = pred.graphs(xs[k % len(xs)], infos[k % len(xs)])
        if r.fault is not None:
            text, recs = r.fault(text, recs)
        queue.append((k % len(xs), text, recs))
        k += 1
        if len(queue) < t["in_flight"]:
            continue
        b, text, recs = queue.popleft()
        counts, rr = fetch(recs)
        last_t = time.perf_counter()
        images += len(counts)
        last[b] = (text, recs)
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
        prog += answers(*last[b], info_host[b], n_b) if b in last else [None] * n_b
    x0, i0 = xs[0], infos[0]
    del pred, xs, infos, last, queue, text, recs
    common.free_card(r)
    if r.trace and r.device == "cuda":
        r.readings["stage_ms_per_img"] = {k: v / n_b for k, v in stage_ms(r, x0, i0).items()}
    del x0, i0
    common.free_card(r)
    all_x, all_i = np.concatenate(list(x_host)), np.concatenate(list(info_host))
    ref = reference(r)
    judged = [i for i in picks if prog[i] is not None]
    r.failed += len(picks) - len(judged)
    res = ref.detect(all_x[judged], all_i[judged])
    judge(r, [prog[i] for i in judged], res)
    if r.trace:
        import flops_db

        h, w = (int(v) for v in all_i[0][:2])
        r.readings["flops_per_img"] = flops_db.model_flops(h, w, r.config["model"])
        r.readings["dcn_bound_ms_per_img"] = flops_db.dcn_bound_s(h, w, r.config["model"]) * 1e3
        r.readings.update(kernel_work(res, n_b))


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
    judge(r, [(a["maps"], a["recs"]) for a in low], ref)


def kernel_work(res, batch: int) -> dict:
    """Least time of one program run's labelling and boxes (``flops_db``),
    on the reference's own pixels and components averaged over the judged
    images, per batch."""
    import flops_db

    mean = {k: float(np.mean([a[k] for a in res])) * batch for k in ("taken", "box_pixels")}
    pixels = float(np.mean([a["maps"].shape[0] * a["maps"].shape[1] for a in res])) * batch
    return {"ccl_label": {"bound_s_per_run": flops_db.ccl_bound_s(pixels, mean["taken"]),
                          "launches_per_run": LABEL_KERNELS},
            "db_boxes": {"bound_s_per_run": flops_db.boxes_bound_s(mean["box_pixels"],
                                                                   mean["taken"]),
                         "launches_per_run": 1}}
