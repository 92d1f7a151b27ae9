"""Driver ``device_replay``: the captured detect program replayed on
batches already on the card.

Set-up renders the scene pool, makes ``distinct_batches`` batches of
``batch`` variants at ``image`` (w, h), pads them into ``bucket`` (the
reference's own resize and pad), uploads them, and runs each once through
``predictor.graphs`` (the warm-up run and the capture of the one shape).
The window replays them in turn with ``in_flight`` batches queued: after
queueing batch k it fetches batch k - in_flight + 1's line counts and
records, until the first fetch that ends after the window's close.
``imgs_per_s`` is the images of every fetch over the time from the
window's start to the end of that last fetch: all the work and all the
time of the window, and at most one batch past it. Every fetched answer is held against the first answer
of its batch, which it must repeat bit for bit (``repeat_mismatches``
counts the images that do not); after the window a sample of the images is
judged against the reference.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from drivers import common
from harness.trace import Tracer
from inputs import make
from reference import prep as ref_prep


def padded_batches(run, pool_seed: int):
    t = run.traffic
    w, h = t["image"]
    n = t["batch"] * t["distinct_batches"]
    imgs = make.variants(pool_seed, t["scenes"], [(w, h)] * n, t["input_workers"])
    config = dict(run.config, buckets=[t["bucket"]])
    preps = [ref_prep.prep(make.bgr(im), config) for im in imgs]
    x = np.stack([p[0] for p in preps]).reshape(t["distinct_batches"], t["batch"],
                                                *preps[0][0].shape)
    info = np.stack([p[1] for p in preps]).reshape(t["distinct_batches"], t["batch"], 3)
    return x, info


def fetch(lines):
    with torch.profiler.record_function("bench.fetch"):
        return lines.count.cpu().numpy(), lines.recs.cpu().numpy()


def run(r) -> None:
    t = r.traffic
    t0 = time.perf_counter()
    pred = common.predictor(r)
    x_host, info_host = padded_batches(r, r.seed)
    r.readings["setup_parts"]["inputs_s"] = time.perf_counter() - t0
    dev = pred.device
    xs = [torch.from_numpy(b).to(dev) for b in x_host]
    infos = [torch.from_numpy(i).to(dev) for i in info_host]
    t1 = time.perf_counter()
    first = []
    for k in range(len(xs)):
        for _ in range(2):  # the warm-up run and capture, then a replay
            out = pred.graphs(xs[k], infos[k])
        if r.fault is not None:
            out = r.fault(*out)
        first.append(fetch(out[1]))
    if r.device == "cuda":
        torch.cuda.synchronize()
    r.readings["setup_parts"]["warmup_capture_s"] = time.perf_counter() - t1

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
            props, lines = pred.graphs(xs[k % len(xs)], infos[k % len(xs)])
        if r.fault is not None:
            props, lines = r.fault(props, lines)
        queue.append((k % len(xs), props, lines))
        k += 1
        if len(queue) < t["in_flight"]:
            continue
        b, props, lines = queue.popleft()
        counts, recs = fetch(lines)
        last_t = time.perf_counter()
        images += len(counts)
        last[b] = (props, lines)
        if not (np.array_equal(counts, first[b][0]) and np.array_equal(recs, first[b][1])):
            wrong += int(np.sum(np.any(recs != first[b][1], axis=(1, 2))
                                | (counts != first[b][0])))
        if last_t > end:
            break
    if r.device == "cuda":
        torch.cuda.synchronize()
    r.attempted = images
    r.compared["repeat_mismatches"] = (wrong, 0)
    r.e2e["imgs_per_s"] = images / max(last_t - r.window_start, 1e-9)
    r.readings["imgs_per_s"] = r.e2e["imgs_per_s"]
    tracer.finish([dev.index or 0] if dev.type == "cuda" else [0])
    r.read_memory_peak()

    # the answers judged: a seeded sample of the distinct images
    n_b = t["batch"]
    picks = common.sample(r.seed, len(xs) * n_b, t["sample"])
    prog = []
    for b in range(len(xs)):
        prog += common.program_records(*last[b], n_b) if b in last else [None] * n_b
    if r.trace and r.device == "cuda":
        r.readings["stage_ms_per_img"] = {
            k: v / n_b for k, v in stage_ms(pred, xs[0], infos[0]).items()}
    del pred, xs, infos, last, queue, props, lines
    common.free_card(r)
    all_x, all_i = np.concatenate(list(x_host)), np.concatenate(list(info_host))
    ref = common.reference(r)
    judged = [i for i in picks if prog[i] is not None]
    r.failed += len(picks) - len(judged)
    common.judge_padded(r, [prog[i] for i in judged], ref.detect(all_x[judged], all_i[judged]))
    if r.trace:
        r.readings["flops_per_img"] = flops_of(r)
        r.readings["nms_fused"] = nms_work(r, ref.detect(all_x, all_i), n_b,
                                           x_host.shape[2:4])


def control(r, quant: str = "fp8") -> None:
    """The control in the program's place: the reference computed in
    ``quant`` on the cell's inputs and sample, judged as the program is."""
    x_host, info_host = padded_batches(r, r.seed)
    n = x_host.shape[0] * x_host.shape[1]
    picks = common.sample(r.seed, n, r.traffic["sample"])
    x = np.concatenate(list(x_host))[picks]
    info = np.concatenate(list(info_host))[picks]
    low = common.reference(r, quant=quant).detect(x, info)
    common.free_card(r)
    ref = common.reference(r).detect(x, info)
    common.judge_padded(r, [(a["props"], a["recs"]) for a in low], ref)


def flops_of(r) -> float:
    import flops

    w, h = r.traffic["image"]
    return flops.model_flops(h, w, r.config["model"])


def nms_work(r, res, batch: int, bucket) -> dict:
    """Least time of one program run's two fused-NMS launches (the
    proposal NMS over the top-n slots, the detector's over the kept
    slots), averaged over the distinct images, per batch."""
    import flops

    fh, fw = bucket[0] // 16, bucket[1] // 16
    slots = min(r.config["TEST"]["RPN_PRE_NMS_TOP_N"], fh * fw * r.config["model"]["num_anchors"])
    post = r.config["TEST"]["RPN_POST_NMS_TOP_N"]
    tests = np.mean([a["pair_tests"] for a in res]) * batch
    line_tests = np.mean([a["line_pair_tests"] for a in res]) * batch
    return {"bound_s_per_run": flops.nms_bound_s(batch * slots, int(tests))
            + flops.nms_bound_s(batch * post, int(line_tests)),
            "launches_per_run": 2}


def stage_ms(pred, x, info) -> dict:
    """Device ms of each stage of the eager program on one window batch,
    between CUDA events at its stage marks; a sleep queued first lets the
    host issue the whole program before the card starts it."""
    from ctpn_tpu_torch.inference.pipeline import build_detect_fn

    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    detect = build_detect_fn(pred.model, mode=pred.mode, on_stage=mark)
    detect(x, info)  # warm the eager program's kernels
    torch.cuda.synchronize()
    events.clear()
    torch.cuda._sleep(int(2e9))
    mark("start")
    _, lines = detect(x, info)
    lines.count.cpu()
    torch.cuda.synchronize()
    return {events[i + 1][0]: events[i][1].elapsed_time(events[i + 1][1])
            for i in range(len(events) - 1)}
