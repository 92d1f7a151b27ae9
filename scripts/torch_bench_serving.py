#!/usr/bin/env python3
"""Serving load test of the PyTorch port: concurrent HTTP clients against
the micro-batcher (the port of ``scripts/bench_serving.py``).

Drives an in-process ``ctpn_tpu_torch.serving.DetectionServer`` (the
shipped weights, one CUDA card) with a burst and a sustained mixed-bucket
phase, a fresh JPEG per request, then prints latency percentiles, wall
throughput and the batcher's counters.

Landscape (600x900) and portrait (900x600) requests land in different
padded buckets, so the sustained phase runs the pipelined dispatch: the
completer thread fetches batch k-1 while the card runs batch k and the
dispatcher gathers batch k+1 (``ctpn_tpu_torch/serving.py``). Both buckets
are warmed (run and captured) at ``--max-batch`` before timing.

    python3 scripts/torch_bench_serving.py [--clients 64] [--sustained 96] \
        [--max-batch 8] [--sustained-clients 16] \
        [--artifact data/artifacts/ctpn_synth_f16.npz] \
        [--device cuda] [--set TPU.NMS_FUSED False TPU.FUSED_STEM True] [--trace]

Every response must be 200 with ``count == len(boxes)`` and finite records;
any other answer is an error. Prints one line per phase (ok, errors, wall
s, p50/p95/p99 ms, batches, images per batch, img/s), then ``shed`` and
``images_run``, and last one JSON line ``{"metric": "serving_http_p50_ms",
...}``: the sustained phase's p50, p95, p99 and img/s, both phases in full,
the host ms per request of a JPEG encode and of the handler's decode,
resize and pad on one thread (``host_ms_per_request``),
``program_runs`` (every ``run_batch`` of the process, the warm-up included:
the kernels' launches are counted per program run), the kernel route and
the card's name and power limit as ``nvidia-smi`` prints them. Exits 1
when a request failed or was shed. ``--device cpu`` runs the port's plain
kernel versions (tests, with tiny buckets through ``--set``).

``--trace`` turns the port's tracing on (``utils/timer.py``) before the
predictor is built: the last line then also carries ``spans``, what the
server's ``GET /healthz`` reports under ``"spans"`` after the sustained
phase (whose totals alone it holds: they are reset after the burst).
Each phase's ``max_ms`` is its longest request.
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
ARTIFACT = REPO / "data" / "artifacts" / "ctpn_synth_f16.npz"
LANDSCAPE, PORTRAIT = (600, 900), (900, 600)


def fresh_jpeg(rng, shape=LANDSCAPE) -> bytes:
    arr = rng.randint(0, 255, shape + (3,), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def post(url: str, body: bytes) -> tuple:
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def check_response(status: int, out: dict) -> np.ndarray:
    """The records of a good answer; raises on any other."""
    if status != 200:
        raise RuntimeError(f"HTTP {status}: {out}")
    recs = np.asarray(out["boxes"], np.float64).reshape(-1, 9)
    if out["count"] != len(recs) or not np.isfinite(recs).all():
        raise RuntimeError(f"bad records: count {out['count']}, {len(recs)} rows")
    return recs


def route_name(cfg) -> str:
    fused, stem = bool(cfg.TPU.NMS_FUSED), bool(cfg.TPU.FUSED_STEM)
    return {(True, False): "default", (False, True): "served"}.get(
        (fused, stem), f"NMS_FUSED {fused}, FUSED_STEM {stem}")


def count_runs(predictor) -> list:
    """Count ``predictor.run_batch`` calls (``run_padded``, ``warmup`` and
    ``detect_image`` go through it) in the returned one-element list."""
    runs = [0]
    run_batch = predictor.run_batch

    def counted(images, im_info):
        runs[0] += 1
        return run_batch(images, im_info)

    predictor.run_batch = counted
    return runs


def percentiles_ms(lat) -> dict:
    if not len(lat):
        return {"p50_ms": None, "p95_ms": None, "p99_ms": None}
    p50, p95, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 95, 99])
    return {"p50_ms": float(p50), "p95_ms": float(p95), "p99_ms": float(p99)}


def host_costs(n: int = 8) -> dict:
    """Host ms per request, one thread, no card: the load generator's JPEG
    encode and the handler's decode, resize and pad (``serving.py``)."""
    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.serving import _decode_image
    from ctpn_tpu_torch.utils.image import prep_image, resize_im

    rng = np.random.RandomState(1)
    t0 = time.perf_counter()
    bodies = [fresh_jpeg(rng) for _ in range(n)]
    t1 = time.perf_counter()
    for body in bodies:
        prep_image(resize_im(_decode_image(body), cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)[0])
    t2 = time.perf_counter()
    return {"client_jpeg_encode": (t1 - t0) / n * 1e3, "handler_prep": (t2 - t1) / n * 1e3,
            "body_kib": sum(map(len, bodies)) / n / 1024}


def run_phase(url: str, n_clients: int, n_requests: int, rng, mixed: bool) -> tuple:
    """``n_requests`` POSTs from ``n_clients`` closed-loop clients, one in
    three a portrait when ``mixed``; returns (latencies s, wall s, errors)."""
    lat, errors = [], []
    lock = threading.Lock()
    idx = iter(range(n_requests))

    def worker(seed):
        local = np.random.RandomState(seed)
        while True:
            with lock:
                i = next(idx, None)
            if i is None:
                return
            body = fresh_jpeg(local, PORTRAIT if mixed and i % 3 == 0 else LANDSCAPE)
            t0 = time.perf_counter()
            try:
                check_response(*post(url, body))
            except Exception as e:  # noqa: BLE001 - every failure is counted
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=worker, args=(int(rng.randint(1 << 31)),))
               for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lat, time.perf_counter() - t0, errors


def health(detect_url: str) -> dict:
    """The server's ``GET /healthz`` answer."""
    url = detect_url.rsplit("/", 1)[0] + "/healthz"
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_summary(lat, wall: float, errors: list, batches: int, n: int) -> dict:
    return {"ok": len(lat), "errors": len(errors), "wall_s": wall,
            **percentiles_ms(lat),
            "max_ms": float(np.max(lat) * 1e3) if len(lat) else None,
            "batches": batches,
            "img_per_batch": n / max(batches, 1), "img_per_s": len(lat) / wall}


def print_phase(name: str, s: dict) -> None:
    def ms(v):
        return "n/a" if v is None else f"{v:.0f}ms"

    print(f"  {name}: ok={s['ok']} err={s['errors']} wall={s['wall_s']:.1f}s "
          f"p50={ms(s['p50_ms'])} p95={ms(s['p95_ms'])} p99={ms(s['p99_ms'])} "
          f"batches={s['batches']} ({s['img_per_batch']:.1f} img/batch) "
          f"thru={s['img_per_s']:.1f} img/s", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--clients", type=int, default=64)
    p.add_argument("--sustained", type=int, default=96)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--artifact", default=str(ARTIFACT))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' plain versions)")
    p.add_argument("--sustained-clients", type=int, default=16,
                   help="closed-loop clients of the sustained phase")
    p.add_argument("--set", dest="set_cfg", nargs="*", default=[],
                   help="cfg key/value overrides, e.g. the served kernel route")
    p.add_argument("--trace", action="store_true",
                   help="trace the server: /healthz's span totals of the sustained phase")
    args = p.parse_args(argv)

    from ctpn_tpu_torch.config import cfg, cfg_from_list
    from ctpn_tpu_torch.utils import timer
    from ctpn_tpu_torch.utils.device import resolve_device

    cfg_from_list(args.set_cfg)
    timer.enable(args.trace)
    dev = resolve_device(args.device)

    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.parallel.multicard import card_line
    from ctpn_tpu_torch.serving import DetectionServer
    from ctpn_tpu_torch.utils.image import pick_bucket, resize_factor
    from ctpn_tpu_torch.utils.weights import load_params

    card = card_line() if dev.type == "cuda" else "cpu"
    predictor = CTPNPredictor(load_params(args.artifact, device=dev), device=dev)
    runs = count_runs(predictor)
    srv = DetectionServer(predictor, host="127.0.0.1", port=0,
                          max_batch=args.max_batch, window_ms=5.0)
    serve_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    serve_thread.start()
    host, port = srv.server_address
    url = f"http://{host}:{port}/detect"

    # warm the buckets the requests land in, at the serving batch size
    for h, w in (LANDSCAPE, PORTRAIT):
        f = resize_factor(h, w, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
        bucket = pick_bucket(int(round(h * f)), int(round(w * f)))
        print(f"warming bucket {bucket}...", flush=True)
        predictor.warmup(bucket, batch=args.max_batch)
    warm_runs = runs[0]

    host = host_costs()
    print("host ms per request, one thread: " + json.dumps(host), flush=True)
    rng = np.random.RandomState(0)
    try:
        print(f"burst: {args.clients} simultaneous clients, one request each", flush=True)
        lat, wall, errs = run_phase(url, args.clients, args.clients, rng, mixed=False)
        b0 = srv.batcher.batches_run
        burst = phase_summary(lat, wall, errs, b0, args.clients)
        print_phase("burst", burst)

        print(f"sustained mixed-bucket: {args.sustained_clients} clients x "
              f"{args.sustained} requests (1/3 portrait)", flush=True)
        timer.reset()
        lat, wall, errs2 = run_phase(url, args.sustained_clients, args.sustained, rng,
                                     mixed=True)
        sustained = phase_summary(lat, wall, errs2, srv.batcher.batches_run - b0,
                                  args.sustained)
        print_phase("sustained", sustained)
        traced = {"spans": health(url)["spans"]} if args.trace else {}
    finally:
        srv.shutdown()
        srv.batcher.join(timeout=60)
        serve_thread.join(timeout=60)
        srv.server_close()
    batcher = srv.batcher
    print(f"shed={batcher.shed} images_run={batcher.images_run}", flush=True)
    errors = errs + errs2
    if errors:
        print("errors:", errors[:5], file=sys.stderr)
    print(json.dumps({
        "metric": "serving_http_p50_ms", "value": sustained["p50_ms"], "unit": "ms",
        "p95_ms": sustained["p95_ms"], "p99_ms": sustained["p99_ms"],
        "img_per_s": sustained["img_per_s"],
        "burst": burst, "sustained": sustained,
        "sent": args.clients + args.sustained,
        "ok": burst["ok"] + sustained["ok"], "errors": len(errors),
        "shed": batcher.shed, "images_run": batcher.images_run,
        "batches_run": batcher.batches_run, "warm_runs": warm_runs,
        "host_ms_per_request": host,
        "program_runs": runs[0], "max_batch": args.max_batch,
        "route": route_name(cfg), "device": str(dev), "card": card, **traced,
    }), flush=True)
    return 1 if errors or batcher.shed else 0


if __name__ == "__main__":
    sys.exit(main())
