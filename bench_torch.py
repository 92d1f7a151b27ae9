"""Benchmark of the PyTorch port: end-to-end CTPN inference throughput on
one CUDA card (the port's counterpart of ``bench.py``).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "images/sec", "vs_baseline": R, ...}

Times what ``bench.py`` times, ``jax.jit(build_detect_fn(model, mode="H"))``
called on arrays already on the device: the detect program of
``CTPNPredictor`` (mean-subtract -> VGG16 bf16 -> BiLSTM -> heads ->
proposal decode with NMS -> text connector), captured once as a CUDA graph
and replayed (``ctpn_tpu_torch/inference/graphs.py``), on a batch uploaded
to the card before the clock starts, at the bucket a 600x900 image lands in
(608x912 under the default ``TPU.BUCKETS``), mode H. One warm-up call (the
eager run and the capture) and a fetch; then ``BENCH_ITERS`` replays with
the host clock around them, ended by a fetch of the last batch's line
counts and ``torch.cuda.synchronize()``. The kernels are built before the
warm-up; the build, the weight load and the warm-up with its capture are
set-up, printed on the ``#`` line, outside the timed window.

Two rows, as in ``bench.py``: random weights (``init_params(0)``, the
port's own seeded draw: flax's PRNGKey(0) draw needs JAX) on a noise
batch, then the shipped weights (``data/artifacts/ctpn_synth_f16.npz``) on
the real batch (``_real_batch``); ``BENCH_CONTENT`` picks the headline.
Each row's last replayed batch must give the records of a separate eager
run of the program on the same device tensors (line counts exact, records
paired one-to-one within 0.5 px), or the run fails: no value is printed
for a program whose records are wrong.

Environment, ``bench.py``'s hooks: ``BENCH_BATCH`` (48 on the card, 2 on
the CPU), ``BENCH_ITERS`` (14, 2), ``BENCH_CONTENT`` (``real`` or
``noise``), ``BENCH_CFG_SET`` (space-separated KEY VALUE pairs for the
port's cfg; ``"TPU.NMS_FUSED False TPU.FUSED_STEM True"`` is the served
route), ``BENCH_RETRIES`` (3), ``BENCH_BACKOFF_S`` (30),
``BENCH_CHILD_TIMEOUT_S`` (1800); and, in place of ``BENCH_PLATFORM``,
``BENCH_DEVICE``: ``cuda`` (the default) or ``cpu`` (the kernels' plain
versions, for tests). Without a card the default fails; it never times the
CPU in its place.

    python3 bench_torch.py
    BENCH_CFG_SET="TPU.NMS_FUSED False TPU.FUSED_STEM True" python3 bench_torch.py
    BENCH_DEVICE=cpu BENCH_BATCH=2 BENCH_ITERS=1 python3 bench_torch.py

Besides ``bench.py``'s keys the line carries ``device`` (the card's name,
or ``"cpu"``), ``power_limit_w`` (``nvidia-smi``; null on the CPU),
``cards`` (the cards the timed program ran on: 1), ``route``
(``TPU.NMS_FUSED``, ``TPU.FUSED_STEM``), ``batch``, ``iters`` and
``attempts`` (the child runs the supervisor made). The ``# bench_torch``
line on stderr is one JSON object: per row the set-up seconds, the graph
pool's MiB, the kernels' launches per replayed batch and the records'
worst pairing.

Supervision, as in ``bench.py``: the measurement runs in a fresh child
process per attempt; the supervisor relays the child's line with
``attempts`` added, and on persistent failure prints one parseable line
with ``value: null``, the error's salient lines and ``attempts``, and
exits 0.

Imports numpy, torch and ``ctpn_tpu_torch`` only: nothing of JAX, of the
JAX package or of ``bench.py``.
"""

import json
import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np

ROOT = osp.dirname(osp.abspath(__file__))
ARTIFACT = osp.join(ROOT, "data", "artifacts", "ctpn_synth_f16.npz")
METRIC = "ctpn_e2e_inference_throughput_600x900"
# BASELINE.json's target is a TPU figure: 1000 images/sec on a v5e-8, that
# is 125 per TPU chip; vs_baseline divides the value per card by it
TARGET_PER_CHIP = 1000.0 / 8.0
RECORDS_ATOL = 0.5
REPORT = "# bench_torch "


def _real_batch(batch: int, bh: int, bw: int):
    """(batch, bh, bw, 3) uint8 real-content images + per-image im_info:
    seeded synthetic scene-text renders (``data/synth.py``, seed 11,
    900x600, RGB to BGR) in every slot, the bytes of ``bench.py``'s
    ``_real_batch`` where its reference demo photographs are absent. The
    photographs are not part of this repository, so the port reads none.
    """
    from ctpn_tpu_torch.data.synth import render_image
    from ctpn_tpu_torch.utils.image import prep_image

    rng = np.random.RandomState(11)
    images, infos = [], []
    for _ in range(batch):
        arr, _ = render_image(rng, width=900, height=600)
        data, info, _pad = prep_image(arr[..., ::-1], bucket=(bh, bw))  # RGB -> BGR
        images.append(data)
        infos.append(info)
    return np.stack(images), np.stack(infos)


def _artifact_fingerprint() -> str:
    """Short content hash of the shipped artifact (``bench.py``'s), so that
    a swap of the weights behind the headline shows in the line."""
    import hashlib

    h = hashlib.sha256()
    with open(ARTIFACT, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return f"ctpn_synth_f16.npz:{h.hexdigest()[:12]}"


def _noise_batch(batch: int, bh: int, bw: int):
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (batch, bh, bw, 3)).astype(np.uint8)
    infos = np.tile(np.array([600, 900, 1.0], np.float32), (batch, 1))
    return images, infos


def _check_records(got, want) -> float:
    """The records gate: ``got`` (the replayed program's ``TextLines``)
    against ``want`` (the eager program's) with line counts exact and
    records paired within ``RECORDS_ATOL`` px; returns the worst pairing,
    raises ``RuntimeError`` otherwise."""
    from ctpn_tpu_torch.parallel.multicard import pair_rows

    counts, want_counts = got.count.cpu().numpy(), want.count.cpu().numpy()
    if not np.array_equal(counts, want_counts):
        raise RuntimeError(f"records gate: line counts {counts.tolist()} replayed, "
                           f"{want_counts.tolist()} eager")
    recs, want_recs = got.recs.cpu().numpy(), want.recs.cpu().numpy()
    worst = max([pair_rows(recs[i, :c], want_recs[i, :c])
                 for i, c in enumerate(counts)], default=0.0)
    if not worst <= RECORDS_ATOL:  # a NaN fails too
        raise RuntimeError(f"records gate: a replayed record is {worst} px from the "
                           f"eager program's (limit {RECORDS_ATOL})")
    return worst


def _time_detect(predictor, images, infos, iters):
    """Seconds of ``iters`` calls of ``predictor``'s captured program
    (``predictor.graphs``: replays on the card, the eager program on the
    CPU) on ``images``, ``infos`` uploaded to its device beforehand, the
    last call's ``TextLines``, and the row's report: the warm-up seconds
    (the eager run and the capture, with a fetch), the kernels' launches
    per timed call and the records gate's worst pairing."""
    import torch

    from ctpn_tpu_torch.ops import _kernel, _launches

    dev = predictor.device
    x, info = torch.from_numpy(images).to(dev), torch.from_numpy(infos).to(dev)
    t0 = time.perf_counter()
    _, lines = predictor.graphs(x, info)
    lines.count.cpu()
    warmup_s = time.perf_counter() - t0
    wrappers = _kernel.wrappers()
    _launches.init(*wrappers.values())
    t0 = time.perf_counter()
    for _ in range(iters):
        _, lines = predictor.graphs(x, info)
    lines.count.cpu()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    launches = {name: w.LAUNCHES / iters for name, w in wrappers.items() if w.LAUNCHES}
    _, eager = predictor.program(x, info)
    worst = _check_records(lines, eager)
    return seconds, lines, {"warmup_s": warmup_s, "launches_per_batch": launches,
                            "records_worst_px": worst}


def _power_limit_w(device):
    """The card's power limit in W (``nvidia-smi``), None off the card."""
    import torch

    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = visible.split(",")[index].strip() if visible else str(index)
    out = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return float(out.split()[0])


def main():
    import torch

    from ctpn_tpu_torch.config import cfg, cfg_from_list
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.models.factory import init_params
    from ctpn_tpu_torch.utils.device import resolve_device
    from ctpn_tpu_torch.utils.image import pick_bucket
    from ctpn_tpu_torch.utils.weights import load_params

    device = resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))
    if device.type not in ("cuda", "cpu"):
        sys.exit(f"BENCH_DEVICE must be 'cuda' or 'cpu', got {device}")
    on_card = device.type == "cuda"

    # A/B hook: space-separated KEY VALUE pairs applied to the global cfg
    # (e.g. BENCH_CFG_SET="TPU.NMS_FUSED False TPU.FUSED_STEM True", the
    # served route)
    sets = os.environ.get("BENCH_CFG_SET")
    if sets:
        cfg_from_list(sets.split())

    bh, bw = pick_bucket(600, 900)
    # batch 48 and 14 iterations: the work bench.py times on its accelerator
    batch = int(os.environ.get("BENCH_BATCH", "48" if on_card else "2"))
    iters = int(os.environ.get("BENCH_ITERS", "14" if on_card else "2"))
    content = os.environ.get("BENCH_CONTENT", "real")
    if content not in ("real", "noise"):
        sys.exit(f"BENCH_CONTENT must be 'real' or 'noise', got {content!r}")
    if content == "real" and not osp.exists(ARTIFACT):
        content = "noise"

    report = {"device": torch.cuda.get_device_name(device) if on_card else "cpu",
              "bucket": [bh, bw], "batch": batch, "iters": iters, "content": content,
              "build_s": None, "rows": {}}
    if on_card:
        from ctpn_tpu_torch.ops import _build, _kernel

        t0 = time.perf_counter()
        _build.build(_kernel.sources())
        report["build_s"] = time.perf_counter() - t0

    rows = [("noise", lambda: init_params(0), _noise_batch)]
    if content == "real":
        rows.append(("real", lambda: load_params(ARTIFACT, device=device), _real_batch))
    results = {}
    for name, params, make_batch in rows:
        images, infos = make_batch(batch, bh, bw)
        t0 = time.perf_counter()
        predictor = CTPNPredictor(params(), mode="H", device=device)
        load_s = time.perf_counter() - t0
        seconds, _, row = _time_detect(predictor, images, infos, iters)
        results[name] = batch * iters / seconds
        row.update(imgs_per_sec=results[name], ms_per_batch=seconds / iters * 1e3,
                   load_s=load_s, pool_mib=predictor.graphs.pool_mib())
        report["rows"][name] = row
        del predictor  # its graph and pool, before the next row's
        if on_card:
            torch.cuda.empty_cache()

    imgs_per_sec = results[content]
    cards = 1  # the program and its inputs live on one device
    line = {
        "metric": METRIC,
        "value": round(imgs_per_sec, 2),
        "unit": "images/sec",
        "vs_baseline": round(imgs_per_sec / cards / TARGET_PER_CHIP, 4),
        "content": content,
    }
    if content == "real":
        line["noise_imgs_per_sec"] = round(results["noise"], 2)
        line["artifact"] = _artifact_fingerprint()
    line.update(device=report["device"], power_limit_w=_power_limit_w(device), cards=cards,
                route={"TPU.NMS_FUSED": bool(cfg.TPU.NMS_FUSED),
                       "TPU.FUSED_STEM": bool(cfg.TPU.FUSED_STEM)},
                batch=batch, iters=iters)
    print(json.dumps(line))
    print(REPORT + json.dumps(report), file=sys.stderr)


def _salient(text: str) -> str:
    """The lines of a failed child's output that look like error text (an
    out-of-memory message sits mid-trace; a CUDA or nvcc message may name
    no exception), its last six, joined."""
    tail = text.strip().splitlines()
    salient = [ln for ln in tail if any(
        k in ln for k in ("Error", "ERROR", "error:", "INTERNAL", "RESOURCE",
                          "Ran out of memory", "CUDA", "nvcc"))]
    pick = (salient or tail)[-6:]
    return " | ".join(pick)


def _supervise() -> int:
    """Run the measurement in a child process with bounded retries.

    A fresh process per attempt starts the card's context anew. Success =
    the child printed a JSON object line with a "metric" key; that line is
    relayed with ``attempts`` added. After the retries are exhausted (or
    the child hangs past the per-attempt timeout, when it is killed),
    print one JSON line with value null, the error and ``attempts``, and
    exit 0, so that a caller always parses something.
    """
    attempts = max(1, int(os.environ.get("BENCH_RETRIES", "3")))
    backoff = float(os.environ.get("BENCH_BACKOFF_S", "30"))
    child_timeout = float(os.environ.get("BENCH_CHILD_TIMEOUT_S", "1800"))
    env = dict(os.environ, CTPN_BENCH_CHILD="1")
    last_err = "no attempts ran"
    for attempt in range(attempts):
        if attempt:
            print(f"# bench attempt {attempt} failed; retrying in {backoff:.0f}s:"
                  f" {last_err[-300:]}", file=sys.stderr)
            time.sleep(backoff)
        try:
            proc = subprocess.run([sys.executable, osp.abspath(__file__)],
                                  capture_output=True, text=True, env=env,
                                  timeout=child_timeout)
        except subprocess.TimeoutExpired:
            last_err = f"child timed out after {child_timeout:.0f}s"
            continue
        if proc.stderr:
            sys.stderr.write(proc.stderr)
        for line in reversed(proc.stdout.strip().splitlines()):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and "metric" in obj:
                obj["attempts"] = attempt + 1
                print(json.dumps(obj))
                return 0
        last_err = (_salient(proc.stderr or proc.stdout or "")
                    or f"rc={proc.returncode}, no output")
    print(json.dumps({
        "metric": METRIC,
        "value": None,
        "unit": "images/sec",
        "vs_baseline": None,
        "error": last_err[-600:],
        "attempts": attempts,
    }))
    return 0


if __name__ == "__main__":
    if os.environ.get("CTPN_BENCH_CHILD") == "1":
        main()
    else:
        sys.exit(_supervise())
