"""The port's load path against the JAX package's, and the port's three load
scripts (``scripts/torch_bench_serving.py``,
``scripts/torch_bench_serving_sustained.py``,
``scripts/torch_bench_streaming.py``) run on the CPU.

* The port's ``DetectionServer`` and the JAX package's each answer the same
  six seeded JPEG bodies (synthetic text scenes, two of them portrait, so
  both buckets run), sent at once, on the shipped weights in float32 at
  the 192x288 and 288x192 buckets, on both kernel routes: the default
  route and the served route (``NMS_FUSED False``, ``FUSED_STEM True``).
  Each response pairs with its JAX twin: counts equal, records paired
  one-to-one within 0.5 px (``__graft_entry__.py::_rows_match``).
* Each script runs as a subprocess with ``--device cpu`` and tiny buckets
  at tiny counts and prints its JSON line: no error, every request sent
  answered.
* With ``--trace`` each script's line carries the span totals of its timed
  phase, and the stage clock's stages where it times the program alone.
* Each script run with the default device where there is no CUDA exits
  non-zero and names CUDA.
* The test network runs its stride-16 convs one image at a time, so that
  an image's records do not depend on its slot in the batch (on the card,
  cuDNN's batched kernel summed the last slots in another order): shown
  against a stand-in conv whose sums depend on the slot.
"""

import io
import json
import os
import os.path as osp
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.inference.pipeline import CTPNPredictor as JaxPredictor
from ctpn_tpu.serving import DetectionServer as JaxServer
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.data.synth import render_image
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.serving import DetectionServer
from ctpn_tpu_torch.utils.weights import load_params
from tests.test_torch_pipeline import ARTIFACT, rows_match

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SMALL = {
    "TPU.COMPUTE_DTYPE": "float32",
    "TPU.BUCKETS": [[192, 288], [288, 192]],
    "TEXT.SCALE": 192, "TEXT.MAX_SCALE": 288,
    "TEST.SCALES": (192,), "TEST.MAX_SIZE": 288,
}
ROUTES = {
    "default": {"TPU.NMS_FUSED": True, "TPU.FUSED_STEM": False},
    "served": {"TPU.NMS_FUSED": False, "TPU.FUSED_STEM": True},
}
# the scripts' tiny cfg: f32, 64x96 and 96x64 buckets
TINY_SET = ["TPU.COMPUTE_DTYPE", "float32", "TPU.BUCKETS", "[[64,96],[96,64]]",
            "TEXT.SCALE", "64", "TEXT.MAX_SCALE", "96", "TEST.SCALES", "[64]",
            "TEST.MAX_SIZE", "96"]
SCRIPTS = {
    "serving": ("torch_bench_serving.py",
                ["--clients", "4", "--sustained", "6", "--max-batch", "2"],
                "serving_http_p50_ms"),
    "sustained": ("torch_bench_serving_sustained.py",
                  ["--clients", "3", "--seconds", "1", "--max-batch", "2", "--pool", "3"],
                  "serving_batcher_sustained_throughput"),
    "streaming": ("torch_bench_streaming.py",
                  ["--images", "6", "--batch", "2", "--workers", "2", "--latency"],
                  "ctpn_streaming_serving_throughput"),
}
KEYS = {
    "serving": {"metric", "value", "p95_ms", "p99_ms", "img_per_s", "burst", "sustained",
                "ok", "errors", "shed", "images_run", "program_runs", "route", "card"},
    "sustained": {"metric", "value", "unit", "jit_rate", "batcher_efficiency", "p50_ms",
                  "p99_ms", "ok", "errors", "shed", "batches", "img_per_batch", "clients",
                  "seconds", "program_runs", "route", "card"},
    "streaming": {"metric", "value", "unit", "vs_baseline", "baseline", "ok", "errors",
                  "program_runs", "route", "card"},
}


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _set_both(pairs):
    for c in (jcfg, tcfg):
        for key, value in pairs.items():
            section, name = key.split(".")
            c[section][name] = value


def _bodies(seed, n=6):
    """``n`` JPEG bodies of synthetic text scenes, every third a portrait."""
    rng = np.random.RandomState(seed)
    bodies = []
    for i in range(n):
        w, h = (288, 432) if i % 3 == 1 else (432, 288)
        buf = io.BytesIO()
        Image.fromarray(render_image(rng, width=w, height=h)[0]).save(buf, format="JPEG")
        bodies.append(buf.getvalue())
    return bodies


def _answers(server, bodies):
    """POST every body at once to ``server``; the (status, JSON) answers."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address
    out = [None] * len(bodies)

    def client(i):
        req = urllib.request.Request(f"http://{host}:{port}/detect", data=bodies[i],
                                     method="POST")
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                out[i] = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            out[i] = e.code, json.loads(e.read())

    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
            assert not c.is_alive()
    finally:
        server.shutdown()
        t.join(timeout=60)
        server.server_close()
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_server_answers_match_jax_server(route):
    _set_both(dict(SMALL, **ROUTES[route]))
    bodies = _bodies(31)
    want = _answers(JaxServer(JaxPredictor(jax_load_params(ARTIFACT), mode="H"),
                              max_batch=4, window_ms=100.0), bodies)
    pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), device="cpu")
    assert pred.model.trunk.fused_stem == ROUTES[route]["TPU.FUSED_STEM"]
    got = _answers(DetectionServer(pred, max_batch=4, window_ms=100.0), bodies)
    assert set(pred.buckets_run) == {(192, 288), (288, 192)}
    total = 0
    for (status, out), (jstatus, jout) in zip(got, want):
        assert status == jstatus == 200, (out, jout)
        assert out["image_shape"] == jout["image_shape"]
        assert out["count"] == jout["count"] == len(out["boxes"])
        rows_match(np.asarray(out["boxes"], np.float64).reshape(-1, 9),
                   np.asarray(jout["boxes"], np.float64).reshape(-1, 9), 0.5)
        total += out["count"]
    assert total > 0  # the comparison saw real detections


def _script(name, args, env=None):
    return subprocess.run(
        [sys.executable, osp.join(REPO, "scripts", name), *args],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", **(env or {})))


@pytest.mark.parametrize("which", sorted(SCRIPTS))
def test_script_runs_on_cpu(which):
    name, args, metric = SCRIPTS[which]
    extra = ["--artifact", ARTIFACT] if which == "streaming" else []
    proc = _script(name, [*args, *extra, "--device", "cpu", "--set", *TINY_SET])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    line = next(ln for ln in lines if ln["metric"] == metric)
    assert KEYS[which] <= set(line), KEYS[which] - set(line)
    assert line["errors"] == 0 and line["ok"] == line["sent"] > 0
    assert line["card"] == "cpu" and line["route"] == "default"
    if which == "serving":
        assert line["sent"] == 10 and line["shed"] == 0
        # the burst of 4 is coalesced; every program run is a warm-up or a batch
        assert line["burst"]["batches"] < 4
        assert line["program_runs"] == line["warm_runs"] + line["batches_run"]
    if which == "sustained":
        assert line["batches"] > 0 and line["jit_rate"] > 0
    if which == "streaming":
        assert line["sent"] == 6 and line["baseline"] == "TPU v5e per-chip target"
        latency = next(ln for ln in lines if ln["metric"] == "ctpn_single_image_latency_p50")
        assert latency["calls"] == 6 and {"p90_ms", "max_ms"} <= set(latency)


# spans each script's ``--trace`` line must carry
TRACED = {
    "serving": {"serve.decode", "serve.queue_wait", "serve.fetch", "serve.accept_wait",
                "predict.pad"},
    "sustained": {"serve.gather", "serve.dispatch", "serve.queue_wait", "serve.fetch",
                  "predict.pad"},
    "streaming": {"stream.prep", "stream.wait", "stream.fetch", "predict.pad"},
}


@pytest.mark.parametrize("which", sorted(SCRIPTS))
def test_script_traces_on_cpu(which):
    """``--trace``: the span totals of the timed phase, and, where the
    script times the replayed program alone, the stage clock's stages."""
    name, args, metric = SCRIPTS[which]
    extra = ["--artifact", ARTIFACT] if which == "streaming" else []
    proc = _script(name, [*args, *extra, "--device", "cpu", "--trace", "--set", *TINY_SET])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    line = next(ln for ln in lines if ln["metric"] == metric)
    assert TRACED[which] <= set(line["spans"]), TRACED[which] - set(line["spans"])
    if which != "serving":
        assert line["stage_ms"]["rows"] >= line["batches"] > 0
        assert line["stage_ms"]["forward"] > 0


@pytest.mark.parametrize("which", sorted(SCRIPTS))
def test_script_refuses_to_run_without_cuda(which):
    """The default device is the card: without one the script stops,
    naming CUDA, and never runs on the CPU unasked."""
    name, args, _metric = SCRIPTS[which]
    proc = _script(name, args, env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not any(ln.startswith("{") for ln in proc.stdout.splitlines())


# ---- an image's records do not depend on its slot in the padded batch


def _slot_dependent_conv(conv2d):
    """A stand-in for cuDNN's small-spatial conv at batch 8, whose
    reduction order depends on the output tile: each image's result moves
    by an amount that grows with its slot in the batch."""
    def conv(x, w, b=None, **kw):
        out = conv2d(x, w, b, **kw)
        slot = torch.arange(out.shape[0], dtype=out.dtype).reshape(-1, 1, 1, 1)
        return out + 1e-3 * slot
    return conv


@pytest.mark.parametrize("per_image", [False, True])
def test_per_image_conv_makes_records_slot_independent(monkeypatch, per_image):
    """``Conv3x3(per_image=True)`` runs one conv per image, so an image's
    output is the same in slot 1 and in slot 7 even where the batched conv
    sums each slot in another order (the stand-in); without it the stand-in
    shows the dependence the server's records had on the card."""
    from ctpn_tpu_torch.models import vgg

    conv = vgg.Conv3x3(8, 8, per_image=per_image)
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 8, 6, 9).astype(np.float32))
    swapped = x.clone()
    swapped[[1, 7]] = x[[7, 1]]
    monkeypatch.setattr(vgg.F, "conv2d", _slot_dependent_conv(vgg.F.conv2d))
    with torch.no_grad():
        a, b = conv(x)[1], conv(swapped)[7]
    assert torch.equal(a, b) == per_image


def test_per_image_tail_on_the_test_network():
    """The test network runs its four stride-16 convs (conv5_1-5_3 and
    ``rpn_conv``) per image, the training network none; per image or
    batched, the outputs agree to f32 rounding."""
    from ctpn_tpu_torch.models.ctpn import CTPN
    from ctpn_tpu_torch.models.factory import get_network
    from ctpn_tpu_torch.models.vgg import Conv3x3

    def per_image(model):
        return sorted(n for n, m in model.named_modules()
                      if isinstance(m, Conv3x3) and m.per_image)

    tail = ["rpn_conv", "trunk.conv5_1", "trunk.conv5_2", "trunk.conv5_3"]
    assert per_image(get_network("VGGnet_test", "cpu")) == tail
    assert per_image(get_network("VGGnet_train", "cpu")) == []
    stages = ((1, 1, 4), (2, 1, 8), (3, 1, 8), (4, 1, 8), (5, 2, 8))
    tiny = dict(trunk_stages=stages, lstm_hidden=4, rpn_channels=8, dtype=torch.float32)
    torch.manual_seed(0)
    batched = CTPN(**tiny)
    sliced = CTPN(per_image_tail=True, **tiny)
    sliced.load_state_dict(batched.state_dict())
    assert per_image(sliced) == ["rpn_conv", "trunk.conv5_1", "trunk.conv5_2"]
    x = torch.from_numpy(np.random.RandomState(1).randn(3, 64, 96, 3).astype(np.float32))
    with torch.no_grad():
        want, got = batched(x), sliced(x)
    torch.testing.assert_close(got.cls_prob, want.cls_prob, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(got.bbox_pred, want.bbox_pred, atol=1e-6, rtol=1e-5)
