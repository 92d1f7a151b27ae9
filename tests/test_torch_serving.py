"""The port's HTTP server: ``ctpn_tpu_torch.serving`` driven as
tests/test_serving.py drives the JAX package's.

A real ``DetectionServer`` on an ephemeral port, with a CPU predictor on
the shipped weights at the tiny 64x96 bucket and both kernel routes of this
slice selected (``TPU.NMS_FUSED = False``, ``TPU.FUSED_STEM = True``; on the
CPU they run their plain versions). Concurrent clients must be coalesced
into fewer padded batches than requests. The batcher's own cases use fake
predictors, as in the JAX package's tests. The CLI case starts
``python -m ctpn_tpu_torch.cli.serve --device cpu`` as a subprocess, with
and without ``--trace`` (the span totals under ``/healthz``'s "spans").
"""

import contextlib
import io
import json
import os
import os.path as osp
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ARTIFACT = osp.join(REPO, "data", "artifacts", "ctpn_synth_f16.npz")
TINY = {
    "TEXT.SCALE": 64, "TEXT.MAX_SCALE": 96, "TPU.BUCKETS": [[64, 96]],
    "TEST.RPN_PRE_NMS_TOP_N": 256, "TEST.RPN_POST_NMS_TOP_N": 64,
    "TPU.NMS_FUSED": False, "TPU.FUSED_STEM": True,
}


@pytest.fixture(autouse=True)
def tiny_cfg():
    reset_cfg()
    for key, value in TINY.items():
        section, name = key.split(".")
        tcfg[section][name] = value
    yield
    reset_cfg()


@pytest.fixture
def server():
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.serving import DetectionServer
    from ctpn_tpu_torch.utils.weights import load_params

    pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), device="cpu")
    assert pred.model.trunk.fused_stem
    srv = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=4,
                          window_ms=250.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def _url(srv, path):
    host, port = srv.server_address
    return f"http://{host}:{port}{path}"


def _jpeg_bytes(rng):
    arr = rng.randint(0, 255, (60, 90, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=180) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        out = json.loads(r.read())
    assert r.status == 200
    assert out["status"] == "ok"
    assert out["mode"] == "H"
    assert out["device"] == "cpu"
    assert out["buckets_compiled"] == []
    assert "spans" not in out  # tracing is off by default


@pytest.fixture
def traced_server():
    """The ``server`` fixture's server, built with tracing on."""
    from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
    from ctpn_tpu_torch.serving import DetectionServer
    from ctpn_tpu_torch.utils import timer
    from ctpn_tpu_torch.utils.weights import load_params

    was = timer.enabled()
    timer.enable(True)
    timer.reset()
    srv = None
    try:
        pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), device="cpu")
        srv = DetectionServer(pred, host="127.0.0.1", port=0, max_batch=4,
                              window_ms=50.0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield srv
    finally:
        if srv is not None:
            srv.shutdown()
            t.join(timeout=60)
            srv.server_close()
        timer.enable(was)
        timer.reset()


def test_healthz_reports_spans_when_tracing(traced_server, rng):
    status, out = _post(_url(traced_server, "/detect"), _jpeg_bytes(rng))
    assert status == 200 and out["count"] == len(out["boxes"])
    with urllib.request.urlopen(_url(traced_server, "/healthz"), timeout=30) as r:
        spans = json.loads(r.read())["spans"]
    for name in ("serve.decode", "serve.queue_wait", "serve.fetch", "serve.gather",
                 "serve.dispatch", "serve.unscale", "predict.pad"):
        assert spans[name]["n"] >= 1, name
        assert 0 <= spans[name]["max_s"] <= spans[name]["s"]
    # the POST's connection and the GET's: the second's thread may start
    # after its wait is read
    assert spans["serve.accept_wait"]["n"] >= 1
    assert spans["serve.decode"]["n"] == spans["serve.queue_wait"]["n"] == 1
    assert traced_server.predictor.clock.row() == 1  # one program run


def test_concurrent_requests_coalesce(server, rng):
    from ctpn_tpu_torch.ops import nms

    bodies = [_jpeg_bytes(rng) for _ in range(4)]
    results = [None] * 4
    sweeps = nms.nms_fixed_point_blocked.SWEEPS

    def client(i):
        results[i] = _post(_url(server, "/detect"), bodies[i])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for status, out in results:
        assert status == 200
        assert out["image_shape"] == [60, 90]
        assert isinstance(out["boxes"], list)
        assert out["count"] == len(out["boxes"])
        for rec in out["boxes"]:
            assert len(rec) == 9 and np.isfinite(rec).all()
    # the 4 simultaneous requests fit in fewer batches than requests
    # (window 250 ms, max_batch 4)
    assert server.batcher.images_run == 4
    assert server.batcher.batches_run < 4
    assert server.predictor.buckets_run == {(64, 96): None}
    # the bitmask route resolved each batch (two NMS calls per batch)
    assert nms.nms_fixed_point_blocked.SWEEPS - sweeps >= 2 * server.batcher.batches_run


def test_microbatcher_leftovers_seed_next_round():
    """Other-bucket items must lead the NEXT round, not requeue behind new
    arrivals (minority-bucket starvation)."""
    from ctpn_tpu_torch.serving import MicroBatcher, _Pending

    mb = MicroBatcher.__new__(MicroBatcher)  # no thread start
    MicroBatcher.__init__(mb, predictor=None, max_batch=4, window_ms=1.0)

    def item(shape):
        return _Pending(np.zeros(shape + (3,), np.uint8),
                        np.zeros(3, np.float32), 1.0, shape)

    a1, b1, a2 = item((64, 96)), item((96, 64)), item((64, 96))
    for it in (a1, b1, a2):
        mb.submit(it)
    first = mb._gather()
    assert [id(x) for x in first] == [id(a1), id(a2)]
    assert mb._leftover == [b1]
    for _ in range(8):
        mb.submit(item((64, 96)))
    second = mb._gather()
    assert second[0] is b1
    mb.stop()


def test_microbatcher_sheds_expired_requests():
    from ctpn_tpu_torch.serving import MicroBatcher, _Pending

    class FakePredictor:
        calls = []

        def run_padded(self, images, infos, batch_size):
            self.calls.append(len(images))
            raise AssertionError("must not run for all-expired batch")

    mb = MicroBatcher.__new__(MicroBatcher)
    MicroBatcher.__init__(mb, predictor=FakePredictor(), max_batch=4,
                          window_ms=1.0)
    dead = _Pending(np.zeros((4, 4, 3), np.uint8), np.zeros(3, np.float32),
                    1.0, (4, 4), deadline=0.0)  # long expired
    mb._dispatch([dead])
    assert dead.event.is_set()
    assert isinstance(dead.error, TimeoutError)
    assert mb.shed == 1 and FakePredictor.calls == []
    mb.stop()


def test_dispatch_overlaps_result_fetch():
    """The dispatcher must queue batch k+1 while batch k's results are
    still being fetched (completer thread); the completer fetches tensors
    with ``.cpu()``."""
    from ctpn_tpu_torch.serving import MicroBatcher, _Pending

    release = threading.Event()

    class BlockingCount:
        """``.cpu()`` on this blocks until the test releases it."""

        def cpu(self):
            assert release.wait(timeout=60)
            return torch.ones(4, dtype=torch.int32)

    class Lines:
        def __init__(self, blocking):
            self.count = BlockingCount() if blocking else torch.ones(4, dtype=torch.int32)
            self.recs = torch.full((4, 8, 9), 2.0)

    class FakePredictor:
        calls = []

        def run_padded(self, images, infos, batch_size):
            self.calls.append(len(images))
            # the first batch's results "execute" slowly; later ones are ready
            return None, Lines(blocking=len(self.calls) == 1)

    mb = MicroBatcher(predictor=FakePredictor(), max_batch=2, window_ms=5.0)
    mb.start()

    def item():
        return _Pending(np.zeros((8, 8, 3), np.uint8),
                        np.ones(3, np.float32), 1.0, (8, 8))

    first = [item(), item()]
    for it in first:
        mb.submit(it)
    # the completer now blocks fetching batch 1; batch 2 must still dispatch
    second = [item(), item()]
    for it in second:
        mb.submit(it)
    deadline = time.monotonic() + 30
    while len(FakePredictor.calls) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(FakePredictor.calls) == 2, "second batch did not dispatch"
    assert not first[0].event.is_set()  # batch 1 results still in flight

    release.set()
    for it in first + second:
        assert it.event.wait(timeout=30)
        assert it.error is None
        assert it.result.shape == (1, 9)  # count=1 row, unscaled
    assert mb.batches_run == 2 and mb.images_run == 4
    mb.stop()
    mb.join(timeout=30)
    mb._completer.join(timeout=30)
    assert not mb._completer.is_alive()  # the sentinel trailed the batches


def test_bad_content_length_header(server):
    import http.client

    host, port = server.server_address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.putrequest("POST", "/detect")
    conn.putheader("Content-Length", "abc")
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 400
    assert b"Content-Length" in resp.read()
    conn.close()


def test_oversized_body_rejected_without_read(server):
    """A huge Content-Length must be refused up front (413), not buffered."""
    import http.client

    from ctpn_tpu_torch.serving import MAX_BODY_BYTES

    host, port = server.server_address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.putrequest("POST", "/detect")
    conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
    conn.endheaders()  # headers only: the body never follows
    resp = conn.getresponse()
    assert resp.status == 413
    assert b"exceeds" in resp.read()
    conn.close()


def test_oversized_body_rejected_even_on_mode_mismatch(server):
    """The size cap precedes the mode-mismatch drain."""
    import http.client

    from ctpn_tpu_torch.serving import MAX_BODY_BYTES

    host, port = server.server_address
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.putrequest("POST", "/detect?mode=O")
    conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413
    conn.close()


def test_bad_requests(server):
    status, out = _post(_url(server, "/detect"), b"not an image")
    assert status == 400 and "error" in out
    status, out = _post(_url(server, "/detect?mode=X"), b"x")
    assert status == 400
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert ei.value.code == 404


def test_serve_refuses_frozen_artifact(tmp_path, rng, monkeypatch):
    """``serve`` refuses the JAX package's frozen artifact (StableHLO, with
    a pointer to ``ctpn-torch-export --frozen``) and serves the port's: a
    ``FrozenPredictor`` warmed on its max-batch program answers a POST."""
    from ctpn_tpu_torch import serving
    from ctpn_tpu_torch.inference.frozen import FrozenPredictor, export_frozen
    from ctpn_tpu_torch.utils.weights import load_params

    jax_frozen = tmp_path / "jax_frozen.npz"
    meta = json.dumps({"format": "ctpn-frozen-v1", "platforms": ["cpu"]})
    np.savez(jax_frozen, __meta__=np.frombuffer(meta.encode(), np.uint8))
    assert serving.is_frozen(str(jax_frozen)) and not serving.is_frozen(ARTIFACT)
    with pytest.raises(ValueError, match="ctpn-torch-export --frozen"):
        serving.serve(str(jax_frozen), device="cpu", verbose=False)

    port_frozen = export_frozen(load_params(ARTIFACT, device="cpu"),
                                str(tmp_path / "frozen.npz"),
                                shapes=[(2, 64, 96)], device="cpu")
    seen = {}

    class OnePost(serving.DetectionServer):
        """Serves one POST on a thread, then returns: ``serve`` shuts down."""

        def serve_forever(self):
            t = threading.Thread(target=super(OnePost, self).serve_forever, daemon=True)
            t.start()
            seen["predictor"] = self.predictor
            seen["warm"] = dict(self.predictor.buckets_run)
            seen["post"] = _post(_url(self, "/detect"), _jpeg_bytes(rng))

    monkeypatch.setattr(serving, "DetectionServer", OnePost)
    serving.serve(port_frozen, port=0, max_batch=2, device="cpu", verbose=False)
    assert isinstance(seen["predictor"], FrozenPredictor)
    assert seen["warm"] == {(64, 96): None}  # the batch-2 program ran at warm-up
    status, out = seen["post"]
    assert status == 200 and out["count"] == len(out["boxes"])
    with pytest.raises(ValueError, match="mode"):
        serving.serve(port_frozen, mode="O", device="cpu", verbose=False)


@contextlib.contextmanager
def _cli_server(*extra):
    """``python -m ctpn_tpu_torch.cli.serve`` on the CPU with ``--set``
    overrides and ``extra`` arguments; yields the port read from its
    "listening" line, and stops it."""
    sets = []
    for key, value in TINY.items():
        sets += [key, json.dumps(value) if isinstance(value, list) else str(value)]
    proc = subprocess.Popen(
        [sys.executable, "-m", "ctpn_tpu_torch.cli.serve", "--artifact",
         ARTIFACT, "--port", "0", "--no-warmup", "--device", "cpu",
         "--max-batch", "2", *extra, "--set", *sets],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"),
    )
    try:
        port = None
        for line in proc.stdout:
            if "listening on" in line:
                port = int(line.split("listening on ")[1].split()[0].rsplit(":", 1)[1])
                break
        assert port, "the server printed no listening line"
        yield port
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def _health(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        return json.loads(r.read())


def test_cli_serves_on_cpu(rng):
    """``python -m ctpn_tpu_torch.cli.serve`` with ``--set`` overrides:
    read the port from the "listening" line, POST one image, stop."""
    with _cli_server() as port:
        status, out = _post(f"http://127.0.0.1:{port}/detect", _jpeg_bytes(rng))
        assert status == 200 and out["count"] == len(out["boxes"])
        health = _health(port)
        assert health["buckets_compiled"] == [[64, 96]]
        assert health["batches_run"] == 1
        assert "spans" not in health


def test_cli_trace_reports_spans(rng):
    """``ctpn-torch-serve --trace``: after one request ``/healthz`` has the
    serving path's spans."""
    with _cli_server("--trace") as port:
        status, _ = _post(f"http://127.0.0.1:{port}/detect", _jpeg_bytes(rng))
        assert status == 200
        spans = _health(port)["spans"]
        assert {"serve.decode", "serve.queue_wait", "serve.fetch"} <= set(spans)
        assert spans["serve.fetch"]["n"] == 1
