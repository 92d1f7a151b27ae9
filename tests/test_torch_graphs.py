"""The detect program as a captured program (``inference/graphs.py``) and the
program's freedom from host syncs.

* ``detect_program`` (through ``CTPNPredictor.run_batch``, eager on the
  CPU) against the JAX package's jitted ``build_detect_fn`` at batch 2, in
  H and O mode, on the shipped weights in float32 and two seeded synthetic
  renders in the 192x288 bucket. Tolerances of
  ``tests/test_torch_parallel.py``: counts exact, rois within
  ``rtol=1e-5, atol=1e-4``, line records paired one-to-one within 0.5 px.
* No tensor is made from host data inside the program after a warm-up: a
  ``TorchDispatchMode`` spy counts ``aten.lift_fresh*`` (``torch.tensor``
  of host values) and host-to-device ``aten._to_copy``, and
  ``torch.from_numpy`` is counted too; all must be 0.
* ``DetectGraphs``' bookkeeping, with a fake capture backend on the CPU
  (a "capture" runs the program and keeps its outputs; a "replay" runs it
  again, counting nothing, and writes into those outputs, as a graph
  writes into its memory): one capture per key, results that a later
  replay cannot overwrite, launches per replay equal to those recorded at
  capture, tensors a kernel handed over kept with the graph, and a capture
  or replay error that propagates with no eager run in its place.
* With tracing off, a predictor's capture holds no stage-clock stamp and
  no span is recorded; with it on, every run of the program stamps a row
  (eager: one per call, answers unchanged) and each step of a call is a
  ``graphs.*`` span.
"""

import os.path as osp

import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.data.synth import render_image
from ctpn_tpu.inference.pipeline import CTPNPredictor as JaxPredictor
from ctpn_tpu.inference.pipeline import build_detect_fn as jax_build_detect
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import cfg, reset_cfg
from ctpn_tpu_torch.inference.graphs import DetectGraphs
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.ops import _launches
from ctpn_tpu_torch.parallel import shard_detect_fn
from ctpn_tpu_torch.utils.image import prep_image, resize_im
from ctpn_tpu_torch.utils.weights import load_params, params_to_jax
from tests.test_torch_train_step import BH, BW, TINY

torch.set_num_threads(2)

ARTIFACT = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                    "data", "artifacts", "ctpn_synth_f16.npz")
SMALL = {"TPU.COMPUTE_DTYPE": "float32", "TPU.BUCKETS": [[192, 288]],
         "TEXT.SCALE": 192, "TEXT.MAX_SCALE": 288,
         "TEST.SCALES": (192,), "TEST.MAX_SIZE": 288}


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _set_both(pairs):
    for c in (jcfg, cfg):
        for key, value in pairs.items():
            section, name = key.split(".")
            c[section][name] = value


def _render_batch(seed=11, n=2):
    """``n`` seeded renders, resized and padded as ``detect_image`` does."""
    rng = np.random.RandomState(seed)
    data, infos = [], []
    for _ in range(n):
        im = render_image(rng, width=432, height=288)[0][..., ::-1].copy()
        resized, _ = resize_im(im, cfg.TEXT.SCALE, cfg.TEXT.MAX_SCALE)
        d, info, _ = prep_image(resized)
        data.append(d)
        infos.append(info)
    return np.stack(data), np.stack(infos).astype(np.float32)


def _pair(a, b, atol):
    assert a.shape == b.shape, (a.shape, b.shape)
    used = np.zeros(len(b), bool)
    for row in a:
        d = np.abs(b - row[None]).max(axis=1)
        d[used] = np.inf
        j = int(d.argmin())
        assert d[j] <= atol, d[j]
        used[j] = True


@pytest.mark.parametrize("mode", ["H", "O"])
def test_detect_program_matches_jax_build_detect_fn(mode):
    _set_both(SMALL)
    images, infos = _render_batch()
    jp = JaxPredictor(jax_load_params(ARTIFACT), mode=mode)
    jprops, jlines = jax.jit(jax_build_detect(jp.model, mode=mode))(
        jp.params, images, infos)
    pred = CTPNPredictor(load_params(ARTIFACT, device="cpu"), mode=mode, device="cpu")
    props, lines = pred.run_batch(images, infos)
    np.testing.assert_array_equal(props.count.numpy(), np.asarray(jprops.count))
    np.testing.assert_array_equal(lines.count.numpy(), np.asarray(jlines.count))
    np.testing.assert_allclose(props.rois.numpy(), np.asarray(jprops.rois),
                               rtol=1e-5, atol=1e-4)
    recs, jrecs = lines.recs.numpy(), np.asarray(jlines.recs)
    for i, c in enumerate(lines.count.numpy()):
        _pair(recs[i, :c], jrecs[i, :c], 0.5)
    assert int(lines.count.sum()) > 0  # the comparison saw real lines


class HostDataSpy(TorchDispatchMode):
    """Counts the ops that make a tensor from host data: ``lift_fresh``
    (``torch.tensor`` of host values) and copies from the CPU to another
    device."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name.startswith("lift_fresh"):
            self.seen.append(name)
        elif name in ("_to_copy", "copy_"):
            src = args[1] if name == "copy_" else args[0]
            dst = kwargs.get("device") if name == "_to_copy" else args[0].device
            if src.device.type == "cpu" and dst is not None \
                    and torch.device(dst).type != "cpu":
                self.seen.append(name)
        return func(*args, **kwargs)


def _tiny_predictor(mode="H"):
    torch.manual_seed(0)
    model = CTPN(dtype=torch.float32, **TINY)
    params = params_to_jax(model.state_dict())
    return CTPNPredictor(params, model=CTPN(dtype=torch.float32, **TINY),
                         mode=mode, device="cpu")


def _toy_batch(n=2, bh=BH, bw=BW):
    rng = np.random.RandomState(3)
    images = rng.uniform(0, 60, (n, bh, bw, 3)).astype(np.uint8)
    for i in range(n):
        images[i, 12 + 4 * i:36 + 4 * i, 8:56] = 220
    return images, np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))


@pytest.mark.parametrize("mode", ["H", "O"])
def test_no_tensor_from_host_data_inside_the_program(mode, monkeypatch):
    pred = _tiny_predictor(mode)
    images, infos = _toy_batch()
    x, info = torch.from_numpy(images), torch.from_numpy(infos)
    pred.program(x, info)  # warm-up: the device constants are made here
    from_numpy = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: from_numpy.append(1) or real(a))
    with HostDataSpy() as spy:
        pred.program(x, info)
        assert spy.seen == [] and from_numpy == []
        torch.tensor([1.0])  # the spy sees what it looks for
    assert spy.seen == ["lift_fresh"]


class FakeKernel:
    """Stands in for a kernel's wrapper in the launch counts."""


class FakeBackend:
    """The CUDA graph machinery on the CPU: ``capture`` runs the program
    and keeps its outputs; ``replay`` runs it again with its launches not
    counted (a replay runs no Python) and writes into those outputs."""

    def __init__(self):
        self.captures = 0
        self.replays = 0
        self.fail = None

    def upload(self, static, x):
        static.copy_(x)

    def run(self, fn):
        return fn()

    def capture(self, fn):
        if self.fail:
            raise self.fail
        self.captures += 1
        return fn, fn()

    def replay(self, graph):
        if self.fail:
            raise self.fail
        self.replays += 1
        with _launches.recording():
            new = graph()
        for static, t in zip(tree_leaves(self.outputs_of[graph]), tree_leaves(new)):
            static.copy_(t)

    def finish(self, out):
        return out


def _fake_graphs(detect, variant=None):
    fake = FakeBackend()
    graphs = DetectGraphs(detect, torch.device("cpu"), variant=variant, backend=fake)
    fake.outputs_of = _OutputsOf(graphs)
    return graphs, fake


class _OutputsOf:
    """graph -> its static outputs, read from the wrapper."""

    def __init__(self, graphs):
        self.graphs = graphs

    def __getitem__(self, graph):
        return next(c.outputs for c in self.graphs.graphs.values() if c.graph is graph)


def _counting_detect(launches_per_call=2, held=None):
    _launches.init(FakeKernel)
    dev = torch.device("cuda", 0)  # the index the counts are kept under

    def detect(images, im_info):
        for _ in range(launches_per_call):
            _launches.count(FakeKernel, dev)
        if held is not None:
            _launches.hold(held)
        s = images.float().sum(dim=(1, 2, 3))
        return s * im_info[:, 0], im_info[:, 1] + 1.0
    return detect


def test_one_capture_per_key():
    variant = ["H"]
    graphs, fake = _fake_graphs(_counting_detect(), variant=lambda: variant[0])
    calls = [((2, 8, 8, 3), np.uint8), ((2, 8, 8, 3), np.uint8),
             ((1, 8, 8, 3), np.uint8), ((2, 8, 16, 3), np.uint8),
             ((2, 16, 8, 3), np.uint8), ((2, 8, 8, 3), np.float32),
             ((2, 8, 8, 3), np.uint8)]
    for shape, dtype in calls:
        graphs(np.ones(shape, dtype), np.ones((shape[0], 3), np.float32))
    variant[0] = "O"
    graphs(np.ones((2, 8, 8, 3), np.uint8), np.ones((2, 3), np.float32))
    assert fake.captures == len(graphs.graphs) == 6
    assert fake.replays == 2
    assert {k[1:4] for k in graphs.graphs} == {(2, 8, 8), (1, 8, 8), (2, 8, 16), (2, 16, 8)}


def test_results_held_at_once_are_not_aliased():
    graphs, _ = _fake_graphs(_counting_detect())
    info = np.ones((2, 3), np.float32)
    first = graphs(np.full((2, 4, 4, 3), 1, np.uint8), info)  # the warm-up's own
    second = graphs(np.full((2, 4, 4, 3), 2, np.uint8), info)  # replay
    third = graphs(np.full((2, 4, 4, 3), 3, np.uint8), info)  # replay
    assert first[0].tolist() == [48.0, 48.0]
    assert second[0].tolist() == [96.0, 96.0]
    assert third[0].tolist() == [144.0, 144.0]
    (entry,) = graphs.graphs.values()
    for out in (second, third):
        for t, static in zip(out, entry.outputs):
            assert t.data_ptr() != static.data_ptr()


def test_replays_add_the_launches_recorded_at_capture():
    graphs, fake = _fake_graphs(_counting_detect(launches_per_call=3))
    images, info = np.ones((2, 4, 4, 3), np.uint8), np.ones((2, 3), np.float32)
    graphs(images, info)  # warm-up run: 3 real launches; capture: recorded
    assert FakeKernel.LAUNCHES == 3
    (entry,) = graphs.graphs.values()
    assert dict(entry.launches) == {(FakeKernel, 0): 3}
    for k in range(1, 5):
        graphs(images, info)
        assert FakeKernel.LAUNCHES == 3 + 3 * k
    assert dict(FakeKernel.LAUNCHES_BY_DEVICE) == {0: 15}
    assert fake.replays == 4


def test_capture_keeps_the_tensors_a_kernel_hands_over():
    packed = torch.arange(4.0)
    graphs, _ = _fake_graphs(_counting_detect(held=packed))
    graphs(np.ones((1, 4, 4, 3), np.uint8), np.ones((1, 3), np.float32))
    (entry,) = graphs.graphs.values()
    assert len(entry.held) == 1 and entry.held[0] is packed
    with _launches.recording() as rec:
        pass
    _launches.hold(packed)  # outside a recording: kept nowhere
    assert rec.held == []


def test_capture_and_replay_errors_propagate():
    ran = []

    def detect(images, im_info):
        ran.append(1)
        return (images.float().sum(),)

    graphs, fake = _fake_graphs(detect)
    fake.fail = RuntimeError("operation not permitted when stream is capturing")
    images, info = np.ones((1, 4, 4, 3), np.uint8), np.ones((1, 3), np.float32)
    with pytest.raises(RuntimeError, match="capturing"):
        graphs(images, info)
    assert graphs.graphs == {} and len(ran) == 1  # the warm-up only
    fake.fail = None
    graphs(images, info)
    fake.fail = RuntimeError("replay failed")
    with pytest.raises(RuntimeError, match="replay failed"):
        graphs(images, info)
    assert len(ran) == 3  # two warm-ups and one capture: no eager run in its place


def test_predictor_replays_equal_eager_and_key_on_route():
    pred = _tiny_predictor()
    fake = FakeBackend()
    pred.graphs.backend = fake
    fake.outputs_of = _OutputsOf(pred.graphs)
    images, infos = _toy_batch()
    want = pred.program(torch.from_numpy(images), torch.from_numpy(infos))
    for _ in range(3):
        got = pred.run_batch(images, infos)
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w)
    assert (fake.captures, fake.replays) == (1, 2)
    cfg.TPU.NMS_FUSED = not cfg.TPU.NMS_FUSED
    pred.run_batch(images, infos)
    assert fake.captures == 2 and len(pred.graphs.graphs) == 2


class StampSpy(TorchDispatchMode):
    """Counts the stage clock's stamps (``ctpn_torch::stage_stamp``)."""

    def __init__(self):
        super().__init__()
        self.stamps = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "stage_stamp" in str(func):
            self.stamps += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("tracing", [False, True])
def test_predictor_stamps_and_spans_only_with_tracing(tracing):
    """Tracing off: a capture (fake backend) and its replays hold no stamp
    and no span is recorded. On: each run of the program (warm-up, the fake
    capture's run, each replay) stamps one row of four, and every step of a
    call is a span."""
    from ctpn_tpu_torch.utils import timer

    was = timer.enabled()
    timer.enable(tracing)
    timer.reset()
    try:
        pred = _tiny_predictor()
        assert (pred.clock is not None) == tracing
        fake = FakeBackend()
        pred.graphs.backend = fake
        fake.outputs_of = _OutputsOf(pred.graphs)
        images, infos = _toy_batch()
        with StampSpy() as spy:
            for _ in range(3):
                pred.run_batch(images, infos)
        assert (fake.captures, fake.replays) == (1, 2)
        runs = 1 + fake.captures + fake.replays
        assert spy.stamps == (4 * runs if tracing else 0)
        spans = timer.totals()
        if not tracing:
            assert spans == {}
        else:
            assert pred.clock.row() == runs
            assert {k: spans[f"graphs.{k}"]["n"] for k in
                    ("upload", "replay", "clone", "capture", "finish")} == {
                "upload": 3, "replay": 2, "clone": 2, "capture": 1, "finish": 3}
    finally:
        timer.enable(was)
        timer.reset()


def test_predictor_stamps_once_per_call():
    """Eager on the CPU: a predictor built with tracing on writes one row
    per call and answers as one built with it off."""
    from ctpn_tpu_torch.utils import timer

    was = timer.enabled()
    images, infos = _toy_batch()
    try:
        timer.enable(False)
        plain = _tiny_predictor()
        assert plain.clock is None
        want = plain.run_batch(images, infos)
        timer.enable(True)
        timer.reset()
        pred = _tiny_predictor()
        for k in range(1, 4):
            got = pred.run_batch(images, infos)
            assert pred.clock.row() == k
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(g, w)  # the stamps change no answer
        stages = pred.clock.read()
        assert stages["rows"] == 3 and stages["forward"] > 0
        assert "predict.pad" not in timer.totals()  # run_batch pads nothing
        pred.run_padded(list(images[:1]), list(infos[:1]), 2)
        assert timer.totals()["predict.pad"]["n"] == 1 and pred.clock.row() == 4
    finally:
        timer.enable(was)
        timer.reset()


def test_sharded_replicas_each_capture_their_own():
    pred = _tiny_predictor()
    detect = shard_detect_fn(lambda d: pred.program, ["cpu", "cpu"])
    try:
        fakes = []
        for rep in detect.replicas:
            fake = FakeBackend()
            rep.backend = fake
            fake.outputs_of = _OutputsOf(rep)
            fakes.append(fake)
        images, infos = _toy_batch(4)
        want = pred.program(torch.from_numpy(images), torch.from_numpy(infos))
        for _ in range(2):
            got = detect(images, infos)
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                if g.dtype in (torch.bool, torch.int32):
                    assert torch.equal(g, w)
                else:  # batch 2 per replica against batch 4
                    torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
        assert [(f.captures, f.replays) for f in fakes] == [(1, 1), (1, 1)]
        assert detect.replicas[0] is not detect.replicas[1]
    finally:
        detect.close()
