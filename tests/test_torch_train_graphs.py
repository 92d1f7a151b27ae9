"""The train step as a captured program (``training/graphs.py``) and the
split of the step into a host part and a device part
(``training/train_step.py``), on the CPU at the tiny widths of
``tests/test_torch_train_step.py``.

* The device part, given the host part's scalars and the JAX package's
  draws, against ``jax.jit(build_train_step(...))`` over three steps of
  Adam, RMS and Momentum, with ``test_torch_train_step.py``'s tolerances
  (metrics 2e-5 relative, Adam's after the first step 1e-3; parameters
  1e-6, Adam's 1e-5 where the gradient exceeds 1e-7 and 2 * lr per step
  below it).
* The device part reads no host value: run with step 5's scalars while
  the host's counters say step 0, it gives step 5's update, bit for bit;
  so a step captured at step 0 and replayed at step 5 takes step 5's
  learning rate and bias correction.
* A step updates every parameter, gradient buffer and moment in place
  (same object, same ``data_ptr``, new values).
* No tensor is made from host data inside the device part (the spy of
  ``tests/test_torch_graphs.py``).
* ``TrainGraphs``' bookkeeping with a fake capture backend (a "capture"
  runs the program with its launches recorded and then rolls the state
  back, since a real capture executes nothing; a "replay" runs it again,
  counting nothing, and writes into the captured outputs): one capture
  per key, a warm-up that answers the first call and advances the step
  once, metrics that a later replay cannot overwrite, launches added per
  replay, errors that propagate with no eager step in place of a replay,
  eleven eager steps before a DDP model is captured, ``restore()`` after a
  capture, and ``SolverWrapper`` logging the eager step's metrics through
  the wrapper.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.models.ctpn import CTPN as JCTPN
from ctpn_tpu.training.train_step import Batch as JBatch
from ctpn_tpu.training.train_step import build_train_step as jax_build
from ctpn_tpu.training.train_step import create_train_state as jax_state
from ctpn_tpu_torch.config import cfg, cfg_from_list, reset_cfg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.ops import _launches
from ctpn_tpu_torch.training import solver as solver_mod
from ctpn_tpu_torch.training.graphs import DDP_WARMUP_STEPS, TrainGraphs
from ctpn_tpu_torch.training.solver import SolverWrapper
from ctpn_tpu_torch.training.train_step import (
    METRICS,
    Batch,
    TrainStep,
    build_train_step,
    create_train_state,
    state_tensors,
)
from ctpn_tpu_torch.utils.weights import params_from_jax, params_to_jax
from tests.test_torch_graphs import HostDataSpy
from tests.test_torch_train_step import (
    BH,
    BW,
    FH,
    FW,
    K,
    LR,
    TINY,
    _flat,
    jax_step_draws,
    toy_arrays,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _set_both(**train):
    for c in (jcfg, cfg):
        c.TRAIN.LEARNING_RATE = LR
        for k, v in train.items():
            c.TRAIN[k] = v


def _model(seed=1):
    torch.manual_seed(seed)
    return CTPN(dtype=torch.float32, **TINY)


def _draws(seed, n=2, k=K):
    return torch.rand((2, n, k), generator=torch.Generator().manual_seed(seed))


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


# ------------------------------------------------- the device part vs JAX


@pytest.mark.parametrize("solver", ["Adam", "RMS", "Momentum"])
def test_device_part_matches_jax(rng, solver):
    _set_both(SOLVER=solver, STEPSIZE=2)  # the third step runs at lr * GAMMA
    adam = solver == "Adam"
    arrays = toy_arrays(rng, 2)
    jmodel = JCTPN(dtype=jnp.float32, **TINY)
    jstate = jax_state(jax.random.PRNGKey(0), jmodel, (1, BH, BW, 3))
    model = CTPN(dtype=torch.float32, **TINY)
    model.load_state_dict(params_from_jax(jstate.params))
    state = create_train_state(model)
    jstep = jax.jit(jax_build(jmodel, FH, FW))
    step = build_train_step(model, FH, FW)
    jbatch = JBatch(*(jnp.asarray(a) for a in arrays))
    batch = Batch.from_numpy(arrays)
    min_grad = {n: np.full(p.shape, np.inf, np.float32) for n, p in model.named_parameters()}

    for it in range(3):
        _, draws = jax_step_draws(jstate.rng, 2)
        jstate, want = jstep(jstate, jbatch)
        host = step.host_part(state, 2, torch.from_numpy(draws))
        assert state.step == it + 1
        vec = step.device_part(state, batch, host.draws, host.scalars)
        got = TrainStep.metrics(vec, host.learning_rate)
        assert vec.shape == (len(METRICS),) and sorted(got) == sorted(want)
        rtol = 1e-3 if adam and it else 2e-5
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                       err_msg=f"step {it} {k}")
        for n, p in model.named_parameters():
            min_grad[n] = np.minimum(min_grad[n], p.grad.abs().numpy())

    want_p = dict(_flat(jstate.params))
    got_p = dict(_flat(params_to_jax(model.state_dict())))
    grads = dict(_flat(params_to_jax({n: torch.from_numpy(g) for n, g in min_grad.items()})))
    for k in want_p:
        diff = np.abs(got_p[k] - want_p[k])
        if adam:
            noisy = grads[k] < 1e-7
            assert diff[~noisy].max(initial=0) < 1e-5, k
            assert diff[noisy].max(initial=0) <= 2 * LR * 3, k
        else:
            assert diff.max() < 1e-6, k


def test_device_part_reads_the_scalars_not_the_host_state(rng):
    """Step 5's scalars with the host's counters at step 0 give step 5's
    update, equal to a run that took six eager steps; and a step captured
    at step 0 and replayed through step 5 gives the same."""
    _set_both(SOLVER="Adam", STEPSIZE=2)  # lr at step 5 is lr * GAMMA^2
    batch = Batch.from_numpy(toy_arrays(rng, 2))
    draws = [_draws(s) for s in range(6)]

    ref = _model()
    ref_state = create_train_state(ref)
    ref_step = build_train_step(ref, FH, FW)
    ref_metrics = [ref_step(ref_state, batch, d) for d in draws]

    model = _model()
    state = create_train_state(model)
    step = build_train_step(model, FH, FW)
    for d in draws[:5]:
        step(state, batch, d)
    scalars5 = torch.from_numpy(state.opt.scalars(state.opt_state, state.step))
    scalars0 = torch.from_numpy(state.opt.scalars({"count": 0}, 0))
    assert not torch.equal(scalars5, scalars0)  # lr and both corrections differ
    state.step, state.opt_state["count"] = 0, 0  # what a capture at step 0 saw
    vec = step.device_part(state, batch, draws[5], scalars5)
    for n, p in model.named_parameters():
        assert torch.equal(p, dict(ref.named_parameters())[n]), n
    for k, v in TrainStep.metrics(vec, 0.0).items():
        if k != "learning_rate":
            assert torch.equal(v, ref_metrics[5][k]), k

    captured = _model()
    graphs, fake = _fake_graphs(create_train_state(captured))
    got = [graphs(batch, d) for d in draws]
    assert (fake.captures, fake.replays) == (1, 5)
    assert [g["learning_rate"] for g in got] == [m["learning_rate"] for m in ref_metrics]
    assert got[5]["learning_rate"] == pytest.approx(LR * 0.01, rel=1e-6)
    for n, p in captured.named_parameters():
        assert torch.equal(p, dict(ref.named_parameters())[n]), n


@pytest.mark.parametrize("solver", ["Adam", "RMS", "Momentum"])
def test_step_updates_state_in_place(rng, solver):
    cfg.TRAIN.SOLVER = solver
    model = _model()
    state = create_train_state(model)
    step = build_train_step(model, FH, FW)
    tensors = state_tensors(state)
    n_params = len(list(model.parameters()))
    assert len(tensors) == n_params * (4 if solver == "Adam" else 3)  # grads exist
    before = [(t, t.data_ptr(), t.detach().clone()) for t in tensors]
    step(state, Batch.from_numpy(toy_arrays(rng, 2)), _draws(0))
    after = state_tensors(state)
    assert len(after) == len(before)
    for (t, ptr, old), now in zip(before, after):
        assert now is t and now.data_ptr() == ptr
    moved = [not torch.equal(t, old) for t, _, old in before]
    assert all(moved[n_params:2 * n_params])  # every gradient buffer was written
    assert sum(moved[:n_params]) >= n_params - 2 and all(moved[2 * n_params:])


def test_no_tensor_from_host_data_inside_the_device_part(rng, monkeypatch):
    cfg.TRAIN.SOLVER = "Adam"
    model = _model()
    state = create_train_state(model)
    step = build_train_step(model, FH, FW)
    batch = Batch.from_numpy(toy_arrays(rng, 2))
    step(state, batch, _draws(0))  # warm-up: the device constants are made here
    host = step.host_part(state, 2, _draws(1))
    from_numpy = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: from_numpy.append(1) or real(a))
    with HostDataSpy() as spy:
        step.device_part(state, batch, host.draws, host.scalars)
        assert spy.seen == [] and from_numpy == []
        torch.tensor([1.0])  # the spy sees what it looks for
    assert spy.seen == ["lift_fresh"]


# -------------------------------------------- TrainGraphs, fake backend


class FakeKernel:
    """Stands in for a kernel's wrapper in the launch counts."""


class FakeBackend:
    """The CUDA graph machinery on the CPU. ``capture`` runs the program
    with its launches recorded, keeps its outputs, then puts back every
    tensor the step wrote (a capture executes nothing); ``replay`` runs the
    program again with its launches not counted and writes into the
    captured outputs, as a graph writes into its memory."""

    def __init__(self, state):
        self.state = state
        self.captures = self.replays = self.follows = 0
        self.fail = None
        self.outputs = {}

    def upload(self, static, x):
        static.copy_(x)

    def run(self, fn):
        return fn()

    def follow_caller(self):
        self.follows += 1

    def capture(self, fn):
        if self.fail:
            raise self.fail
        self.captures += 1
        saved = [t.detach().clone() for t in state_tensors(self.state)]
        out = fn()
        with torch.no_grad():
            for t, s in zip(state_tensors(self.state), saved):
                t.copy_(s)
        self.outputs[fn] = out
        return fn, out

    def replay(self, graph):
        if self.fail:
            raise self.fail
        self.replays += 1
        with _launches.recording():
            new = graph()
        self.outputs[graph].copy_(new)

    def finish(self, out):
        return out


def _fake_graphs(state, rank=0, world=1):
    fake = FakeBackend(state)
    return TrainGraphs(state, torch.device("cpu"), rank, world, backend=fake), fake


def _toy_batch(n=2, bh=BH, bw=BW, seed=3):
    rng = np.random.RandomState(seed)
    arrays = toy_arrays(rng, n)
    if (bh, bw) != (BH, BW):
        arrays[0] = rng.uniform(0, 60, (n, bh, bw, 3)).astype(np.uint8)
        arrays[1] = np.tile(np.array([bh, bw, 1.0], np.float32), (n, 1))
    return Batch.from_numpy(arrays)


def test_one_capture_per_key():
    cfg.TRAIN.SOLVER = "Momentum"
    graphs, fake = _fake_graphs(create_train_state(_model()))
    calls = [(2, BH, BW), (2, BH, BW), (1, BH, BW), (2, BW, BH), (2, BH, BW), (1, BH, BW)]
    for n, bh, bw in calls:
        graphs(_toy_batch(n, bh, bw))
    cfg.TPU.REMAT = True
    graphs(_toy_batch())
    graphs(_toy_batch())
    assert fake.captures == len(graphs.graphs) == 4
    assert fake.replays == 4 and graphs.eager_steps == 4
    assert graphs.state.step == len(calls) + 2
    assert {k[1:4] for k in graphs.graphs} == {(2, BH, BW), (1, BH, BW), (2, BW, BH)}
    assert {k[4:] for k in graphs.graphs} == {("Momentum", False, 1), ("Momentum", True, 1)}
    assert fake.follows == len(calls) + 2
    with pytest.raises(ValueError, match="host batch"):
        graphs(Batch(*(t.to("meta") for t in _toy_batch())))


def test_warmup_answers_the_first_call_and_steps_once():
    """The first call is the eager step (then a capture that steps
    nothing); replays continue from it: parameters, metrics and the host's
    counters equal an eager run's, step by step."""
    cfg.TRAIN.SOLVER = "Adam"
    batch = _toy_batch()
    ref = _model()
    ref_state = create_train_state(ref)
    ref_step = build_train_step(ref, FH, FW)
    state = create_train_state(_model())
    graphs, fake = _fake_graphs(state)
    for it in range(3):
        want = ref_step(ref_state, batch, _draws(it))
        got = graphs(batch, _draws(it))
        assert (state.step, state.opt_state["count"]) == (it + 1, it + 1)
        assert (fake.captures, fake.replays) == (1, it)
        for k in want:
            assert float(got[k]) == float(want[k]), (it, k)
        for n, p in state.model.named_parameters():
            assert torch.equal(p, dict(ref.named_parameters())[n]), (it, n)


def test_metrics_held_at_once_are_not_aliased():
    cfg.TRAIN.SOLVER = "Momentum"
    graphs, _ = _fake_graphs(create_train_state(_model()))
    batch = _toy_batch()
    held = [graphs(batch, _draws(0)) for _ in range(4)]  # warm-up, then replays
    losses = [float(m["total_loss"]) for m in held]
    assert len(set(losses)) == 4  # each step moved the parameters
    (entry,) = graphs.graphs.values()
    for m in held[1:]:
        assert m["total_loss"].data_ptr() != entry.outputs.data_ptr()
    assert [float(m["total_loss"]) for m in held] == losses


def test_replays_add_the_launches_recorded_at_capture(monkeypatch):
    _launches.init(FakeKernel)
    real = TrainStep.device_part

    def counting(self, *args):
        _launches.count(FakeKernel, torch.device("cuda", 0))
        return real(self, *args)

    monkeypatch.setattr(TrainStep, "device_part", counting)
    graphs, fake = _fake_graphs(create_train_state(_model()))
    batch = _toy_batch()
    graphs(batch)  # warm-up: one real launch; the capture's is recorded
    assert FakeKernel.LAUNCHES == 1
    (entry,) = graphs.graphs.values()
    assert dict(entry.launches) == {(FakeKernel, 0): 1}
    for k in range(1, 4):
        graphs(batch)
        assert FakeKernel.LAUNCHES == 1 + k
    assert dict(FakeKernel.LAUNCHES_BY_DEVICE) == {0: 4} and fake.replays == 3


def test_capture_and_replay_errors_propagate(monkeypatch):
    ran = []
    real = TrainStep.device_part
    monkeypatch.setattr(TrainStep, "device_part",
                        lambda self, *a: ran.append(1) or real(self, *a))
    state = create_train_state(_model())
    graphs, fake = _fake_graphs(state)
    batch = _toy_batch()
    fake.fail = RuntimeError("operation not permitted when stream is capturing")
    with pytest.raises(RuntimeError, match="capturing"):
        graphs(batch)
    # the warm-up step was taken and counted; nothing was captured
    assert graphs.graphs == {} and len(ran) == 1 and state.step == 1
    fake.fail = None
    graphs(batch)
    fake.fail = RuntimeError("replay failed")
    with pytest.raises(RuntimeError, match="replay failed"):
        graphs(batch)
    assert len(ran) == 3  # two warm-ups and one capture: no eager step in its place


def test_ddp_model_steps_eagerly_before_its_capture(tmp_path):
    """Under ``DistributedDataParallel`` the first eleven steps are eager
    (the eleventh captures), then the step replays: a one-rank gloo group."""
    cfg.TRAIN.SOLVER = "Momentum"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        from ctpn_tpu_torch.parallel.dp import wrap_model

        model = _model()
        ref = _model()
        ddp = wrap_model(model, torch.device("cpu"))
        graphs, fake = _fake_graphs(create_train_state(ddp))
        ref_state = create_train_state(ref)
        ref_step = build_train_step(ref, FH, FW)
        batch = _toy_batch()
        assert graphs.warmup_steps == DDP_WARMUP_STEPS == 11
        for it in range(DDP_WARMUP_STEPS + 2):
            got = graphs(batch, _draws(it))
            want = ref_step(ref_state, batch, _draws(it))
            assert fake.captures == (it >= DDP_WARMUP_STEPS - 1), it
            torch.testing.assert_close(got["total_loss"], want["total_loss"],
                                       rtol=1e-5, atol=0)
        assert (graphs.eager_steps, fake.replays) == (DDP_WARMUP_STEPS, 2)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the solver around it


SMALL = ["TRAIN.SCALES", "[64]", "TRAIN.MAX_SIZE", "96",
         "TPU.BUCKETS", "[[64,96],[96,64]]", "TPU.MAX_GT", "64"]


@pytest.fixture(scope="module")
def roidb(tmp_path_factory):
    """Two synthetic scenes as a VOC roidb, at the 64x96 bucket."""
    from ctpn_tpu_torch.data.prepare import split_labels, to_voc
    from ctpn_tpu_torch.data.roidb import get_training_roidb
    from ctpn_tpu_torch.data.synth import generate_dataset
    from ctpn_tpu_torch.data.voc import PascalVOC

    root = tmp_path_factory.mktemp("voc")
    reset_cfg()
    cfg_from_list(SMALL + ["ROOT_DIR", str(root), "TRAIN.USE_FLIPPED", "False"])
    raw = generate_dataset(str(root / "raw"), n_images=2, seed=4)
    split_labels(*raw, str(root / "img"), str(root / "lbl"))
    to_voc(str(root / "lbl"), str(root / "img"), str(root / "VOCdevkit2007" / "VOC2007"))
    out = get_training_roidb(PascalVOC("trainval", "2007",
                                       devkit_path=str(root / "VOCdevkit2007")))
    reset_cfg()
    return out


def _solver_cfg(tmp_path):
    cfg_from_list(SMALL + ["ROOT_DIR", str(tmp_path), "TRAIN.SOLVER", "Adam",
                           "TRAIN.DISPLAY", "1", "TRAIN.SNAPSHOT_ITERS", "100",
                           "TRAIN.USE_FLIPPED", "False"])


def _solver(out, roidb):
    return SolverWrapper(roidb, str(out), model=_model(0), data_parallel=False,
                         device="cpu")


def test_restore_after_a_capture(tmp_path, roidb):
    """``restore()`` copies into the tensors a captured step holds: the
    next replay starts from the restored state and retakes the step it
    took before, bit for bit."""
    _solver_cfg(tmp_path)
    sw = _solver(tmp_path / "run", roidb[:1])
    state = create_train_state(sw.model)
    graphs, fake = _fake_graphs(state)
    batch = _toy_batch(1)
    graphs(batch)
    graphs(batch)
    sw.snapshot(state)  # step 2
    tensors = [(t, t.data_ptr()) for t in state_tensors(state)]
    third = graphs(batch)
    after_third = _params(sw.model)
    graphs(batch)
    assert state.step == 4
    sw.restore(state)
    assert state.step == 2 and state.opt_state["count"] == 2
    for (t, ptr), now in zip(tensors, state_tensors(state)):
        assert now is t and now.data_ptr() == ptr
    again = graphs(batch)  # a replay, with the generator's draws of step 3
    assert fake.captures == 1 and fake.replays == 4
    assert state.step == 3 and float(again["total_loss"]) == float(third["total_loss"])
    for n, p in _params(sw.model).items():
        assert torch.equal(p, after_third[n]), n


def test_solver_through_the_wrapper_logs_the_eager_metrics(tmp_path, roidb, monkeypatch):
    _solver_cfg(tmp_path)
    eager = _solver(tmp_path / "eager", roidb).train_model(4)
    fakes = []

    def fake_graphs(state, device, rank=0, world=1):
        graphs, fake = _fake_graphs(state, rank, world)
        fakes.append(fake)
        return graphs

    monkeypatch.setattr(solver_mod, "TrainGraphs", fake_graphs)
    replayed = _solver(tmp_path / "replayed", roidb).train_model(4)
    assert len(fakes) == 1 and fakes[0].captures >= 1 and fakes[0].replays >= 2
    assert fakes[0].captures + fakes[0].replays == 4
    rows = {}
    for name in ("eager", "replayed"):
        lines = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        rows[name] = [json.loads(ln) for ln in lines]
    assert [r["step"] for r in rows["replayed"]] == [1, 2, 3, 4]
    for a, b in zip(rows["eager"], rows["replayed"]):
        for k in METRICS + ("learning_rate", "step"):
            assert a[k] == b[k], k
    assert eager["total_loss"] == replayed["total_loss"]
