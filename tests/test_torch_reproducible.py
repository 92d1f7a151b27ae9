"""The train step runs only kernels that give the same result from the same
inputs (``training/train_step.py::reproducible``), and detection keeps the
algorithms it had. On the CPU, at the tiny widths of
``tests/test_torch_train_step.py``:

* the scope is active inside ``TrainStep.device_part`` (the eager step,
  and ``TrainGraphs``' warm-up, capture and replays with the fake capture
  backend of ``tests/test_torch_train_graphs.py``) and not inside
  ``CTPNPredictor.run_batch`` or ``DetectGraphs`` (the fake backend of
  ``tests/test_torch_graphs.py``): a patched ``BiLSTM.forward`` records
  the process's flags each time the model runs. After a step the flags are
  what they were before; nested scopes and an exception inside restore
  them;
* for each solver, two device parts from clones of one state (same
  parameters, moments, scalars and draws) give bit-equal states and
  metrics;
* the captured step (warm-up, capture, replays) under the scope still
  computes the JAX package's step: three steps of each solver against
  ``jax.jit(build_train_step(...))`` with the JAX step's own draws, at the
  tolerances of ``tests/test_torch_train_graphs.py::
  test_device_part_matches_jax`` (metrics 2e-5 relative, Adam's after the
  first step 1e-3; parameters 1e-6, Adam's 1e-5 where the gradient exceeds
  1e-7 and 2 * lr per step below it).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.deterministic as det

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.models.ctpn import CTPN as JCTPN
from ctpn_tpu.training.train_step import Batch as JBatch
from ctpn_tpu.training.train_step import build_train_step as jax_build
from ctpn_tpu.training.train_step import create_train_state as jax_state
from ctpn_tpu_torch.config import cfg, reset_cfg
from ctpn_tpu_torch.inference.graphs import DetectGraphs
from ctpn_tpu_torch.models import rnn
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.training.graphs import TrainGraphs
from ctpn_tpu_torch.training.train_step import (
    CUBLAS_WORKSPACE,
    Batch,
    build_train_step,
    create_train_state,
    reproducible,
    state_tensors,
)
from ctpn_tpu_torch.utils.weights import params_from_jax, params_to_jax
from tests.test_torch_graphs import FakeBackend as DetectFakeBackend
from tests.test_torch_graphs import _OutputsOf, _tiny_predictor, _toy_batch
from tests.test_torch_train_graphs import FakeBackend
from tests.test_torch_train_step import (
    BH,
    BW,
    FH,
    FW,
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


def flags():
    return (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory, os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


SCOPED = (True, False, True, False, False, CUBLAS_WORKSPACE)


@pytest.fixture
def seen(monkeypatch):
    """The flags at each call of the model's BiLSTM; the test starts from
    flags other than the scope's (``CUBLAS_WORKSPACE_CONFIG`` unset),
    restored at its end."""
    calls = []
    real = rnn.BiLSTM.forward

    def recording(self, x):
        calls.append(flags())
        return real(self, x)

    monkeypatch.setattr(rnn.BiLSTM, "forward", recording)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    saved = flags()
    torch.backends.cudnn.benchmark = True
    torch.use_deterministic_algorithms(False)
    det.fill_uninitialized_memory = True
    try:
        yield calls
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark, mode,
         warn_only, det.fill_uninitialized_memory, _) = saved
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)


def _model(seed=1):
    torch.manual_seed(seed)
    return CTPN(dtype=torch.float32, **TINY)


def _draws(seed, n=2):
    return torch.rand((2, n, FH * FW * 10), generator=torch.Generator().manual_seed(seed))


def test_scope_is_on_in_the_step_and_its_capture_not_in_detection(rng, seen):
    cfg.TRAIN.SOLVER = "Adam"
    before = flags()
    assert before != SCOPED
    batch = Batch.from_numpy(toy_arrays(rng, 2))
    model = _model()
    state = create_train_state(model)
    build_train_step(model, FH, FW)(state, batch, _draws(0))
    assert seen == [SCOPED] and flags() == before

    graphs_state = create_train_state(_model())
    fake = FakeBackend(graphs_state)
    graphs = TrainGraphs(graphs_state, torch.device("cpu"), backend=fake)
    for k in range(3):  # the warm-up and the capture, then two replays
        graphs(batch, _draws(k))
        assert flags() == before
    assert (fake.captures, fake.replays) == (1, 2)
    assert seen == [SCOPED] * 5

    seen.clear()
    pred = _tiny_predictor()
    images, infos = _toy_batch()
    pred.run_batch(images, infos)  # the CPU's eager program
    detect_fake = DetectFakeBackend()
    pred.graphs.backend = detect_fake
    detect_fake.outputs_of = _OutputsOf(pred.graphs)
    for _ in range(2):  # the warm-up and the capture, then a replay
        pred.run_batch(images, infos)
    direct = DetectGraphs(pred.program, torch.device("cpu"), backend=DetectFakeBackend())
    direct.backend.outputs_of = _OutputsOf(direct)
    direct(images, infos)
    assert (detect_fake.captures, detect_fake.replays) == (1, 1)
    assert seen == [before] * 6 and flags() == before


def test_scope_nests_and_restores_on_error(seen):
    before = flags()
    with reproducible():
        with reproducible():
            assert flags() == SCOPED
        assert flags() == SCOPED
    assert flags() == before
    with pytest.raises(RuntimeError, match="inside"):
        with reproducible():
            raise RuntimeError("inside")
    assert flags() == before


@pytest.mark.parametrize("solver", ["Adam", "RMS", "Momentum"])
def test_device_parts_from_clones_are_bit_equal(rng, solver):
    cfg.TRAIN.SOLVER = solver
    batch = Batch.from_numpy(toy_arrays(rng, 2))
    first = _model()
    state = create_train_state(first)
    step = build_train_step(first, FH, FW)
    step(state, batch, _draws(0))  # moments that are not zero
    clone = _model(seed=2)
    clone.load_state_dict(first.state_dict())
    clone_state = create_train_state(clone)
    with torch.no_grad():
        for t, v in zip(state_tensors(clone_state), state_tensors(state)):
            t.copy_(v)
    clone_state.step = state.step
    clone_state.opt_state.update({k: v for k, v in state.opt_state.items()
                                  if not isinstance(v, list)})
    clone_step = build_train_step(clone, FH, FW)
    host = step.host_part(state, 2, _draws(1))
    clone_host = clone_step.host_part(clone_state, 2, _draws(1))
    assert torch.equal(host.scalars, clone_host.scalars)
    got = step.device_part(state, batch, host.draws, host.scalars)
    want = clone_step.device_part(clone_state, batch, clone_host.draws, clone_host.scalars)
    assert torch.equal(got, want)
    tensors, clone_tensors = state_tensors(state), state_tensors(clone_state)
    assert len(tensors) == len(clone_tensors)
    for a, b in zip(tensors, clone_tensors):
        assert torch.equal(a, b)


@pytest.mark.parametrize("solver", ["Adam", "RMS", "Momentum"])
def test_captured_step_under_the_scope_matches_jax(rng, solver, seen):
    for c in (jcfg, cfg):
        c.TRAIN.LEARNING_RATE = LR
        c.TRAIN.SOLVER = solver
        c.TRAIN.STEPSIZE = 2  # the third step runs at lr * GAMMA
    adam = solver == "Adam"
    arrays = toy_arrays(rng, 2)
    jmodel = JCTPN(dtype=jnp.float32, **TINY)
    jstate = jax_state(jax.random.PRNGKey(0), jmodel, (1, BH, BW, 3))
    model = CTPN(dtype=torch.float32, **TINY)
    model.load_state_dict(params_from_jax(jstate.params))
    state = create_train_state(model)
    graphs = TrainGraphs(state, torch.device("cpu"), backend=FakeBackend(state))
    jstep = jax.jit(jax_build(jmodel, FH, FW))
    jbatch = JBatch(*(jnp.asarray(a) for a in arrays))
    batch = Batch.from_numpy(arrays)
    min_grad = {n: np.full(p.shape, np.inf, np.float32) for n, p in model.named_parameters()}
    for it in range(3):
        _, draws = jax_step_draws(jstate.rng, 2)
        jstate, want = jstep(jstate, jbatch)
        got = graphs(batch, torch.from_numpy(draws))
        rtol = 1e-3 if adam and it else 2e-5
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                       err_msg=f"step {it} {k}")
        for n, p in model.named_parameters():
            min_grad[n] = np.minimum(min_grad[n], p.grad.abs().numpy())
    assert seen and all(f == SCOPED for f in seen)

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
