"""The port's train step against ``ctpn_tpu.training.train_step`` (CPU).

Both start from the same parameters (the JAX package's ``model.init``,
carried over by ``params_from_jax``), take the same uint8 batch (the JAX
tests' toy batch: bright strips on dark noise, gt boxes on the strips) and
the same anchor-target draws (the JAX step's own: the port is fed them),
then take three steps of each solver with float32 compute on the JAX
tests' narrow trunk.

Tolerances: every metric within 2e-5 relative, parameters within 1e-6
after three steps, for RMS and Momentum. Adam divides each gradient by its
root mean square plus 1e-8, so an element whose gradient is under 1e-7
(a near-dead input channel of the LSTM's input projection) moves by up to
the learning rate on rounding noise in either package; those elements are
held to 2 * lr per step, every other element to 1e-5, and the metrics of
the steps after the first to 1e-3 relative, since the loss then sees the
moved parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.models.ctpn import CTPN as JCTPN
from ctpn_tpu.training.train_step import Batch as JBatch
from ctpn_tpu.training.train_step import build_train_step as jax_build
from ctpn_tpu.training.train_step import create_train_state as jax_state
from ctpn_tpu_torch.config import cfg, reset_cfg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.training.train_step import (
    Batch,
    Optimizer,
    build_train_step,
    create_train_state,
    make_lr_schedule,
)
from ctpn_tpu_torch.utils.weights import params_from_jax, params_to_jax

torch.set_num_threads(2)

BH, BW = 64, 80
FH, FW = 4, 5
K = FH * FW * 10
TINY_STAGES = ((1, 1, 8), (2, 1, 8), (3, 1, 16), (4, 1, 16), (5, 1, 16))
TINY = dict(trunk_stages=TINY_STAGES, lstm_hidden=16, rpn_channels=32)
LR = 1e-3


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def toy_arrays(rng, n):
    """The JAX tests' toy batch (``tests/test_training.py``) in uint8."""
    images = rng.uniform(0, 60, (n, BH, BW, 3)).astype(np.uint8)
    max_gt, max_dc = 8, 4
    gt = np.zeros((n, max_gt, 4), np.float32)
    gt_valid = np.zeros((n, max_gt), bool)
    for i in range(n):
        y = 16 + 8 * (i % 2)
        for s in range(3):
            x1 = 8 + 16 * s
            gt[i, s] = [x1, y, x1 + 15, y + 24]
            gt_valid[i, s] = True
            images[i, y:y + 24, x1:x1 + 16] = 220
    return [images, np.tile(np.array([BH, BW, 1.0], np.float32), (n, 1)), gt,
            gt_valid, np.zeros((n, max_gt), bool), np.zeros((n, max_dc, 4), np.float32),
            np.zeros((n, max_dc), bool)]


def jax_step_draws(rng, n):
    """The JAX step's draws: ``split(state.rng)``, then per image as in
    ``anchor_target_batched``. Returns (next rng, (2, n, K) draws)."""
    rng, rng_targets = jax.random.split(rng)
    out = np.zeros((2, n, K), np.float32)
    for i, r in enumerate(jax.random.split(rng_targets, n)):
        r_fg, r_bg = jax.random.split(r)
        out[0, i] = np.asarray(jax.random.uniform(r_fg, (K,)))
        out[1, i] = np.asarray(jax.random.uniform(r_bg, (K,)))
    return rng, out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


CASES = {
    # STEPSIZE 2: the third step runs at lr * GAMMA
    "Adam": dict(SOLVER="Adam", STEPSIZE=2),
    "RMS": dict(SOLVER="RMS"),
    "Momentum": dict(SOLVER="Momentum"),
    "Momentum_ohem": dict(SOLVER="Momentum", OHEM=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_steps_match_jax(rng, case):
    for c in (jcfg, cfg):
        c.TRAIN.LEARNING_RATE = LR
        for k, v in CASES[case].items():
            c.TRAIN[k] = v
    adam = cfg.TRAIN.SOLVER == "Adam"
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
    min_grad = {n: np.full(p.shape, np.inf, np.float32)
                for n, p in model.named_parameters()}

    for it in range(3):
        rng_next, draws = jax_step_draws(jstate.rng, 2)
        jstate, want = jstep(jstate, jbatch)
        assert np.array_equal(np.asarray(jstate.rng), np.asarray(rng_next))
        got = step(state, batch, torch.from_numpy(draws))
        assert state.step == it + 1 and sorted(got) == sorted(want)
        rtol = 1e-3 if adam and it else 2e-5
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                       err_msg=f"step {it} {k}")
        for n, p in model.named_parameters():
            min_grad[n] = np.minimum(min_grad[n], p.grad.abs().numpy())
        if it == 0:  # the clip is active: |g| > 10 scales the update
            assert float(got["grad_norm"]) > 10.0
            if cfg.TRAIN.SOLVER == "Momentum":  # the update is lr * the clipped g
                np.testing.assert_allclose(float(got["update_norm"]), LR * 10.0,
                                           rtol=1e-5)
    if adam:
        assert float(got["learning_rate"]) == pytest.approx(LR * 0.1, rel=1e-6)

    want_p = dict(_flat(jstate.params))
    got_p = dict(_flat(params_to_jax(model.state_dict())))
    grads = dict(_flat(params_to_jax({n: torch.from_numpy(g) for n, g in min_grad.items()})))
    assert sorted(got_p) == sorted(want_p)
    for k in want_p:
        diff = np.abs(got_p[k] - want_p[k])
        if adam:
            noisy = grads[k] < 1e-7
            assert diff[~noisy].max(initial=0) < 1e-5, k
            assert diff[noisy].max(initial=0) <= 2 * LR * 3, k
        else:
            assert diff.max() < 1e-6, k


def test_remat_matches_plain(rng):
    """``TPU.REMAT`` recomputes the forward in the backward: the same
    losses and the same update."""
    arrays = toy_arrays(rng, 2)
    draws = torch.rand((2, 2, K), generator=torch.Generator().manual_seed(0))
    results = []
    for remat in (False, True):
        cfg.TPU.REMAT = remat
        torch.manual_seed(1)
        model = CTPN(dtype=torch.float32, **TINY)
        cfg.TRAIN.SOLVER = "Adam"
        state = create_train_state(model)
        metrics = build_train_step(model, FH, FW)(state, Batch.from_numpy(arrays), draws)
        results.append((metrics, {n: p.detach().clone()
                                  for n, p in model.named_parameters()}))
    (m0, p0), (m1, p1) = results
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6, err_msg=k)
    for n in p0:
        np.testing.assert_allclose(p1[n].numpy(), p0[n].numpy(), rtol=0, atol=1e-7,
                                   err_msg=n)


def test_bf16_compute_trains_f32_params(rng):
    """With bfloat16 compute the parameters stay float32 and every one of
    them gets a finite float32 gradient through the cast in ``forward``;
    the convs' gradients are not zero."""
    model = CTPN(dtype=torch.bfloat16, **TINY)
    cfg.TRAIN.SOLVER = "Adam"
    state = create_train_state(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = build_train_step(model, FH, FW)(state, Batch.from_numpy(toy_arrays(rng, 2)))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all(), n
        if n.endswith("weight") and "trunk" in n:
            assert p.grad.abs().sum() > 0, n
        assert not torch.equal(p.detach(), before[n]) or p.grad.abs().sum() == 0, n


def test_draws_come_from_the_generator(rng):
    """Without ``draws`` the step takes (2, B, K) uniforms from the state's
    generator: two states seeded alike take identical steps."""
    arrays = toy_arrays(rng, 2)
    cfg.RNG_SEED, cfg.TRAIN.SOLVER = 9, "Momentum"
    out = []
    for _ in range(2):
        torch.manual_seed(3)
        model = CTPN(dtype=torch.float32, **TINY)
        state = create_train_state(model)
        step = build_train_step(model, FH, FW)
        out.append([float(step(state, Batch.from_numpy(arrays))["total_loss"])
                    for _ in range(2)])
        assert state.gen.initial_seed() == 9
    assert out[0] == out[1]


def test_lr_schedule_and_solver_names():
    sched = make_lr_schedule(1e-3, 0.1, 2)
    assert [sched(s) for s in (0, 1, 2, 3, 4)] == pytest.approx(
        [1e-3, 1e-3, 1e-4, 1e-4, 1e-5], rel=1e-6)
    assert sched(2) == float(np.float32(1e-3) * np.float32(0.1))
    with pytest.raises(ValueError, match="unknown solver"):
        Optimizer("Adagrad", sched)
