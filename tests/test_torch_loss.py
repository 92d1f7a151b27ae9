"""The port's losses against ``ctpn_tpu.training.loss`` on the same inputs.

Tolerances: ``smooth_l1`` and the losses within 1e-6 relative (the
reductions sum in another order); the OHEM selection exactly where the
ranked cross-entropies have no near-ties, and on exact ties (identical
logits, as padded regions give), which both sides break by index;
``weight_decay_loss`` within 1e-6 relative over the full-width parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.ops.anchor_target import AnchorTargets as JTargets
from ctpn_tpu.training.loss import ctpn_loss as jax_loss
from ctpn_tpu.training.loss import smooth_l1 as jax_smooth_l1
from ctpn_tpu.training.loss import weight_decay_loss as jax_wd
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.models.factory import init_params
from ctpn_tpu_torch.ops.anchor_target import AnchorTargets
from ctpn_tpu_torch.training.loss import (
    ctpn_loss,
    decayed,
    decayed_parameters,
    ohem_keep,
    smooth_l1,
    weight_decay_loss,
)
from ctpn_tpu_torch.utils.weights import jax_key, params_from_jax

torch.set_num_threads(2)

N, H, W, A = 2, 3, 5, 10


def _inputs(rng, tie_block=False):
    """Random logits, predictions, labels in {-1, 0, 1} and targets."""
    score = rng.normal(0, 2, (N, H, W, A * 2)).astype(np.float32)
    if tie_block:  # identical logits over a region: exact ce ties
        score[:, 1:] = score[:, :1, :1]
    pred = rng.normal(0, 0.5, (N, H, W, A * 4)).astype(np.float32)
    labels = rng.choice([-1, 0, 0, 0, 1], size=(N, H, W, A)).astype(np.int32)
    tgt = rng.normal(0, 0.5, (N, H, W, A * 4)).astype(np.float32)
    fg = np.repeat(labels == 1, 4, axis=-1)
    biw = np.where(fg, np.tile([0, 1, 0, 1], A * N * H * W).reshape(fg.shape), 0)
    bow = fg.astype(np.float32)
    return score, pred, (labels, tgt, biw.astype(np.float32), bow)


def _both(score, pred, t, **kw):
    want_total, want = jax_loss(jnp.asarray(score), jnp.asarray(pred),
                                JTargets(*(jnp.asarray(a) for a in t)), **kw)
    got_total, got = ctpn_loss(torch.from_numpy(score), torch.from_numpy(pred),
                               AnchorTargets(*(torch.from_numpy(a) for a in t)), **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)


def test_smooth_l1_matches_jax():
    x = np.linspace(-3, 3, 601).astype(np.float32)
    np.testing.assert_allclose(smooth_l1(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_smooth_l1(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("ohem", [None, 40, 5])
def test_ctpn_loss_matches_jax(rng, ohem):
    score, pred, t = _inputs(rng)
    _both(score, pred, t, ohem_batchsize=ohem)


def _jax_ohem_keep(score, labels, batchsize):
    """The selection inside ``ctpn_tpu.training.loss.ctpn_loss`` (OHEM)."""
    logits = jnp.asarray(score).reshape(N, -1, 2)
    lbl = jnp.asarray(labels).reshape(N, -1)
    logp = jax.nn.log_softmax(logits, axis=-1)
    ce = -jnp.take_along_axis(logp, jnp.maximum(lbl, 0)[..., None], axis=2)[..., 0]
    neg_ce = jnp.where(lbl == 0, ce, -jnp.inf)
    rank = jnp.argsort(jnp.argsort(-neg_ce, axis=1), axis=1)
    n_fg = jnp.sum(lbl == 1, axis=1, keepdims=True)
    return np.asarray((lbl == 1) | ((lbl == 0) & (rank < batchsize - n_fg)))


@pytest.mark.parametrize("ties", [False, True])
def test_ohem_selects_jax_set(rng, ties):
    """Distinct logits: no near-ties, the same set. A block of identical
    logits: exact ties inside each implementation, broken by index in both
    (stable sorts), so the same set again, and the same loss."""
    score, pred, t = _inputs(rng, tie_block=ties)
    labels = t[0]
    logp = torch.log_softmax(torch.from_numpy(score).reshape(N, -1, 2), -1)
    lbl = torch.from_numpy(labels).reshape(N, -1)
    ce = -torch.gather(logp, 2, lbl.clamp(min=0).long()[..., None])[..., 0]
    if not ties:  # the ranked cross-entropies are well apart
        neg = np.sort(ce[lbl == 0].numpy())
        assert np.diff(neg).min() > 1e-5
    got = ohem_keep(ce, lbl, 12).numpy()
    np.testing.assert_array_equal(got, _jax_ohem_keep(score, labels, 12))
    _both(score, pred, t, ohem_batchsize=12)


def test_weight_decay_on_converted_params():
    """Full-width parameters (``init_params``) in both layouts: the same
    L2 sum, and the decayed set is the JAX package's ``kernel`` leaves
    outside the LSTM cell."""
    tree = init_params(seed=1)
    model = CTPN(dtype=torch.float32)
    model.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        got = weight_decay_loss(decayed_parameters(model), 5e-4)
    want = jax_wd(jax.tree_util.tree_map(jnp.asarray, tree), 5e-4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    names = {jax_key(n) for n, _ in model.named_parameters() if decayed(n)}
    assert "bilstm/out_proj/kernel" in names and "rpn_conv/kernel" in names
    assert len([n for n in names if n.startswith("VGG16Trunk_0/")]) == 13
    assert not any("input_proj" in n or "w_h_" in n or n.endswith("bias")
                   for n in names)
    assert len(names) == 17
