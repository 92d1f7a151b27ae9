"""Model forward: the port's ``CTPN`` against flax ``CTPN.apply``.

Weights cross through ``params_from_jax``. Tolerances:
* float32: atol 1e-4 on every head (conv/matmul summation order differs
  between XLA:CPU and PyTorch's CPU kernels; nothing else does);
* bfloat16: atol 2e-2 (about two bf16 ulps at the heads' magnitude ~1):
  a conv output that lands near a bf16 rounding boundary may round the
  other way after a different f32 summation order, and one such ulp
  propagates through the later stages.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.models.ctpn import CTPN as JCTPN
from ctpn_tpu.models.rnn import BiLSTM as JBiLSTM
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.models.rnn import BiLSTM
from ctpn_tpu_torch.utils.weights import load_params, params_from_jax

torch.set_num_threads(2)

ARTIFACT = osp.join(
    osp.dirname(osp.dirname(osp.abspath(__file__))),
    "data", "artifacts", "ctpn_synth_f16.npz",
)
TINY_STAGES = ((1, 1, 8), (2, 1, 8), (3, 1, 16), (4, 1, 16), (5, 1, 16))
TINY = dict(trunk_stages=TINY_STAGES, lstm_hidden=16, rpn_channels=32)


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _compare(got, want, atol_prob, atol_raw):
    for name, atol in (
        ("cls_prob", atol_prob), ("cls_score", atol_raw), ("bbox_pred", atol_raw)
    ):
        g = getattr(got, name).detach().float().numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        assert g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize(
    "dtype,atol_prob,atol_raw",
    [("float32", 1e-4, 1e-4), ("bfloat16", 2e-2, 2e-2)],
)
def test_narrow_ctpn_matches_flax(rng, dtype, atol_prob, atol_raw):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = rng.uniform(-120, 120, (2, 64, 96, 3)).astype(np.float32)
    jmodel = JCTPN(dtype=jdt, **TINY)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(x))

    model = CTPN(dtype=getattr(torch, dtype), **TINY)
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _compare(got, want, atol_prob, atol_raw)


def test_bilstm_matches_flax(rng):
    x = rng.normal(0, 1, (2, 3, 11, 24)).astype(np.float32)
    jm = JBiLSTM(hidden=16, d_out=20)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda p: p * 2.0, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    m = BiLSTM(24, hidden=16, d_out=20)
    state = {k.split(".", 1)[1]: v for k, v in
             params_from_jax({"bilstm": params}).items()}
    m.load_state_dict(state)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_params_from_jax_layouts():
    flat = {
        "VGG16Trunk_0/conv1_1/kernel": np.arange(3 * 3 * 3 * 4, dtype=np.float32)
        .reshape(3, 3, 3, 4),
        "bilstm/input_proj/kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
        "bilstm/w_h_fw": np.ones((2, 8), np.float32),
    }
    sd = params_from_jax(flat)
    assert sd["trunk.conv1_1.weight"].shape == (4, 3, 3, 3)  # OIHW
    assert sd["trunk.conv1_1.weight"][2, 1, 0, 1] == flat[
        "VGG16Trunk_0/conv1_1/kernel"][0, 1, 1, 2]
    assert torch.equal(sd["bilstm.input_proj.weight"],
                       torch.from_numpy(flat["bilstm/input_proj/kernel"].T))
    assert sd["bilstm.w_h_fw"].shape == (2, 8)  # h @ w_h layout kept


def test_full_width_artifact_matches_flax_f32(rng):
    """Full VGG16 width on the shipped weights, 128x192, float32."""
    x = rng.uniform(-120, 120, (1, 128, 192, 3)).astype(np.float32)
    want = JCTPN(dtype=jnp.float32).apply(
        {"params": jax_load_params(ARTIFACT)}, jnp.asarray(x)
    )
    model = CTPN(dtype=torch.float32)
    model.load_state_dict(params_from_jax(load_params(ARTIFACT, device="cpu")))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _compare(got, want, 1e-4, 1e-4)
