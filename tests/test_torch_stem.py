"""Fused stem of the port against the JAX package.

The port's plain stem (``fused_stem_block_ref``) is held against the Pallas
kernel ``fused_stem_block`` run in interpret mode on the CPU, as
tests/test_stem.py runs it. Tolerance: max relative error
``|a - b| / (|b| + 1)`` below 1e-2, the JAX package's own (bf16
resolution: the two sum the same products in another order, and a sum
near a bf16 rounding boundary may round the other way). The model case
holds ``CTPN(fused_stem=True)`` against flax ``CTPN(fused_stem=True)`` on
the same weights at ``cls_prob`` atol 5e-3, the tolerance of
tests/test_stem.py for the fused against the stock model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpn_tpu.models.ctpn import CTPN as JCTPN
from ctpn_tpu.ops.stem_pallas import fused_stem_block as jax_stem
from ctpn_tpu_torch.config import cfg as tcfg
from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.models.factory import get_network
from ctpn_tpu_torch.models.vgg import VGG16Trunk
from ctpn_tpu_torch.ops.stem_fused import (
    fused_stem_block,
    fused_stem_block_ref,
    pack_stem_weights,
    packed_stem_weights,
)
from ctpn_tpu_torch.utils.weights import params_from_jax

torch.set_num_threads(2)

REL_TOL = 1e-2  # tests/test_stem.py's bf16-resolution bound


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _weights(rng, b1_value=None):
    w1 = rng.randn(3, 3, 3, 64).astype(np.float32) * 0.05
    b1 = (np.full(64, b1_value, np.float32) if b1_value is not None
          else rng.randn(64).astype(np.float32) * 0.1)
    w2 = rng.randn(3, 3, 64, 64).astype(np.float32) * 0.05
    b2 = rng.randn(64).astype(np.float32) * 0.1
    return w1, b1, w2, b2


def _both(x, w1, b1, w2, b2):
    """(port, JAX) stem outputs as f32 NHWC numpy arrays."""
    want = jax_stem(*map(jnp.asarray, (x, w1, b1, w2, b2)), interpret=True)
    want = np.asarray(want.astype(jnp.float32))

    def oihw(k):
        return torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    got = fused_stem_block(xt, oihw(w1), torch.from_numpy(b1),
                           oihw(w2), torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    return got.float().permute(0, 2, 3, 1).numpy(), want


# the last three: H and W multiples of 8 that the CUDA kernel's 16 x 24 tile
# does not divide (partial tiles at the right and bottom edges), an image
# smaller than one tile, and a portrait image like the 912x608 bucket
@pytest.mark.parametrize(
    "shape", [(2, 64, 96), (1, 32, 48), (1, 24, 136), (3, 8, 8), (2, 96, 40)])
def test_plain_stem_matches_pallas(rng, shape):
    n, h, w = shape
    x = rng.randn(n, h, w, 3).astype(np.float32) * 50
    got, want = _both(x, *_weights(rng))
    assert got.shape == want.shape == (n, h // 2, w // 2, 64)
    rel = np.abs(got - want) / (np.abs(want) + 1.0)
    assert rel.max() < REL_TOL, rel.max()


def _oihw(rng):
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in _weights(rng))
    return w1.permute(3, 2, 0, 1).contiguous(), b1, w2.permute(3, 2, 0, 1).contiguous(), b2


def test_pack_stem_weights_layout(rng):
    """The packed layouts against their index formulas: w1k rows in
    (ky, kx, ci) order; w2k rows (tap, co) of 64 input channels whose
    16-byte chunks (8 bf16) are XOR-swizzled by co & 7."""
    w1, b1, w2, b2 = _oihw(rng)
    w1k, b1k, w2k, b2k = pack_stem_weights(w1, b1, w2, b2)
    assert w1k.shape == (27, 64) and w1k.dtype == torch.float32
    assert w2k.shape == (9, 64, 8, 8) and w2k.dtype == torch.bfloat16
    assert w2k.is_contiguous() and w2k.numel() * 2 == 73728
    w1r = w1.to(torch.bfloat16).float().numpy()
    w2r = w2.to(torch.bfloat16).float().numpy()
    want1 = np.empty((27, 64), np.float32)
    want2 = np.empty((9, 64, 8, 8), np.float32)
    for ky in range(3):
        for kx in range(3):
            for ci in range(3):
                want1[(ky * 3 + kx) * 3 + ci] = w1r[:, ci, ky, kx]
            for co in range(64):
                for q in range(8):
                    lo = 8 * (q ^ (co & 7))
                    want2[ky * 3 + kx, co, q] = w2r[co, lo:lo + 8, ky, kx]
    np.testing.assert_array_equal(w1k.numpy(), want1)
    np.testing.assert_array_equal(w2k.float().numpy(), want2)
    np.testing.assert_array_equal(b1k.numpy(), b1.numpy())
    np.testing.assert_array_equal(b2k.numpy(), b2.numpy())


def test_packed_weights_cache_follows_the_parameters(rng):
    """Same tensors, same version: one packing. An in-place update or
    ``load_state_dict`` must not leave stale packed weights."""
    trunk = VGG16Trunk(stages=NARROW, fused_stem=True)
    params = (trunk.conv1_1.weight, trunk.conv1_1.bias,
              trunk.conv1_2.weight, trunk.conv1_2.bias)
    first = packed_stem_weights(*params)
    assert packed_stem_weights(*params) is first
    state = {k: v.clone() for k, v in trunk.state_dict().items()}
    w1, b1, w2, b2 = _oihw(rng)
    state.update({"conv1_1.weight": w1, "conv1_1.bias": b1,
                  "conv1_2.weight": w2, "conv1_2.bias": b2})
    trunk.load_state_dict(state)
    second = packed_stem_weights(*params)
    assert second is not first
    for got, want in zip(second, pack_stem_weights(w1, b1, w2, b2)):
        assert torch.equal(got, want)
    with torch.no_grad():
        trunk.conv1_2.bias.add_(1.0)
    assert torch.equal(packed_stem_weights(*params)[3], b2 + 1.0)


def test_fused_trunk_output_follows_load_state_dict(rng):
    x = torch.from_numpy(rng.uniform(-120, 120, (1, 3, 32, 48)).astype(np.float32))
    trunk = VGG16Trunk(stages=NARROW, fused_stem=True)
    with torch.no_grad():
        before = trunk(x)
        state = {k: v.clone() for k, v in trunk.state_dict().items()}
        state["conv1_2.weight"] = _oihw(rng)[2]
        trunk.load_state_dict(state)
        after = trunk(x)
        fresh = VGG16Trunk(stages=NARROW, fused_stem=True)
        fresh.load_state_dict(state)
        assert not torch.equal(before, after)
        assert torch.equal(after, fresh(x))


def test_plain_stem_border_ring_is_zero_padded(rng):
    """An all-zero image with conv1 bias 3.0: conv1 values centred outside
    the image must be 0, not relu(3.0), or the border pixels differ."""
    x = np.zeros((1, 32, 48, 3), np.float32)
    w1, b1, w2, _ = _weights(rng, b1_value=3.0)
    got, want = _both(x, w1, b1, w2, np.zeros(64, np.float32))
    np.testing.assert_allclose(got, want, rtol=REL_TOL, atol=REL_TOL)
    # a leaked ring would change exactly the border row and column
    assert not np.allclose(got[0, 0], got[0, 5])


def test_stem_rejects_bad_geometry_and_inputs():
    w1, b = torch.zeros((64, 3, 3, 3)), torch.zeros(64)
    w2 = torch.zeros((64, 64, 3, 3))
    with pytest.raises(ValueError, match="H%8"):
        fused_stem_block(torch.zeros((1, 3, 20, 48), dtype=torch.bfloat16), w1, b, w2, b)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_stem_block(torch.zeros((1, 3, 32, 48)), w1, b, w2, b)
    with pytest.raises(ValueError, match="w2"):
        fused_stem_block(torch.zeros((1, 3, 32, 48), dtype=torch.bfloat16),
                         w1, b, w2[:32], b)


def test_wrapper_dispatch(rng):
    """CPU tensors run the plain version without a launch; a device that is
    neither CPU nor CUDA raises."""
    x = torch.from_numpy(rng.randn(1, 3, 16, 24).astype(np.float32)).to(torch.bfloat16)
    ws = [torch.from_numpy(w) for w in _weights(rng)]
    ws = [ws[0].permute(3, 2, 0, 1), ws[1], ws[2].permute(3, 2, 0, 1), ws[3]]
    before = fused_stem_block.LAUNCHES
    assert torch.equal(fused_stem_block(x, *ws), fused_stem_block_ref(x, *ws))
    assert fused_stem_block.LAUNCHES == before
    with pytest.raises(ValueError, match="unsupported device"):
        fused_stem_block(x.to("meta"), *[w.to("meta") for w in ws])


NARROW = ((1, 2, 64), (2, 1, 16), (3, 1, 16), (4, 1, 16), (5, 1, 16))


def test_fused_stem_model_matches_flax(rng):
    """A narrow CTPN with the fused stem against flax's, same weights, f32
    trunk (the stem still rounds to bf16 inside, in both)."""
    x = rng.uniform(-120, 120, (1, 64, 96, 3)).astype(np.float32)
    kw = dict(trunk_stages=NARROW, lstm_hidden=16, rpn_channels=32)
    jmodel = JCTPN(dtype=jnp.float32, fused_stem=True, **kw)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(x))

    model = CTPN(dtype=torch.float32, fused_stem=True, **kw)
    model.load_state_dict(params_from_jax(params))
    stock = CTPN(dtype=torch.float32, **kw)
    stock.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        got_stock = stock(torch.from_numpy(x))
    np.testing.assert_allclose(
        got.cls_prob.numpy(), np.asarray(want.cls_prob), atol=5e-3, rtol=0)
    # the fused route really ran: the stem's bf16 roundings move the heads
    assert not np.array_equal(got.cls_prob.numpy(), got_stock.cls_prob.numpy())


def test_factory_gates_fused_stem_to_test_graph():
    tcfg.TPU.FUSED_STEM = True
    assert get_network("VGGnet_test", "cpu").trunk.fused_stem
    assert not get_network("VGGnet_train", "cpu").trunk.fused_stem
    tcfg.TPU.FUSED_STEM = False
    assert not get_network("VGGnet_test", "cpu").trunk.fused_stem
