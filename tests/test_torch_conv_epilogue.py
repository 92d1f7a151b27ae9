"""The trunk's fused conv epilogue (``ctpn_tpu_torch.ops.conv_epilogue``)
and its wiring into the model.

On the CPU the op runs its plain version. The plain version must be the
separate passes it replaces, bit for bit; the wrapper must refuse what the
kernel does not take; and a ``CTPN`` with gradients off (the fused path)
must give the bits of the same model with gradients on (the separate
passes). The kernel itself is held to the plain version on the card by
``chip_smoke.py`` phase 3.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctpn_tpu_torch.config import reset_cfg
from ctpn_tpu_torch.models import vgg
from ctpn_tpu_torch.models.ctpn import CTPN
from ctpn_tpu_torch.ops.conv_epilogue import conv_epilogue

torch.set_num_threads(2)

# a narrow ladder with VGG16's pooling structure and blocks of one to three
# convs, so pools follow only a block's last conv
LADDER = ((1, 2, 8), (2, 1, 8), (3, 3, 16), (4, 1, 16), (5, 2, 16))
NARROW = dict(trunk_stages=LADDER, lstm_hidden=16, rpn_channels=32)
N_CONVS = sum(reps for _, reps, _ in LADDER) + 1  # the trunk and rpn_conv


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _straddling(rng, shape) -> torch.Tensor:
    """bf16 values around zero, a few of them -0.0 and +0.0."""
    a = rng.normal(0, 1, shape).astype(np.float32)
    a.flat[::7] = -0.0
    a.flat[3::11] = 0.0
    return torch.from_numpy(a).to(torch.bfloat16)


def _conv_output(rng, n, c, h, w) -> torch.Tensor:
    return _straddling(rng, (n, c, h, w)).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("pool", [False, True], ids=["relu", "relu_pool"])
@pytest.mark.parametrize("hw", [(6, 10), (7, 9)], ids=["even", "odd"])
@pytest.mark.parametrize("c", [64, 512])
def test_plain_version_is_the_separate_passes(rng, c, hw, pool):
    y = _conv_output(rng, 2, c, *hw)
    bias = _straddling(rng, (c,))
    want = F.relu(y + bias.view(1, c, 1, 1))
    if pool:
        want = F.max_pool2d(want, 2, 2)
    got = conv_epilogue(y, bias, pool)
    assert got.shape == want.shape
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # without a bias: the ReLU (and pool) of y itself
    bare = F.relu(y)
    if pool:
        bare = F.max_pool2d(bare, 2, 2)
    np.testing.assert_array_equal(_bits(conv_epilogue(y, None, pool)), _bits(bare))


def _bad_inputs(rng):
    y = _conv_output(rng, 1, 16, 4, 6)
    b = _straddling(rng, (16,))
    return {
        "float32": (y.float(), b.float(), False, "bfloat16"),
        "nchw": (y.contiguous(), b, False, "channels_last"),
        "c_not_multiple_of_8": (_conv_output(rng, 1, 12, 4, 6), _straddling(rng, (12,)),
                                False, "multiple of 8"),
        "bias_shape": (y, _straddling(rng, (8,)), False, "bias"),
        "bias_dtype": (y, b.float(), False, "bias"),
        "pool_of_one_row": (_conv_output(rng, 1, 16, 1, 6), b, True, "2x2 pool"),
        "three_dims": (y[0], b, False, r"\(N, C, H, W\)"),
    }


@pytest.mark.parametrize("case", ["float32", "nchw", "c_not_multiple_of_8", "bias_shape",
                                  "bias_dtype", "pool_of_one_row", "three_dims"])
def test_wrapper_refuses(rng, case):
    y, b, pool, match = _bad_inputs(rng)[case]
    with pytest.raises(ValueError, match=match):
        conv_epilogue(y, b, pool)


def _narrow_model(per_image_tail: bool) -> CTPN:
    torch.manual_seed(0)
    model = CTPN(dtype=torch.bfloat16, per_image_tail=per_image_tail, **NARROW)
    with torch.no_grad():  # biases straddle zero, as trained ones do
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0, 0.1)
    return model.eval()


@pytest.mark.parametrize("per_image_tail", [False, True], ids=["batched", "per_image"])
def test_fused_path_gives_the_separate_passes_bits(rng, monkeypatch, per_image_tail):
    model = _narrow_model(per_image_tail)
    calls = []

    def counted(y, bias, pool):
        calls.append((tuple(y.shape), pool))
        return conv_epilogue(y, bias, pool)

    monkeypatch.setattr(vgg, "conv_epilogue", counted)
    x = torch.from_numpy(rng.uniform(-120, 120, (3, 64, 96, 3)).astype(np.float32))
    feat_x = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous()

    with torch.enable_grad():  # the separate passes (training's path)
        want = model(x)
        want_feat = model.trunk(feat_x)
    assert calls == []
    with torch.inference_mode():
        got = model(x)
        got_feat = model.trunk(feat_x)
    # every conv went through the op once per forward; pools after the
    # last conv of blocks 1-4 only
    pools = [pool for _, pool in calls[:N_CONVS]]
    assert len(calls) == N_CONVS + N_CONVS - 1
    assert pools == [False, True, True, False, False, True, True, False, False, False]
    np.testing.assert_array_equal(_bits(got_feat), _bits(want_feat))
    for name in ("bbox_pred", "cls_score", "cls_prob"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      w.detach().numpy().view(np.int32), err_msg=name)


def test_float32_keeps_the_separate_passes(rng, monkeypatch):
    monkeypatch.setattr(vgg, "conv_epilogue", lambda *a: pytest.fail("op called in f32"))
    model = CTPN(dtype=torch.float32, **NARROW).eval()
    x = torch.from_numpy(rng.uniform(-120, 120, (1, 32, 48, 3)).astype(np.float32))
    with torch.inference_mode():
        model(x)


def test_export_holds_the_op(tmp_path):
    """A ``torch.export`` of the detect program (the frozen artifact's)
    holds one ``ctpn_torch::conv_epilogue`` node per conv."""
    import io

    from ctpn_tpu_torch.config import cfg
    from ctpn_tpu_torch.inference.frozen import export_frozen
    from ctpn_tpu_torch.utils.weights import params_to_jax

    for key, value in {"RPN_PRE_NMS_TOP_N": 200, "RPN_POST_NMS_TOP_N": 50}.items():
        cfg.TEST[key] = value
    cfg.TPU.MAX_LINES = 16
    model = _narrow_model(per_image_tail=True)
    path = export_frozen(params_to_jax(model.state_dict()), str(tmp_path / "f.npz"),
                         shapes=[(2, 64, 96)], model=model, device="cpu")
    with np.load(path) as blobs:
        exported = torch.export.load(io.BytesIO(blobs["program/2x64x96"].tobytes()))
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert sum("ctpn_torch.conv_epilogue" in t for t in targets) == N_CONVS
    assert not any("aten.relu" in t or "max_pool2d" in t for t in targets)
