"""The bottleneck's residual epilogue (``ctpn_tpu_torch.ops.residual_epilogue``)
and its wiring into DBNet's trunk (``models/resnet.py``).

On the CPU the op runs its plain version. The plain version must be the
passes it replaces, bit for bit, and follow the contract (each add rounded
to bf16, then the ReLU); the wrapper must refuse what the kernel does not
take; the launcher must hand the kernel its pointers and shapes; and a
narrow ``ResNet50DCN`` with gradients off (the op) must give the bits of
the same trunk with gradients on (the passes). The kernel itself is held
to the plain version on the card by ``chip_smoke.py`` phase 29.
"""

import contextlib
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctpn_tpu_torch.models import resnet
from ctpn_tpu_torch.models.resnet import ResNet50DCN
from ctpn_tpu_torch.ops import residual_epilogue as RE
from ctpn_tpu_torch.ops.residual_epilogue import residual_epilogue

torch.set_num_threads(2)

CL = torch.channels_last


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _values(rng, shape) -> np.ndarray:
    """float32 values that bf16 holds exactly, around zero, with -0.0, +0.0
    and NaN among them."""
    a = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    a = a.to(torch.bfloat16).float().numpy()
    a.flat[::7] = -0.0
    a.flat[3::11] = 0.0
    a.flat[5::97] = np.nan
    return a


def _with_ties(y, b, idt, bi) -> None:
    """Make some adds fall halfway between two bf16 values (1 or 1 + 2**-7,
    plus half its step), so that their rounding is a tie, to even: conv3's
    bias add in channels 1, 6, ..., the identity's in 2, 7, ..., the sum in
    3, 8, ... (no bias there)."""
    halves = np.where(np.arange(y.shape[-1]) % 2, 1.0, 1.0 + 2.0 ** -7).astype(np.float32)
    y[:, 1::5], b[1::5] = halves, 2.0 ** -8
    idt[:, 2::5], bi[2::5] = halves, 2.0 ** -8
    y[:, 3::5], idt[:, 3::5], b[3::5], bi[3::5] = halves, 2.0 ** -8, -0.0, -0.0


def _bf16(a: np.ndarray) -> np.ndarray:
    """float32 rounded to bf16 (to nearest, ties to even), as float32."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16 << 16).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), r)


def _contract(y, b, idt, bi) -> np.ndarray:
    """relu(bf16(bf16(y + b) + bf16(idt + bi))) in NumPy."""
    s = _bf16(_bf16(y + b) + _bf16(idt + bi))
    return np.where(np.isnan(s), s, np.maximum(s, 0))


def _t(a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return t.contiguous(memory_format=CL) if t.ndim == 4 else t


BIASES = {"both": (True, True), "conv3_only": (True, False), "identity_only": (False, True),
          "none": (False, False)}


@pytest.mark.parametrize("biases", sorted(BIASES))
@pytest.mark.parametrize("c", [256, 512, 1024, 2048])
def test_plain_version_is_the_passes_and_the_contract(rng, c, biases):
    """Each stage's width, at a narrow size; NaN, signed zeros and ties of
    the bf16 rounding among the values."""
    shape = (2, c, 3, 5)
    y, idt = _values(rng, shape), _values(rng, shape)
    b = _values(rng, (c,)) * 0.5
    bi = _values(rng, (c,)) * 0.5
    _with_ties(y, b, idt, bi)
    with_b, with_bi = BIASES[biases]
    tb = _t(b) if with_b else None
    tbi = _t(bi) if with_bi else None
    got = residual_epilogue(_t(y), tb, _t(idt), tbi)
    assert got.shape == shape and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=CL)

    passes = _t(y) + tb.view(1, c, 1, 1) if with_b else _t(y)
    ident = _t(idt) + tbi.view(1, c, 1, 1) if with_bi else _t(idt)
    np.testing.assert_array_equal(_bits(got), _bits(F.relu(passes + ident)))

    zero = np.float32(-0.0)
    want = _contract(y, b.reshape(1, c, 1, 1) if with_b else zero, idt,
                     bi.reshape(1, c, 1, 1) if with_bi else zero)
    np.testing.assert_array_equal(got.float().numpy(), want)  # NaN at NaN, 0 == -0
    assert np.isnan(want).any() and (want == 0).any()


def test_ties_round_to_even():
    """1 + 2**-8 rounds down to 1, (1 + 2**-7) + 2**-8 up to 1 + 2**-6: the
    adds round to nearest, ties to even, as PyTorch's bf16 add does."""
    y = _t(np.array([1.0, 1.0 + 2 ** -7] * 4, np.float32).reshape(1, 8, 1, 1))
    b = _t(np.full(8, 2 ** -8, np.float32))
    zero = _t(np.zeros((1, 8, 1, 1), np.float32))
    got = residual_epilogue(y, b, zero, None).float().flatten().tolist()
    assert got == [1.0, 1.0 + 2 ** -6] * 4


def _bad(rng):
    y = _t(_values(rng, (1, 16, 4, 6)))
    b = _t(_values(rng, (16,)))
    return {
        "float32": (y.float(), b, y.float(), None, "bfloat16"),
        "nchw": (y.contiguous(), b, y, None, "channels_last"),
        "identity_nchw": (y, b, y.contiguous(), None, "channels_last"),
        "c_not_multiple_of_8": (_t(_values(rng, (1, 12, 4, 6))), None,
                                _t(_values(rng, (1, 12, 4, 6))), None, "multiple of 8"),
        "shapes_differ": (y, b, _t(_values(rng, (1, 16, 4, 5))), None, "identity must be"),
        "identity_dtype": (y, b, y.float().contiguous(memory_format=CL), None, "bfloat16"),
        "bias_shape": (y, _t(_values(rng, (8,))), y, None, "bias"),
        "identity_bias_dtype": (y, None, y, b.float(), "identity_bias"),
        "bias_device": (y, torch.empty(16, dtype=torch.bfloat16, device="meta"), y, None,
                        "bias must be on"),
        "identity_device": (y, None, torch.empty((1, 16, 4, 6), dtype=torch.bfloat16,
                                                 device="meta").contiguous(memory_format=CL),
                            None, "device"),
        "three_dims": (y[0], b, y[0], None, r"\(N, C, H, W\)"),
    }


@pytest.mark.parametrize("case", ["float32", "nchw", "identity_nchw", "c_not_multiple_of_8",
                                  "shapes_differ", "identity_dtype", "bias_shape",
                                  "identity_bias_dtype", "bias_device", "identity_device",
                                  "three_dims"])
def test_wrapper_refuses(rng, case):
    y, b, idt, bi, match = _bad(rng)[case]
    with pytest.raises(ValueError, match=match):
        residual_epilogue(y, b, idt, bi)


@pytest.fixture
def fake_launch(monkeypatch):
    """The CUDA launcher on CPU tensors, with the entry point stubbed."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=9))
    calls = []
    monkeypatch.setattr(RE._KERNEL, "_fn", lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(RE.residual_epilogue, "LAUNCHES", 0)
    return calls


def test_the_launcher_hands_the_kernel_both_maps_and_biases(rng, fake_launch):
    y, idt = _t(_values(rng, (3, 24, 5, 7))), _t(_values(rng, (3, 24, 5, 7)))
    b = _t(_values(rng, (24,)))
    out = RE._launch(y, b, idt, None)
    assert out.shape == (3, 24, 5, 7) and out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=CL)
    assert fake_launch == [(y.data_ptr(), b.data_ptr(), idt.data_ptr(), None, out.data_ptr(),
                            3, 24, 5, 7, 9)]
    assert RE.residual_epilogue.LAUNCHES == 1


def test_the_launcher_refuses_a_misaligned_map_and_skips_an_empty_one(rng, fake_launch):
    base = torch.empty(2 * 8 * 4 * 6 + 1, dtype=torch.bfloat16)
    idt = base[1:].view(2, 4, 6, 8).permute(0, 3, 1, 2)  # channels_last, 2 bytes off
    assert idt.is_contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="aligned"):
        RE._launch(_t(_values(rng, (2, 8, 4, 6))), None, idt, None)
    empty = _t(np.zeros((0, 8, 4, 6), np.float32))
    out = RE._launch(empty, None, empty, None)
    assert out.shape == (0, 8, 4, 6) and fake_launch == []


def test_fake_kernel_gives_the_shape_and_layout():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        y = torch.empty((3, 64, 23, 41), dtype=torch.bfloat16).contiguous(memory_format=CL)
        b = torch.empty(64, dtype=torch.bfloat16)
        out = torch.ops.ctpn_torch.residual_epilogue(y, b, y, None)
        got = (tuple(out.shape), out.dtype, out.is_contiguous(memory_format=CL))
    assert got == ((3, 64, 23, 41), torch.bfloat16, True)


# a narrow trunk: stage 1's first block and stage 2's first block project
# their identities (a stride-1 and a stride-2 projection); the others add
# the block's input
NARROW = dict(stages=((2, 8), (2, 8), (1, 16), (1, 16)), stem_width=8)
N_BLOCKS = sum(blocks for blocks, _ in NARROW["stages"])


def _narrow_trunk() -> ResNet50DCN:
    torch.manual_seed(0)
    model = ResNet50DCN(**NARROW)
    with torch.no_grad():  # biases straddle zero, as folded ones do
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.normal_(0, 0.1)
    return model.eval()


def test_trunk_with_the_op_gives_the_passes_bits(monkeypatch):
    model = _narrow_trunk()
    calls = []

    def counted(y, bias, identity, identity_bias):
        calls.append((tuple(y.shape), bias is None, identity_bias is None))
        return residual_epilogue(y, bias, identity, identity_bias)

    monkeypatch.setattr(resnet, "residual_epilogue", counted)
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16)
    with torch.enable_grad():  # the passes (training's path)
        want = model(x)
    assert calls == []
    with torch.inference_mode():
        got = model(x)
    assert len(calls) == N_BLOCKS
    # on the CPU the convs keep their biases and the op adds none
    assert all(no_b and no_bi for _, no_b, no_bi in calls)
    assert [shape for shape, _, _ in calls] == [
        (2, 32, 16, 24), (2, 32, 16, 24), (2, 32, 8, 12), (2, 32, 8, 12), (2, 64, 4, 6),
        (2, 64, 2, 3)]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(g), _bits(w.detach()))


def test_float32_keeps_the_passes(monkeypatch):
    monkeypatch.setattr(resnet, "residual_epilogue", lambda *a: pytest.fail("op called in f32"))
    with torch.inference_mode():
        _narrow_trunk()(torch.randn(1, 3, 32, 48))


def test_bias_apart_follows_the_device(monkeypatch):
    """On the CPU the conv keeps its bias; on CUDA it runs without it and
    hands the bias on (``Conv3x3.bias_apart``, the split both epilogue ops
    take)."""
    conv = resnet.ConvK(8, 16, 1)
    x = torch.randn(1, 8, 3, 4).to(torch.bfloat16)
    y, b = conv.bias_apart(x)
    assert b is None and y.is_contiguous(memory_format=CL)
    np.testing.assert_array_equal(_bits(y), _bits(conv(x)))

    class OnCuda(torch.Tensor):
        is_cuda = True

    seen = []
    monkeypatch.setattr(resnet.ConvK, "forward",
                        lambda self, t, bias=True: seen.append(bias) or t.new_zeros(1, 16, 3, 4))
    y, b = conv.bias_apart(x.as_subclass(OnCuda))
    assert seen == [False] and b.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(b), _bits(conv.bias.to(torch.bfloat16)))
