"""The decoders' skip input in one pass (``ctpn_tpu_torch.ops.resize_concat``)
and its wiring into CRAFT's decoder and EAST's merge branch.

On the CPU the op runs its plain version. The plain version must be the
two PyTorch calls it replaces (``F.interpolate`` and ``torch.cat``, or the
``cat`` alone when the sizes agree); the wrapper must refuse what the
kernel does not take; the launcher must hand the kernel the shapes and
allocate a ``channels_last`` output; and both models must give the
outputs of the separate passes they ran before the op. The kernel itself
is held to the plain version on the card, bit for bit, by
``chip_smoke.py`` phase 27.
"""

import contextlib
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctpn_tpu_torch.models import vgg
from ctpn_tpu_torch.models.craft import CRAFT
from ctpn_tpu_torch.models.east import EAST
from ctpn_tpu_torch.ops import resize_concat as RC

torch.set_num_threads(2)

CL = torch.channels_last

# (h's (C1, h, w), skip's (C2, H, W)) at the cells' 736x1280 padded input,
# channels cut to 8 and 16: CRAFT's four blocks (block 1 reads fc7 and
# conv5_2 at one size), EAST's three merge stages
CRAFT_SITES = [((16, 46, 80), (16, 46, 80)), ((16, 46, 80), (16, 92, 160)),
               ((8, 92, 160), (16, 184, 320)), ((8, 184, 320), (8, 368, 640))]
EAST_SITES = [((16, 23, 40), (16, 46, 80)), ((16, 46, 80), (8, 92, 160)),
              ((8, 92, 160), (8, 184, 320))]
UNEVEN = [((16, 19, 29), (8, 38, 57)), ((8, 37, 57), (16, 75, 113)),
          ((8, 75, 113), (8, 37, 57)), ((8, 1, 1), (8, 9, 13)), ((24, 5, 7), (8, 11, 3))]
EQUAL = [((8, 5, 7), (8, 5, 7)), ((24, 12, 20), (16, 12, 20))]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _values(rng, shape, edges: bool = False) -> torch.Tensor:
    """bf16 channels_last values around zero; with ``edges``, -0.0, NaN and
    infinities among them."""
    a = rng.normal(0, 2, shape).astype(np.float32)
    a.flat[::7] = -0.0
    if edges:
        for start, step, value in ((5, 97, np.nan), (6, 101, np.inf), (8, 103, -np.inf)):
            a.flat[start::step] = value
    return torch.from_numpy(a).to(torch.bfloat16).contiguous(memory_format=CL)


def _pair(rng, h_shape, skip_shape, n=1, edges=False):
    return _values(rng, (n, *h_shape), edges), _values(rng, (n, *skip_shape), edges)


def _separate_passes(h, skip):
    """The two PyTorch calls; no resize when the sizes agree (CRAFT's
    block 1)."""
    if h.shape[2:] != skip.shape[2:]:
        h = F.interpolate(h, size=skip.shape[2:], mode="bilinear", align_corners=False)
    return torch.cat([h, skip], 1)


@pytest.mark.parametrize("edges", [False, True], ids=["plain", "edges"])
@pytest.mark.parametrize(
    "site", CRAFT_SITES + EAST_SITES + UNEVEN + EQUAL,
    ids=[f"craft{k}" for k in range(1, 5)] + [f"east{k}" for k in range(2, 5)]
    + ["19x29", "37x57", "shrink", "1x1", "odd"] + ["equal", "equal_wide"])
def test_plain_version_is_the_separate_passes(rng, site, edges):
    h, skip = _pair(rng, *site, n=2, edges=edges)
    want = _separate_passes(h, skip)
    got = RC.resize_concat_ref(h, skip)
    assert got.shape == (2, h.shape[1] + skip.shape[1], *skip.shape[2:])
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("site", [UNEVEN[1], EQUAL[1]], ids=["resize", "equal"])
def test_the_op_on_the_cpu_is_the_plain_version_in_channels_last(rng, site):
    h, skip = _pair(rng, *site, n=2)
    before = RC.resize_concat.LAUNCHES
    got = RC.resize_concat(h, skip)
    assert got.is_contiguous(memory_format=CL)
    assert got.shape == (2, h.shape[1] + skip.shape[1], *skip.shape[2:])
    np.testing.assert_array_equal(_bits(got), _bits(RC.resize_concat_ref(h, skip)))
    np.testing.assert_array_equal(_bits(torch.ops.ctpn_torch.resize_concat(h, skip)),
                                  _bits(got))
    assert RC.resize_concat.LAUNCHES == before  # no kernel on the CPU


def _bad(case):
    rng = np.random.RandomState(1)
    h, skip = _pair(rng, (8, 4, 6), (16, 8, 12), n=2)
    args = dict(h=h, skip=skip)
    args.update({
        "h_float32": dict(h=h.float()),
        "skip_float32": dict(skip=skip.float()),
        "h_nchw": dict(h=h.contiguous()),
        "skip_nchw": dict(skip=skip.contiguous()),
        "h_channels_12": dict(h=_values(rng, (2, 12, 4, 6))),
        "skip_channels_4": dict(skip=_values(rng, (2, 4, 8, 12))),
        "no_channels": dict(h=h[:, :0]),
        "h_three_dims": dict(h=h[0]),
        "batch": dict(skip=skip[:1]),
        "device": dict(skip=skip.to("meta")),
        "empty_map": dict(h=_values(rng, (2, 8, 0, 6))),
    }[case])
    return args


@pytest.mark.parametrize("case", ["h_float32", "skip_float32", "h_nchw", "skip_nchw",
                                  "h_channels_12", "skip_channels_4", "no_channels",
                                  "h_three_dims", "batch", "device", "empty_map"])
@pytest.mark.parametrize("fn", ["op", "ref"])
def test_the_contract_refuses(case, fn):
    f = RC.resize_concat if fn == "op" else RC.resize_concat_ref
    with pytest.raises(ValueError):
        f(**_bad(case))


@pytest.fixture
def fake_launch(monkeypatch):
    """The CUDA launcher on CPU tensors, with the entry point stubbed."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=9))
    calls = []
    monkeypatch.setattr(RC._KERNEL, "_fn", lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(RC.resize_concat, "LAUNCHES", 0)
    return calls


def test_the_launcher_hands_the_kernel_the_shapes_and_a_channels_last_buffer(rng, fake_launch):
    h, skip = _pair(rng, (16, 19, 29), (24, 38, 57), n=3)
    out = RC._launch(h, skip)
    assert out.shape == (3, 40, 38, 57) and out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=CL)
    assert fake_launch == [(h.data_ptr(), skip.data_ptr(), out.data_ptr(),
                            3, 16, 24, 19, 29, 38, 57, 9)]
    assert RC.resize_concat.LAUNCHES == 1


def test_the_launcher_refuses_a_misaligned_map_and_skips_an_empty_one(rng, fake_launch):
    base = torch.empty(2 * 8 * 4 * 6 + 1, dtype=torch.bfloat16)
    h = base[1:].view(2, 4, 6, 8).permute(0, 3, 1, 2)  # channels_last, 2 bytes off
    assert h.is_contiguous(memory_format=CL)
    with pytest.raises(ValueError, match="aligned"):
        RC._launch(h, _values(rng, (2, 8, 8, 12)))
    out = RC._launch(_values(rng, (0, 8, 4, 6)), _values(rng, (0, 8, 8, 12)))
    assert out.shape == (0, 16, 8, 12) and fake_launch == []


def test_fake_kernel_gives_the_shape():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        h = torch.empty((3, 16, 23, 40), dtype=torch.bfloat16).contiguous(memory_format=CL)
        skip = torch.empty((3, 8, 46, 80), dtype=torch.bfloat16).contiguous(memory_format=CL)
        out = torch.ops.ctpn_torch.resize_concat(h, skip)
        got = (tuple(out.shape), out.dtype, out.is_contiguous(memory_format=CL))
    assert got == ((3, 24, 46, 80), torch.bfloat16, True)


def _old_craft_decoder(m: CRAFT, taps):
    """CRAFT's decoder as it ran before the op: resize, then ``cat``."""
    c2, c3, c4, c5 = taps
    fc = m.fc7(m.fc6(F.max_pool2d(c5, 3, 1, 1)))
    h = torch.cat([fc, c5], 1)
    for k, skip in enumerate((None, c4, c3, c2), start=1):
        if skip is not None:
            h = F.interpolate(h, size=skip.shape[-2:], mode="bilinear", align_corners=False)
            h = torch.cat([h, skip], 1)
        h = getattr(m, f"up{k}_1x1").conv_relu(h)
        h = getattr(m, f"up{k}_3x3").conv_relu(h)
    for conv in (m.cls1, m.cls2, m.cls3, m.cls4):
        h = conv.conv_relu(h)
    return m.head(h)


def _old_east_merge(m: EAST, taps):
    """EAST's merge branch as it ran before the op."""
    h = taps[-1]
    for k, skip in enumerate(taps[-2::-1], start=2):
        g = F.interpolate(h, size=skip.shape[-2:], mode="bilinear", align_corners=False)
        h = getattr(m, f"merge{k}_1x1").conv_relu(torch.cat([g, skip], 1))
        h = getattr(m, f"merge{k}_3x3").conv_relu(h)
    return m.out_conv.conv_relu(h)


NARROW_CRAFT = dict(trunk_stages=((1, 2, 8), (2, 2, 8), (3, 3, 16), (4, 3, 16), (5, 2, 16)),
                    fc_width=16, up_widths=((16, 16), (16, 8), (8, 8), (8, 8)),
                    cls_widths=(8, 8, 8, 8))
NARROW_EAST = dict(trunk_stages=((1, 2, 8), (2, 2, 8), (3, 3, 16), (4, 3, 16), (5, 3, 16)),
                   widths=(16, 8, 8), out_width=8)


@pytest.mark.parametrize("mode", ["bf16_no_grad", "bf16_grad", "f32_no_grad"])
@pytest.mark.parametrize("model", ["craft", "east"])
def test_models_give_the_outputs_of_the_separate_passes(model, mode):
    """CRAFT's maps and EAST's merge output equal, bit for bit, those of the
    decoders as they ran before the op (on the CPU the op runs the same
    passes), at an input whose sizes halve unevenly (8 px of padding off
    the cells' 736x1280 ladder), in inference and training."""
    dtype = torch.bfloat16 if mode.startswith("bf16") else torch.float32
    torch.manual_seed(3)
    if model == "craft":
        m = CRAFT(dtype=dtype, **NARROW_CRAFT).eval()
        new, old = m.maps, lambda taps: _old_craft_decoder(m, taps)
    else:
        m = EAST(dtype=dtype, **NARROW_EAST).eval()
        new, old = m.merge, lambda taps: _old_east_merge(m, taps)
    x = torch.from_numpy(np.random.RandomState(4).normal(0, 50, (2, 88, 152, 3))
                         .astype(np.float32))
    with torch.enable_grad() if mode == "bf16_grad" else torch.no_grad():
        taps = m.trunk_taps(x)
        got, want = new(taps), old(taps)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.detach().float().numpy(), want.detach().float().numpy())


def test_upsample_concat_runs_the_plain_passes_off_the_card(rng, monkeypatch):
    """Off the card, and in training or float32 anywhere, the models'
    helper never reaches the op: it resizes and concatenates."""
    monkeypatch.setattr(vgg, "resize_concat", lambda *a: pytest.fail("the op was called"))
    h, skip = _pair(rng, (8, 5, 7), (8, 10, 14), n=2)
    with torch.no_grad():
        got = vgg.upsample_concat(h, skip)
        same = vgg.upsample_concat(skip, skip)
    np.testing.assert_array_equal(_bits(got), _bits(_separate_passes(h, skip)))
    np.testing.assert_array_equal(_bits(same), _bits(torch.cat([skip, skip], 1)))
