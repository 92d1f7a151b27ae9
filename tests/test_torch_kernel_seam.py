"""The seam of the hand-written kernels (``ctpn_tpu_torch/ops/_kernel.py``).

The registry must hold the fifteen counted kernels by the names the
certificates print, each with its source; the ops' schemas must stay as
they are, so that an exported artifact still loads; and a launch must hand
the entry point its pointers and the stream, raise naming the kernel on a
non-zero return without counting it, and count it once otherwise. The
entry points themselves run only on the card: here they are stubbed, and
so are ``torch.cuda.device`` and ``current_stream``.
"""

import contextlib
import ctypes
import importlib
import types
from collections import Counter
from pathlib import Path

import pytest
import torch

import ctpn_tpu_torch
from ctpn_tpu_torch.ops import _build, _kernel, _launches
from ctpn_tpu_torch.utils import timer

KERNELS = {  # registry name: (module, wrapper)
    "nms_fused": ("nms_fused", "nms_keep_sorted_fused"),
    "nms_bitmask": ("nms_bitmask", "suppression_bitmask"),
    "nms_resolve": ("nms_resolve", "nms_resolve"),
    "stem_fused": ("stem_fused", "fused_stem_block"),
    "conv_epilogue": ("conv_epilogue", "conv_epilogue"),
    "chain_walk": ("chain_walk", "chain_walk"),
    "successors": ("successors", "successors"),
    "lanms_walk": ("lanms", "lanms_walk"),
    "quad_bitmask": ("quad_nms", "quad_bitmask"),
    "ccl_label": ("ccl", "ccl_label"),
    "craft_boxes": ("craft_boxes", "craft_boxes"),
    "resize_concat": ("resize_concat", "resize_concat"),
    "deform_conv": ("deform_conv", "deform_conv"),
    "db_boxes": ("db_boxes", "db_boxes"),
    "residual_epilogue": ("residual_epilogue", "residual_epilogue"),
}

SCHEMAS = [
    "ctpn_torch::nms_keep_sorted_fused(Tensor boxes, Tensor valid, float thresh, "
    "int? max_keep) -> Tensor",
    "ctpn_torch::suppression_bitmask(Tensor boxes, Tensor valid, float thresh) -> Tensor",
    "ctpn_torch::nms_resolve(Tensor mask, Tensor valid) -> Tensor",
    "ctpn_torch::fused_stem_block(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) "
    "-> Tensor",
    "ctpn_torch::conv_epilogue(Tensor y, Tensor? bias, bool pool) -> Tensor",
    "ctpn_torch::chain_walk(Tensor succ, Tensor feats, Tensor x1, Tensor x2, int steps) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor)",
    "ctpn_torch::successors(Tensor boxes, Tensor scores, Tensor valid, int max_gap, "
    "float min_v_overlaps, float min_size_sim) -> Tensor",
    "ctpn_torch::lanms_walk(Tensor cells, Tensor count, float thresh, int cap) "
    "-> (Tensor, Tensor, Tensor, Tensor)",
    "ctpn_torch::quad_bitmask(Tensor quads, Tensor valid, float thresh) -> Tensor",
    "ctpn_torch::ccl_label(Tensor maps, Tensor extent, float low_text, float link_threshold, "
    "float text_threshold, int min_area, int cap, int connectivity=4) "
    "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    "ctpn_torch::craft_boxes(Tensor maps, Tensor labels, Tensor stats, Tensor score, "
    "Tensor count, Tensor extent, float low_text, float scale) -> Tensor",
    "ctpn_torch::resize_concat(Tensor h, Tensor skip) -> Tensor",
    "ctpn_torch::deform_conv(Tensor x, Tensor om, Tensor weight, int stride) -> Tensor",
    "ctpn_torch::db_boxes(Tensor prob, Tensor labels, Tensor stats, Tensor count, "
    "Tensor extent, Tensor dest, float box_thresh, float unclip, float min_size) "
    "-> (Tensor, Tensor)",
    "ctpn_torch::residual_epilogue(Tensor y, Tensor? bias, Tensor identity, "
    "Tensor? identity_bias) -> Tensor",
    "ctpn_torch::stage_stamp(Tensor(a!) ring, int slot) -> ()",
]

STREAM = 7


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=STREAM))


def test_registry_holds_the_eight_kernels_each_with_its_source():
    """Fifteen since the successor graph's kernel, CRAFT's labelling and
    box kernels, the decoders' resize-and-concatenate kernel, DB's
    deformable conv, DB's box kernel and the bottleneck's residual
    epilogue joined the eight (the name is kept, so that the test keeps its
    history)."""
    reg = _kernel.registry()
    assert sorted(reg) == sorted(KERNELS)
    assert reg["successors"].source == "chain_walk"
    assert reg["ccl_label"].source == reg["craft_boxes"].source == "craft_ccl"
    assert reg["db_boxes"].source == "craft_ccl"
    assert reg["residual_epilogue"].source == "conv_epilogue"
    for name, entry in reg.items():
        module, wrapper = KERNELS[name]
        assert entry.wrapper is getattr(
            importlib.import_module(f"ctpn_tpu_torch.ops.{module}"), wrapper)
        assert isinstance(entry.wrapper.LAUNCHES, int)
        assert isinstance(entry.wrapper.LAUNCHES_BY_DEVICE, Counter)
        assert (_build.CSRC / f"{entry.source}.cu").is_file()
    assert _kernel.wrappers() == {name: e.wrapper for name, e in reg.items()}
    assert reg["resize_concat"].source == "resize_concat"
    assert _kernel.sources() == ["chain_walk", "conv_epilogue", "craft_ccl", "deform_conv",
                                 "nms_bitmask", "nms_fused", "nms_resolve", "quad_nms",
                                 "resize_concat", "stem_fused"]
    assert "stage_stamp" not in reg


@pytest.mark.parametrize("schema", SCHEMAS)
def test_op_schema_is_pinned(schema):
    _kernel.registry()
    name = schema.split("::")[1].split("(")[0]
    assert str(getattr(torch.ops.ctpn_torch, name).default._schema) == schema


def test_only_the_seam_defines_ops():
    pkg = Path(ctpn_tpu_torch.__file__).parent
    found = [p.relative_to(pkg).as_posix() for p in sorted(pkg.rglob("*.py"))
             if "torch.library.Library(" in p.read_text()]
    assert found == ["ops/_kernel.py"]


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_a_failed_launch_raises_naming_the_kernel_and_counts_nothing(name, fake_cuda,
                                                                     monkeypatch):
    entry = _kernel.registry()[name]
    monkeypatch.setattr(entry, "_fn", lambda *args: 700)
    before = entry.wrapper.LAUNCHES, dict(entry.wrapper.LAUNCHES_BY_DEVICE)
    with pytest.raises(RuntimeError, match=f"^{name} kernel launch failed: CUDA error 700$"):
        entry(torch.device("cuda", 0), 1, 2)
    assert (entry.wrapper.LAUNCHES, dict(entry.wrapper.LAUNCHES_BY_DEVICE)) == before


def test_a_launch_passes_pointers_and_the_stream_and_counts_once(fake_cuda, monkeypatch):
    entry = _kernel.registry()["chain_walk"]
    calls = []
    monkeypatch.setattr(entry, "_fn", lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(entry.wrapper, "LAUNCHES", 0)
    monkeypatch.setattr(entry.wrapper, "LAUNCHES_BY_DEVICE", Counter())
    t = torch.zeros(4)
    dev = torch.device("cuda", 1)
    entry(dev, t, None, 3, 0.5)
    assert calls == [(t.data_ptr(), None, 3, 0.5, STREAM)]
    assert entry.wrapper.LAUNCHES == 1 and dict(entry.wrapper.LAUNCHES_BY_DEVICE) == {1: 1}
    with _launches.recording() as rec:  # a capture records; the counts wait for replays
        entry(dev, t, None, 3, 0.5)
    assert entry.wrapper.LAUNCHES == 1
    assert rec.launches == Counter({(entry.wrapper, 1): 1})


def test_an_entry_is_loaded_and_declared_once(fake_cuda, monkeypatch):
    class Fn:
        argtypes = restype = None

        def __call__(self, *args):
            return 0

    lib = types.SimpleNamespace(ctpn_quad_bitmask=Fn())
    loads = []
    monkeypatch.setattr(_build, "load", lambda source: loads.append(source) or lib)
    entry = _kernel.Entry("quad_bitmask", [_kernel.PTR, _kernel.INT], source="quad_nms")
    for _ in range(3):
        entry(torch.device("cuda", 0), None, 1)
    assert loads == ["quad_nms"]
    assert lib.ctpn_quad_bitmask.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    assert lib.ctpn_quad_bitmask.restype is ctypes.c_int


def test_the_stage_stamp_launches_through_the_seam_uncounted(fake_cuda, monkeypatch):
    before = {name: fn.LAUNCHES for name, fn in _kernel.wrappers().items()}
    monkeypatch.setattr(timer._STAMP, "_fn", lambda *args: 0)
    timer._STAMP(torch.device("cuda", 0), torch.zeros(3, dtype=torch.int64), 256, 1, 0)
    assert {name: fn.LAUNCHES for name, fn in _kernel.wrappers().items()} == before
    monkeypatch.setattr(timer._STAMP, "_fn", lambda *args: 3)
    with pytest.raises(RuntimeError, match="^stage_stamp kernel launch failed: CUDA error 3$"):
        timer._STAMP(torch.device("cuda", 0), torch.zeros(3, dtype=torch.int64), 256, 1, 0)
