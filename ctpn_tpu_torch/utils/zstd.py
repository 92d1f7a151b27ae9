"""ctypes wrapper of the port's Zstandard decoder (``ops/csrc/zstd_decode.cpp``).

The library is built at first use by ``ops/_build.py`` with the host C++
compiler into ``ctpn_tpu_torch/_build/``, as ``native.py`` builds
``host_ops``. There is no other decoder: without a compiler, or with a
frame the decoder refuses, :func:`decompress` raises and names the input.

``MODES`` counts, over the process, the frame, block, literal, sequence and
offset modes the decoder has met (``block_rle``, ``lit_treeless``,
``seq_repeat``, ``offset_repeat_2``, ...), so that a test can show that
each was exercised.
"""

from __future__ import annotations

import ctypes
import threading
from collections import Counter
from typing import Optional

import numpy as np

from ctpn_tpu_torch.ops import _build

SOURCE = "ops/csrc/zstd_decode.cpp"
MODES: Counter = Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_names: tuple = ()
_ERR_LEN = 256


def _load() -> ctypes.CDLL:
    global _lib, _names
    with _lock:
        if _lib is not None:
            return _lib
        if _build.cxx() is None:
            raise RuntimeError(
                f"reading zstd frames needs {SOURCE} built with a host C++ "
                "compiler, and none was found (set CXX)")
        lib = _build.load("zstd_decode")
        u8p = ctypes.c_void_p
        lib.ctpn_zstd_content_size.restype = ctypes.c_int64
        lib.ctpn_zstd_content_size.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_int]
        lib.ctpn_zstd_decompress.restype = ctypes.c_int64
        lib.ctpn_zstd_decompress.argtypes = [
            u8p, ctypes.c_uint64, u8p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int]
        lib.ctpn_zstd_nmodes.restype = ctypes.c_int
        lib.ctpn_zstd_mode_name.restype = ctypes.c_char_p
        lib.ctpn_zstd_mode_name.argtypes = [ctypes.c_int]
        _names = tuple(lib.ctpn_zstd_mode_name(i).decode()
                       for i in range(lib.ctpn_zstd_nmodes()))
        _lib = lib
        return lib


def mode_names() -> tuple:
    """Every mode the decoder counts, in its order."""
    _load()
    return _names


def content_size(data, name: str = "<bytes>") -> Optional[int]:
    """The decoded size the frame headers give, or None when a frame has no
    content size."""
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.ctpn_zstd_content_size(src.ctypes.data, src.size, err, _ERR_LEN)
    if n == -2:
        raise ValueError(f"{name}: zstd: {err.value.decode()}")
    return None if n == -1 else int(n)


def decompress(data, size: Optional[int] = None, name: str = "<bytes>",
               limit: Optional[int] = None) -> np.ndarray:
    """Decode the zstd frames of ``data`` (bytes-like) into a uint8 array.

    The output size comes from the frame headers; where a frame has none,
    ``size`` (the expected decoded size, e.g. a zarr chunk's byte size) must
    be given, or else ``limit``, a bound on it (an OCDBT node's
    ``max_decoded_node_bytes``). Output past that size, a corrupt frame or a
    checksum mismatch raises ``ValueError`` naming ``name``.
    """
    lib = _load()
    src = np.frombuffer(data, np.uint8)
    known = content_size(src, name)
    if known is not None and size is not None and known != size:
        raise ValueError(
            f"{name}: zstd frames hold {known} bytes, expected {size}")
    cap = next((c for c in (known, size, limit) if c is not None), None)
    if cap is None:
        raise ValueError(
            f"{name}: zstd frame without a content size and no expected size")
    if limit is not None and cap > limit:
        raise ValueError(f"{name}: zstd frames hold {cap} bytes, above {limit}")
    out = np.empty(cap, np.uint8)
    modes = (ctypes.c_int64 * len(_names))()
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.ctpn_zstd_decompress(src.ctypes.data, src.size, out.ctypes.data,
                                 cap, modes, err, _ERR_LEN)
    with _lock:
        MODES.update({k: v for k, v in zip(_names, modes) if v})
    if n < 0:
        raise ValueError(f"{name}: zstd: {err.value.decode()}")
    if known is None and size is None:  # bounded by ``limit`` only
        return out[:n].copy()
    if n != cap:
        raise ValueError(f"{name}: zstd frames decoded to {n} bytes, expected {cap}")
    return out
