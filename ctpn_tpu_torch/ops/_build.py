"""Build the hand-written CUDA kernels and the host C++ library at first use
and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a``, and each
``ops/csrc/<name>.cpp`` (host code: ``native.py``'s geometry) with the host
C++ compiler, into a shared library with a plain C interface, under
``ctpn_tpu_torch/_build/`` (git-ignored). The library's file name carries a
hash of the source and flags, so an edited source rebuilds. Nothing here
runs at import time: the CPU tests import every module of the package on a
machine with no ``nvcc``.

Each C entry point takes its pointers and the stream as ``void*`` and
returns ``cudaGetLastError()``; ``ops/_kernel.py`` declares its
``argtypes`` once and raises on a non-zero return.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "ops" / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)
# per-source extra flags: the NMS IoU test, the chain walk's sums,
# CRAFT's and DB's box corners and the bilinear blends must round exactly as the plain
# versions do, so no multiply-add contraction but the blend's own
# (``__fmaf_rn``)
EXTRA_FLAGS: Dict[str, Sequence[str]] = {
    "chain_walk": ("-fmad=false",),
    "craft_ccl": ("-fmad=false",),
    "deform_conv": ("-fmad=false",),
    "nms_fused": ("-fmad=false",),
    "nms_bitmask": ("-fmad=false",),
    "quad_nms": ("-fmad=false",),
    "resize_concat": ("-fmad=false",),
}

# host C++: no -march=native and no contraction of a*b+c into an FMA, which
# would move the last bit of an IoU (and so an NMS decision at the
# threshold) against the numpy oracles
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")


def cxx() -> Optional[str]:
    """Path of the host C++ compiler (``$CXX``, then ``g++``, ``c++``), or
    None when there is none."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    return None


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(name: str) -> Sequence[str]:
    if _source(name).suffix == ".cpp":
        return CXX_FLAGS
    return NVCC_FLAGS + tuple(EXTRA_FLAGS.get(name, ()))


def _compiler(name: str) -> str:
    if _source(name).suffix == ".cu":
        return nvcc()
    found = cxx()
    if found is None:
        raise RuntimeError("no host C++ compiler found: set CXX")
    return found


def library_path(name: str) -> Path:
    src = _source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, one compiler
    process per source (``nvcc`` for ``.cu``, the host C++ compiler for
    ``.cpp``), all started together. Returns each started build's compiler
    output (for a kernel, the ``-Xptxas=-v`` register and shared-memory
    report); raises with the output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_compiler(name), *_flags(name), "-o", str(tmp), str(_source(name))]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "compiler failed for "
            + ", ".join(failed)
            + "\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``ops/csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
