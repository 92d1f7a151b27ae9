"""The port stands alone: ``ctpn_tpu_torch`` and ``chip_smoke.py`` import
neither JAX, flax nor any module of ``ctpn_tpu``, and the entry points never
drop to the CPU quietly.

The import check runs in a subprocess: this test process has JAX loaded
already (``tests/conftest.py``).
"""

import ast
import os
import os.path as osp
import pkgutil
import subprocess
import sys

import ctpn_tpu_torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ctpn_tpu")

_PROBE = """
import importlib, pkgutil, sys
import ctpn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    ctpn_tpu_torch.__path__, "ctpn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names))
print(",".join(bad))
"""


def _module_names():
    return [m.name for m in pkgutil.walk_packages(
        ctpn_tpu_torch.__path__, "ctpn_tpu_torch.")]


def test_package_imports_no_jax_and_no_ctpn_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
        env=dict(os.environ, PYTHONPATH=REPO),
    ).stdout.splitlines()
    assert int(out[0]) == len(_module_names()) >= 15
    assert out[1] == "", f"forbidden modules imported: {out[1]}"


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_name_no_forbidden_import():
    """AST check of chip_smoke.py and every module of the package (catches
    imports inside functions that the subprocess probe never runs)."""
    paths = [osp.join(REPO, "chip_smoke.py")]
    for name in _module_names():
        rel = name.replace(".", osp.sep)
        pkg = osp.join(REPO, rel, "__init__.py")
        paths.append(pkg if osp.exists(pkg) else osp.join(REPO, rel + ".py"))
    for path in paths:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{osp.relpath(path, REPO)} imports {sorted(bad)}"


_NO_CUDA = """
import torch
assert not torch.cuda.is_available()
from ctpn_tpu_torch.utils.weights import load_params
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.models.factory import get_network
params = load_params("data/artifacts/ctpn_synth_f16.npz", device="cpu")
for call in (lambda: CTPNPredictor(params), lambda: get_network("VGGnet_test"),
             lambda: load_params("data/artifacts/ctpn_synth_f16.npz")):
    try:
        call()
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise SystemExit("an entry point ran without CUDA")
print("ok")
"""


def test_entry_points_raise_without_cuda():
    """With CUDA hidden, the default device raises instead of running on
    the CPU."""
    out = subprocess.run(
        [sys.executable, "-c", _NO_CUDA], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
                 OMP_NUM_THREADS="2"),
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
