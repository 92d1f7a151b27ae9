"""The port stands alone: ``ctpn_tpu_torch``, ``chip_smoke.py``,
``bench_torch.py`` and the port's scripts (``scripts/torch_*.py``) import
neither JAX, flax nor any module of ``ctpn_tpu`` (and ``bench_torch.py``
not ``bench.py``), TensorFlow only inside
the two reference readers of ``cli/convert_reference.py``, and the entry
points never drop to the CPU quietly.

The import check runs in a subprocess: this test process has JAX loaded
already (``tests/conftest.py``).
"""

import ast
import glob
import os
import os.path as osp
import pkgutil
import subprocess
import sys

import ctpn_tpu_torch

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
             "ctpn_tpu")
SCRIPTS = sorted(glob.glob(osp.join(REPO, "scripts", "torch_*.py")))

_PROBE = """
import importlib, importlib.util, pkgutil, sys
import ctpn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    ctpn_tpu_torch.__path__, "ctpn_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate({scripts!r}):  # the scripts, loaded by path
    spec = importlib.util.spec_from_file_location(f"_script{{i}}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {forbidden!r})
print(len(names))
print(",".join(bad))
print("tensorflow" in sys.modules)
print("bench" in sys.modules)
"""


def _module_names():
    return [m.name for m in pkgutil.walk_packages(
        ctpn_tpu_torch.__path__, "ctpn_tpu_torch.")]


def test_package_imports_no_jax_and_no_ctpn_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN),
                                             scripts=["chip_smoke.py", "bench_torch.py",
                                                      *SCRIPTS])],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True,
        env=dict(os.environ, PYTHONPATH=REPO),
    ).stdout.splitlines()
    assert int(out[0]) == len(_module_names()) >= 15
    assert out[1] == "", f"forbidden modules imported: {out[1]}"
    assert out[2] == "False", "importing the package imported tensorflow"
    assert out[3] == "False", "a script imported bench.py"
    # the walk covers the serving slice's modules and the rest of inference
    assert {
        "ctpn_tpu_torch.serving", "ctpn_tpu_torch.cli.serve",
        "ctpn_tpu_torch.inference.streaming", "ctpn_tpu_torch.ops.nms_bitmask",
        "ctpn_tpu_torch.ops.stem_fused", "ctpn_tpu_torch.inference.frozen",
        "ctpn_tpu_torch.inference.records", "ctpn_tpu_torch.cli.demo",
        "ctpn_tpu_torch.cli.export_model", "ctpn_tpu_torch.eval",
        "ctpn_tpu_torch.utils.host_ref", "ctpn_tpu_torch.utils.timer",
        "ctpn_tpu_torch.postprocess.oracle", "ctpn_tpu_torch.native",
        "ctpn_tpu_torch.cli.train_synth", "ctpn_tpu_torch.cli.eval_holdout",
        "ctpn_tpu_torch.cli.convert_reference", "ctpn_tpu_torch.parallel.mesh",
        "ctpn_tpu_torch.parallel.dp", "ctpn_tpu_torch.parallel.multicard",
        "ctpn_tpu_torch.ops._launches", "ctpn_tpu_torch.utils.orbax_io",
        "ctpn_tpu_torch.utils.zstd",
    } <= set(_module_names())


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
    """AST check of chip_smoke.py, bench_torch.py, the port's scripts and
    every module of the package (catches imports inside functions that the
    subprocess probe never runs); bench_torch.py imports no ``bench``."""
    assert {"torch_bench_serving.py", "torch_bench_serving_sustained.py",
            "torch_bench_streaming.py"} <= {osp.basename(p) for p in SCRIPTS}
    bench_torch = osp.join(REPO, "bench_torch.py")
    assert not _imported_roots(bench_torch) & {"bench", *FORBIDDEN}
    assert _imported_roots(bench_torch) <= {"json", "os", "subprocess", "sys", "time",
                                            "hashlib", "numpy", "torch",
                                            "ctpn_tpu_torch"}
    paths = [osp.join(REPO, "chip_smoke.py"), bench_torch, *SCRIPTS]
    for name in _module_names():
        rel = name.replace(".", osp.sep)
        pkg = osp.join(REPO, rel, "__init__.py")
        paths.append(pkg if osp.exists(pkg) else osp.join(REPO, rel + ".py"))
    for path in paths:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{osp.relpath(path, REPO)} imports {sorted(bad)}"


def test_tensorflow_only_inside_the_readers():
    """TensorFlow is imported nowhere in the package and ``chip_smoke.py``
    but inside ``vars_from_tf_checkpoint`` and ``vars_from_frozen_pb``."""
    readers = {"vars_from_tf_checkpoint", "vars_from_frozen_pb"}
    paths = [osp.join(REPO, "chip_smoke.py")] + [
        osp.join(REPO, *m.split(".")) + ".py" for m in _module_names()]
    found = []
    for path in paths:
        if not osp.exists(path):  # a package: its __init__ holds no import of TF
            continue
        tree = ast.parse(open(path).read(), filename=path)
        for fn in [None] + [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]:
            body = ast.walk(fn) if fn else ast.iter_child_nodes(tree)
            for node in body:
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom)
                         else [])
                if any(n.split(".")[0] == "tensorflow" for n in names):
                    found.append((osp.relpath(path, REPO), fn.name if fn else None))
    assert set(found) == {("ctpn_tpu_torch/cli/convert_reference.py", r) for r in readers}


_NO_CUDA = """
import contextlib, io
import torch
assert not torch.cuda.is_available()
from ctpn_tpu_torch.utils.weights import load_params
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.models.factory import get_network
from ctpn_tpu_torch.inference.frozen import FrozenCTPN, export_frozen
from ctpn_tpu_torch.cli import demo, eval_holdout, export_model
import tempfile
art = "data/artifacts/ctpn_synth_f16.npz"
root = tempfile.mkdtemp()
params = load_params(art, device="cpu")
for call in (lambda: CTPNPredictor(params), lambda: get_network("VGGnet_test"),
             lambda: load_params(art), lambda: FrozenCTPN("unused.npz"),
             lambda: export_frozen(params, "unused.npz"),
             lambda: demo.main(["--artifact", art, "--output", "unused"]),
             lambda: demo.main(["--frozen", "unused.npz", "--output", "unused"]),
             lambda: export_model.main(["--artifact", art, "--out", "unused.npz",
                                        "--frozen"]),
             lambda: eval_holdout.main(["--artifact", art, "--root", root,
                                        "--images", "0", "--holdout", "1"])):
    try:
        with contextlib.redirect_stdout(io.StringIO()):  # the CLIs' progress lines
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
