"""The harness end to end on the CPU at tiny sizes (``tiny.py``): every
cell prints the contract's last line, a broken timed path makes
``correct`` false, and the run refuses what it must refuse."""

import json
import shutil
import subprocess
import sys
import types

import pytest

from conftest import BENCH, ROOT
from harness.core import forbidden_modules, load_json

CELLS = [w["name"] for w in load_json(ROOT / "BENCHMARK.json")["workloads"]]
TINY = str(BENCH / "tests" / "tiny.py")


def _run_tiny(*args, timeout=240):
    proc = subprocess.run([sys.executable, TINY, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("workload", CELLS)
def test_cell_prints_the_result_line(workload):
    out, err = _run_tiny(workload)
    bench = load_json(ROOT / "BENCHMARK.json")
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]}
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == want
    assert out["compared"]
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["count"] == {w["name"]: w for w in bench["workloads"]}[workload]["chips"]
    # the compared numbers are the last lines of standard error
    tail = err.strip().splitlines()[-len(out["compared"]):]
    assert [t.split(":")[0] for t in tail] == [f"compared {k}" for k in out["compared"]]


@pytest.mark.parametrize("workload", ["h_device_b48"])
def test_traced_run_prints_per_layer_metrics_only(workload):
    out, _ = _run_tiny(workload, "1")
    bench = load_json(ROOT / "BENCHMARK.json")
    per_layer = {m["name"] for m in bench["per_layer"]}
    assert set(out["metrics"]) <= per_layer
    assert out["correct"] is True


BROKEN = [(w, f) for w in CELLS for f in ("shift", "half")]


@pytest.mark.parametrize("workload,fault", BROKEN)
def test_broken_timed_path_is_not_correct(workload, fault):
    out, _ = _run_tiny(workload, "0", fault)
    assert out["correct"] is False, out["compared"]


def test_every_per_layer_metric_has_a_reader():
    import run as R

    for m in load_json(ROOT / "BENCHMARK.json")["per_layer"]:
        path = R.reader_path(m["name"])
        assert path.exists(), m["name"]
        assert callable(getattr(R.load_module(path, "reader_check"), "read", None))
    assert R.reader_path("mfu.offline").name == "mfu.py"
    assert R.reader_path("nms_fused_roofline").name == "nms_fused_roofline.py"


def test_no_jax_check_compares_whole_top_level_names():
    assert forbidden_modules({"ctpn_tpu_torch", "ctpn_tpu_torch.serving", "numpy"}) == []
    assert forbidden_modules({"ctpn_tpu.ops.nms", "numpy"}) == ["ctpn_tpu"]
    assert forbidden_modules({"jax", "jax.numpy"}) == ["jax"]
    assert forbidden_modules({"jaxlib", "flax.linen", "bench", "bench_torch"}) == [
        "bench", "bench_torch", "flax", "jaxlib"]


@pytest.mark.parametrize("name", ["jax", "ctpn_tpu"])
def test_run_refuses_when_a_forbidden_module_is_loaded(monkeypatch, name):
    import run as R

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    args = R.parse(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    with pytest.raises(SystemExit) as e:
        R.execute(args, ROOT)
    assert e.value.code == 3


def test_run_refuses_without_a_card(monkeypatch):
    import torch

    import run as R

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = R.parse(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    with pytest.raises(SystemExit) as e:
        R.execute(args, ROOT)
    assert e.value.code == 2


def test_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_trace_summary_takes_the_union_inside_the_harness_spans():
    import torch

    from harness.trace import summarize

    def ev(name, start, end, device=None):
        kind = torch.autograd.DeviceType.CUDA if device is not None else torch.autograd.DeviceType.CPU
        return types.SimpleNamespace(name=name, device_type=kind, device_index=device or 0,
                                     time_range=types.SimpleNamespace(start=start, end=end))

    events = [ev("bench.replay", 100, 1100), ev("bench.fetch", 1100, 2100),
              ev("k1", 0, 400, 0), ev("k2", 300, 600, 0),  # overlap; starts before the window
              ev("k3", 1000, 1500, 0), ev("bench.replay", 200, 300, 0)]  # a span's device copy
    out = summarize(events, window_s=99.0, cards=[0])
    assert out["window_s"] == pytest.approx(2000 / 1e6)
    assert out["busy_s"] == pytest.approx((500 + 500) / 1e6)
    assert out["kernels"]["k1"]["n"] == 1 and "bench.replay" not in out["kernels"]
    assert out["breakdown"]["idle_gaps"][0] == ["bench.replay", pytest.approx(400 / 1e6)]
