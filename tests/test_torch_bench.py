"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

* The port's real and noise batches equal ``bench.py``'s bit for bit (batch
  3, 608x912; ``bench.py`` loaded as a module: only its ``main`` imports
  JAX; its reference photographs absent, as the port reads none), and so
  does the artifact's fingerprint.
* The records of the bench's timed function (``_time_detect`` on a CPU
  predictor: the kernels' plain versions) against the JAX package's jitted
  ``build_detect_fn`` on the same real-content arrays, shipped weights in
  float32, in the 192x288 bucket: line counts exact, records paired
  one-to-one within 0.5 px (``__graft_entry__.py::_rows_match``).
* The records gate raises when the replayed records differ from the eager
  program's (a stub predictor), and passes within 0.5 px.
* The supervisor, in a subprocess: with CUDA hidden and ``BENCH_DEVICE``
  unset, one parseable line with ``value`` null, an error naming CUDA, rc 0,
  ``attempts`` equal to ``BENCH_RETRIES`` and no timing; with
  ``BENCH_DEVICE=cpu`` (a 192x288 bucket through ``BENCH_CFG_SET``), a line
  with every key of ``bench.py``'s success line and the port's own.
"""

import importlib.util
import json
import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ctpn_tpu.config import cfg as jcfg
from ctpn_tpu.inference.pipeline import CTPNPredictor as JaxPredictor
from ctpn_tpu.inference.pipeline import build_detect_fn as jax_build_detect
from ctpn_tpu.utils.weights import load_params as jax_load_params
from ctpn_tpu_torch.config import cfg, reset_cfg
from ctpn_tpu_torch.inference.graphs import DetectGraphs
from ctpn_tpu_torch.inference.pipeline import CTPNPredictor
from ctpn_tpu_torch.parallel.multicard import pair_rows
from ctpn_tpu_torch.postprocess.connector import TextLines
from ctpn_tpu_torch.utils.weights import load_params

torch.set_num_threads(2)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
SMALL = {"TPU.COMPUTE_DTYPE": "float32", "TPU.BUCKETS": [[192, 288]],
         "TEST.SCALES": (192,), "TEST.MAX_SIZE": 288}
# the same settings for the bench's child, through BENCH_CFG_SET
SMALL_SET = "TPU.COMPUTE_DTYPE float32 TPU.BUCKETS [[192,288]] TEST.SCALES [192] " \
            "TEST.MAX_SIZE 288"
# the keys of bench.py's success line (its main), and the port's additions
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "content",
              "noise_imgs_per_sec", "artifact"}
PORT_KEYS = {"device", "power_limit_w", "cards", "route", "batch", "iters", "attempts"}


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", osp.join(REPO, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench = _load("bench")
bench_torch = _load("bench_torch")


@pytest.fixture(autouse=True)
def _fresh_torch_cfg():
    reset_cfg()
    yield
    reset_cfg()


def _set_both(pairs):
    for c in (jcfg, cfg):
        for key, value in pairs.items():
            section, name = key.split(".")
            c[section][name] = value


@pytest.mark.parametrize("which", ["_real_batch", "_noise_batch"])
def test_batches_equal_bench_py_bit_for_bit(which, monkeypatch, tmp_path):
    # bench.py's rule where its reference photographs are absent: renders in
    # every slot, whatever the machine holds
    monkeypatch.setattr(bench, "REF_DEMO", str(tmp_path / "absent"))
    images, infos = getattr(bench_torch, which)(3, 608, 912)
    want_images, want_infos = getattr(bench, which)(3, 608, 912)
    assert images.dtype == want_images.dtype == np.uint8
    assert infos.dtype == want_infos.dtype
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(infos, want_infos)
    assert images.shape == (3, 608, 912, 3)


def test_artifact_fingerprint_equals_bench_py():
    assert bench_torch._artifact_fingerprint() == bench._artifact_fingerprint()


def test_timed_records_match_jax_build_detect_fn():
    _set_both(SMALL)
    images, infos = bench_torch._real_batch(2, 192, 288)
    pred = CTPNPredictor(load_params(bench_torch.ARTIFACT, device="cpu"), mode="H",
                         device="cpu")
    seconds, lines, row = bench_torch._time_detect(pred, images, infos, 1)
    assert seconds > 0 and row["records_worst_px"] == 0.0
    assert row["launches_per_batch"] == {}  # the plain versions count nothing
    jp = JaxPredictor(jax_load_params(bench_torch.ARTIFACT), mode="H")
    _, jlines = jax.jit(jax_build_detect(jp.model, mode="H"))(jp.params, images, infos)
    counts = lines.count.numpy()
    np.testing.assert_array_equal(counts, np.asarray(jlines.count))
    recs, jrecs = lines.recs.numpy(), np.asarray(jlines.recs)
    for i, c in enumerate(counts):
        assert pair_rows(recs[i, :c], jrecs[i, :c]) <= 0.5
    assert counts.sum() > 0  # the comparison saw real lines


def _lines(recs, count):
    recs = torch.as_tensor(np.asarray(recs, np.float32))
    count = torch.as_tensor(np.asarray(count, np.int32))
    return TextLines(recs, torch.arange(recs.shape[1])[None] < count[:, None], count)


class StubPredictor:
    """A predictor whose captured program (``graphs``) and eager program
    (``program``) answer with fixed lines."""

    device = torch.device("cpu")

    def __init__(self, replayed, eager):
        self.replayed, self.eager = replayed, eager

    def graphs(self, images, im_info):
        return None, self.replayed

    def program(self, images, im_info):
        return None, self.eager


_RECS = np.arange(2 * 3 * 9, dtype=np.float32).reshape(2, 3, 9) * 7.0


@pytest.mark.parametrize("shift, count, error", [
    (0.0, [3, 2], None),
    (0.4, [3, 2], None),
    (0.6, [3, 2], "px from the eager"),
    (0.0, [3, 1], "line counts"),
])
def test_records_gate(shift, count, error):
    moved = _RECS.copy()
    moved[1, 1, 4] += shift
    pred = StubPredictor(_lines(moved, count), _lines(_RECS, [3, 2]))
    images, infos = bench_torch._noise_batch(2, 16, 16)
    if error is None:
        _, _, row = bench_torch._time_detect(pred, images, infos, 2)
        assert row["records_worst_px"] == pytest.approx(shift, abs=1e-5)
    else:
        with pytest.raises(RuntimeError, match=error):
            bench_torch._time_detect(pred, images, infos, 2)


def test_detect_graphs_refuse_tensors_on_another_device():
    graphs = DetectGraphs(lambda x, info: (x, info), torch.device("cpu"))
    with pytest.raises(ValueError, match="tensors on cpu"):
        graphs(torch.empty(1, 4, 4, 3, device="meta"), np.zeros((1, 3), np.float32))


@pytest.mark.parametrize("message", [
    "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 2.00 GiB",
    "nvcc fatal   : Unsupported gpu architecture 'compute_90a'",
    "CUDA kernel errors might be asynchronously reported at some other API call",
])
def test_null_line_keeps_cuda_and_nvcc_messages(message):
    # the message sits above more than six lines of traceback scaffolding,
    # so it survives only by the filter, not as the output's tail
    scaffold = [f"  File \"m{i}.py\", line {i}, in f" for i in range(8)]
    text = "\n".join(["Traceback (most recent call last):", message, *scaffold])
    assert message in bench_torch._salient(text)


def _run_bench(**env):
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    base.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2", BENCH_BACKOFF_S="0", **env)
    proc = subprocess.run([sys.executable, osp.join(REPO, "bench_torch.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=base)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and len(lines) == 1, (proc.stdout, proc.stderr)
    return json.loads(lines[0]), proc.stderr


def test_supervisor_without_a_card_prints_the_null_line():
    line, err = _run_bench(CUDA_VISIBLE_DEVICES="", BENCH_RETRIES="2")
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["metric"] == bench.METRIC and line["unit"] == "images/sec"
    assert "CUDA" in line["error"] and line["attempts"] == 2
    assert "device" not in line  # nothing was timed, on the CPU or elsewhere
    assert bench_torch.REPORT not in err


def test_supervisor_on_the_cpu_prints_bench_py_keys():
    line, err = _run_bench(BENCH_DEVICE="cpu", BENCH_BATCH="1", BENCH_ITERS="1",
                           BENCH_CFG_SET=SMALL_SET)
    assert BENCH_KEYS | PORT_KEYS <= set(line)
    assert line["metric"] == bench.METRIC and line["content"] == "real"
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert (line["cards"], line["batch"], line["iters"], line["attempts"]) == (1, 1, 1, 1)
    assert line["route"] == {"TPU.NMS_FUSED": True, "TPU.FUSED_STEM": False}
    assert line["artifact"] == bench._artifact_fingerprint()
    assert line["value"] > 0 and line["noise_imgs_per_sec"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 125.0, abs=1e-3)
    (report,) = [json.loads(ln[len(bench_torch.REPORT):]) for ln in err.splitlines()
                 if ln.startswith(bench_torch.REPORT)]
    assert report["bucket"] == [192, 288] and set(report["rows"]) == {"noise", "real"}
    assert all(r["records_worst_px"] == 0.0 for r in report["rows"].values())
