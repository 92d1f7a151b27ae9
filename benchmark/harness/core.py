"""The run of one cell: its files, its guards, its clock and its result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
files are found by those names (``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json``), and the traffic
file names the driver (``drivers/<driver>.py``) that runs it. A driver
fills :class:`Run`; the per-layer metrics are read from it by the readers
in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]

# top-level module names that nothing the benchmark runs may load: JAX and
# its libraries, the JAX package and its bench scripts. Compared whole, so
# the port's ``ctpn_tpu_torch`` is not ``ctpn_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ctpn_tpu", "bench",
             "bench_torch")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({str(n).split(".")[0] for n in list(names)} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().replace("\n", "; ")


class Run:
    """One run of one cell: the arguments, the cell's files, what the
    driver measured, the readings the per-layer readers take, and the
    comparison's numbers.

    ``device`` is "cuda" on the card; the CPU only in the tests, which
    drive the harness at tiny sizes (``overrides`` then replaces entries
    of the config and traffic files).
    """

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 root: Path, device: str = "cuda",
                 overrides: Optional[Dict[str, Dict[str, Any]]] = None):
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.root = Path(root)
        self.device = device
        bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        self.bench = bench
        self.config = load_json(BENCH_DIR / "configs" / f"{self.cell['config']}.json")
        self.traffic = load_json(BENCH_DIR / "traffic" / f"{self.cell['traffic']}.json")
        self.limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
        for key, extra in (overrides or {}).items():
            getattr(self, key).update(extra)
        self.chips = int(self.cell["chips"])
        # end-to-end metrics, host clock
        self.attempted = 0
        self.failed = 0
        self.e2e: Dict[str, float] = {}
        self.window_start: Optional[float] = None
        self.setup_s: Optional[float] = None
        # what the per-layer readers read (spans, counters, the trace)
        self.readings: Dict[str, Any] = {}
        self.breakdown: Optional[Dict[str, list]] = None
        # the comparison: name -> (value, limit)
        self.compared: Dict[str, tuple] = {}
        self.notes: Dict[str, Any] = {}
        self.memory_peak_bytes = 0
        self.fault: Optional[Callable] = None  # tests: breaks the timed path

    # -------------------------------------------------------------- clock
    def start_window(self) -> float:
        """Ends set-up; returns the window's start (perf_counter)."""
        self.setup_s = process_age_s()
        self.window_start = time.perf_counter()
        return self.window_start

    def window_end(self) -> float:
        return self.window_start + self.seconds

    def read_memory_peak(self) -> None:
        """The peak of allocated memory on the fullest card used, read once
        the window has closed and before the reference runs."""
        if self.device != "cuda":
            return
        import torch

        self.memory_peak_bytes = max(torch.cuda.max_memory_allocated(i)
                                     for i in range(self.chips))

    def log(self, msg: str) -> None:
        print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def apply_program_config(config: Dict[str, Any]) -> None:
    """Set the port's cfg to the configuration as it is run: the TEST and
    TEXT values, the compute type, the mode and the route."""
    from ctpn_tpu_torch.config import cfg, cfg_from_list, reset_cfg

    reset_cfg()
    pairs: List[Any] = []
    for section in ("TEST", "TEXT"):
        for k, v in config[section].items():
            pairs += [f"{section}.{k}", v]
    pairs += ["TEST.DETECT_MODE", config["mode"],
              "TPU.COMPUTE_DTYPE", config["compute_dtype"],
              "TPU.BUCKETS", [list(b) for b in config["buckets"]]]
    for k, v in config["program"].items():
        pairs += [k, v]
    cfg_from_list(pairs)
    if cfg.TEST.DETECT_MODE != config["mode"]:
        raise RuntimeError("the port's cfg did not take the configuration")


def weights_path(run: Run) -> Path:
    """The configuration's weights file, checked against its digest."""
    import hashlib

    w = run.config["weights"]
    path = run.root / w["file"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != w["sha256"]:
        raise RuntimeError(f"{path}: sha256 {digest} is not the configuration's "
                           f"{w['sha256']}")
    return path
