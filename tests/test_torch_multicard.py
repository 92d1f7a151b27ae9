"""The multi-card certificate (``ctpn_tpu_torch.parallel.multicard``) on the
CPU at ``dryrun_multichip``'s sizes (``--small``): two gloo ranks for the
training leg, two CPU replicas for the detection and frozen legs.

It must pass its own gates (a falling loss over six steps; the 2-rank step
equal to one process within 1e-4 relative and 1e-3 * lr; DP detection equal
to one replica slice by slice and to one process on the whole batch in
counts; the DP frozen program equal to the live DP function), count no
kernel launch (the CPU runs the plain versions) and say that it ran on no
card.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))


def test_multicard_small_on_two_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "ctpn_tpu_torch.parallel.multicard", "--device", "cpu",
         "--devices", "2", "--small"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("multicard: CPU only (no card): training over 2 gloo ranks")
    report = json.loads(lines[-1][len("multicard "):])
    assert report["cards"] == 0 and report["replicas"] == 2 and report["ranks"] == 2
    train = report["training"]
    assert train["backend"] == "gloo"
    losses = train["descent"]["losses"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert all(v < losses[0] for v in losses[3:])
    assert train["parity"]["ranks"] == 2 and max(train["parity"]["rel_diff"].values()) <= 1e-4
    for route in ("default", "served"):
        row = report["inference"][route]
        assert row["equal_to_one_card_per_slice"] and row["per_replica_batch"] == 4
        assert row["worst_pair_px"] <= 0.5
        assert not any(row["launches_per_card"].values())
        counts = np.asarray(row["line_counts"])
        assert counts.sum() > 0 and (counts > 0).mean() >= 0.5
    frozen = report["frozen"]
    assert frozen["equal_to_live_dp"] and frozen["dp_devices"] == 2
    assert frozen["line_counts"] == report["inference"]["default"]["line_counts"]
    assert "dp_detect" not in report  # readings are taken on cards only
