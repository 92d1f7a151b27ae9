"""The port's tracing (``ctpn_tpu_torch/utils/timer.py``) on the CPU.

* Off (the default), ``span`` records nothing and a profiler run shows no
  ``ctpn.*`` event.
* On, each span is counted in ``totals()`` and shows in a profiler run as
  ``ctpn.<name>``; ``add`` holds up under threads.
* The stage clock's plain version (``ctpn_torch::stage_stamp`` on a CPU
  tensor): four ordered stamps per row, a ring that wraps past ``ROWS``
  rows, and ``read(since_row)`` that skips rows from before.
"""

import sys
import threading
import time

import pytest
import torch

from ctpn_tpu_torch.utils import timer

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _tracing_restored():
    was = timer.enabled()
    timer.reset()
    yield
    timer.enable(was)
    timer.reset()


def _profiled_names(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _spans():
    for name in ("a", "a", "b"):
        with timer.span(name):
            time.sleep(0.002)


def test_tracing_off_records_nothing():
    timer.enable(False)
    assert not timer.enabled()
    assert timer.span("a") is timer.span("b")  # the shared nullcontext
    names = _profiled_names(_spans)
    assert not [n for n in names if n.startswith("ctpn.")]
    assert timer.totals() == {}


def test_tracing_on_counts_each_span():
    timer.enable(True)
    names = _profiled_names(_spans)
    assert {"ctpn.a", "ctpn.b"} <= names
    got = timer.totals()
    assert got["a"]["n"] == 2 and got["b"]["n"] == 1
    assert got["a"]["s"] >= 0.004 and got["a"]["max_s"] >= 0.002
    assert got["a"]["max_s"] <= got["a"]["s"]
    timer.add("wait", 0.5)
    timer.add("wait", 0.25)
    assert timer.totals()["wait"] == {"n": 2, "s": 0.75, "max_s": 0.5}
    timer.reset()
    assert timer.totals() == {}


def test_span_propagates_an_error_and_still_counts():
    timer.enable(True)
    with pytest.raises(KeyError):
        with timer.span("x"):
            raise KeyError("inside")
    assert timer.totals()["x"]["n"] == 1


def test_totals_lose_no_interval_under_threads():
    timer.enable(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                timer.add("t", 1.0)
                with timer.span("s"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = timer.totals()
    assert got["t"]["n"] == 24000 and got["t"]["s"] == 24000.0
    assert got["s"]["n"] == 24000


def _stamp_rows(clock, n):
    for _ in range(n):
        for name in timer.STAGES:
            clock.stamp(name)


def test_cpu_stage_clock_orders_wraps_and_skips():
    clock = timer.StageClock("cpu")
    assert clock.row() == 0 and clock.read() is None
    _stamp_rows(clock, 3)
    rows = clock.ring[:-1].reshape(timer.ROWS, len(timer.STAGES))[:3]
    assert bool((rows[:, 1:] >= rows[:, :-1]).all())  # the four stamps in order
    assert bool((rows[1:, 0] >= rows[:-1, -1]).all())  # and the rows
    first = clock.read()
    assert first["rows"] == 3
    assert set(first) == {"forward", "proposal_layer", "detect_lines", "between", "rows"}
    assert all(first[k] >= 0 for k in first)

    _stamp_rows(clock, timer.ROWS + 40)  # the ring comes round
    done = 3 + timer.ROWS + 40
    assert clock.row() == done
    assert clock.read(0)["rows"] == timer.ROWS - 1  # the oldest row may be torn
    assert clock.read(done - 5)["rows"] == 5  # rows from before are skipped
    assert clock.read(done) is None
    one = clock.read(done - 1)
    assert one["rows"] == 1 and "between" not in one


def test_half_stamped_run_is_not_read():
    clock = timer.StageClock("cpu")
    _stamp_rows(clock, 2)
    clock.stamp("start")
    clock.stamp("forward")  # a run still on its way
    assert clock.row() == 2 and clock.read()["rows"] == 2
