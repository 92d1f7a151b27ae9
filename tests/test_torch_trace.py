"""The port's tracing (``ctpn_tpu_torch/utils/timer.py``) on the CPU.

* Off (the default), ``span`` records nothing and a profiler run shows no
  ``ctpn.*`` event.
* On, each span is counted in ``totals()`` and shows in a profiler run as
  ``ctpn.<name>``; ``add`` holds up under threads.
* The stage clock's plain version (``ctpn_torch::stage_stamp`` on a CPU
  tensor): four ordered stamps per row, a ring that wraps past ``ROWS``
  rows, and ``read(since_row)`` that skips rows from before; and, on
  stamps written into its ring by hand, the nesting rule: a parent reads
  the same with children as without, a child from the stamp before it,
  and a child out of its place is refused.
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


FLAT = ("start", "trunk", "neck", "head", "boxes")
NESTED = ("start", "trunk", "neck.a", "neck.b", "neck", "head.a", "head", "boxes")


def _written(stages, rows):
    """A CPU clock of ``stages`` whose ring holds ``rows``, each a dict of
    stage -> stamp in ns, as if the program had stamped them."""
    clock = timer.StageClock("cpu", stages)
    ring = clock.ring[:-1].view(timer.ROWS, len(stages))
    for i, row in enumerate(rows):
        ring[i] = torch.tensor([row[s] for s in stages])
    clock.ring[-1] = len(rows)
    return clock


def _runs(n=5, cover=True):
    """Made-up runs in ns: the parents' stamps as a flat program would
    stamp them, the children's between them; the last child of ``neck``
    ends on the parent's own stamp where ``cover``, 0.25 ms before it
    otherwise."""
    out = []
    for k in range(n):
        t0 = 10_000_000 * k
        row = {"start": t0, "trunk": t0 + 2_000_000, "neck": t0 + 3_500_000,
               "head": t0 + 4_250_000, "boxes": t0 + 5_000_000}
        row["neck.a"] = t0 + 2_000_000 + 400_000 + 1000 * k
        row["neck.b"] = row["neck"] - (0 if cover else 250_000)
        row["head.a"] = t0 + 4_000_000
        out.append(row)
    return out


def test_a_parent_reads_the_same_with_and_without_children():
    runs = _runs()
    flat, nested = _written(FLAT, runs).read(), _written(NESTED, runs).read()
    assert set(nested) == set(flat) | {"neck.a", "neck.b", "head.a"}
    assert {k: nested[k] for k in flat} == flat
    assert (flat["trunk"], flat["neck"], flat["head"], flat["boxes"]) == (2.0, 1.5, 0.75, 0.75)
    assert flat["between"] == 5.0 and flat["rows"] == 5


def test_each_child_is_timed_from_the_stamp_before_it():
    read = _written(NESTED, _runs()).read()
    # neck.a from trunk's stamp (the median of 0.400 .. 0.404 ms), neck.b
    # from neck.a's, head.a from neck's, and the parents from theirs
    assert read["neck.a"] == pytest.approx(0.402)
    assert read["neck.b"] == pytest.approx(1.5 - 0.402)
    assert read["head.a"] == pytest.approx(0.5)
    assert read["head"] == 0.75 and read["boxes"] == 0.75


@pytest.mark.parametrize("cover", [True, False])
def test_children_sum_to_their_parent_where_they_cover_it(cover):
    read = _written(NESTED, _runs(cover=cover)).read()
    gap = 0.0 if cover else 0.25
    assert read["neck.a"] + read["neck.b"] == pytest.approx(read["neck"] - gap)
    # head.a stops short of head: the rest is the parent's own
    assert read["head.a"] == pytest.approx(read["head"] - 0.25)


@pytest.mark.parametrize("stages", [
    ("start.a", "start", "trunk"),  # the tuple starts with a child
    ("start", "trunk", "trunk.a"),  # or ends with one
    ("start", "neck.a", "trunk", "neck"),  # before another stage than its parent
    ("start", "trunk", "neck", "neck.a", "head"),  # after its parent
    ("start", "trunk", "neck.a", "head.a", "neck", "head"),  # its parent not next
    ("start", "trunk", ".a", "neck"),  # no parent's name
])
def test_a_misplaced_child_raises(stages):
    with pytest.raises(ValueError):
        timer.StageClock("cpu", stages)

