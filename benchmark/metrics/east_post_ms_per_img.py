"""Device ms per image of EAST's post-process (threshold, compaction and
RBOX restore, the locality-aware walk, quad NMS and records): CUDA events
at the eager program's stage marks, from ``merge`` to the end (``decode``,
``lanms`` and ``quad_nms``), on one window batch after the window, divided
by the batch."""

STAGES = ("decode", "lanms", "quad_nms")


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
