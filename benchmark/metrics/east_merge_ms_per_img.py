"""Device ms per image of EAST's merge branch and heads: CUDA events at the
eager program's stage marks, from ``trunk`` to ``merge``, on one window
batch after the window, divided by the batch."""


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    return None if not stages else stages.get("merge")
