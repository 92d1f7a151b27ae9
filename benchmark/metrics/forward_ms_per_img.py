"""Device ms per image of the eager program's ``forward``
stage: CUDA events at the program's stage marks (``build_detect_fn(on_stage=)``)
on one window batch, after the window, divided by the batch."""


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    return None if not stages else stages.get("forward")
