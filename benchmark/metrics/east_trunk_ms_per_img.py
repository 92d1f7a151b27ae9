"""Device ms per image of EAST's trunk (the VGG16 taps, mean subtract
included): CUDA events at the eager program's stage marks, from ``start``
to ``trunk`` (``build_east_detect_fn(on_stage=)``), on one window batch
after the window, divided by the batch."""


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    return None if not stages else stages.get("trunk")
