"""The whole step's share of the cards' bfloat16 peak: the traced run's
images per second over its whole window (host clock; the profiler is on
over the window's last seconds) times the model's operations per image
(at each image's resized size, ``flops.py``), over 989e12 per card. One
reader for every split of the metric (``mfu.offline``, ...)."""

import flops


def read(run):
    rate, per_img = run.readings.get("imgs_per_s"), run.readings.get("flops_per_img")
    if not rate or not per_img:
        return None
    return 100.0 * rate * per_img / (flops.BF16_TENSOR_OPS_PER_S * run.chips)
