"""Device ms per image of CRAFT's decoder (slice5's pool, fc6 and fc7, the
four U-net blocks and conv_cls): the stage clock's stamps inside replays
of the captured program, from ``trunk`` to ``decoder``, on one window
batch after the window (``drivers/craft_replay.stage_ms``), divided by
the batch."""


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    return None if not stages else stages.get("decoder")
