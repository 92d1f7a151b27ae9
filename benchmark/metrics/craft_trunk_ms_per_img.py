"""Device ms per image of CRAFT's trunk (the normalisation and the VGG16
taps up to conv5_2): the stage clock's stamps inside replays of the
captured program, from ``start`` to ``trunk``, on one window batch after
the window (``drivers/craft_replay.stage_ms``), divided by the batch."""


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    return None if not stages else stages.get("trunk")
