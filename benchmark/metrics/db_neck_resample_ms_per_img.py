"""Device ms per image of DBNet's FPN resampling: the three top-down
upsample-and-add passes (the stage clock's ``neck.topdown``) and the
three upsamples to stride 4 with the four-way concat (``neck.fuse``),
children of ``neck`` timed from the stamp before each inside replays of
the captured program (``drivers/craft_replay.stage_ms``), divided by the
batch."""

STAGES = ("neck.topdown", "neck.fuse")


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
