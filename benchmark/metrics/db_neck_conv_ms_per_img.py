"""Device ms per image of DBNet's FPN convs: the four 1x1 lateral convs
(the stage clock's ``neck.lateral``) and the four 3x3 smoothing convs
(``neck.smooth``), children of ``neck`` timed from the stamp before each
inside replays of the captured program (``drivers/craft_replay.stage_ms``),
divided by the batch."""

STAGES = ("neck.lateral", "neck.smooth")


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
