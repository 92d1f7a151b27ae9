"""Device ms per image of DBNet's decoder: the FPN (``neck``) and the
binarize head to the stride-1 map (``head``), from the stage clock's
stamps inside replays of the captured program
(``drivers/craft_replay.stage_ms``), divided by the batch."""

STAGES = ("neck", "head")


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
