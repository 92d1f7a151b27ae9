"""Device ms per image of DBNet's binarize head up to stride 2: the 3x3
conv and the first transposed conv with their epilogues (the stage
clock's ``head.conv``, a child of ``head`` timed from the stamp before it)
inside replays of the captured program (``drivers/craft_replay.stage_ms``),
divided by the batch."""

STAGES = ("head.conv",)


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
