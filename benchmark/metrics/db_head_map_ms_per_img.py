"""Device ms per image of DBNet's stride-1 map: the float32 one-channel
transposed conv as a matmul, its 2x2 interleave and the sigmoid (the
stage clock's ``head.map``, a child of ``head`` timed from the stamp
before it) inside replays of the captured program
(``drivers/craft_replay.stage_ms``), divided by the batch."""

STAGES = ("head.map",)


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
