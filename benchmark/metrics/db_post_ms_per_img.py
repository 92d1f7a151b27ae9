"""Device ms per image of DBNet's post-process (the 8-connected labelling
and the scored, unclipped boxes): the stage clock's stamps inside replays
of the captured program, from ``head`` to the end (``label`` and
``boxes``) (``drivers/craft_replay.stage_ms``), divided by the batch."""

STAGES = ("label", "boxes")


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
