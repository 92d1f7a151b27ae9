"""Device ms per image of CRAFT's post-process (the connected components
and the minimum-area boxes): the stage clock's stamps inside replays of
the captured program, from ``decoder`` to the end (``label`` and
``boxes``), on one window batch after the window
(``drivers/craft_replay.stage_ms``), divided by the batch."""

STAGES = ("label", "boxes")


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or not all(s in stages for s in STAGES):
        return None
    return sum(stages[s] for s in STAGES)
