"""Device ms per image of DBNet's trunk (the normalisation, the stem and
the four bottleneck stages, the 13 deformable sites among them): the stage
clock's stamps inside replays of the captured program, from ``start`` to
``trunk`` (every stage between them summed), on one window batch after the
window (``drivers/craft_replay.stage_ms``), divided by the batch."""


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages or "trunk" not in stages:
        return None
    return sum(v for k, v in stages.items() if k.startswith("dcn") or k == "trunk")
