"""Device ms per image of DBNet's 13 deformable sites (each the offset
conv, the sampling and the product with its epilogue): the stage clock's
``dcnNN_out`` stages (from the stamp before each site to the one after
it) inside replays of the captured program, summed
(``drivers/craft_replay.stage_ms``), divided by the batch."""


def read(run):
    stages = run.readings.get("stage_ms_per_img")
    if not stages:
        return None
    sites = [v for k, v in stages.items() if k.startswith("dcn") and k.endswith("_out")]
    return sum(sites) if sites else None
