"""The deformable sites' share of their roofline: the least time of the 13
sites of one image (``flops_db.dcn_bound_s``: per site the larger of its
operations at the bfloat16 peak and its bytes at the HBM rate, no column
buffer counted) over their stamped device time per image (the stage
clock's ``dcnNN_out`` stages summed, as ``db_dcn_ms_per_img`` reads them)."""


def read(run):
    bound, stages = run.readings.get("dcn_bound_ms_per_img"), run.readings.get("stage_ms_per_img")
    if not bound or not stages:
        return None
    ms = sum(v for k, v in stages.items() if k.startswith("dcn") and k.endswith("_out"))
    return 100.0 * bound / ms if ms > 0 else None
