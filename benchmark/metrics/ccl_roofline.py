"""The labelling kernels' share of their roofline: the least time of one
program run's labelling (``flops_craft.ccl_bound_s``: the maps read and the
labels written over the extents, and the kept components' records, at the
HBM rate, on the reference's own components) over the traced time of its
four kernels (``ccl_label_*_kernel``) per run."""


def read(run):
    trace, work = run.readings.get("trace"), run.readings.get("ccl_label")
    if not trace or not work:
        return None
    hits = [v for name, v in trace["kernels"].items() if "ccl_label_" in name]
    n = sum(v["n"] for v in hits)
    if n == 0:
        return None
    per_run = sum(v["s"] for v in hits) / (n / work["launches_per_run"])
    return 100.0 * work["bound_s_per_run"] / per_run
