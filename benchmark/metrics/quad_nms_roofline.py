"""The quad suppression bitmask kernel's share of its roofline: the least
time of one program run's bitmask (``flops_east.quad_bitmask_bound_s``:
its words written at the HBM rate, or the IoU tests of the reference's own
greedy NMS at the float32 peak) over the kernel's traced time per run."""


def read(run):
    trace, work = run.readings.get("trace"), run.readings.get("quad_bitmask")
    if not trace or not work:
        return None
    hits = [v for name, v in trace["kernels"].items() if "quad_bitmask_kernel" in name]
    n = sum(v["n"] for v in hits)
    if n == 0:
        return None
    per_run = sum(v["s"] for v in hits) / (n / work["launches_per_run"])
    return 100.0 * work["bound_s_per_run"] / per_run
