"""The fused NMS kernel's share of its roofline: the least time of one
program run's two launches (``flops.nms_bound_s``: bytes at the HBM rate
or the IoU pair tests that greedy NMS needs on the reference's own
proposals at the float32 peak) over the kernel's traced time per run."""


def read(run):
    trace, work = run.readings.get("trace"), run.readings.get("nms_fused")
    if not trace or not work:
        return None
    k = trace["kernels"]
    hits = [v for name, v in k.items() if "nms_fused_kernel" in name]
    n = sum(v["n"] for v in hits)
    if n == 0:
        return None
    per_run = sum(v["s"] for v in hits) / (n / work["launches_per_run"])
    return 100.0 * work["bound_s_per_run"] / per_run
