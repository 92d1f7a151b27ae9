"""The box kernel's share of its roofline: the least time of one program
run's boxes (``flops_db.boxes_bound_s``: each taken component's bounding
box of labels and probabilities read, its statistics read and its record
written, at the HBM rate, on the reference's own components) over the
traced time of ``db_boxes_kernel`` per run."""


def read(run):
    trace, work = run.readings.get("trace"), run.readings.get("db_boxes")
    if not trace or not work:
        return None
    hits = [v for name, v in trace["kernels"].items() if "db_boxes_kernel" in name]
    n = sum(v["n"] for v in hits)
    if n == 0:
        return None
    per_run = sum(v["s"] for v in hits) / (n / work["launches_per_run"])
    return 100.0 * work["bound_s_per_run"] / per_run
