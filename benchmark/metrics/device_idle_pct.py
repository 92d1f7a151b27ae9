"""Share of the traced window in which no kernel, copy or set ran on the
card (mean over the cards used): 100 * (1 - busy / window). One reader for
every split of the metric (``device_idle_pct.offline``, ...)."""


def read(run):
    trace = run.readings.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
