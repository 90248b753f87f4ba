"""100 - the union of the device's kernel, copy and set intervals over the
profiled stretch's span (%)."""


def read(run):
    t = run.trace or {}
    if not t.get("span_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
