"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the device (the union of the trace's device intervals)."""

UNIT = "%"


def read(rec):
    tr = rec.trace
    if not tr or not tr.get("busy_s") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
