"""step_mfu_pct: the whole step's share of the card's peak. The FLOPs of
each traced step's route (matrix products and convolutions, counted once at
set-up by ``FlopCounterMode`` over the reference on the meta device), over
the traced window's seconds and the peak of the configuration's stated
precision (``data/peaks.json``)."""

UNIT = "%"


def read(rec):
    tr = rec.trace
    peak = rec.peaks.get(rec.config["peak"])
    steps = [s for s in rec.steps if s.traced]
    if not tr or not tr.get("busy_s") or not peak or not steps:
        return None
    if any(s.route not in rec.counts for s in steps):
        return None
    flops = sum(rec.counts[s.route]["flops"] for s in steps)
    return 100.0 * flops / tr["window_s"] / peak
