"""warp_roofline: the windowed warp kernels' share of their roofline. The
bytes each warp of a step needs (image and flow read once, output written
once, in the stated dtypes; recorded by the reference's warp on the meta
device), over the card's HBM bandwidth, divided by the device time of the
kernels whose names the configuration lists (``warp_kernels``) in the
trace. It reads the same work whatever implements the warp."""

UNIT = "%"


def read(rec):
    tr = rec.trace
    bw = rec.peaks.get("hbm_bytes_per_s")
    steps = [s for s in rec.steps if s.traced]
    if not tr or not tr.get("busy_s") or not bw or not steps:
        return None
    if any(s.route not in rec.counts for s in steps):
        return None
    names = rec.config["warp_kernels"]
    kernel_s = sum(v for n, v in tr["kernel_s"].items() if any(k in n for k in names))
    if kernel_s <= 0:
        return None
    nbytes = sum(rec.counts[s.route]["warp_bytes"] for s in steps)
    return 100.0 * nbytes / bw / kernel_s
