"""vfimamba_route_pct: the share of the pairs completed in the window that
the router (``AdaptiveRouter`` by ``router_gate.bin_winner``) sent to
VFIMamba, from the pipeline's routing counters (``AdaptivePipeline.stats``)
step by step. Nothing to read where the configuration has no such route."""

UNIT = "%"


def read(rec):
    if "vfimamba" not in rec.counts:
        return None
    routes = [s.route for s in rec.completed()]
    if not routes or None in routes:
        return None
    return 100.0 * sum(r == "vfimamba" for r in routes) / len(routes)
