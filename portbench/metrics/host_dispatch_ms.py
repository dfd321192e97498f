"""host_dispatch_ms: the host's time in the call into one step of the
program (the flagship's fused step; the adaptive pipeline's
``interpolate_batch`` + ``upscale_batch``, its route-mask readback
included), by the benchmark's clock around the call, as a mean per step
over the traced steps. Moves output_fps where the host sets the pace."""

UNIT = "ms"


def read(rec):
    spans = [s.dispatch_s for s in rec.steps if s.traced]
    return 1e3 * sum(spans) / len(spans) if spans else None
