"""analysis_host_ms: the host's time in the router's analysis per traced
step (the program's ``vfisr.analysis`` span: the flagship step's HUD ring
push and ``analyze_small``; ``AdaptiveRouter.analyze_device``), from the
spans the program logs while the trace runs (``portbench/spans.py``).
Moves output_fps where the host's dispatch of the analysis sets the pace."""

from portbench.spans import host_ms_per_step

UNIT = "ms"


def read(rec):
    return host_ms_per_step(rec, "analysis")
