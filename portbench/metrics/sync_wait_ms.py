"""sync_wait_ms: the host's time blocked on the device per traced step
(the program's ``vfisr.sync`` spans: each call in a step that waits for
the device, such as the router's ``motion_mean`` and route-mask readbacks
and the experts' timestep uploads), from the spans the program logs while
the trace runs (``portbench/spans.py``). Moves output_fps where a wait
keeps the host from dispatching a step ahead."""

from portbench.spans import host_ms_per_step

UNIT = "ms"


def read(rec):
    return host_ms_per_step(rec, "sync")
