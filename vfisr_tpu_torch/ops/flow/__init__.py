"""Dense optical flow."""

from vfisr_tpu_torch.ops.flow.farneback import farneback_flow, flow_magnitude

__all__ = ["farneback_flow", "flow_magnitude"]
