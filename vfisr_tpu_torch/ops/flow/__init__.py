"""Dense optical flow."""

from vfisr_tpu_torch.ops.flow.farneback import farneback_flow

__all__ = ["farneback_flow"]
