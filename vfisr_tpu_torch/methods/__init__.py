"""The experiments' inline methods (port of ``vfisr_tpu/methods/``)."""

from vfisr_tpu_torch.methods.inline import (
    calc_motion,
    detect_ui_mask,
    edge_enhance,
    estimate_motion_complexity,
    estimate_uncertainty,
    flow_interpolate,
    frame_dup,
    linear_blend,
    mcar_interpolate_cached,
    ughi_interpolate,
    ui_aware_interpolate,
)

__all__ = [
    "linear_blend",
    "frame_dup",
    "edge_enhance",
    "flow_interpolate",
    "detect_ui_mask",
    "ui_aware_interpolate",
    "estimate_motion_complexity",
    "mcar_interpolate_cached",
    "estimate_uncertainty",
    "ughi_interpolate",
    "calc_motion",
]
