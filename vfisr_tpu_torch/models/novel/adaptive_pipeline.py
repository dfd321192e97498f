"""The adaptive router's scene-cut gate (port of
``vfisr_tpu/models/novel/adaptive_pipeline.py:96-124``, the parts the
flagship uses; the router and ``AdaptivePipeline`` are later work)."""

from __future__ import annotations

import torch

from vfisr_tpu_torch.core.warp import backward_warp
from vfisr_tpu_torch.ops.ssim import ssim as ssim_windowed

_HUD_RES = (180, 320)  # the reference's 320x180 HUD analysis frames


def scene_cut_signals(s0: torch.Tensor, s1: torch.Tensor, flow_small: torch.Tensor,
                      scene_thr: float, scene_warp_thr: float):
    """Scene cut = SSIM of the small grays below ``scene_thr`` AND SSIM after
    warping s1 back by the measured flow below ``scene_warp_thr`` (real
    motion re-aligns under the warp; a cut does not).

    s0/s1: [N,h,w] small grays; flow_small: [N,h,w,2] in small-res px.
    Returns (is_scene [N] bool, ssim [N], warped_ssim [N]).
    """
    ssim_score = ssim_windowed(s0, s1)
    warped = backward_warp(s1[..., None], flow_small, 1.0, border="replicate")[..., 0]
    warped_ssim = ssim_windowed(s0, warped)
    is_scene = (ssim_score < scene_thr) & (warped_ssim < scene_warp_thr)
    return is_scene, ssim_score, warped_ssim
