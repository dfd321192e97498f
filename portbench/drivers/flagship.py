"""Driver of the ``flagship`` kind: the deployment path of ``process`` and
``FlagshipVFI``, ``pipeline/flagship.py::make_flagship_step`` over P pairs
per step (one pair from each stream, each with its own HUD history), its
IFNet built at the configuration's widths and dtype with seeded weights.
"""

from __future__ import annotations

import torch

from portbench.reference import pipeline as ref
from portbench.reference import rife as ref_rife


ROUTES = ("flagship",)  # the routes a step can take


def weight_shapes(cfg: dict) -> dict:
    return {"ifnet": ref_rife.param_shapes(ref_rife.IFNetConfig.from_dict(cfg["ifnet"]))}


class Program:
    """The program under test, set up for one run."""

    def __init__(self, cfg: dict, params: dict, streams, device):
        from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig
        from vfisr_tpu_torch.pipeline.flagship import (FlagshipConfig, init_history,
                                                       make_flagship_step)

        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        net = cfg["ifnet"]
        rcfg = RIFEConfig(scales=tuple(net["scales"]), channels=tuple(net["channels"]),
                          num_convs=net["num_convs"], min_warp_scale=net["min_warp_scale"],
                          level_warp_radius=tuple(net["level_warp_radius"]),
                          final_warp_radius=tuple(net["final_warp_radius"]),
                          dtype=getattr(torch, net["dtype"]),
                          warp_dtype=getattr(torch, net["warp_dtype"]))
        with torch.device("meta"):
            module = IFNet(rcfg)
        module = module.to_empty(device=device)
        module.load_state_dict(params["ifnet"])
        self.module = module.to(rcfg.dtype).eval().requires_grad_(False)
        fcfg = FlagshipConfig(
            out_hw=tuple(cfg["out_hw"]), timestamps=tuple(cfg["timestamps"]),
            analysis_hw=tuple(cfg["analysis_hw"]),
            scene_ssim_threshold=cfg["scene_ssim_threshold"],
            scene_warp_ssim_threshold=cfg["scene_warp_ssim_threshold"],
            hud_var_threshold=cfg["hud_var_threshold"],
            hud_coverage_threshold=cfg["hud_coverage_threshold"],
            hud_agree_eps=cfg["hud_agree_eps"], sr_filter="lanczos4", shared_flow=True)
        self.step_fn = make_flagship_step(self.module, fcfg)
        self.streams = streams
        self.hist, self.hcnt = init_history(streams.n, device)

    def step(self, g: int):
        """Dispatch step g: (uint8 frames [(1+T)*P, OH, OW, 3] on the device,
        the route of the step)."""
        x0, x1 = self.streams.pair(g)
        up, _, self.hist, self.hcnt, _ = self.step_fn(x0, x1, self.hist, self.hcnt)
        return up, "flagship"

    def close(self):
        self.module = self.step_fn = self.hist = self.hcnt = None


def reference(cfg: dict, params: dict, streams, g: int, prec) -> torch.Tensor:
    """The reference's uint8 frames of step g."""
    x0, x1 = streams.pair(g)
    hist, cnt = ref.history_of(streams.history(g), streams.n, x0.device)
    return ref.flagship_step(params["ifnet"], x0, x1, hist, cnt, cfg, prec)


def step_on_meta(cfg: dict, n: int, route: str):
    """One step of the reference on the meta device, in the dtypes the
    configuration states (what the FLOP and byte counts read)."""
    dt = getattr(torch, cfg["ifnet"]["dtype"])
    params = {k: torch.empty(s, dtype=dt, device="meta") for k, s in weight_shapes(cfg)["ifnet"]}
    h, w = cfg["in_hw"]
    x0 = torch.empty((n, h, w, 3), device="meta")
    hist = torch.zeros((n, 10, *ref.ops.HUD_RES), device="meta")
    cnt = torch.zeros((n,), dtype=torch.int32, device="meta")
    ref.flagship_step(params, x0, x0, hist, cnt, cfg, dtype=dt)
