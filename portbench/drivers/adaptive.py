"""Driver of the ``adaptive`` kind: the paper's router, the model that
``process --method adaptive`` runs. ``AdaptivePipeline`` in the hosted
route mode, quality-aware, Lanczos4 SR, with RIFE (float32) and VFIMamba
(full) built at the configuration's widths with seeded weights. A step is
``process_video``'s ``device_step``: ``interpolate_batch``, then
``upscale_batch`` and ``to_uint8``. One stream.
"""

from __future__ import annotations

from pathlib import Path

import torch

from portbench.reference import pipeline as ref
from portbench.reference import rife as ref_rife
from portbench.reference import vfimamba as ref_mamba

_ROOT = Path(__file__).resolve().parents[1]


def gate_path(cfg: dict) -> Path:
    return _ROOT / cfg["gate"]


ROUTES = ("rife", "vfimamba", "scene")  # the routes a step can take


def weight_shapes(cfg: dict) -> dict:
    return {"rife": ref_rife.param_shapes(ref_rife.IFNetConfig.from_dict(cfg["rife"])),
            "vfimamba": ref_mamba.param_shapes(ref_mamba.MambaConfig.from_dict(cfg["vfimamba"]))}


def _module(cls, cfg_obj, params: dict, device):
    with torch.device("meta"):
        module = cls(cfg_obj)
    module = module.to_empty(device=device)
    module.load_state_dict(params)
    return module.eval().requires_grad_(False)


class Program:
    """The program under test, set up for one run."""

    def __init__(self, cfg: dict, params: dict, streams, device):
        from vfisr_tpu_torch.models.novel.adaptive_pipeline import AdaptivePipeline
        from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig, RIFEModel
        from vfisr_tpu_torch.models.sota.vfimamba import MambaConfig, VFIMambaModel, VFIMambaNet

        if streams.n != 1:
            raise ValueError("the adaptive driver runs one stream")
        torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
        r = cfg["rife"]
        rcfg = RIFEConfig(scales=tuple(r["scales"]), channels=tuple(r["channels"]),
                          num_convs=r["num_convs"], min_warp_scale=r["min_warp_scale"],
                          level_warp_radius=tuple(r["level_warp_radius"]),
                          final_warp_radius=tuple(r["final_warp_radius"]),
                          dtype=getattr(torch, r["dtype"]), warp_dtype=getattr(torch, r["warp_dtype"]))
        rife = RIFEModel(device=str(device), config=rcfg)
        rife.module = _module(IFNet, rcfg, params["rife"], device)
        rife._loaded = True
        mamba = VFIMambaModel(variant=cfg["vfimamba_variant"], device=str(device))
        mamba.module = _module(VFIMambaNet, MambaConfig(**cfg["vfimamba"]), params["vfimamba"],
                               device)
        mamba._loaded = True
        self.pipe = AdaptivePipeline(device=str(device), route_mode="hosted", quality_aware=True,
                                     sr_model_name="lanczos", gate_path=str(gate_path(cfg)))
        self.pipe._rife, self.pipe._vfimamba, self.pipe._loaded = rife, mamba, True
        self.streams = streams
        self.ts = tuple(cfg["timestamps"])
        self.scale = cfg["out_hw"][0] / cfg["in_hw"][0]

    def step(self, g: int):
        """Dispatch step g: (uint8 frames [1+T, OH, OW, 3] on the device, the
        pair's route from the pipeline's routing counters)."""
        from vfisr_tpu_torch.core.frames import to_uint8

        s = self.pipe.stats
        before = (s.rife_count, s.vfimamba_count, s.scene_change_count)
        x0, x1 = self.streams.pair(g)
        mids = self.pipe.interpolate_batch(x0, x1, self.ts)
        frames = torch.cat([x0[:, None], mids], dim=1)[0]
        up = to_uint8(self.pipe.upscale_batch(frames, self.scale))
        after = (s.rife_count, s.vfimamba_count, s.scene_change_count)
        route = [n for n, a, b in zip(("rife", "vfimamba", "scene"), after, before) if a > b]
        return up, route[0] if len(route) == 1 else None

    def close(self):
        self.pipe = None


def reference(cfg: dict, params: dict, streams, g: int, prec) -> torch.Tensor:
    x0, x1 = streams.pair(g)
    hist, cnt = ref.history_of(streams.history(g), 1, x0.device)
    frames, _ = ref.adaptive_step(params["rife"], params["vfimamba"], x0, x1, hist, cnt, cfg,
                                  ref.load_bins(gate_path(cfg)), prec)
    return frames


def step_on_meta(cfg: dict, n: int, route: str):
    shapes = weight_shapes(cfg)
    params = {g: {k: torch.empty(s, device="meta") for k, s in shapes[g]} for g in shapes}
    h, w = cfg["in_hw"]
    x0 = torch.empty((n, h, w, 3), device="meta")
    hist = torch.zeros((n, 10, *ref.ops.HUD_RES), device="meta")
    cnt = torch.zeros((n,), dtype=torch.int32, device="meta")
    ref.adaptive_step(params["rife"], params["vfimamba"], x0, x0, hist, cnt, cfg, [], route=route)
