"""Model registry (port of ``vfisr_tpu/models/registry.py``): the same 13
names. ``span``, ``safa``, ``rife_span`` and ``vfimamba_span`` are not
ported yet; ``get_model`` raises ``NotImplementedError`` for them."""

from __future__ import annotations

from typing import Callable, Dict, List

from vfisr_tpu_torch.models.base import BaseModel


def _bicubic(**kw):
    from vfisr_tpu_torch.models.traditional.baselines import BicubicBaseline

    return BicubicBaseline(**kw)


def _lanczos(**kw):
    from vfisr_tpu_torch.models.traditional.baselines import LanczosBaseline

    return LanczosBaseline(**kw)


def _optical_flow(**kw):
    from vfisr_tpu_torch.models.traditional.baselines import OpticalFlowVFI

    return OpticalFlowVFI(**kw)


def _rife(**kw):
    from vfisr_tpu_torch.models.sota.rife import RIFEModel

    return RIFEModel(**kw)


def _rife_lite(**kw):
    from vfisr_tpu_torch.models.sota.rife import RIFELiteModel

    return RIFELiteModel(**kw)


def _vfimamba(**kw):
    from vfisr_tpu_torch.models.sota.vfimamba import VFIMambaModel

    return VFIMambaModel(variant="full", **kw)


def _vfimamba_s(**kw):
    from vfisr_tpu_torch.models.sota.vfimamba import VFIMambaModel

    return VFIMambaModel(variant="small", **kw)


def _adaptive(**kw):
    from vfisr_tpu_torch.models.novel.adaptive_pipeline import AdaptivePipeline

    return AdaptivePipeline(**kw)


def _flagship(**kw):
    from vfisr_tpu_torch.pipeline.flagship import FlagshipVFI

    return FlagshipVFI(**kw)


def _not_ported(name: str):
    def make(**kw):
        raise NotImplementedError(
            f"model {name!r} is not ported yet (SPAN and SAFA: ROADMAP queue 1, item 7)")

    return make


MODEL_REGISTRY: Dict[str, Callable[..., BaseModel]] = {
    # traditional
    "bicubic": _bicubic,
    "lanczos": _lanczos,
    "optical_flow": _optical_flow,
    # sota
    "rife": _rife,
    "rife_lite": _rife_lite,
    "vfimamba": _vfimamba,
    "vfimamba_s": _vfimamba_s,
    "span": _not_ported("span"),
    "safa": _not_ported("safa"),
    # two-stage compositions
    "rife_span": _not_ported("rife_span"),
    "vfimamba_span": _not_ported("vfimamba_span"),
    # novel
    "adaptive": _adaptive,
    # the fused deployment step
    "flagship": _flagship,
}


def list_models() -> List[str]:
    """All registered model names."""
    return sorted(MODEL_REGISTRY)


def get_model(name: str, load: bool = False, **kwargs) -> BaseModel:
    """Instantiate a model by registry name; optionally call its load()."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {', '.join(list_models())}")
    model = MODEL_REGISTRY[name](**kwargs)
    if load:
        model.ensure_loaded()
    return model


def get_available_models() -> Dict[str, Callable[..., BaseModel]]:
    """name -> factory."""
    return dict(MODEL_REGISTRY)
