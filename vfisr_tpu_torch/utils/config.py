"""Configuration loading (port of ``vfisr_tpu/utils/config.py``):
``config/default.yaml``, deep-merged with a user file and dict overrides,
feeding the constructors.

PyYAML is imported inside ``load_config`` only, so the device paths never
import it; where it is missing, ``load_config`` raises an error that names
it. ``warp.backend`` keeps the reference's names: ``pallas`` is the port's
windowed warp (the hand-written kernel on the GPU) and ``gather`` its exact
warp (``core/warp.py``); ``warp_backend`` maps them.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Optional

DEFAULT_CONFIG_PATH = Path(__file__).resolve().parents[2] / "config" / "default.yaml"

# warp.backend in the config -> core.warp.backward_warp's backend
WARP_BACKENDS = {"pallas": "windowed", "gather": "exact"}


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError("load_config needs PyYAML (the 'yaml' module) to read "
                          f"{DEFAULT_CONFIG_PATH.name}; it is not installed") from e
    return yaml


def _deep_merge(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: Optional[str | Path] = None, overrides: Optional[dict] = None) -> dict:
    """Load default.yaml, optionally merged with another file and dict overrides."""
    yaml = _yaml()
    with open(DEFAULT_CONFIG_PATH) as f:
        cfg = yaml.safe_load(f)
    if path:
        with open(path) as f:
            cfg = _deep_merge(cfg, yaml.safe_load(f) or {})
    if overrides:
        cfg = _deep_merge(cfg, overrides)
    return cfg


def get(cfg: dict, dotted: str, default: Any = None) -> Any:
    """cfg lookup by dotted path, e.g. get(cfg, 'adaptive.route_mode')."""
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def warp_backend(cfg: dict) -> str:
    """The port's warp backend for the config's ``warp.backend`` ('pallas'
    -> 'windowed', 'gather' -> 'exact'; 'pallas' when unset)."""
    name = get(cfg, "warp.backend", "pallas")
    if name not in WARP_BACKENDS:
        raise ValueError(f"warp.backend must be one of {sorted(WARP_BACKENDS)}; got {name!r}")
    return WARP_BACKENDS[name]


def make_adaptive_pipeline(cfg: Optional[dict] = None, **kwargs):
    """Construct AdaptivePipeline from config (thresholds no longer hardcoded)."""
    from vfisr_tpu_torch.models.novel.adaptive_pipeline import AdaptivePipeline

    cfg = cfg or load_config()
    a = cfg.get("adaptive", {})
    params = dict(
        motion_threshold_low=a.get("motion_threshold_low", 5.0),
        motion_threshold_high=a.get("motion_threshold_high", 25.0),
        route_mode=a.get("route_mode", "hosted"),
    )
    params.update(kwargs)
    return AdaptivePipeline(**params)
