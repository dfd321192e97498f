"""The router's calibration record (port of ``vfisr_tpu/utils/router_gate.py``).

Reads ``weights/router_gate.json`` (written by
``scripts/calibrate_router.py`` on held-out scenes), so routing follows
measured expert quality rather than assumed thresholds:

- ``scene_gate``: the flow-compensated SSIM threshold of the scene-cut gate;
- ``experts``: held-out PSNR per expert (``heavy_expert_allowed``);
- ``expert_bins``: per-motion-bin PSNR per expert and regime
  (``expert_bins``, ``bin_winner``);
- ``blend_vs_rife_crossover_px``: the motion below which a linear blend
  beats RIFE.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

DEFAULT_PATH = Path(__file__).resolve().parents[2] / "weights" / "router_gate.json"

_cache: dict = {}


def load_gate(path: Optional[str] = None) -> Optional[dict]:
    """The calibration record; None when absent or unreadable."""
    p = Path(path) if path else DEFAULT_PATH
    key = str(p)
    if key not in _cache:
        try:
            _cache[key] = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            _cache[key] = None
    return _cache[key]


def clear_cache() -> None:
    _cache.clear()


def blend_crossover_px(path: Optional[str] = None) -> Optional[float]:
    """Motion (mean 480x270 flow px) below which blend beats RIFE; None
    when uncalibrated."""
    gate = load_gate(path)
    if not gate:
        return None
    val = gate.get("blend_vs_rife_crossover_px")
    return float(val) if val is not None else None


def heavy_expert_allowed(heavy: str = "vfimamba", fast: str = "rife",
                         path: Optional[str] = None) -> bool:
    """True when the heavy expert's measured held-out quality is at least
    the fast expert's; True when uncalibrated (the reference's behaviour)."""
    gate = load_gate(path)
    if not gate:
        return True
    experts = gate.get("experts", {})
    hq, fq = experts.get(heavy), experts.get(fast)
    if hq is None or fq is None:
        return True
    return float(hq) >= float(fq)


def scene_warp_threshold(path: Optional[str] = None) -> Optional[float]:
    """Calibrated warped-SSIM threshold of the scene-cut gate; None when
    uncalibrated (the gate is then the reference's SSIM-only test)."""
    gate = load_gate(path)
    if not gate:
        return None
    sg = gate.get("scene_gate")
    if not sg:
        return None
    val = sg.get("warped_ssim_threshold")
    return float(val) if val is not None else None


def expert_bins(regime: str, path: Optional[str] = None) -> Optional[list]:
    """Measured per-motion-bin expert quality of a regime ('native': full-res
    pairs, motion = the router's full-res Farneback motion_mean; 'sweep':
    degraded 960x540 -> SR, motion at 480x270): bins sorted by motion_lo,
    {"motion_lo", "motion_hi", <expert>: mean PSNR, ...}; None when
    uncalibrated."""
    gate = load_gate(path)
    if not gate:
        return None
    bins = (gate.get("expert_bins") or {}).get(regime)
    return bins or None


def bin_winner(regime: str, motion: float, experts=("rife", "vfimamba"),
               margin_db: float = 0.25, static_eps_px: float = 0.25,
               path: Optional[str] = None) -> Optional[str]:
    """The measured-best expert at a pair's motion, or None when
    uncalibrated or the motion lies in no bin.

    A later-listed (heavier) expert must win its bin by more than
    ``margin_db``, so ties and near-ties go to the first-listed (fast) one.
    Below ``static_eps_px`` the pair is static and the fast expert is
    returned. Above the last bin edge the last bin decides."""
    bins = expert_bins(regime, path)
    if not bins:
        return None
    if motion < static_eps_px:
        return experts[0]
    chosen = next((b for b in bins if b["motion_lo"] <= motion < b["motion_hi"]), None)
    if chosen is None and motion >= bins[-1]["motion_hi"]:
        chosen = bins[-1]
    if chosen is None:
        return None
    scored = [(e, chosen.get(e)) for e in experts if chosen.get(e) is not None]
    if len(scored) < 2:
        return None
    best_e, best_q = scored[0]
    for e, q in scored[1:]:
        if q > best_q + margin_db:
            best_e, best_q = e, q
    return best_e
