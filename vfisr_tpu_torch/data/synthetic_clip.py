"""Synthetic gaming-like source clips (port of ``scripts/make_synthetic_clip.py``).

Deterministic clips with the content classes the router and the metrics
care about: parallax-scrolling textured worlds, occluding sprites,
particle bursts, a static HUD (minimap, health bar, ammo text), scene cuts
and high-motion pans. Presets:

- ``render_clip`` (``smooth``): blurred-noise worlds, one cut at 62%;
- ``render_hard_clip(profile="v1")`` (``hard``): worlds with hard edges
  (panel grids, signage, speckle, checker patches), textured sprites, cuts
  at 45% and 80%, the speed profile of ``_speed_profile``;
- ``render_hard_clip(profile="routing")`` (``routing``): the same worlds
  with interleaved speed strata, frozen-world static blocks and an
  animated HUD spinner (no two frames identical).

The reference's seeds, draws and arithmetic are kept: every value drawn
from its numpy generators is drawn here in the same order. The textures'
cubic upsample and Gaussian blur (``_texture``) and each frame's
composite run on ``device`` (``cuda`` by default) in the reference's
float32 (float64 for the smooth preset, whose textures numpy promotes);
the shapes drawn on uint8 run on the host (``data/draw.py``). Signage
strings go through ``draw_signage`` (``draw.put_signage``), the only
drawing that is not OpenCV's pixel for pixel.

``iter_frames`` / ``iter_hard_frames`` yield the RGB uint8 frames;
``render_clip`` / ``render_hard_clip`` write them as Y4M through
``data/video_io.py::VideoWriter`` (the reference wrote mp4v through cv2),
each frame's I420 planes made on the device.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from vfisr_tpu_torch.core.color import rgb_to_i420
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data import draw
from vfisr_tpu_torch.data.video_io import VideoWriter
from vfisr_tpu_torch.ops.conv import gaussian_blur

draw_signage = draw.put_signage
# the presets' scene cuts, as fractions of the clip
HARD_CUTS = (0.45, 0.80)
SMOOTH_CUT = 0.62
BOB_ROOM = 160  # the hard worlds' vertical bob room (rows beyond the frame)


def _tick(stats: Optional[dict], key: str, start: float) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + time.perf_counter() - start


def _texture(rng, h: int, w: int, scale: int, palette, device) -> torch.Tensor:
    """Smooth random texture, [h, w, 3] float64 on device: float32 noise at
    1/scale upsampled with cubic, blurred (sigma 1.5, 13 taps), times the
    palette (float64, as numpy promotes it), clipped to [0, 1]."""
    small = torch.from_numpy(rng.random((h // scale, w // scale, 3)).astype(np.float32))
    tex = resize(small.to(device), (h, w), "cubic")
    tex = gaussian_blur(tex[None], 0, 1.5)[0]
    pal = torch.as_tensor(np.asarray(palette, np.float64), device=device)
    return torch.clamp(tex.double() * pal, 0, 1)


def _detail_texture(rng, h: int, w: int, scale: int, palette, device) -> np.ndarray:
    """Game-world texture with high-frequency structure, [h, w, 3] float32
    on the host: panel grid lines, signage strings, specular speckle and
    near-Nyquist checker patches stamped on ``_texture``, so they move with
    the camera (they make blends ghost at > 5 px displacement)."""
    u8 = (_texture(rng, h, w, scale, palette, device) * 255).to(torch.uint8).cpu().numpy()

    # panel/brick grid: strong axis-aligned edges every 80-140 px
    gy = int(rng.integers(80, 140))
    gx = int(rng.integers(80, 140))
    shade = tuple(int(c) for c in rng.integers(10, 60, 3))
    for y in range(0, h, gy):
        draw.line(u8, (0, y), (w, y), shade, 2)
    for x in range(0, w, gx):
        draw.line(u8, (x, 0), (x, h), shade, 2)

    # signage glyphs: short bright strings at random world positions
    for _ in range(w // 60):
        s = "".join(rng.choice(list(draw.SIGNAGE_GLYPHS), rng.integers(3, 8)))
        org = (int(rng.integers(0, max(w - 160, 1))),
               int(rng.integers(min(30, h - 11), h - 10)))
        col = tuple(int(c) for c in rng.integers(150, 255, 3))
        draw_signage(u8, s, org, float(rng.uniform(0.5, 1.4)), col, int(rng.integers(1, 3)))

    # specular speckle: unfiltered pixel noise on a subset of pixels
    speck = rng.random((h, w)) > 0.985
    u8[speck] = rng.integers(180, 255, (int(speck.sum()), 3))

    # fine near-Nyquist checker patches (SR aliasing probes)
    for _ in range(w // 400):
        ph, pw = int(rng.integers(40, 90)), int(rng.integers(60, 140))
        if h <= ph or w <= pw:
            continue
        y0 = int(rng.integers(0, h - ph))
        x0 = int(rng.integers(0, w - pw))
        p = int(rng.integers(2, 4))
        yy, xx = np.mgrid[0:ph, 0:pw]
        checker = (((yy // p) + (xx // p)) % 2 * 160 + 60).astype(np.uint8)
        u8[y0:y0 + ph, x0:x0 + pw] = checker[..., None]

    return u8.astype(np.float32) / 255.0


def _speed_profile(n_frames: int, fps: int, cut1: float, cut2: float, rng=None) -> np.ndarray:
    """Per-frame horizontal camera speed (px/s), signed: a MEDIUM ramp (4 ->
    9 px per keyframe pair), MEDIUM-HARD 14, an EXTREME burst 30, a +-14
    reversal after the first cut, HARD 18, then a ramp 8 -> 20 (a keyframe
    pair spans 2 frames, so pair flow = speed / (fps / 2)). ``rng`` is not
    drawn from (the reference passes it)."""
    v = np.zeros(n_frames, np.float32)
    f = np.arange(n_frames) / n_frames
    half_fps = fps / 2.0
    for i in range(n_frames):
        x = f[i]
        if x < 0.15:
            v[i] = half_fps * (4 + (x / 0.15) * 5)
        elif x < 0.30:
            v[i] = half_fps * 14
        elif x < cut1:
            v[i] = half_fps * 30
        elif x < 0.62:
            v[i] = half_fps * 14 * np.sin(2 * np.pi * (x - cut1) / 0.17)
        elif x < cut2:
            v[i] = half_fps * 18
        else:
            v[i] = half_fps * (8 + (x - cut2) / (1 - cut2) * 12)
    return v


def _routing_speed_profile(n_frames: int, fps: int):
    """Interleaved strata in a repeating 2.5 s cycle, (speed px/s signed,
    world-advance bool) per frame: static 0.30 s (world frozen), medium
    0.90 s (13 px/pair), hard 0.75 s (20), easy 0.20 s (3), extreme 0.15 s
    (32), medium 0.20 s (13); the pan's direction alternates per cycle."""
    half_fps = fps / 2.0
    cycle = [(0.30, 0.0), (0.90, 13.0), (0.75, 20.0),
             (0.20, 3.0), (0.15, 32.0), (0.20, 13.0)]
    cycle_len = sum(d for d, _ in cycle)
    v = np.zeros(n_frames, np.float32)
    advance = np.ones(n_frames, bool)
    for i in range(n_frames):
        t = i / fps
        k = int(t // cycle_len)
        pos = t % cycle_len
        sign = 1.0 if k % 2 == 0 else -1.0
        for dur, pair_flow in cycle:
            if pos < dur:
                v[i] = sign * pair_flow * half_fps
                advance[i] = pair_flow > 0
                break
            pos -= dur
    return v, advance


def _draw_hud(frame_u8: np.ndarray, width: int, height: int) -> None:
    """Static HUD overlay (identical every frame): the minimap box with
    "MAP", the health bar, the ammo text."""
    draw.rectangle(frame_u8, (40, 40), (300, 200), (20, 20, 26), -1)
    draw.rectangle(frame_u8, (40, 40), (300, 200), (178, 178, 191), 2)
    draw.put_label(frame_u8, "MAP", (60, 80), 0.8, (230, 230, 230), 2)
    draw.rectangle(frame_u8, (40, height - 90), (460, height - 50), (26, 26, 26), -1)
    draw.rectangle(frame_u8, (44, height - 86), (44 + 300, height - 54), (51, 204, 77), -1)
    draw.put_label(frame_u8, "AMMO 30/120", (width - 420, height - 60), 1.1, (242, 242, 242), 2)


def _to_u8(frame: torch.Tensor) -> np.ndarray:
    """``(np.clip(frame, 0, 1) * 255).astype(np.uint8)`` on the device, back
    on the host."""
    return (torch.clamp(frame, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def iter_hard_frames(seconds: float = 12.0, fps: int = 60, width: int = 1920,
                     height: int = 1080, seed: int = 11, profile: str = "v1",
                     device: str = "cuda", stats: Optional[dict] = None) -> Iterator[np.ndarray]:
    """The hard preset's RGB uint8 frames ([height, width, 3]): detailed
    worlds, textured hard-edged sprites crossing paths, particles in the
    EXTREME burst and the second HARD phase, the static HUD, two cuts.
    ``profile="routing"`` takes ``_routing_speed_profile``: sprites, bob and
    particles follow a world clock that stops in the static blocks,
    particles in the >= 18 px/pair blocks only, and a HUD spinner turns.
    ``stats``, when given, collects host seconds under "textures" and
    "composite" (the frame's composite on the device, its read-back and the
    shapes drawn on it)."""
    if profile not in ("v1", "routing"):
        raise ValueError(f"profile {profile!r}: 'v1' or 'routing'")
    start = time.perf_counter()
    rng = np.random.default_rng(seed)
    n_frames = int(seconds * fps)
    margin = BOB_ROOM
    th, tw = height + margin, width * 2

    def scene_textures(k):
        r = np.random.default_rng(seed * 1000 + k)
        palettes = [
            (np.array([0.30, 0.38, 0.52]), np.array([0.40, 0.52, 0.36])),
            (np.array([0.52, 0.33, 0.28]), np.array([0.48, 0.44, 0.30])),
            (np.array([0.28, 0.30, 0.36]), np.array([0.36, 0.42, 0.52])),
        ][k % 3]
        far = _detail_texture(r, th, tw, 28, palettes[0], device)
        near = _detail_texture(r, th, tw, 14, palettes[1], device)
        mask = (_texture(r, th, tw, 48, np.array([1.0, 1.0, 1.0]), device)[..., 0]
                > 0.52).float()[..., None]
        return torch.from_numpy(far).to(device), torch.from_numpy(near).to(device), mask

    scenes = [scene_textures(k) for k in range(3)]
    cut1, cut2 = HARD_CUTS
    cut1_i, cut2_i = int(n_frames * cut1), int(n_frames * cut2)
    if profile == "routing":
        vx, adv = _routing_speed_profile(n_frames, fps)
        wt = np.cumsum(adv) / fps  # world clock: frozen in static blocks
    else:
        vx = _speed_profile(n_frames, fps, cut1, cut2, rng)
        wt = np.arange(n_frames) / fps
    cam_x = np.cumsum(vx) / fps  # px

    # textured, hard-edged sprites (occluders)
    n_sprites = 8
    spr_size = rng.integers(70, 200, n_sprites)
    y_lo = min(120, 0.1 * height)
    spr_y0 = rng.uniform(y_lo, max(height - 320, y_lo + 1), n_sprites)
    spr_phase = rng.uniform(0, 2 * np.pi, n_sprites)
    spr_speed = rng.uniform(180, 640, n_sprites)  # px/s, some occlude fast
    spr_tex = []
    for s in range(n_sprites):
        sr = np.random.default_rng(seed + 99 + s)
        tex = _detail_texture(sr, int(spr_size[s]), int(spr_size[s]), 8,
                              rng.uniform(0.5, 1.0, 3), device)
        spr_tex.append(torch.from_numpy(tex).to(device))

    n_part = 300
    part_pos = rng.uniform([0, 0], [width, height], (n_part, 2))
    part_vel = rng.normal(0, 260, (n_part, 2))
    if profile == "routing":
        # the spinner's ring is the same pixels every frame: drawn once
        cx, cy, r = width - 70, 70, 16
        ring = draw.circle(np.zeros((height, width), np.uint8), (cx, cy), r + 4, 1, 2) > 0
    _tick(stats, "textures", start)

    for i in range(n_frames):
        start = time.perf_counter()
        t = i / fps
        w_t = float(wt[i])  # sprite/bob/particle clock (= t for v1)
        scene_k = 0 if i < cut1_i else (1 if i < cut2_i else 2)
        far, near, nm_full = scenes[scene_k]
        cam = cam_x[i]
        xf = int(cam * 0.4) % width
        xn = int(cam) % width
        yb = int(margin / 2 + 50 * np.sin(2 * np.pi * 0.23 * w_t))
        frame = far[yb:yb + height, xf:xf + width].clone()
        nm = nm_full[yb:yb + height, xn:xn + width]
        frame = frame * (1 - nm) + near[yb:yb + height, xn:xn + width] * nm

        # textured sprites: hard edges, crossing paths (occlusion events)
        for s in range(n_sprites):
            sz = int(spr_size[s])
            x = int((spr_phase[s] * 300 + w_t * spr_speed[s]) % (width + 2 * sz)) - sz
            y = int(spr_y0[s] + 90 * np.sin(2 * np.pi * 0.5 * w_t + spr_phase[s]))
            x2, y2 = min(x + sz, width), min(y + sz, height)
            xc, yc = max(x, 0), max(y, 0)
            if x2 > xc and y2 > yc:
                frame[yc:y2, xc:x2] = spr_tex[s][yc - y:y2 - y, xc - x:x2 - x]

        frame_u8 = _to_u8(frame)

        # particle phases: the EXTREME burst and the second HARD phase
        # (routing profile: any hard/extreme block, >= 18 px/pair)
        if profile == "routing":
            in_burst = abs(float(vx[i])) >= 18.0 * fps / 2.0 - 1e-3
        else:
            in_burst = (int(n_frames * 0.30) <= i < cut1_i) or (
                int(n_frames * 0.62) <= i < cut2_i)
        if in_burst:
            pp = part_pos + part_vel * (w_t % 3.0)
            px = np.mod(pp[:, 0], width).astype(int)
            py = np.mod(pp[:, 1], height).astype(int)
            for k in range(n_part):
                draw.circle(frame_u8, (px[k], py[k]), 2, (255, 242, 178), -1)

        _draw_hud(frame_u8, width, height)
        if profile == "routing":
            # animated HUD spinner: frames are never bitwise-identical,
            # even in frozen-world static blocks (menu-animation analog)
            ang = 2 * np.pi * 1.5 * t
            frame_u8[ring] = (60, 60, 70)
            draw.line(frame_u8, (cx, cy), (int(cx + r * np.cos(ang)), int(cy + r * np.sin(ang))),
                      (240, 240, 250), 3)
        _tick(stats, "composite", start)
        yield frame_u8


def iter_frames(seconds: float = 12.0, fps: int = 60, width: int = 1920,
                height: int = 1080, seed: int = 7, device: str = "cuda",
                stats: Optional[dict] = None) -> Iterator[np.ndarray]:
    """The smooth preset's RGB uint8 frames: two blurred-noise worlds (a cut
    at 62%), a slow pan with a fast-pan burst in the last 2 s before the
    cut, tinted sprites, a particle burst in the middle third of scene 1,
    the static HUD. ``stats`` as ``iter_hard_frames``'s."""
    start = time.perf_counter()
    rng = np.random.default_rng(seed)
    n_frames = int(seconds * fps)
    # double-width textures for wraparound scrolling
    bg_far = _texture(rng, height, width * 2, 32, np.array([0.25, 0.35, 0.55]), device)
    bg_near = _texture(rng, height, width * 2, 16, np.array([0.35, 0.55, 0.35]), device)
    bg_far2 = _texture(rng, height, width * 2, 24, np.array([0.55, 0.3, 0.25]), device)
    bg_near2 = _texture(rng, height, width * 2, 12, np.array([0.5, 0.45, 0.3]), device)
    near_mask = (_texture(rng, height, width * 2, 48, np.array([1.0, 1.0, 1.0]), device)[..., 0]
                 > 0.55).float()[..., None]

    n_sprites = 6
    spr_size = rng.integers(60, 160, n_sprites)
    spr_y0 = rng.uniform(100, height - 260, n_sprites)
    spr_phase = rng.uniform(0, 2 * np.pi, n_sprites)
    spr_speed = rng.uniform(120, 420, n_sprites)  # px/s
    spr_color = torch.as_tensor(rng.uniform(0.3, 1.0, (n_sprites, 3)), device=device)

    n_part = 220
    part_pos = rng.uniform([0, 0], [width, height], (n_part, 2))
    part_vel = rng.normal(0, 220, (n_part, 2))
    _tick(stats, "textures", start)

    cut_at = int(n_frames * SMOOTH_CUT)
    for i in range(n_frames):
        start = time.perf_counter()
        t = i / fps
        scene2 = i >= cut_at
        far, near = (bg_far2, bg_near2) if scene2 else (bg_far, bg_near)
        # camera: slow pan, then a fast pan burst in the last 2 s of scene 1
        pan_speed = 90.0
        if not scene2 and i >= cut_at - 2 * fps:
            pan_speed = 900.0  # EXTREME-motion stratum
        cam = (t * pan_speed) % width
        xf = int(cam * 0.4) % width
        xn = int(cam) % width
        frame = far[:, xf:xf + width].clone()
        nm = near_mask[:, xn:xn + width]
        frame = frame * (1 - nm) + near[:, xn:xn + width] * nm

        # sprites (sinusoidal paths)
        for s in range(n_sprites):
            sz = int(spr_size[s])
            x = int((spr_phase[s] * 300 + t * spr_speed[s]) % (width + sz)) - sz
            y = int(spr_y0[s] + 60 * np.sin(2 * np.pi * 0.4 * t + spr_phase[s]))
            x2, y2 = min(x + sz, width), min(y + sz // 2, height)
            x, y = max(x, 0), max(y, 0)
            if x2 > x and y2 > y:
                frame[y:y2, x:x2] = frame[y:y2, x:x2] * 0.25 + spr_color[s] * 0.75

        frame_u8 = _to_u8(frame)

        # particle burst in the middle third of scene 1
        if not scene2 and n_frames // 3 < i < cut_at - 2 * fps:
            pp = part_pos + part_vel * (t - n_frames / 3 / fps)
            px = np.mod(pp[:, 0], width).astype(int)
            py = np.mod(pp[:, 1], height).astype(int)
            for k in range(n_part):
                draw.circle(frame_u8, (px[k], py[k]), 2, (255, 242, 178), -1)

        _draw_hud(frame_u8, width, height)
        _tick(stats, "composite", start)
        yield frame_u8


def _write(path: str, frames: Iterator[np.ndarray], width: int, height: int, fps: int,
           device, stats: Optional[dict]) -> int:
    """Write the frames to ``path`` (``VideoWriter``); returns their count.
    A Y4M frame's I420 planes are made on ``device``. ``stats`` collects the
    write's host seconds under "write"."""
    n = 0
    with VideoWriter(path, width, height, fps) as writer:
        for frame in frames:
            start = time.perf_counter()
            if str(path).lower().endswith(".y4m"):
                writer.write_i420(rgb_to_i420(torch.from_numpy(frame).to(device)).cpu().numpy())
            else:
                writer.write(frame)
            _tick(stats, "write", start)
            n += 1
    return n


def render_hard_clip(path: str, seconds: float = 12.0, fps: int = 60, width: int = 1920,
                     height: int = 1080, seed: int = 11, profile: str = "v1",
                     device: str = "cuda", stats: Optional[dict] = None) -> int:
    """``iter_hard_frames`` written to ``path`` (Y4M); returns the frame
    count."""
    return _write(path, iter_hard_frames(seconds, fps, width, height, seed, profile, device,
                                         stats), width, height, fps, device, stats)


def render_clip(path: str, seconds: float = 12.0, fps: int = 60, width: int = 1920,
                height: int = 1080, seed: int = 7, device: str = "cuda",
                stats: Optional[dict] = None) -> int:
    """``iter_frames`` written to ``path`` (Y4M); returns the frame count."""
    return _write(path, iter_frames(seconds, fps, width, height, seed, device, stats),
                  width, height, fps, device, stats)
