"""vfisr_tpu_torch/data/draw.py's drawing calls, labels, signage and remap
held against cv2, vfisr_tpu_torch/data/synthetic_clip.py against
scripts/make_synthetic_clip.py, and the make_synthetic_clip CLI.

No JAX program is compiled: the reference renderer is numpy and cv2. The
port's torch ops run on one intra-op thread.

Tolerances:
- ``line``, ``circle``, ``rectangle`` and ``remap``: equal
  to cv2 on every pixel (remap's float32 output bit for bit). Thick lines at
  an angle and thick circles are drawn inside the image (the port raises
  where OpenCV 5's clipping of them is not reproduced; that refusal has its
  own test); thin lines, axis-parallel thick lines and rectangles are also
  clipped.
- The fixed labels: equal to ``cv2.putText`` on random backgrounds, colours
  and origins (clipped too).
- Signage: ``text_size`` equal to ``cv2.getTextSize``; ink only inside that
  box; each glyph's ink within +-30% of cv2's at scales 0.5, 0.9 and 1.4,
  thickness 1 and 2; the generator's state after a detail texture equal to
  the reference's.
- Frames with the signage suppressed on both sides (400x160, 0.5 s at 60
  fps; the smooth preset at 400x360, the smallest height its sprite range
  takes): at most 1 LSB apart, on at most 0.1% of the values (reached:
  v1 2.3e-6, routing 8.2e-6, smooth 2.0e-6 of the values, 1 LSB; the
  textures' cubic upsample and blur take another float order than cv2's).
- Speed profiles: equal.
"""

import importlib.util
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)
from vfisr_tpu_torch import make_synthetic_clip as cli
from vfisr_tpu_torch.data import draw
from vfisr_tpu_torch.data import synthetic_clip as sc
from vfisr_tpu_torch.data.video_io import VideoReader

ROOT = Path(__file__).resolve().parents[1]
FONT = cv2.FONT_HERSHEY_SIMPLEX
LABELS = (("HP", 0.5, 1), ("MAP", 0.8, 2), ("AMMO 30/120", 1.1, 2), ("A7", 0.8, 1))
W, H, H_SMOOTH, SECONDS, FPS = 400, 160, 360, 0.5, 60
LSB_SHARE = 1e-3


def _reference():
    spec = importlib.util.spec_from_file_location("ref_make_synthetic_clip",
                                                  ROOT / "scripts" / "make_synthetic_clip.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pt(rng, lo, hi):
    return tuple(int(v) for v in rng.integers(lo, hi, 2))


def _col(rng):
    return tuple(int(c) for c in rng.integers(0, 256, 3))


def _same(rng, cv_fn, port_fn, args, h=72, w=96):
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    ref = cv_fn(img.copy(), *args)
    return np.array_equal(port_fn(img.copy(), *args), ref)


@pytest.mark.parametrize("thickness", [1, 2, 3])
def test_line_matches_cv2(thickness):
    rng = np.random.default_rng(thickness)
    h, w = 72, 96
    for _ in range(150):
        if thickness == 1:  # any angle, end points off the image too
            args = (_pt(rng, -40, 140), _pt(rng, -40, 140))
        else:  # any angle, the stroke inside the image
            m = thickness
            args = ((int(rng.integers(m, w - m)), int(rng.integers(m, h - m))),
                    (int(rng.integers(m, w - m)), int(rng.integers(m, h - m))))
        assert _same(rng, cv2.line, draw.line, args + (_col(rng), thickness), h, w), args
    for _ in range(80):  # axis-parallel, clipped (the worlds' grid lines)
        a, b = _pt(rng, -10, 110), _pt(rng, -10, 110)
        args = (a, (b[0], a[1])) if rng.random() < 0.5 else (a, (a[0], b[1]))
        assert _same(rng, cv2.line, draw.line, args + (_col(rng), thickness), h, w), args
    for y in (0, h - 1, h):  # a world's grid line from x = 0 to x = w
        assert _same(rng, cv2.line, draw.line, ((0, y), (w, y), _col(rng), thickness), h, w)


@pytest.mark.parametrize("thickness", [-1, 1, 2, 3])
def test_circle_and_rectangle_match_cv2(thickness):
    rng = np.random.default_rng(10 + thickness)
    h, w = 72, 96
    for _ in range(80):
        r = int(rng.integers(0, 30))
        if thickness > 1:
            m = r + thickness
            c = (int(rng.integers(m, max(w - m, m + 1))), int(rng.integers(m, max(h - m, m + 1))))
            if c[0] + m > w - 1 or c[1] + m > h - 1:
                continue
        else:
            c = _pt(rng, -20, 110)
        assert _same(rng, cv2.circle, draw.circle, (c, r, _col(rng), thickness), h, w), (c, r)
        a, b = _pt(rng, -20, 110), _pt(rng, -20, 110)
        assert _same(rng, cv2.rectangle, draw.rectangle, (a, b, _col(rng), thickness), h, w), (a, b)


def test_spinner_matches_cv2():
    """The routing preset's spinner: a circle of radius 20 at thickness 2,
    a hand of 16 px at thickness 3 at every angle."""
    rng = np.random.default_rng(5)
    for k in range(45):  # a turn and an eighth: 40 frames per turn
        ang = 2 * np.pi * 1.5 * k / 60
        cx, cy = 330, 70
        end = (int(cx + 16 * np.cos(ang)), int(cy + 16 * np.sin(ang)))
        img = rng.integers(0, 256, (160, 400, 3), np.uint8)
        ref = cv2.circle(img.copy(), (cx, cy), 20, (60, 60, 70), 2)
        cv2.line(ref, (cx, cy), end, (240, 240, 250), 3)
        got = draw.circle(img.copy(), (cx, cy), 20, (60, 60, 70), 2)
        assert np.array_equal(draw.line(got, (cx, cy), end, (240, 240, 250), 3), ref), k


def test_thick_strokes_leaving_the_image_raise():
    img = np.zeros((40, 60, 3), np.uint8)
    with pytest.raises(ValueError, match="leaves the 60x40 image"):
        draw.line(img, (-5, 3), (30, 20), (255, 0, 0), 2)
    with pytest.raises(ValueError, match="leaves the 60x40 image"):
        draw.circle(img, (5, 20), 10, (255, 0, 0), 3)


def test_remap_matches_cv2():
    """The warp family's maps (float32, sin/cos displacement) and random
    maps reaching past the border, BORDER_REFLECT."""
    rng = np.random.default_rng(6)
    worst = 0.0
    for c in (1, 3):
        for s in (1, 3, 5):
            x = rng.random((64, 64, c)).astype(np.float32)
            yy, xx = np.mgrid[0:64, 0:64].astype(np.float32)
            mx = xx + 0.6 * s * np.sin(2 * np.pi * yy / 16.0)
            my = yy + 0.6 * s * np.cos(2 * np.pi * xx / 16.0)
            mx2, my2 = (rng.uniform(-20, 84, (48, 70)).astype(np.float32) for _ in range(2))
            for a, b in ((mx, my), (mx2, my2)):
                ref = cv2.remap(x, a, b, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REFLECT)
                got = draw.remap(x, a, b, "reflect").reshape(ref.shape)
                worst = max(worst, float(np.abs(got - ref).max()))
    assert worst == 0.0, worst


@pytest.mark.parametrize("label", LABELS, ids=[l[0] for l in LABELS])
def test_labels_match_putText(label):
    text, scale, thickness = label
    rng = np.random.default_rng(len(text))
    for _ in range(40):
        img = rng.integers(0, 256, (60, 160, 3), np.uint8)
        org, col = (int(rng.integers(-120, 150)), int(rng.integers(-5, 80))), _col(rng)
        ref = cv2.putText(img.copy(), text, org, FONT, scale, col, thickness)
        assert np.array_equal(draw.put_label(img.copy(), text, org, scale, col, thickness), ref)
    with pytest.raises(ValueError, match="no coverage raster"):
        draw.put_label(img, text, (0, 30), scale + 0.1, (0, 0, 0), thickness)


@pytest.mark.parametrize("thickness", [1, 2])
def test_signage_contract(thickness):
    rng = np.random.default_rng(thickness)
    for scale in (0.5, 0.9, 1.4):
        for g in draw.SIGNAGE_GLYPHS:
            size = draw.text_size(g, scale, thickness)
            assert size == cv2.getTextSize(g, FONT, scale, thickness), (g, scale)
            (w, h), base = size
            org = (10, 60)
            ref = cv2.putText(np.zeros((100, 80, 3), np.uint8), g, org, FONT, scale,
                              (255, 255, 255), thickness)
            got = draw.put_signage(np.zeros((100, 80, 3), np.uint8), g, org, scale,
                                   (255, 255, 255), thickness)
            box = np.zeros((100, 80), bool)
            box[org[1] - h:org[1] + base, org[0]:org[0] + w] = True
            assert not got[~box].any(), (g, scale)
            ratio = got[..., 0].sum() / ref[..., 0].sum()
            assert 0.7 <= ratio <= 1.3, (g, scale, ratio)
    for _ in range(200):
        s = "".join(rng.choice(list(draw.SIGNAGE_GLYPHS), rng.integers(3, 8)))
        scale = float(rng.uniform(0.5, 1.4))
        assert draw.text_size(s, scale, thickness) == cv2.getTextSize(s, FONT, scale, thickness)
    with pytest.raises(ValueError, match="signage"):
        draw.text_size("AQ", 1.0, thickness)


def test_detail_texture_draws_as_the_reference_does():
    """With each side's own signage, the generator ends where the
    reference's ends: every draw after the text is the same."""
    ref = _reference()
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    a = ref._detail_texture(r1, 200, 500, 14, np.array([0.4, 0.5, 0.3]))
    b = sc._detail_texture(r2, 200, 500, 14, np.array([0.4, 0.5, 0.3]), "cpu")
    assert r1.bit_generator.state == r2.bit_generator.state
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32


def test_speed_profiles_match():
    ref = _reference()
    for n, fps in ((720, 60), (301, 30)):
        assert np.array_equal(sc._speed_profile(n, fps, *sc.HARD_CUTS),
                              ref._speed_profile(n, fps, 0.45, 0.80, None))
        for a, b in zip(sc._routing_speed_profile(n, fps), ref._routing_speed_profile(n, fps)):
            assert np.array_equal(a, b)


@pytest.fixture
def reference_frames(monkeypatch):
    """The reference renderer with cv2.VideoWriter capturing RGB frames and
    cv2.putText drawing only the HUD labels; the port's signage hook off."""
    ref = _reference()
    frames = []

    class Capture:
        def __init__(self, *a, **k):
            pass

        def isOpened(self):
            return True

        def write(self, f):
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))

        def release(self):
            pass

    real_put = cv2.putText

    def hud_only(img, text, *a, **k):
        return real_put(img, text, *a, **k) if text in ("MAP", "AMMO 30/120") else img

    monkeypatch.setattr(cv2, "VideoWriter", Capture)
    monkeypatch.setattr(cv2, "putText", hud_only)
    monkeypatch.setattr(sc, "draw_signage", lambda *a, **k: None)
    return ref, frames


@pytest.mark.parametrize("preset", ["v1", "routing", "smooth"])
def test_frames_match_reference(preset, reference_frames):
    ref, frames = reference_frames
    if preset == "smooth":
        n = ref.render_clip("unused.mp4", SECONDS, FPS, W, H_SMOOTH, 7)
        got = list(sc.iter_frames(SECONDS, FPS, W, H_SMOOTH, 7, "cpu"))
    else:
        n = ref.render_hard_clip("unused.mp4", SECONDS, FPS, W, H, 11, preset)
        got = list(sc.iter_hard_frames(SECONDS, FPS, W, H, 11, preset, "cpu"))
    assert n == len(got) == len(frames) == int(SECONDS * FPS)
    d = np.abs(np.stack(frames).astype(np.int16) - np.stack(got))
    assert d.max() <= 1 and (d > 0).mean() <= LSB_SHARE, (d.max(), (d > 0).mean())
    if preset == "routing":
        assert all(not np.array_equal(a, b) for a, b in zip(got, got[1:]))
    if preset == "v1":
        hud = np.stack(got)[:, 40:H, 40:301]
        assert (hud == hud[:1]).all()


def test_cli_writes_y4m(tmp_path, monkeypatch):
    out = tmp_path / "clip.y4m"
    res = cli.main([str(out), "--preset", "routing", "--seconds", "0.1", "--width", "320",
                    "--height", "128", "--device", "cpu"])
    with VideoReader(str(out)) as r:
        frames = list(r)
    assert res["frames"] == len(frames) == 6 and frames[0].shape == (128, 320, 3)
    assert all(res[k] > 0 for k in ("textures", "composite", "write"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="only Y4M"):
        cli.main([str(tmp_path / "clip.mp4"), "--preset", "hard", "--seconds", "0.1", "--width", "320",
                  "--height", "128", "--device", "cpu"])
