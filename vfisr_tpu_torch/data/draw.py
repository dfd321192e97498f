"""The OpenCV drawing and warping calls of the synthetic scenes and clips, in
numpy (``vfisr_tpu/train/data.py``, ``scripts/make_synthetic_clip.py`` and
``vfisr_tpu/evaluation/lpips_calibrate.py`` draw with ``cv2``, which the
card's machine does not have). Each writes HWC uint8 in place, as cv2 does,
and equals OpenCV 5.0.0 on an x86-64 host pixel for pixel unless it says
otherwise.

- ``rotation_matrix_2d``: ``cv2.getRotationMatrix2D``, closed form.
- ``warp_affine``: ``cv2.warpAffine`` with INTER_LINEAR, BORDER_REFLECT
  (``fedcba|abcdef|fedcba``) or the constant zero border, on uint8 HWC or
  float32 HW images. M is inverted as ``cv2.invertAffineTransform`` does and
  each output pixel is a bilinear sample at the inverted map in OpenCV 5's
  float32 arithmetic (``warp_affine``'s docstring), pixel for pixel: a
  float64 sample leaves about one pixel in 10^4 1 LSB off, where the value
  is within 1e-4 of .5, and the older recipe of 1/32 coordinates and
  15-bit weights 13% of them.
- ``remap``: ``cv2.remap`` with INTER_LINEAR and BORDER_REFLECT on float32
  images and float32 maps. OpenCV 5 samples a float map at its float
  coordinates (no 1/32 quantisation) with the lerps of ``warp_affine``.
- ``line``, ``circle``, ``rectangle``: ``cv2.line``, ``cv2.circle`` and
  ``cv2.rectangle`` at any thickness (-1 fills; LINE_8), by OpenCV's own
  integer rasterisers: Bresenham for thin lines,
  the 16.16 fixed-point polygon fill with round caps for thick ones, the
  midpoint circle, and a polygon of 5-degree steps for a thick circle.
  A thick line at an angle, or a thick circle, whose stroke would leave
  the image raises: OpenCV 5 clips those by a rule not reproduced here
  (axis-parallel thick lines and rectangles clip as OpenCV does).
- Text. ``putText`` (FONT_HERSHEY_SIMPLEX) is anti-aliased on OpenCV 5, even
  at LINE_8: each pixel becomes ``round(bg + (colour - bg) * a / 255)`` with
  a coverage ``a`` that depends only on the string, scale and thickness.
  ``put_label`` draws the fixed labels ("HP", "MAP", "AMMO 30/120", "A7")
  from their coverage rasters, taken from cv2, on any background and in any
  colour, equal to cv2. ``put_signage`` draws other strings of the signage
  glyphs at scales 0.5-1.4 with a raster of the port's own (a 5x7 stroke
  font), held by contract: ``text_size`` equals ``cv2.getTextSize``
  (OpenCV 5's font size ``rint(scale / 0.037)`` px, a width table per size
  and weight taken from cv2, thickness 1 regular and 2 or more bold), the
  ink lies inside that box, and each glyph's ink equals cv2's mean ink for
  that glyph and weight.
"""

from __future__ import annotations

import base64
import functools
import math
import zlib

import numpy as np

# "HP" (0.5, thickness 1) in black on white: the grey values putText leaves
# in the white 57x21 HUD box, rows 5-15 and columns 5-23 of it (the origin
# at the box's (4, 16)), 255 minus the label's coverage; one hex row each
_HP_ROWS = (
    "b0abfffffffff988daffb08484848cb9f1ffff",
    "493effffffffe700a0ff490d393929001dd0ff",
    "493effffffffe700a0ff493bffffffdd1f3cff",
    "493effffffffe700a0ff493bffffffff7905f8",
    "493effffffffe700a0ff493bffffffff491dff",
    "4902070707070600a0ff4927abab9b54037dff",
    "4927a0a0a0a09100a0ff490516161e4798ffff",
    "493effffffffe700a0ff4937ffffffffffffff",
    "493effffffffe700a0ff4937ffffffffffffff",
    "493effffffffe700a0ff4937ffffffffffffff",
    "5146ffffffffec03a8ff513fffffffffffffff",
)
HP_RASTER = np.frombuffer(bytes.fromhex("".join(_HP_ROWS)), np.uint8).reshape(11, 19)
HUD_BOX = (57, 21)  # (width, height): the box spans (x0, y0) to (x0 + 56, y0 + 20)
# the columns of warpAffine's vector loop on an x86-64 host (OpenCV 5.0.0);
# the columns past its last whole block take its scalar loop
CV_VECTOR_COLUMNS = 16


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """[2, 3] float64: rotation by ``angle`` degrees (counter-clockwise on
    screen) and ``scale`` about ``center`` = (x, y), which OpenCV takes as
    float32 (a ``Point2f``)."""
    a = math.radians(angle)
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64 (0 for a singular matrix)."""
    m = np.asarray(m, np.float64)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def _reflect(i: np.ndarray, n: int) -> np.ndarray:
    """BORDER_REFLECT indices: -1 -> 0, n -> n - 1 (the edge repeated)."""
    period = 2 * n
    i = np.mod(i, period)
    return np.where(i >= n, period - 1 - i, i)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c in float32 with one rounding (the float64 product of two
    float32 values is exact; the sum rounds to float64, then to float32)."""
    product = np.float64(a) * np.asarray(b, np.float64)
    return (product + np.asarray(c, np.float64)).astype(np.float32)


def warp_affine(src: np.ndarray, m, size, border: str = "reflect") -> np.ndarray:
    """``cv2.warpAffine(src, m, size, flags=INTER_LINEAR, borderMode=...)``.

    src: [H, W, C] uint8 or [H, W] float32. size: (width, height) of the
    output. border: "reflect" (BORDER_REFLECT) or "constant" (zeros).

    OpenCV 5's arithmetic, in float32: in its vector blocks of
    ``CV_VECTOR_COLUMNS`` columns the inverted map's row term ``M1 * y + M2``
    rounded twice, then ``sx = fma(M0, x, row)``; in the columns past the
    last whole block (its scalar loop) ``sx = fma(M0, x, M1 * y) + M2``; the
    taps' fractions ``sx - floor(sx)``; a horizontal then a vertical ``fma``
    lerp; uint8 rounded half to even."""
    if src.dtype not in (np.uint8, np.float32):
        raise ValueError(f"warp_affine takes uint8 or float32 images, not {src.dtype}")
    ow, oh = size
    inv = invert_affine(m).astype(np.float32)
    xs = np.arange(ow, dtype=np.float32)[None, :]
    ys = np.arange(oh, dtype=np.float32)[:, None]
    vector = xs < ow - ow % CV_VECTOR_COLUMNS
    sx = np.where(vector, _fma(inv[0, 0], xs, inv[0, 1] * ys + inv[0, 2]),
                  _fma(inv[0, 0], xs, inv[0, 1] * ys) + inv[0, 2])
    sy = np.where(vector, _fma(inv[1, 0], xs, inv[1, 1] * ys + inv[1, 2]),
                  _fma(inv[1, 0], xs, inv[1, 1] * ys) + inv[1, 2])
    return _bilinear(src, sx, sy, border)


def remap(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
          border: str = "reflect") -> np.ndarray:
    """``cv2.remap(src, map_x, map_y, INTER_LINEAR, borderMode=...)``: src
    [H, W(, C)] float32, maps float32 of the output's size."""
    if src.dtype != np.float32:
        raise ValueError(f"remap takes float32 images, not {src.dtype}")
    return _bilinear(src, np.asarray(map_x, np.float32), np.asarray(map_y, np.float32), border)


def _bilinear(src: np.ndarray, sx: np.ndarray, sy: np.ndarray, border: str) -> np.ndarray:
    """The bilinear sample of src at float32 (sx, sy), as OpenCV 5 forms it:
    the taps' fractions ``s - floor(s)``, a horizontal then a vertical
    ``fma`` lerp, uint8 rounded half to even."""
    if border not in ("reflect", "constant"):
        raise ValueError(f"border {border!r}: 'reflect' or 'constant'")
    h, w = src.shape[:2]
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    x0, y0 = fx.astype(np.int64), fy.astype(np.int64)
    # the image's pixels as rows, and a zero row past them for taps outside
    # it under the constant border
    img = src.astype(np.float32).reshape(h * w, -1)
    img = np.concatenate([img, np.zeros((1, img.shape[1]), np.float32)])
    if border == "reflect":
        rows = [_reflect(y0 + d, h) * w for d in (0, 1)]
        cols = [_reflect(x0 + d, w) for d in (0, 1)]
    else:
        rows = [np.where((y0 + d >= 0) & (y0 + d < h), (y0 + d) * w, -h * w) for d in (0, 1)]
        cols = [np.where((x0 + d >= 0) & (x0 + d < w), x0 + d, -h * w) for d in (0, 1)]

    def tap(dy, dx):
        return np.take(img, np.maximum(rows[dy] + cols[dx], -1), axis=0)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    top = _fma(ax, p01 - p00, p00)
    bottom = _fma(ax, p11 - p10, p10)
    out = _fma(ay, bottom - top, top)
    if src.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out[..., 0] if src.ndim == 2 else out


# ---------------------------------------------------------------------------
# OpenCV's integer rasterisers at LINE_8 (imgproc's drawing code): 16.16
# fixed point, C's truncating division, round half to even
# ---------------------------------------------------------------------------

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1, p2):
    """``cv::clipLine`` to the rectangle [0, w) x [0, h): the clipped (p1, p2),
    or None when the segment misses it."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def _line(img: np.ndarray, p1, p2, colour) -> None:
    """A thin line: 8-connected Bresenham from the left end point (the top
    one of a vertical line), after clipping to the image."""
    h, w = img.shape[:2]
    if not all(0 <= x < w and 0 <= y < h for x, y in (p1, p2)):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy, p1 = -dx, -dy, p2
    step = 1 if dy >= 0 else -1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    k = np.arange(major + 1)
    # the minor axis steps where Bresenham's error, dx - 2dy at first, goes
    # below 0: after k steps it has stepped ceil((2 minor k - major) / 2 major)
    m = -((major - 2 * minor * k) // (2 * major)) if major else k * 0
    if dy > dx:
        img[p1[1] + step * k, p1[0] + m] = colour
    else:
        img[p1[1] + step * m, p1[0] + k] = colour


def _poly_edge(img: np.ndarray, p1, p2, colour) -> None:
    """An edge of the filled polygon, 16.16 end points: one pixel per row
    (or column) along the major axis from the lower end, the minor
    coordinate stepped in fixed point, the far end point rounded and set."""
    h, w = img.shape[:2]
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if (dx < 0) if x_major else (dy < 0):
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    if x_major:
        k = np.arange(((x2 - x1) >> XY_SHIFT) + 1)
        xs = ((x1 + _HALF) >> XY_SHIFT) + k
        ys = (y1 + _HALF + k * _cdiv(dy << XY_SHIFT, abs(dx) | 1)) >> XY_SHIFT
    else:
        k = np.arange(((y2 - y1) >> XY_SHIFT) + 1)
        ys = ((y1 + _HALF) >> XY_SHIFT) + k
        xs = (x1 + _HALF + k * _cdiv(dx << XY_SHIFT, abs(dy) | 1)) >> XY_SHIFT
    xs = np.append(xs, (x2 + _HALF) >> XY_SHIFT)
    ys = np.append(ys, (y2 + _HALF) >> XY_SHIFT)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[inside], xs[inside]] = colour


def _circle(img: np.ndarray, center, radius: int, colour, fill: bool) -> None:
    """The midpoint circle (one pixel wide) or disk, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, 2 * radius - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy), (cy + dx, dy)):
            if 0 <= y < h:
                if fill:
                    a, b = max(cx - half, 0), min(cx + half, w - 1)
                    if a <= b:
                        img[y, a:b + 1] = colour
                else:
                    for x in (cx - half, cx + half):
                        if 0 <= x < w:
                            img[y, x] = colour
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _fill_convex(img: np.ndarray, v: list, colour, shift: int) -> None:
    """A filled convex polygon, its points in fixed point of ``shift`` bits:
    the outline's edges, then each row from the left edge rounded to the
    right edge rounded, the edges walked from the top point both ways."""
    h, w = img.shape[:2]
    n = len(v)
    delta = 1 << shift >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    for x, y in v:
        p = (x << up, y << up)
        if shift == 0:
            _line(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT), (x, y), colour)
        else:
            _poly_edge(img, p0, p, colour)
        p0 = p
    xs, ys = [x for x, _ in v], [y for _, y in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    idx, di = [imin, imin], [1, n - 1]
    ye, ex, edx = [ymin, ymin], [-XY_ONE, -XY_ONE], [0, 0]
    edges = n
    y = ymin
    while True:
        for i in (0, 1):
            if y < ye[i]:
                continue
            i0 = idx[i]
            i1 = (i0 + di[i]) % n
            while edges > 0:
                edges -= 1
                ty = (v[i1][1] + delta) >> shift
                if ty > y:
                    xs0, xs1 = v[i0][0] << up, v[i1][0] << up
                    ye[i] = ty
                    edx[i] = _cdiv((xs1 - xs0) * 2 + (ty - y), 2 * (ty - y))
                    ex[i] = xs0
                    idx[i] = i1
                    break
                i0, i1 = i1, (i1 + di[i]) % n
            else:
                edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted(ex)
            x1, x2 = (left + _HALF) >> XY_SHIFT, (right + _HALF) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = colour
        ex[0] += edx[0]
        ex[1] += edx[1]
        y += 1
        if y > ymax:
            break


def _thick_line(img: np.ndarray, p0, p1, colour, thickness: int, caps: int, shift: int) -> None:
    """A line ``thickness`` px wide: the quadrilateral of its two sides, half
    the thickness (plus half a pixel when odd) from the centre line, and
    filled disks of radius ``thickness // 2`` rounded at the ends that
    ``caps`` names (bit 0: p0, bit 1: p1)."""
    up = XY_SHIFT - shift
    p0 = (p0[0] << up, p0[1] << up)
    p1 = (p1[0] << up, p1[1] << up)
    if thickness <= 1:
        _line(img, ((p0[0] + _HALF) >> XY_SHIFT, (p0[1] + _HALF) >> XY_SHIFT),
              ((p1[0] + _HALF) >> XY_SHIFT, (p1[1] + _HALF) >> XY_SHIFT), colour)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * XY_ONE * 0.5) / math.sqrt(r)
        ox, oy = round(dy * r), round(dx * r)
        _fill_convex(img, [(p0[0] + ox, p0[1] + oy), (p0[0] - ox, p0[1] - oy),
                           (p1[0] - ox, p1[1] - oy), (p1[0] + ox, p1[1] + oy)], colour, XY_SHIFT)
    for i, p in enumerate((p0, p1)):
        if caps & (i + 1):
            _circle(img, ((p[0] + _HALF) >> XY_SHIFT, (p[1] + _HALF) >> XY_SHIFT),
                    (half + _HALF) >> XY_SHIFT, colour, True)


def _poly_line(img: np.ndarray, v: list, closed: bool, colour, thickness: int, shift: int) -> None:
    """Segments through v (closed: back to v[0]), each capped at its end and
    the first at its start too."""
    caps = 2 if closed else 3
    p0 = v[-1] if closed else v[0]
    for p in (v if closed else v[1:]):
        _thick_line(img, p0, p, colour, thickness, caps, shift)
        p0, caps = p, 2


# OpenCV's sine table (degrees 0-450), float32 of 7-decimal values
_SIN = np.round(np.sin(np.deg2rad(np.arange(451))), 7).astype(np.float32).astype(np.float64)


def _circle_polygon(cx: int, cy: int, radius: int) -> list:
    """``ellipse2Poly`` of a circle in 16.16 fixed point: points every 5
    degrees (90, 30 or 18 for radii under 3, 10 or 15), each rounded in two
    parts as OpenCV rounds it, repeats dropped."""
    r_px = (radius + _HALF) >> XY_SHIFT
    step = 90 if r_px < 3 else 30 if r_px < 10 else 18 if r_px < 15 else 5
    pts = []
    for a in range(0, 360 + step, step):
        a = min(a, 360)
        x = cx + radius * _SIN[450 - a]
        y = cy + radius * _SIN[a]
        px, py = round(x / XY_ONE) << XY_SHIFT, round(y / XY_ONE) << XY_SHIFT
        p = (px + round(x - px), py + round(y - py))
        if not pts or p != pts[-1]:
            pts.append(p)
    return pts if len(pts) > 1 else [(cx, cy)] * 2


def _require_inside(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, what: str) -> None:
    h, w = img.shape[:2]
    if x0 < 0 or y0 < 0 or x1 > w - 1 or y1 > h - 1:
        raise ValueError(f"{what} leaves the {w}x{h} image: OpenCV 5 clips such a stroke "
                         "by a rule this port does not reproduce")


def line(img: np.ndarray, pt1, pt2, colour, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, colour, thickness)`` (LINE_8): in place,
    returns img. A thick line at an angle must stay ``thickness`` px inside
    the image."""
    (x0, y0), (x1, y1) = (tuple(int(c) for c in p) for p in (pt1, pt2))
    if thickness > 1 and x0 != x1 and y0 != y1:
        _require_inside(img, min(x0, x1) - thickness, min(y0, y1) - thickness,
                        max(x0, x1) + thickness, max(y0, y1) + thickness,
                        f"a {thickness} px line from {(x0, y0)} to {(x1, y1)}")
    _thick_line(img, (x0, y0), (x1, y1), colour, thickness, 3, 0)
    return img


def circle(img: np.ndarray, center, radius: int, colour, thickness: int = 1) -> np.ndarray:
    """``cv2.circle(img, center, radius, colour, thickness)`` (LINE_8;
    thickness -1 fills): in place, returns img. A thick outline must stay
    ``thickness`` px inside the image."""
    cx, cy = int(center[0]), int(center[1])
    if thickness > 1:
        reach = radius + thickness
        _require_inside(img, cx - reach, cy - reach, cx + reach, cy + reach,
                        f"a {thickness} px circle of radius {radius} at {(cx, cy)}")
        _poly_line(img, _circle_polygon(cx << XY_SHIFT, cy << XY_SHIFT, radius << XY_SHIFT),
                   False, colour, thickness, XY_SHIFT)
    else:
        _circle(img, (cx, cy), radius, colour, thickness < 0)
    return img


def rectangle(img: np.ndarray, pt1, pt2, colour, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, colour, thickness)`` (LINE_8; thickness
    -1 fills): in place, returns img."""
    (x0, y0), (x1, y1) = (tuple(int(c) for c in p) for p in (pt1, pt2))
    pts = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    if thickness >= 0:
        _poly_line(img, pts, True, colour, thickness, 0)
    else:
        _fill_convex(img, pts, colour, 0)
    return img


# ---------------------------------------------------------------------------
# Text (FONT_HERSHEY_SIMPLEX on OpenCV 5: anti-aliased coverage)
# ---------------------------------------------------------------------------

def _blend(img: np.ndarray, alpha: np.ndarray, y0: int, x0: int, colour) -> None:
    """``round(bg + (colour - bg) * alpha / 255)`` over the raster placed at
    (y0, x0), clipped to the image (the value is never half-way: 255 is
    odd)."""
    h, w = img.shape[:2]
    ah, aw = alpha.shape
    ya, yb, xa, xb = max(y0, 0), min(y0 + ah, h), max(x0, 0), min(x0 + aw, w)
    if ya >= yb or xa >= xb:
        return
    a = alpha[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.float64)[..., None]
    bg = img[ya:yb, xa:xb].astype(np.float64)
    c = np.asarray(colour, np.float64).reshape((1, 1, -1))
    img[ya:yb, xa:xb] = np.floor(bg + (c - bg) * a / 255.0 + 0.5).astype(img.dtype)


def _ink(b64: str, shape: tuple) -> np.ndarray:
    return np.frombuffer(zlib.decompress(base64.b64decode(b64)), np.uint8).reshape(shape)


@functools.lru_cache(maxsize=None)
def _labels() -> dict:
    """(text, scale, thickness) -> (coverage raster, (row, column) of its top
    left corner from the origin)."""
    return {
        ("HP", 0.5, 1): (255 - HP_RASTER, (-11, 1)),
        ("MAP", 0.8, 2): (_ink("".join(_MAP_INK), (17, 49)), (-17, 1)),
        ("AMMO 30/120", 1.1, 2): (_ink("".join(_AMMO30120_INK), (29, 220)), (-26, 0)),
        ("A7", 0.8, 1): (_ink("".join(_A7_INK), (17, 28)), (-17, 0)),
        # the blind study's side labels, drawn at thickness 8 then 3: OpenCV
        # 5 draws both the same (its anti-aliased glyphs cap the weight)
        **{("A", 2.0, th): (_ink("".join(_A_INK), (41, 40)), (-41, 0)) for th in (3, 8)},
        **{("B", 2.0, th): (_ink("".join(_B_INK), (41, 34)), (-41, 4)) for th in (3, 8)},
    }


def put_label(img: np.ndarray, text: str, org, scale: float, colour, thickness: int) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, colour,
    thickness)`` for the fixed labels of the scenes and clips ("HP" 0.5/1,
    "MAP" 0.8/2, "AMMO 30/120" 1.1/2, "A7" 0.8/1, and the blind study's
    "A" and "B" 2/8 and 2/3), on any background, any
    colour and at any origin (clipped to the image); in place, returns img."""
    key = (text, float(scale), int(thickness))
    if key not in _labels():
        raise ValueError(f"no coverage raster for the label {key}: put_label draws "
                         f"{sorted(_labels())}; put_signage draws other strings")
    alpha, (dy, dx) = _labels()[key]
    _blend(img, alpha, int(org[1]) + dy, int(org[0]) + dx, colour)
    return img


def put_hud_label(img: np.ndarray, x0: int, y0: int) -> np.ndarray:
    """The scenes' HUD (``train/data.py:135-136``): a white box from (x0, y0)
    to (x0 + 56, y0 + 20) with "HP" in it, on an [H, W, 3] uint8 frame that
    holds the whole box; in place, returns img."""
    bw, bh = HUD_BOX
    if not (0 <= x0 and x0 + bw <= img.shape[1] and 0 <= y0 and y0 + bh <= img.shape[0]):
        raise ValueError(f"the HUD box at ({x0}, {y0}) leaves the {img.shape[1]}x{img.shape[0]} "
                         "frame")
    rectangle(img, (x0, y0), (x0 + bw - 1, y0 + bh - 1), (255, 255, 255), -1)
    return put_label(img, "HP", (x0 + 4, y0 + 16), 0.5, (0, 0, 0), 1)


SIGNAGE_GLYPHS = "ABCDEFGHJKLMNPRSTUVWXYZ0123456789"
# the glyphs whose box reaches one row below the baseline (getTextSize's
# baseline 1 at every size and weight)
_DESCENDING = "CGJSU03568"
FONT_SIZES = (14, 38)  # the font sizes (px) of scales 0.5-1.4


def font_px(scale: float) -> int:
    """OpenCV 5's font size in px of a FONT_HERSHEY_SIMPLEX scale (the box's
    height)."""
    return int(np.rint(scale / 0.037))


def _metrics(text: str, scale: float, thickness: int) -> tuple:
    n = font_px(scale)
    bad = set(text) - set(SIGNAGE_GLYPHS)
    if bad or not FONT_SIZES[0] <= n <= FONT_SIZES[1]:
        raise ValueError(f"signage {text!r} at scale {scale}: glyphs {SIGNAGE_GLYPHS} at scales "
                         f"giving {FONT_SIZES[0]}-{FONT_SIZES[1]} px only (font size {n} px"
                         + (f", glyphs {''.join(sorted(bad))}" if bad else "") + ")")
    table = _ADV_BOLD if thickness > 1 else _ADV_REGULAR
    adv = bytes.fromhex(table[n - FONT_SIZES[0]])
    return n, [adv[SIGNAGE_GLYPHS.index(g)] for g in text]


def text_size(text: str, scale: float, thickness: int) -> tuple:
    """``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, scale, thickness)`` for
    signage strings: ((width, height), baseline); width is the glyphs'
    advances plus 1, height the font size."""
    n, adv = _metrics(text, scale, thickness)
    return (sum(adv) + 1, n), int(any(g in _DESCENDING for g in text))


# the signage font: 5x7 cells, '#' lit; lit cells side by side (or corner to
# corner with neither cell between them lit) are joined by a stroke
_GLYPHS = {
    "A": ".###./#...#/#...#/#####/#...#/#...#/#...#",
    "B": "####./#...#/#...#/####./#...#/#...#/####.",
    "C": ".###./#...#/#..../#..../#..../#...#/.###.",
    "D": "####./#...#/#...#/#...#/#...#/#...#/####.",
    "E": "#####/#..../#..../####./#..../#..../#####",
    "F": "#####/#..../#..../####./#..../#..../#....",
    "G": ".###./#...#/#..../#.###/#...#/#...#/.####",
    "H": "#...#/#...#/#...#/#####/#...#/#...#/#...#",
    "J": "..###/...#./...#./...#./...#./#..#./.##..",
    "K": "#...#/#..#./#.#../##.../#.#../#..#./#...#",
    "L": "#..../#..../#..../#..../#..../#..../#####",
    "M": "#...#/##.##/#.#.#/#.#.#/#...#/#...#/#...#",
    "N": "#...#/#...#/##..#/#.#.#/#..##/#...#/#...#",
    "P": "####./#...#/#...#/####./#..../#..../#....",
    "R": "####./#...#/#...#/####./#.#../#..#./#...#",
    "S": ".####/#..../#..../.###./....#/....#/####.",
    "T": "#####/..#../..#../..#../..#../..#../..#..",
    "U": "#...#/#...#/#...#/#...#/#...#/#...#/.###.",
    "V": "#...#/#...#/#...#/#...#/#...#/.#.#./..#..",
    "W": "#...#/#...#/#...#/#.#.#/#.#.#/#.#.#/.#.#.",
    "X": "#...#/#...#/.#.#./..#../.#.#./#...#/#...#",
    "Y": "#...#/#...#/.#.#./..#../..#../..#../..#..",
    "Z": "#####/....#/...#./..#../.#.../#..../#####",
    "0": ".###./#...#/#..##/#.#.#/##..#/#...#/.###.",
    "1": "..#../.##../..#../..#../..#../..#../.###.",
    "2": ".###./#...#/....#/...#./..#../.#.../#####",
    "3": "#####/...#./..#../...#./....#/#...#/.###.",
    "4": "...#./..##./.#.#./#..#./#####/...#./...#.",
    "5": "#####/#..../####./....#/....#/#...#/.###.",
    "6": "..##./.#.../#..../####./#...#/#...#/.###.",
    "7": "#####/....#/...#./..#../.#.../.#.../.#...",
    "8": ".###./#...#/#...#/.###./#...#/#...#/.###.",
    "9": ".###./#...#/#...#/.####/....#/...#./.##..",
}
_SUPERSAMPLE = 4


def _strokes(glyph: str) -> list:
    """The glyph's strokes as ((row, col), (row, col)) cell pairs, and each
    lone cell as a stroke of length 0."""
    rows = _GLYPHS[glyph].split("/")
    lit = {(r, c) for r, row in enumerate(rows) for c, ch in enumerate(row) if ch == "#"}
    strokes = []
    for r, c in sorted(lit):
        joined = False
        for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
            q = (r + dr, c + dc)
            if q in lit and (dr == 0 or dc == 0 or ((r, c + dc) not in lit and (r + dr, c) not in lit)):
                strokes.append(((r, c), q))
                joined = True
        if not joined and not any(((r - dr, c - dc) in lit) for dr, dc in
                                  ((0, 1), (1, 0), (1, 1), (1, -1))):
            strokes.append(((r, c), (r, c)))
    return strokes


@functools.lru_cache(maxsize=4096)
def _glyph_alpha(glyph: str, n: int, adv: int, bold: bool) -> np.ndarray:
    """[n, adv] uint8 coverage of one signage glyph in its cell (the cell's
    bottom row is the row above the baseline): the 5x7 strokes over the cap
    height, 4x4 samples per pixel, the ink the samples nearest the strokes
    that add up to cv2's mean ink for this glyph and weight."""
    s = _SUPERSAMPLE
    cap = int(round(0.74 * n))
    margin = max(1, int(round(0.12 * adv)))
    cw, ch = (adv - 2 * margin) / 5.0, cap / 7.0
    ys = (np.arange(n * s) + 0.5) / s
    xs = (np.arange(adv * s) + 0.5) / s
    py, px = np.meshgrid(ys, xs, indexing="ij")
    dist = np.full(py.shape, np.inf)
    for (r0, c0), (r1, c1) in _strokes(glyph):
        ax, ay = margin + (c0 + 0.5) * cw, n - cap + (r0 + 0.5) * ch
        bx, by = margin + (c1 + 0.5) * cw, n - cap + (r1 + 0.5) * ch
        vx, vy = bx - ax, by - ay
        t = np.clip(((px - ax) * vx + (py - ay) * vy) / max(vx * vx + vy * vy, 1e-12), 0, 1)
        dist = np.minimum(dist, np.hypot(px - (ax + t * vx), py - (ay + t * vy)))
    ink = (_INK_BOLD if bold else _INK_REGULAR)[SIGNAGE_GLYPHS.index(glyph)] / 1000.0
    k = min(int(round(ink * n * n * s * s)), dist.size)
    covered = np.zeros(dist.size, np.float64)
    covered[np.argsort(dist, axis=None, kind="stable")[:k]] = 1.0
    frac = covered.reshape(n, s, adv, s).mean(axis=(1, 3))
    return np.rint(frac * 255).astype(np.uint8)


def put_signage(img: np.ndarray, text: str, org, scale: float, colour, thickness: int) -> np.ndarray:
    """A signage string where ``cv2.putText(img, text, org,
    FONT_HERSHEY_SIMPLEX, scale, colour, thickness)`` draws one: the port's
    own glyphs (module docstring), blended as putText blends, in the box
    ``text_size`` gives (columns org.x to org.x + width - 1, rows org.y -
    height to org.y + baseline - 1); in place, returns img."""
    n, adv = _metrics(text, scale, thickness)
    x = int(org[0])
    for g, a in zip(text, adv):
        _blend(img, _glyph_alpha(g, n, a, thickness > 1), int(org[1]) - n, x, colour)
        x += a
    return img


# ---------------------------------------------------------------------------
# Tables taken from cv2 (OpenCV 5.0.0, x86-64)
# ---------------------------------------------------------------------------

# getTextSize's advance (px) of each of SIGNAGE_GLYPHS, one hex byte per
# glyph, one row per font size 14-38; regular (thickness 1) and bold
# (thickness 2 or more)
_ADV_REGULAR = (
    "0a0a090a09080a0a0909080b0a090909080a090b09090809090909090909090909",
    "0a0a0a0b09090a0b0a09090c0b0a0a09090b0a0c0a0a0909090909090909090909",
    "0b0b0b0b0a0a0b0c0a0a090d0b0a0b0a090c0b0d0a0b0a0a0a0a0a0a0a0a0a0a0a",
    "0c0c0c0c0b0a0c0c0b0a0a0e0c0b0b0b0a0c0b0e0b0b0a0b0b0b0b0b0b0b0b0b0b",
    "0c0c0c0d0b0b0d0d0c0b0a0f0d0c0c0b0b0d0c0f0c0c0b0b0b0b0b0b0b0b0b0b0b",
    "0d0d0d0d0c0b0d0e0c0c0b100e0d0d0c0b0e0d100c0d0c0c0c0c0c0c0c0c0c0c0c",
    "0e0e0e0e0c0c0e0f0d0c0c100e0d0e0d0c0f0d110d0d0c0d0d0d0d0d0d0d0d0d0d",
    "0f0f0e0f0d0d0f100e0d0c110f0e0e0d0c0f0e110e0e0d0d0d0d0d0d0d0d0d0d0d",
    "0f0f0f100e0d10100e0e0d12100f0f0e0d100f120e0f0e0e0e0e0e0e0e0e0e0e0e",
    "101010100e0e10110f0e0d13110f100f0e1110130f0f0e0f0f0f0f0f0f0f0f0f0f",
    "111111110f0e1112100f0e141110100f0e12101410100f0f0f0f0f0f0f0f0f0f0f",
    "11111112100f121310100f15121111100f12111510111010101010101010101010",
    "121212131010121311100f16131112111013121611111011111111111111111111",
    "131313131110131412111016141212111014121712121111111111111111111111",
    "141413141211141512121017141313121115131712131112121212121212121212",
    "141414151212151613121118151314131115141813141213131313131313131313",
    "151515161312151614131219161415131216141914141313131313131313131313",
    "16161616141316171413121a171515141317151a14151314141414141414141414",
    "16161617141317181514131b171516151317161b15161415151515151515151515",
    "17171718151418191615131c181617151418171c16161515151515151515151515",
    "18181819161518191715141c191717161519171d17171516161616161616161616",
    "191918191615191a1716151d19181817151a181d17181617171717171717171717",
    "1919191a17161a1b1817151e1a181917161a191e18181717171717171717171717",
    "1a1a1a1b17171a1c1917161f1b191918161b191f19191718181818181818181818",
    "1b1b1b1b18171b1c191816201c1a1a19171c1a20191a1819191919191919191919",
)
# cv2's ink of each glyph (its coverage summed, / 255) per font size squared,
# x 1000, the mean over sizes 14-38
_INK_REGULAR = (
    180, 232, 170, 207, 180, 146, 196, 191, 158, 175, 114, 237, 213, 174, 205, 180, 122, 174, 154,
    233, 172, 129, 174, 225, 137, 168, 171, 167, 176, 167, 117, 208, 166)
_ADV_BOLD = (
    "0a0a0a0a09090a0b0909080c0a090a09090a0a0c0a0a0909090909090909090909",
    "0b0b0b0b0a090b0b0a0a090d0b0a0a0a090b0a0d0a0a0a0a0a0a0a0a0a0a0a0a0a",
    "0c0b0b0c0a0a0c0c0b0b0a0e0c0b0b0b0a0c0b0e0b0b0a0b0b0b0b0b0b0b0b0b0b",
    "0c0c0c0c0b0b0c0d0c0b0a0e0c0c0c0b0b0d0c0e0c0c0b0b0b0b0b0b0b0b0b0b0b",
    "0d0d0d0d0c0b0d0e0c0c0b0f0d0c0d0c0b0d0d0f0d0c0c0c0c0c0c0c0c0c0c0c0c",
    "0e0e0e0e0c0c0e0e0d0d0b100e0d0d0d0c0e0d100d0d0c0d0d0d0d0d0d0d0d0d0d",
    "0f0e0e0f0d0d0f0f0e0d0c110f0e0e0d0d0f0e110e0e0d0d0d0d0d0d0d0d0d0d0d",
    "0f0f0f0f0e0d0f100e0e0d120f0e0f0e0d100f120f0f0e0e0e0e0e0e0e0e0e0e0e",
    "101010100e0e10110f0f0d13100f100f0e1010130f0f0e0f0f0f0f0f0f0f0f0f0f",
    "111111110f0e1112100f0e14111010100f11101410100f10101010101010101010",
    "12111112100f121210100f15121111100f12111511111010101010101010101010",
    "121212121010121311110f15131112111013121512111111111111111111111111",
    "131313131110131412111016131212121114131612121112121212121212121212",
    "141414141211141513121017141313121114131713131212121212121212121212",
    "151414151212151613131118151314131215141814141313131313131313131313",
    "151515151312151614141219161415141316151914141314141414141414141414",
    "16161616141316171514121a161515141317151a15151414141414141414141414",
    "17171617141417181515131b171616151417161b16161515151515151515151515",
    "18171718151418191616141c181617161518171c17161516161616161616161616",
    "18181819161519191716141c191718171519181d17171616161616161616161616",
    "191919191616191a1817151d19181817161a181d18181717171717171717171717",
    "1a19191a17161a1b1818151e1a181918171a191e19191718181818181818181818",
    "1b1a1a1b18171b1c1918161f1b191a19171b1a1f19191819191919191919191919",
    "1b1b1b1c18181c1d1a1917201c1a1a19181c1b201a1a1919191919191919191919",
    "1c1c1c1c19181c1d1a1a17211c1b1b1a191d1b211b1b191a1a1a1a1a1a1a1a1a1a",
)
_INK_BOLD = (
    268, 333, 256, 305, 272, 225, 295, 296, 242, 272, 179, 342, 314, 259, 305, 269, 193, 270, 239,
    341, 265, 200, 266, 313, 214, 257, 254, 248, 263, 247, 183, 294, 245)
# 'MAP' at 0.8, thickness 2: 17x49 at (-17, 1) from the origin
_MAP_INK = (
    "eNqFkksoRFEYx8+MR5gpKWVqmpXBQsyCsrGZYSGjFGmIkkxKWY1wpSYmsVJeO3lkIatZWHisZEMeCalRSmKBKSVv"
    "Bn/fedx5LORb3O//P+f/6557vmvyaV0ZTJVH03KVbNK0HqVNPo1XX0OekZwTwKgKVZEelLKcJLal5hFZT34Dc1F/"
    "tYmNpGPSQzI0IwIFQrsQq6BZuAWx0YYokP4gtoejwKam+Xd+SHgF8O3goesY0Aj8rAGXRh0Qp24hsSTft062HzFg"
    "Fdjin+FMANIegVvu6FWVLPuBdwlYIkCH4QKYTwBsX8AZd0Hg0DghugS6gfcsFgAeTXGAdY7ENHe1IbrOD3wU6cAR"
    "wYzlk21WQPjkJMQPgBru3PXi+JNmBTio11HfBTYSr/WtXTi3YY9PJUcHxoCXQrvdPgJ8WWPA8/58qXRuVkHPAFNA"
    "8k3cpHplZNZiyTFGp+JmbAVXmTpQHZfHqYxM6b+bDjBzEtOBZZpkWBTdO0r+AHhJIPNVDpKqmBbG/wW89PSolQPg"
    "LiURcHwiUqZ06j3QyRaB8zS10hrBdzFFMBAFfgH8wqJ5"
)
# 'AMMO 30/120' at 1.1, thickness 2: 29x220 at (-26, 0) from the origin
_AMMO30120_INK = (
    "eNrdWHtQVkUUX/l4iSiaggoSpEbpiI9BkfKdkflIMtPUUtScZJDS1C+TydK01CysbHyOQjoNPhoTR9EiM1/VDCkq"
    "U+LgC81nEiIqn/DBtufs3nt3773fxwzjH45nRjyPPWf3d3fP2bMfIQ8vRSYktCGPJvWtofT0I4ptJ6V0+YMI1GmW"
    "0+mcGKjL0bOdziR5QDdm7+XdghQQn5q555MR1sMUCTMYNNlH6EMHzdzw8+pp/Rqbxke5Ka2N0aTmacwnTrY3HfXx"
    "9vxvp/cOlnS2sRqXUaDPdMUaEEcbA6LvMfmUdwuj9ofvU05X0k1r/ZKq9CxqfWbcFfK1V9TxnzLdj5rQswSGHDGs"
    "DcZfE37u9zSdh1iTuO6Gn6bIAvGsvz7gO5DPebcQEn9DWvx6P2Wtq0zYBoCyzRFJs6WRNDzgOtMMF0Ia/2L5utU3"
    "V/Jb4SDeYu0XquEKNjpDE+NqVGy2FvLSHWX1ext7w9YXlLmKarE0/HUmX+CLDs4WdgPbh4rfOuIlVlSN0HyvYrvZ"
    "VIj7qAmbnSXWjfzvGc7NV5H7QcY2YNduTrm4CYVBTDcKh51ZmsIP7P0OxnDYhPeR6/g3NWOLqwbx+toZebjwCn8v"
    "sT4A6QL753pMwUaXcGkwNWOzs6xGdg4mNa6npp1N1fLdgNDCgD8H7NFmhATxMFv1UV1hMaHAjaigFmxLMaPbM64f"
    "Gvp4iXUaljcWNCkqtnuRIDhOWrFZLQ5cxBruH+4CYYEVWuAOA1oY+qYxbrIoQPqwtUzaqG8gdWUr2A6A9C7WlEti"
    "Hk+xEoBfGFTO/v6mYqNZUqVRsFktbZEbIgIcBmGbBVrIr6A/iTtCEtED6vxRuh75CK3AQ+YmINuDfaXzPV5QsF1h"
    "QnlrZA+JQ+Qp1kpgnyZwWLQbRUNQ04Vt8iU7bBbLi6jV8nAJSAVmaC0LQH2iBZdmgXCeMc/QCyGYhcPEuOmM/1Pw"
    "KTSnGVGxtYqNjW2OXAQmXJLHWAGl3O853D4J2ykodoTMhRytUrDZWSaA4bI2vSppd2Ex3j6PC3ERSPsZs4mVDdgL"
    "+oa4vYoYP0nzatuAmLAZ11wm6GvDPMYaKYq6z0WA3sDANg7wJ4beAtalYLOz4Pks0WZ9DaR/TUvZxnfZtW8OZuvn"
    "IOSyXHGxsgGT04l83POMLW0oe3rA9hXGy/AcK4cx1a20c9TfwJawgv059g37c9xHxWZnmSJd4qy8gVRuWsovesm7"
    "2pWJGcDtIiQdygZ2HmKvtjN2GakTm88XGOtEgMdYoVX8gLGmEtsJCVtLrf4OISZsNpY3tROP9CpIZabFZBt3663e"
    "+nocJVA2JGyR1Zb7ww5b0938M+FNZh/rbeOgH4NvHWQgIAv5Qg4SMzYby0SQL2oTj8Pb1YTNLyYmpktKNrYveeKc"
    "5JGXsWz8A8IEHAaxd5O6sHXC5KVFTxi1yxIrH7JxWjLQTswlCUHITfTvZcVmtSCaUm3mqUr2qYR5X+FHPsI2huTR"
    "yUyJ8caC2R+6mqF1YRvOT84RXi/tY3U09Xn8eAoEvLTuJFZsVktv9A4VUy8H4ZA9tgjIAhpPxsN/ld1qoWw8hd49"
    "wTwGmnGfOrCNwBj0gNYT28ZaYsbmDpcQBLKS4461w2axtETvofLdnWmspUdqamqyeB+GVYJxJOmMHsVYNt4Bthpr"
    "40HGzSbesQloB/XXm10sxyUzNuqUEJD4levGEDtsVst5LFq+OFUSRko1FrNDwjoPm9kQ4s+fLlg2sIsvxJYbOrrm"
    "3rEJaIeNl4ZdLOxVyvIFFWJHJCPQyIrNYknH6IXOCEfiRiwXFU2MUfgt6QLWtrSbjq+8PUy5mX9MP9Jwfi0w6VqX"
    "tMFwbDR4GCP8HMXA9WEXcBKHVjpuGKfu9rE2Uf0xAU063ujd6octrEQcau2FOk8aFc6VrjPFwvgWFHv+4HOdxTcL"
    "PQ0XVZPbjOtuOKabj1V3EnXHpKoJtYsVDBp3BFFeD8vrh42EFygTzlROVb8qZTmrMPfmKg6DQDWNcX9IfovN2Prz"
    "RkqhKLtYyaJV0agDXku+9cNGmvxkRK8cbUqZIUWG8fYYoUwu03XFfbBD/Eu/5jxiG2WLzRJrPmTbQCnUZnZYK1qT"
    "2ay//k/+sQpuwRxgPFvgck7LKoCkvrp3abz1VTrlaDmmyf6vY4z7YGMRHKLK48t4Ne8PP9sESl4TqlUYt9qSuLsm"
    "aJeDbWM9ePLrPLCVR2OLnokRZp1/p0FPOjRhq/Gmrw8psR4yas2y0h39aP6YHLYlZ8fUBxTrf72wiFo="
)
# 'A7' at 0.8, thickness 1: 17x28 at (-17, 0) from the origin
_A7_INK = (
    "eNpjYAABo4piMTCDgTG3AgYsIAK3/v+fCZGT+A8HK8ACtv///f/ABWay9s+EgO//J4MF5v9f+ux/LAMysPj/3xxE"
    "837+79Dxfx+K3LL/J8B00v+7jBr//ykhSUn+/B8NZhz5X8vAcPR/E5Jc4/9nbCBa7d9feQaG1P8PmeBS7C/+14MZ"
    "7f93A0m+r/9d4XKx/39KgGiWp/+jQPSi/8vhcqf+LwbT3v/fc4Jox//fBREeMAUz1vx/uxcE9v3/nwX3wHEwLfoT"
    "EUpn4B6IBDMK/j91goCY///1oB54ygpmXPzfDnPB2f/9UA/Ugvkm//9rwOSy/79mA3vghziYX/x/J9zlgq/+GgOp"
    "Jf8nQfgAfM2PRQ=="
)

_A_INK = (
    "eNpjYEABAtG5EGDDyIAHaH/9DwMb8Snc+B8BvHErE/2FpG4VbnV5SMr+fxfAqe4Msrr/6Th9gaLs/xFc6jpR1f1T"
    "wa6M+Qmquv+N2NW5weRvQOl72INwCVT6dgBMgx02ZbxfoLINbG+grDnY1CXAnK/KMA3K/MCJRd0+qOQJBgZLmMUR"
    "mMrk/0LlchgYGG9D2dsw1VVDpX6JAjkNUM5vSQx1sMDYAuKo/IPyitGVmaM66RiUdxFd3VSoxCcuMDcTps0AVRn7"
    "W6j4Aghf+CeU34uqLgim3xUqsB7Kf86Com4DVPgpM1QgGKbRC1mZCIY17O+gIiuQ1eXAdBvChWZCRb7xI6k7BRW8"
    "ihCyhWlNRYhpwsTahOFABJZqDyHUtf/HA/4pwZQxPcan7n89TJ0LXmX/78CS/yL86v7bQJTxfCagbhZEXRwBZf/f"
    "c4DV7SGk7n8YSJksLMH/LclHBav/I6fdShhvJ3qaVISl6t/iQN413JkLlgX/FzIwmKK5FhnAfXiegWEyjD0NMw9y"
    "f4RJ6rG9hjHNsOT9OTDJblcY6zK2ssQKJntP8haEcdYMaxnWCimS/nQAACOCCfo="
)

_B_INK = (
    "eNpjCc5FB/FepgpsDHDQ8B8r+LQ6RgiqYud/XOBHHTsBFf//XzMhpOL/KwVCKv5f5CGk4n8xkoqFyRCQUrfwKULF"
    "DUaEijRECPB0IZRYY1XBwLAQriIDhwpJuIpWHCoYnsGdh0vFfZhwBw4VfP9gwkE4VJTD3SGDXYX9d5joHaQQKxaF"
    "AHHDkMVwO/46EQr1DkIxt5QNv4o/aQRT0G4lginoiwPBFPRBD0nF7j4omHngFULJA3asIcZc8g2uJAtHqDvCw+wR"
    "G464nQE3xBCHCnu4ijAcKgThKqpwqBCHq6jAocINriISh4pNcBWW2FXEwhV8F8SiglFuHjw4/s9HhNitg1Bw+iNy"
    "zBgTytmrCMXtOW4CKu7J4k8ffyfxgBy+EZf813VWEK95vsCQ+/X03I45wdwwzwMAVl3KJQ=="
)
