"""The OpenCV drawing and warping calls of the synthetic scenes, in numpy
(``vfisr_tpu/train/data.py`` draws with ``cv2``, which the card's machine
does not have).

- ``rotation_matrix_2d``: ``cv2.getRotationMatrix2D``, closed form.
- ``warp_affine``: ``cv2.warpAffine`` with INTER_LINEAR, BORDER_REFLECT
  (``fedcba|abcdef|fedcba``) or the constant zero border, on uint8 HWC or
  float32 HW images. M is inverted as ``cv2.invertAffineTransform`` does and
  each output pixel is a bilinear sample at the inverted map in OpenCV 5's
  float32 arithmetic (``warp_affine``'s docstring), pixel for pixel: a
  float64 sample leaves about one pixel in 10^4 1 LSB off, where the value
  is within 1e-4 of .5, and the older recipe of 1/32 coordinates and
  15-bit weights 13% of them.
- ``fill_circle``, ``fill_rectangle``: ``cv2.circle``/``cv2.rectangle``
  with thickness -1 (the disk is x^2 + y^2 <= r^2, which is OpenCV's at the
  scenes' radii).
- ``put_hud_label``: the scenes' white HUD box with its "HP" label
  (``putText``, FONT_HERSHEY_SIMPLEX at 0.5, black, thickness 1, at the
  box's (4, 16)). No Hershey renderer is here: the label is the fixed
  raster OpenCV draws inside the box, a literal below.
"""

from __future__ import annotations

import math

import numpy as np

# the grey values putText leaves in the white 57x21 box, rows 5-15 and
# columns 5-23 of it (255 where it leaves the box white), one hex row each
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
HP_OFFSET = (5, 5)  # (row, column) of the raster in the box
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
    if border not in ("reflect", "constant"):
        raise ValueError(f"border {border!r}: 'reflect' or 'constant'")
    if src.dtype not in (np.uint8, np.float32):
        raise ValueError(f"warp_affine takes uint8 or float32 images, not {src.dtype}")
    h, w = src.shape[:2]
    ow, oh = size
    inv = invert_affine(m).astype(np.float32)
    xs = np.arange(ow, dtype=np.float32)[None, :]
    ys = np.arange(oh, dtype=np.float32)[:, None]
    vector = xs < ow - ow % CV_VECTOR_COLUMNS
    sx = np.where(vector, _fma(inv[0, 0], xs, inv[0, 1] * ys + inv[0, 2]),
                  _fma(inv[0, 0], xs, inv[0, 1] * ys) + inv[0, 2])
    sy = np.where(vector, _fma(inv[1, 0], xs, inv[1, 1] * ys + inv[1, 2]),
                  _fma(inv[1, 0], xs, inv[1, 1] * ys) + inv[1, 2])
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


def fill_circle(img: np.ndarray, center, radius: int, value) -> np.ndarray:
    """``cv2.circle(img, center, radius, value, -1)``: in place, returns img."""
    cx, cy = center
    yy, xx = np.ogrid[0:img.shape[0], 0:img.shape[1]]
    img[(xx - cx) ** 2 + (yy - cy) ** 2 <= radius * radius] = value
    return img


def fill_rectangle(img: np.ndarray, pt1, pt2, value) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, value, -1)``: both corners inclusive,
    clipped to the image; in place, returns img."""
    (xa, ya), (xb, yb) = pt1, pt2
    x0, x1 = max(min(xa, xb), 0), min(max(xa, xb), img.shape[1] - 1)
    y0, y1 = max(min(ya, yb), 0), min(max(ya, yb), img.shape[0] - 1)
    if x0 <= x1 and y0 <= y1:
        img[y0:y1 + 1, x0:x1 + 1] = value
    return img


def put_hud_label(img: np.ndarray, x0: int, y0: int) -> np.ndarray:
    """The scenes' HUD (``train/data.py:135-136``): a white box from (x0, y0)
    to (x0 + 56, y0 + 20) with "HP" in it, on an [H, W, 3] uint8 frame that
    holds the whole box; in place, returns img."""
    bw, bh = HUD_BOX
    if not (0 <= x0 and x0 + bw <= img.shape[1] and 0 <= y0 and y0 + bh <= img.shape[0]):
        raise ValueError(f"the HUD box at ({x0}, {y0}) leaves the {img.shape[1]}x{img.shape[0]} "
                         "frame")
    fill_rectangle(img, (x0, y0), (x0 + bw - 1, y0 + bh - 1), (255, 255, 255))
    ry, rx = HP_OFFSET
    rh, rw = HP_RASTER.shape
    img[y0 + ry:y0 + ry + rh, x0 + rx:x0 + rx + rw] = HP_RASTER[..., None]
    return img
