"""PNG reader and writer in numpy and ``zlib`` (the port's counterpart of the
``cv2.imread``/``cv2.imwrite`` calls of ``vfisr_tpu/harness/triplet.py`` and
``vfisr_tpu/data/extract_intervals.py``, which the card's machine cannot
make: it has neither OpenCV nor PIL).

Scope: 8-bit gray, RGB and RGBA, not interlaced. Anything else raises and
names what it is. ``read_png`` returns HWC uint8 RGB, as
``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`` does: gray is repeated
into the three channels and alpha is dropped.

All five row filters decode. None and Sub rows depend on no other row and
decode together (Sub is a cumulative sum mod 256 along the row); Up rows
take the row above. Average and Paeth depend on the pixel to the left as
well as the row above, so a run of such rows decodes along anti-diagonals
(every pixel of a diagonal depends only on earlier diagonals), one numpy
step per diagonal. ``write_png`` writes filter 0 (None) rows, so what it
writes reads back on the fast path.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, name)
_COLOR_TYPES = {0: (1, "gray"), 2: (3, "RGB"), 3: (1, "palette"), 4: (2, "gray+alpha"),
                6: (4, "RGBA")}
_SUPPORTED = (0, 2, 6)
_FILTERS = ("None", "Sub", "Up", "Average", "Paeth")


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRC checked."""
    pos = len(SIGNATURE)
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError(f"{path}: PNG chunk {ctype!r} cut short")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        yield ctype, payload
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _unfilter_diagonals(raw: np.ndarray, paeth: np.ndarray, above: np.ndarray) -> np.ndarray:
    """Decode a run of Average/Paeth rows. raw [R, W, bpp] filtered bytes;
    paeth [R] bool (else Average); above [W, bpp] the decoded row above the
    run (zeros at the top). Pixel (i, x) needs (i, x-1), (i-1, x) and
    (i-1, x-1): all on earlier anti-diagonals i + x."""
    r, w, bpp = raw.shape
    out = np.zeros((r + 1, w + 1, bpp), np.int16)  # a row of `above` and a zero column
    out[0, 1:] = above
    raw16 = raw.astype(np.int16)
    for d in range(r + w - 1):
        i = np.arange(max(0, d - w + 1), min(r, d + 1))
        x = d - i
        a, b, c = out[i + 1, x], out[i, x + 1], out[i, x]  # left, up, up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred_paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(paeth[i][:, None], pred_paeth, (a + b) >> 1)
        out[i + 1, x + 1] = (raw16[i, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """rows [H, 1 + W*bpp] (each a filter byte and its filtered bytes) ->
    [H, W, bpp] uint8."""
    h = rows.shape[0]
    ftype = rows[:, 0]
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    raw = rows[:, 1:].reshape(h, -1, bpp)
    out = raw.copy()
    sub = ftype == 1
    if sub.any():  # out[x] = raw[x] + out[x - 1], per channel: a cumulative sum mod 256
        out[sub] = np.cumsum(raw[sub], axis=1, dtype=np.uint8)
    above = np.zeros(raw.shape[1:], np.uint8)
    y = 0
    while y < h:
        f = ftype[y]
        if f == 2:
            out[y] = raw[y] + above  # uint8 arithmetic wraps mod 256
        elif f >= 3:
            end = y
            while end < h and ftype[end] >= 3:
                end += 1
            out[y:end] = _unfilter_diagonals(raw[y:end], ftype[y:end] == 4, above)
            y = end
            above = out[y - 1]
            continue
        above = out[y]
        y += 1
    return out


def read_png(path) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG -> HWC uint8 RGB."""
    path = str(path)
    data = Path(path).read_bytes()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _compression, _filter, interlace = header
    if color not in _COLOR_TYPES:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    channels, name = _COLOR_TYPES[color]
    if color not in _SUPPORTED:
        raise ValueError(f"{path}: {name} PNG is not supported (8-bit gray, RGB and RGBA are)")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 1 + w * channels
    if buf.size != h * stride:
        raise ValueError(f"{path}: PNG image data holds {buf.size} bytes, {h * stride} expected")
    px = _unfilter(buf.reshape(h, stride), channels)
    if channels == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def write_png(path, image: np.ndarray) -> None:
    """Write HWC uint8 RGB (or HW uint8 gray) as an 8-bit PNG with filter 0
    rows."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes HxW or HxWx3 uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
