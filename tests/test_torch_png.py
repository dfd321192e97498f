"""vfisr_tpu_torch/data/png.py held against OpenCV (the reference reads and
writes its frames with cv2.imread/imwrite), and data/extract_intervals.py
against vfisr_tpu/data/extract_intervals.py.

Images are made with numpy from a seed: smooth gradients with noisy blocks,
so that libpng's adaptive filter choice takes every filter type. Every
comparison of pixels is bit-equal: PNG is lossless.
"""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from vfisr_tpu.data import extract_intervals as jext
from vfisr_tpu_torch.data import extract_intervals as text
from vfisr_tpu_torch.data.png import SIGNATURE, _chunk, read_png, write_png


def _image(seed: int, h: int = 61, w: int = 97) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) % 256], -1).astype(np.uint8)
    img[h // 4:h // 2, w // 3:w // 2] = rng.integers(0, 256, (h // 2 - h // 4, w // 2 - w // 3, 3))
    return img


def _cv2_read(path) -> np.ndarray:
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _filter_rows(px: np.ndarray, ftypes) -> bytes:
    """PNG-filter [H, W, bpp] uint8 rows with the given filter per row."""
    h, w, bpp = px.shape
    cur = px.astype(np.int32).reshape(h, w * bpp)
    out = bytearray()
    for y in range(h):
        f = int(ftypes[y])
        row = cur[y]
        up = cur[y - 1] if y else np.zeros_like(row)
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        out.append(f)
        out += ((row - pred) % 256).astype(np.uint8).tobytes()
    return bytes(out)


def _png(path, px: np.ndarray, color: int, ftypes, depth=8, interlace=0, raw=None):
    h, w = px.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    data = raw if raw is not None else _filter_rows(px.reshape(h, w, -1), ftypes)
    path.write_bytes(SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"tEXt", b"k\x00v")
                     + _chunk(b"IDAT", zlib.compress(data)[:40])
                     + _chunk(b"IDAT", zlib.compress(data)[40:]) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("strategy", [cv2.IMWRITE_PNG_STRATEGY_DEFAULT,
                                      cv2.IMWRITE_PNG_STRATEGY_FILTERED,
                                      cv2.IMWRITE_PNG_STRATEGY_RLE])
@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
def test_reads_cv2_pngs(tmp_path, kind, strategy):
    img = _image(1)
    if kind == "gray":
        arr = img[..., 0]
    elif kind == "rgba":
        arr = cv2.cvtColor(np.dstack([img, img[..., 1] ^ 0x5A]), cv2.COLOR_RGBA2BGRA)
    else:
        arr = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    path = tmp_path / f"{kind}.png"
    assert cv2.imwrite(str(path), arr, [cv2.IMWRITE_PNG_STRATEGY, strategy,
                                        cv2.IMWRITE_PNG_COMPRESSION, 6])
    out = read_png(path)
    assert out.dtype == np.uint8 and out.shape == img.shape
    assert np.array_equal(out, _cv2_read(path))


@pytest.mark.parametrize("ftypes", ["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("color", [0, 2, 6])
def test_every_row_filter(tmp_path, ftypes, color):
    """Hand-built rows of each filter (all rows one filter, or a seeded mix
    of the five), in two IDAT chunks with an ancillary chunk between: the
    original pixels back, and cv2 reads the same file alike."""
    img = _image(2)
    h = img.shape[0]
    names = ["none", "sub", "up", "average", "paeth"]
    fl = (np.random.default_rng(3).integers(0, 5, h) if ftypes == "mixed"
          else np.full(h, names.index(ftypes)))
    px = {0: img[..., :1], 2: img, 6: np.dstack([img, img[..., 2]])}[color]
    path = tmp_path / "f.png"
    _png(path, px, color, fl)
    out = read_png(path)
    assert np.array_equal(out, np.repeat(img[..., :1], 3, 2) if color == 0 else img)
    assert np.array_equal(out, _cv2_read(path))


@pytest.mark.parametrize("gray", [False, True])
def test_cv2_reads_what_write_png_writes(tmp_path, gray):
    img = _image(4, 72, 130)
    path = tmp_path / "w.png"
    write_png(path, img[..., 0] if gray else img)
    want = np.repeat(img[..., :1], 3, 2) if gray else img
    assert np.array_equal(_cv2_read(path), want)
    assert np.array_equal(read_png(path), want)
    data = path.read_bytes()
    (n,) = struct.unpack(">I", data[33:37])  # the one IDAT, after the signature and IHDR
    assert data[37:41] == b"IDAT"
    stride = 1 + (img.shape[1] if gray else img[0].size)
    assert zlib.decompress(data[41:41 + n])[::stride] == bytes([1]) * img.shape[0]  # Sub rows


def test_unsupported_pngs_raise(tmp_path):
    img = _image(5)
    p = tmp_path / "x.png"
    cv2.imwrite(str(p), (img.astype(np.uint16) * 257)[..., ::-1])
    with pytest.raises(ValueError, match="16-bit"):
        read_png(p)
    _png(p, img[..., :1], 3, np.zeros(img.shape[0]))
    with pytest.raises(ValueError, match="palette"):
        read_png(p)
    _png(p, img[..., :2], 4, np.zeros(img.shape[0]))
    with pytest.raises(ValueError, match="gray\\+alpha"):
        read_png(p)
    _png(p, img, 2, np.zeros(img.shape[0]), interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        read_png(p)
    _png(p, img, 2, None, raw=b"\x07" + bytes(img[0].size) + bytes((img[0].size + 1) * 60))
    with pytest.raises(ValueError, match="row filter 7"):
        read_png(p)
    _png(p, img, 2, np.zeros(img.shape[0]))
    data = bytearray(p.read_bytes())
    data[-20] ^= 1  # inside the second IDAT's payload
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(p)
    p.write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(p)
    with pytest.raises(ValueError, match="uint8"):
        write_png(p, img.astype(np.float32))


def test_interval_helpers_match(tmp_path):
    for v in (0.0, 0.99, 1.0, 4.9, 14.0, 29.9, 30.0, 1e9, float("nan")):
        assert text.classify_difficulty(v) == jext.classify_difficulty(v)
    for shape in ((108, 250, 3), (200, 160, 3), (90, 160, 3)):
        f = np.arange(np.prod(shape), dtype=np.uint32).reshape(shape)
        assert np.array_equal(text.crop16_9(f), jext.crop16_9(f))
    a = cv2.GaussianBlur(_image(6, 96, 160), (0, 0), 3)
    b = np.roll(a, 3, axis=1)
    got = text.compute_motion_stats(a[..., ::-1], b[..., ::-1], device="cpu")
    ref = jext.compute_motion_stats(np.ascontiguousarray(a[..., ::-1]),
                                    np.ascontiguousarray(b[..., ::-1]))
    assert got.keys() == ref.keys() and got["mean_flow"] > 0.2
    # cv2's fixed-point bilinear resize of the gray frames lands some pixels
    # one LSB from the port's f32 one: 7e-4 of the mean flow here
    for k in got:
        assert got[k] == pytest.approx(ref[k], rel=2e-3, abs=1e-4), k


def test_load_interval_reads_what_cv2_wrote(tmp_path):
    d = tmp_path / "clips" / "c" / "intervals" / "interval_0002"
    frames = [_image(i, 64, 96) for i in range(5)]
    for sub in ("keyframes", "midpoints"):
        (d / sub).mkdir(parents=True)
    for i, f in enumerate(frames):
        cv2.imwrite(str(d / "keyframes" / f"kf_{i:04d}.png"), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        if i < 4:
            write_png(d / "midpoints" / f"gt_{i:04d}.png", f[::-1].copy())
    (d / "meta.json").write_text(json.dumps({"difficulty": "HARD"}))
    kfs, mids, meta = text.load_interval("c", 2, tmp_path)
    jkfs, jmids, jmeta = jext.load_interval("c", 2, tmp_path)
    assert meta == jmeta == {"difficulty": "HARD"}
    assert len(kfs) == 5 and len(mids) == 4
    for a, b in zip(kfs + mids, jkfs + jmids):
        assert np.array_equal(a, b)
    kfs, mids, _ = text.load_interval("c", "interval_0002", tmp_path, max_frames=2)
    assert len(kfs) == len(mids) == 2
    with pytest.raises(FileNotFoundError):
        text.load_interval("c", 3, tmp_path)
