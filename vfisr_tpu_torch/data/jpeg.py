"""Baseline JPEG in torch and numpy (the port's counterpart of
``cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, q])`` and
``cv2.imdecode``, which the card's machine cannot be relied on to have).

What it covers is what the system uses: baseline sequential JPEG, 8 bits,
YCbCr 4:2:0 (libjpeg's default), the IJG quality scaling of the standard
quantisation tables and the standard Huffman tables (no optimised coding),
one interleaved scan, no restart markers. Images of any size; the edges
are padded as libjpeg pads them.

The arithmetic is libjpeg-turbo's integer arithmetic (``jccolor.c``,
``jcsample.c``'s h2v2 downsampling, ``jfdctint.c``, ``jcdctmgr.c``'s
reciprocal quantisation, ``jidctint.c``, ``jdsample.c``'s h2v2 fancy
upsampling, ``jdcolor.c``), so a frame encodes to the bytes OpenCV writes
and a file decodes to the pixels OpenCV reads. The colour transforms, the
chroma resampling, both DCTs and the (de)quantisation run as batched
integer tensor ops over 8x8 blocks on ``device``; the entropy coder and the
byte stream are host code (numpy, and one Python loop per decoded symbol).

``decode`` reads the files ``encode`` writes and OpenCV's default baseline
files: 3 components, 4:2:0 or 4:4:4. Anything else raises
``UnsupportedJPEG`` and names what it is (progressive, arithmetic or
lossless coding, 12-bit samples, restart markers, several scans, another
sampling layout).
"""

from __future__ import annotations

import array
import functools
import struct
from typing import Dict, List, Tuple

import numpy as np
import torch


class UnsupportedJPEG(ValueError):
    """A JPEG feature this module does not read."""


_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full((8, 8), 99)
_CHROMA_Q[0, :4] = (17, 18, 24, 47)
_CHROMA_Q[1, :4] = (18, 21, 26, 66)
_CHROMA_Q[2, :3] = (24, 26, 56)
_CHROMA_Q[3, :2] = (47, 66)
_CHROMA_Q = _CHROMA_Q.reshape(64)


def _zigzag() -> np.ndarray:
    """jpeg_natural_order: the natural (row-major) index of each zigzag
    position."""
    order = sorted(((y, x) for y in range(8) for x in range(8)),
                   key=lambda p: (p[0] + p[1], p[1] if (p[0] + p[1]) % 2 == 0 else p[0]))
    return np.array([y * 8 + x for y, x in order])


ZIGZAG = _zigzag()

# Annex K.3 tables: (counts of codes of length 1..16, symbols)
_AC_LUMA_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFFMAN = {
    (0, 0): (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 0): (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), _AC_LUMA_VALS),
    (0, 1): (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (1, 1): (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _AC_CHROMA_VALS),
}  # (class 0 DC / 1 AC, table id) -> (bits, vals)

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix16(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantisation tables in natural order at an IJG
    quality 1-100 (``jpeg_set_quality`` with baseline forced)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def scaled(base):
        return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)

    return scaled(_LUMA_Q), scaled(_CHROMA_Q)


# ---- the device side: integer transforms over 8x8 blocks ----------------

CONST_BITS, PASS1_BITS = 13, 2
F_0_298, F_0_390, F_0_541, F_0_765 = 2446, 3196, 4433, 6270
F_0_899, F_1_175, F_1_501, F_1_847 = 7373, 9633, 12299, 15137
F_1_961, F_2_053, F_2_562, F_3_072 = 16069, 16819, 20995, 25172


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _odd_part(t4, t5, t6, t7):
    """The odd half of jfdctint.c/jidctint.c (figure 8 of the paper):
    returns the four rotated terms in the order of t4..t7."""
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * F_1_175
    z1, z2 = z1 * -F_0_899, z2 * -F_2_562
    z3, z4 = z3 * -F_1_961 + z5, z4 * -F_0_390 + z5
    return (t4 * F_0_298 + z1 + z3, t5 * F_2_053 + z2 + z4,
            t6 * F_3_072 + z2 + z3, t7 * F_1_501 + z1 + z4)


def _fdct_pass(d: List[torch.Tensor], first: bool) -> List[torch.Tensor]:
    """One pass of libjpeg's ISLOW forward DCT over the 8 slices d."""
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
        shift = CONST_BITS - PASS1_BITS
    else:
        out[0], out[4] = _descale(t10 + t11, PASS1_BITS), _descale(t10 - t11, PASS1_BITS)
        shift = CONST_BITS + PASS1_BITS
    z1 = (t12 + t13) * F_0_541
    out[2] = _descale(z1 + t13 * F_0_765, shift)
    out[6] = _descale(z1 + t12 * -F_1_847, shift)
    o4, o5, o6, o7 = _odd_part(t4, t5, t6, t7)
    out[7], out[5], out[3], out[1] = (_descale(v, shift) for v in (o4, o5, o6, o7))
    return out


def _idct_pass(d: List[torch.Tensor], first: bool) -> List[torch.Tensor]:
    """One pass of libjpeg's ISLOW inverse DCT over the 8 slices d."""
    z1 = (d[2] + d[6]) * F_0_541
    t2, t3 = z1 + d[6] * -F_1_847, z1 + d[2] * F_0_765
    t0, t1 = (d[0] + d[4]) << CONST_BITS, (d[0] - d[4]) << CONST_BITS
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = _odd_part(d[7], d[5], d[3], d[1])
    shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    pairs = ((t10, o3), (t11, o2), (t12, o1), (t13, o0))
    out = [None] * 8
    for i, (a, b) in enumerate(pairs):
        out[i], out[7 - i] = _descale(a + b, shift), _descale(a - b, shift)
    return out


def _blockwise(x: torch.Tensor, fn, first_dim: int) -> torch.Tensor:
    """fn over the 8 slices of x [..., 8, 8] along rows (first_dim -1) and
    then columns, or columns first (first_dim -2)."""
    for dim, first in ((first_dim, True), (-3 - first_dim, False)):
        x = torch.stack(fn(list(x.unbind(dim)), first), dim=dim)
    return x


def _reciprocals(divisors: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """jcdctmgr.c's compute_reciprocal with 16-bit DCT elements: (recip,
    corr, total right shift) per divisor."""
    recip, corr, shift = (np.zeros(64, np.int64) for _ in range(3))
    for i, div in enumerate(int(v) for v in divisors):
        r = 16 + div.bit_length() - 1
        fq, fr = divmod(1 << r, div)
        c = div // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= div // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip, corr, shift


def _on(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, np.int64), device=device)


def _quantize(coef: torch.Tensor, qtable: np.ndarray) -> torch.Tensor:
    """ISLOW output (scaled by 8) -> quantised coefficients [..., 64] in
    natural order, by libjpeg-turbo's reciprocal multiply."""
    recip, corr, shift = (_on(v, coef.device) for v in _reciprocals(qtable * 8))
    mag = ((coef.abs() + corr) * recip) >> shift
    return torch.where(coef < 0, -mag, mag)


def _pad_edge(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """x [H, W] replicated at the bottom and right edges to [rows, cols]."""
    h, w = x.shape
    if rows > h:
        x = torch.cat([x, x[-1:].expand(rows - h, -1)], 0)
    if cols > w:
        x = torch.cat([x, x[:, -1:].expand(-1, cols - w)], 1)
    return x


def _to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """[8R, 8C] -> [R, C, 8, 8]."""
    r, c = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(r, 8, c, 8).permute(0, 2, 1, 3)


def _from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    r, c = blocks.shape[:2]
    return blocks.permute(0, 2, 1, 3).reshape(8 * r, 8 * c)


def forward_blocks(rgb: torch.Tensor, quality: int) -> Dict[str, torch.Tensor]:
    """The device half of the encoder: RGB [H, W, 3] uint8 -> quantised
    coefficients in zigzag order, {'Y': [2MR, 2MC, 64], 'Cb'/'Cr': [MR, MC,
    64]} for MR x MC 16x16 MCUs, before the dummy-block rule."""
    h, w, _ = rgb.shape
    mr, mc = -(-h // 16), -(-w // 16)
    x = rgb.to(torch.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = (_fix16(0.299) * r + _fix16(0.587) * g + _fix16(0.114) * b + ONE_HALF) >> SCALEBITS
    offset = (128 << SCALEBITS) + ONE_HALF - 1
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b + offset) >> SCALEBITS
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + offset) >> SCALEBITS
    # the colour buffer to even rows, Y to the iMCU rows and whole blocks
    y_plane = _pad_edge(y, 16 * mr, 16 * mc)
    chroma = {}
    bias = torch.tensor([1, 2], device=rgb.device).repeat(4 * mc)  # 1, 2, 1, 2, ... per column
    for name, c in (("Cb", cb), ("Cr", cr)):
        c = _pad_edge(c, h + h % 2, 16 * mc)
        down = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + bias) >> 2
        chroma[name] = _pad_edge(down, 8 * mr, 8 * mc)
    luma_q, chroma_q = quant_tables(quality)
    zz = torch.as_tensor(ZIGZAG, device=rgb.device)
    out = {}
    for name, plane, q in (("Y", y_plane, luma_q), ("Cb", chroma["Cb"], chroma_q),
                           ("Cr", chroma["Cr"], chroma_q)):
        coef = _blockwise(_to_blocks(plane) - 128, _fdct_pass, -1)
        out[name] = _quantize(coef.flatten(-2), q)[..., zz]
    return out


def inverse_blocks(coefs: torch.Tensor, layout: dict, qtables: Dict[int, np.ndarray]
                   ) -> torch.Tensor:
    """The device half of the decoder: coefficients [MR, MC, blocks per MCU,
    64] in zigzag order -> RGB [H, W, 3] uint8."""
    dev = coefs.device
    mr, mc, nb, _ = coefs.shape
    natural = torch.empty(64, dtype=torch.long, device=dev)
    natural[torch.as_tensor(ZIGZAG, device=dev)] = torch.arange(64, device=dev)
    deq = torch.stack([_on(qtables[t], dev) for t in layout["tables"]])  # [nb, 64]
    x = (coefs.to(torch.int64) * deq[..., torch.as_tensor(ZIGZAG, device=dev)])[..., natural]
    x = _blockwise(x.reshape(mr, mc, nb, 8, 8), _idct_pass, -2)
    # jdmaster.c's range limit: the descaled value wraps modulo 1024, then clamps
    x = torch.clamp(((x + 512) & 1023) - 512 + 128, 0, 255)
    h, w = layout["height"], layout["width"]
    hv = layout["luma"]
    y = x[:, :, :hv * hv].reshape(mr, mc, hv, hv, 8, 8).permute(0, 2, 4, 1, 3, 5)
    y = y.reshape(mr * hv * 8, mc * hv * 8)[:h, :w]
    planes = []
    for k in (hv * hv, hv * hv + 1):
        c = _from_blocks(x[:, :, k])
        planes.append(c[:h, :w] if hv == 1 else _fancy_up(c[:-(-h // 2), :-(-w // 2)], h, w))
    return _ycc_to_rgb(y, *planes)


def _fancy_up(c: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """jdsample.c's h2v2 upsampling of a chroma plane [ceil(h/2), ceil(w/2)]
    to [h, w]: triangular (fancy) where it is wider than 2 samples, else
    replicated."""
    if c.shape[1] <= 2:
        return c.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]
    up = torch.cat([c[:1], c[:-1]], 0)
    down = torch.cat([c[1:], c[-1:]], 0)
    rows = []
    for near in (up, down):  # output rows 2i (the row above) and 2i+1 (below)
        col = c * 3 + near
        left = torch.cat([col[:, :1], col[:, :-1]], 1)
        right = torch.cat([col[:, 1:], col[:, -1:]], 1)
        rows.append(torch.stack([(col * 3 + left + 8) >> 4, (col * 3 + right + 7) >> 4], -1)
                    .flatten(-2))
    return torch.stack(rows, 1).flatten(0, 1)[:h, :w]


def _ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c's YCbCr -> RGB with its rounded tables, range-limited."""
    xb, xr = cb - 128, cr - 128
    r = y + ((_fix16(1.402) * xr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix16(0.34414) * xb + ONE_HALF - _fix16(0.71414) * xr) >> SCALEBITS)
    b = y + ((_fix16(1.772) * xb + ONE_HALF) >> SCALEBITS)
    return torch.clamp(torch.stack([r, g, b], -1), 0, 255).to(torch.uint8)


# ---- the host side: Huffman coding and the byte stream ------------------

_NBITS = np.frexp(np.arange(1 << 16))[1].astype(np.int64)  # bit lengths of 0..65535


def _huff_codes(bits: bytes, vals: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical codes of a table: (code [256], length [256]) by symbol."""
    code, length = np.zeros(256, np.int64), np.zeros(256, np.int64)
    c, k = 0, 0
    for n in range(1, 17):
        for _ in range(bits[n - 1]):
            code[vals[k]], length[vals[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, length


def _magnitude(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(size category, appended bits) of coefficients v."""
    s = _NBITS[np.abs(v)]
    return s, np.where(v < 0, v + (1 << s) - 1, v)


def mcu_sequence(coefs: Dict[str, np.ndarray], h: int, w: int) -> np.ndarray:
    """[MR, MC, 6, 64] blocks in MCU order (Y00 Y01 Y10 Y11 Cb Cr) with
    jccoefct.c's dummy blocks: a Y block past the image's last block column
    or row gets zero AC and the DC of the block before it."""
    y, cb, cr = coefs["Y"], coefs["Cb"], coefs["Cr"]
    mr, mc = cb.shape[:2]
    yb = y.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)
    seq = np.concatenate([yb, cb[:, :, None], cr[:, :, None]], 2).copy()
    if -(-w // 8) % 2:  # right dummies: blocks 1 and 3 of the last MCU column
        for k in (1, 3):
            seq[:, -1, k] = 0
            seq[:, -1, k, 0] = seq[:, -1, k - 1, 0]
    if -(-h // 8) % 2:  # a bottom dummy row: blocks 2 and 3 of the last MCU row
        seq[-1, :, 2:4] = 0
        seq[-1, :, 2:4, 0] = seq[-1, :, 1:2, 0]
    return seq


def entropy_encode(seq: np.ndarray) -> bytes:
    """Huffman-code 4:2:0 MCUs [MR, MC, 6, 64] (zigzag) with the standard
    tables: the scan's bytes, 0xFF stuffed and padded with 1 bits."""
    blocks = seq.reshape(-1, 64).astype(np.int64)
    nblk = blocks.shape[0]
    table = np.tile([0, 0, 0, 0, 1, 1], nblk // 6)
    comp = np.tile([0, 0, 0, 0, 1, 2], nblk // 6)
    dc_code = {t: _huff_codes(*STD_HUFFMAN[(0, t)]) for t in (0, 1)}
    ac_code = {t: _huff_codes(*STD_HUFFMAN[(1, t)]) for t in (0, 1)}

    diff = np.empty(nblk, np.int64)
    for c in np.unique(comp):
        sel = comp == c
        diff[sel] = np.diff(blocks[sel, 0], prepend=0)
    dc_s, dc_bits = _magnitude(diff)

    bi, ki = np.nonzero(blocks[:, 1:])
    ki = ki + 1
    v = blocks[bi, ki]
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev_k = np.where(first, 0, np.concatenate([[0], ki[:-1]]))
    run = ki - prev_k - 1
    zrl, r = run >> 4, run & 15
    s, bits = _magnitude(v)
    last = np.ones(len(bi), bool)
    last[:-1] = bi[1:] != bi[:-1]
    last_k = np.zeros(nblk, np.int64)
    last_k[bi[last]] = ki[last]
    eob = last_k != 63

    group = 1 + zrl  # tokens of each nonzero coefficient
    per_block = 1 + np.bincount(bi, weights=group, minlength=nblk).astype(np.int64) + eob
    start = np.concatenate([[0], np.cumsum(per_block)[:-1]])
    g_excl = np.concatenate([[0], np.cumsum(group)[:-1]])
    first_of_block = np.searchsorted(bi, bi, "left")
    pos = start[bi] + 1 + g_excl - g_excl[first_of_block]
    total = int(per_block.sum())
    val, ln = np.zeros(total, np.int64), np.zeros(total, np.int64)

    for t in (0, 1):
        code, length = dc_code[t]
        sel = table == t
        val[start[sel]] = (code[dc_s[sel]] << dc_s[sel]) | dc_bits[sel]
        ln[start[sel]] = length[dc_s[sel]] + dc_s[sel]
        code, length = ac_code[t]
        tb = table[bi] == t
        sym = r[tb] * 16 + s[tb]
        at = pos[tb] + zrl[tb]
        val[at] = (code[sym] << s[tb]) | bits[tb]
        ln[at] = length[sym] + s[tb]
        zpos = np.repeat(pos[tb], zrl[tb])
        zpos += np.arange(len(zpos)) - np.repeat(np.cumsum(zrl[tb]) - zrl[tb], zrl[tb])
        val[zpos], ln[zpos] = code[0xF0], length[0xF0]
        eb = eob & sel
        end = start[eb] + per_block[eb] - 1
        val[end], ln[end] = code[0x00], length[0x00]

    nbits = int(ln.sum())
    pad = -nbits % 8
    if pad:
        val, ln = np.append(val, (1 << pad) - 1), np.append(ln, pad)
        nbits += pad
    return _stuff(_pack_bits(val, ln, nbits))


def _pack_bits(val: np.ndarray, ln: np.ndarray, nbits: int) -> np.ndarray:
    """Tokens (value, length <= 32) into big-endian bytes. Each token lands
    in at most two 32-bit words; their disjoint bits add up exactly in the
    float64 sums of ``np.bincount``."""
    start = np.cumsum(ln) - ln
    word, off = start >> 5, start & 31
    spill = np.maximum(off + ln - 32, 0)
    head = (val >> spill) << (32 - off - ln + spill)
    tail = (val & ((1 << spill) - 1)) << (32 - spill)
    nwords = (nbits + 31) // 32 + 1
    sums = (np.bincount(word, weights=head, minlength=nwords)
            + np.bincount(word + 1, weights=np.where(spill > 0, tail, 0), minlength=nwords))
    return sums.astype(np.uint64).astype(">u4").view(np.uint8)[:nbits // 8]


def _stuff(data: np.ndarray) -> bytes:
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode(rgb, quality: int = 95, device="cuda") -> bytes:
    """A baseline 4:2:0 JPEG of rgb ([H, W, 3] uint8, numpy or tensor) at
    an IJG quality, as ``cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY,
    quality])`` writes it. The transforms run on ``device``."""
    x = torch.as_tensor(rgb).to(device)
    if x.dtype != torch.uint8 or x.ndim != 3 or x.shape[2] != 3:
        raise ValueError(f"encode takes [H, W, 3] uint8, not {tuple(x.shape)} {x.dtype}")
    h, w = x.shape[:2]
    blocks = {k: v.cpu().numpy() for k, v in forward_blocks(x, quality).items()}
    return assemble(entropy_encode(mcu_sequence(blocks, h, w)), h, w, quality)


def assemble(scan: bytes, h: int, w: int, quality: int) -> bytes:
    """The file around a scan: SOI, JFIF APP0, DQT, SOF0, DHT, SOS, EOI, in
    libjpeg's order."""
    luma_q, chroma_q = quant_tables(quality)
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate((luma_q, chroma_q)):
        out.append(_segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].tolist())))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for cls, t in ((0, 0), (1, 0), (0, 1), (1, 1)):
        bits, vals = STD_HUFFMAN[(cls, t)]
        out.append(_segment(0xC4, bytes([cls << 4 | t]) + bits + vals))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [scan, b"\xff\xd9"]
    return b"".join(out)


@functools.lru_cache(maxsize=16)
def _lookup(bits: bytes, vals: bytes) -> list:
    """A table's decoding lookup over the next 16 bits: (code length,
    symbol) per 16-bit prefix, length 0 where no code starts."""
    code, length = _huff_codes(bits, vals)
    lut = np.zeros(1 << 16, np.int64)
    for sym in set(vals):
        n = int(length[sym])
        lo = int(code[sym]) << (16 - n)
        lut[lo:lo + (1 << (16 - n))] = n | (sym << 8)
    return [(int(e) & 255, int(e) >> 12, (int(e) >> 8) & 15) for e in lut]


def parse(data: bytes) -> dict:
    """Header of a baseline JPEG: size, components, tables and the scan's
    entropy-coded bytes (unstuffed); raises UnsupportedJPEG by name."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    names = {0xC2: "progressive", 0xC3: "lossless", 0xC6: "progressive (differential)",
             0xC5: "hierarchical", 0xC7: "lossless (differential)", 0xC9: "arithmetic-coded",
             0xCA: "progressive arithmetic-coded", 0xCB: "lossless arithmetic-coded",
             0xCD: "hierarchical arithmetic-coded", 0xCE: "hierarchical arithmetic-coded",
             0xCF: "hierarchical arithmetic-coded"}
    info = {"q": {}, "huff": {}, "scan": None}
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG marker expected at byte {pos}")
        while data[pos] == 0xFF:
            pos += 1
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        seg, pos = data[pos + 2:pos + n], pos + n
        if marker in names:
            raise UnsupportedJPEG(f"{names[marker]} JPEG (SOF{marker - 0xC0}) is not read; "
                                  "only baseline sequential Huffman-coded files are")
        if marker == 0xCC:
            raise UnsupportedJPEG("arithmetic coding (DAC marker) is not read")
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                if seg[i] >> 4:
                    raise UnsupportedJPEG("16-bit quantisation tables are not read")
                q = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                info["q"][seg[i] & 15] = np.empty(64, np.int64)
                info["q"][seg[i] & 15][ZIGZAG] = q
                i += 65
        elif marker in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise UnsupportedJPEG(f"{prec}-bit samples are not read (8-bit only)")
            comps = [tuple(seg[6 + 3 * i:9 + 3 * i]) for i in range(nc)]
            info.update(height=h, width=w, comps=comps)
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                bits = seg[i + 1:i + 17]
                k = sum(bits)
                info["huff"][(seg[i] >> 4, seg[i] & 15)] = (bits, seg[i + 17:i + 17 + k])
                i += 17 + k
        elif marker == 0xDD:
            if struct.unpack(">H", seg[:2])[0]:
                raise UnsupportedJPEG("restart markers (a non-zero DRI interval) are not read")
        elif marker == 0xDA:
            if info["scan"] is not None:
                raise UnsupportedJPEG("several scans are not read (one interleaved scan only)")
            ns = seg[0]
            sel = [(seg[1 + 2 * i], seg[2 + 2 * i]) for i in range(ns)]
            ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
            if "comps" not in info:
                raise ValueError("JPEG scan before its frame header")
            if ns != len(info["comps"]) or (ss, se, a) != (0, 63, 0):
                raise UnsupportedJPEG("only one interleaved scan of every component is read")
            end = pos
            while True:
                end = data.index(b"\xff", end)
                if data[end + 1] != 0:
                    break
                end += 2
            if 0xD0 <= data[end + 1] <= 0xD7:
                raise UnsupportedJPEG("restart markers in the scan are not read")
            raw = np.frombuffer(data[pos:end], np.uint8)
            keep = np.ones(len(raw), bool)
            keep[np.nonzero(raw[:-1] == 0xFF)[0] + 1] = False
            info["scan"], info["scan_tables"] = raw[keep].tobytes(), dict(sel)
            pos = end
    if info["scan"] is None:
        raise ValueError("JPEG without a scan")
    comps = info["comps"]
    samp = [c[1] for c in comps]
    if len(comps) != 3 or samp[1:] != [0x11, 0x11] or samp[0] not in (0x11, 0x22):
        raise UnsupportedJPEG(
            f"sampling layout {[f'{s >> 4}x{s & 15}' for s in samp]} is not read "
            "(3 components, 4:2:0 or 4:4:4)")
    return info


def entropy_decode(info: dict) -> np.ndarray:
    """Huffman-decode the scan: [MR, MC, blocks per MCU, 64] coefficients
    in zigzag order (one Python step per symbol)."""
    h, w, comps = info["height"], info["width"], info["comps"]
    hv = comps[0][1] >> 4
    mr, mc = -(-h // (8 * hv)), -(-w // (8 * hv))
    per_mcu = [0] * (hv * hv) + [1, 2]
    luts = []
    for cid, _, _ in comps:
        td_ta = info["scan_tables"][cid]
        try:
            luts.append((_lookup(*info["huff"][(0, td_ta >> 4)]),
                         _lookup(*info["huff"][(1, td_ta & 15)])))
        except KeyError as e:
            raise ValueError(f"JPEG Huffman table {e} not defined") from None
    scan = info["scan"]
    padded = np.frombuffer(scan + b"\x00" * 5, np.uint8).astype(np.int64)
    w5 = ((padded[:-4] << 32) | (padded[1:-3] << 24) | (padded[2:-2] << 16)
          | (padded[3:-1] << 8) | padded[4:]).tolist()
    nbits = 8 * len(scan)
    coef = array.array("i", bytes(4 * mr * mc * len(per_mcu) * 64))
    pred = [0, 0, 0]
    p = 0
    base = 0
    for _ in range(mr * mc):
        for c in per_mcu:
            dc_lut, ac_lut = luts[c]
            wnd = (w5[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
            n, _, s = dc_lut[wnd >> 16]
            if not n:
                raise ValueError(f"corrupt JPEG data (bad DC code at bit {p})")
            if s:
                v = (wnd >> (32 - n - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                pred[c] += v
            coef[base] = pred[c]
            p += n + s
            k = 1
            while k < 64:
                wnd = (w5[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
                n, r, s = ac_lut[wnd >> 16]
                if not n:
                    raise ValueError(f"corrupt JPEG data (bad AC code at bit {p})")
                if not s:
                    p += n
                    if r == 15:
                        k += 16
                        continue
                    break
                k += r
                v = (wnd >> (32 - n - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                coef[base + k] = v
                k += 1
                p += n + s
            if k > 64:
                raise ValueError("corrupt JPEG data (coefficients past 63)")
            base += 64
        if p > nbits:
            raise ValueError("JPEG scan ends early")
    return np.frombuffer(coef, np.int32).reshape(mr, mc, len(per_mcu), 64)


def layout(info: dict) -> dict:
    """The MCU layout of a parsed file, as ``inverse_blocks`` takes it."""
    comps = info["comps"]
    hv = comps[0][1] >> 4
    return dict(height=info["height"], width=info["width"], luma=hv,
                tables=[comps[0][2]] * (hv * hv) + [comps[1][2], comps[2][2]])


def decode(data: bytes, device="cuda") -> torch.Tensor:
    """A baseline JPEG's RGB pixels [H, W, 3] uint8 on ``device``, as
    ``cv2.imdecode`` (then BGR -> RGB) gives them."""
    info = parse(data)
    coefs = torch.from_numpy(entropy_decode(info)).to(device)
    return inverse_blocks(coefs, layout(info), info["q"])
