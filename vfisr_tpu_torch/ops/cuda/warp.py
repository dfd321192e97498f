"""Windowed backward warp: the CUDA port of the TPU's Pallas warp kernel.

Replaces ``vfisr_tpu/ops/pallas/warp.py::warp_windowed`` (the
``pl.pallas_call`` at warp.py:348) in all three weight modes:
``warp_windowed`` is K1 (``weight_mode='interp'``, the warp) and
``warp_windowed_grad`` is K2 (``'grad_y'`` and ``'grad_x'``, the warp's
flow gradient, both in one launch and reduced over channels with the
cotangent). The kernels are ``csrc/warp_windowed.cu``: nvcc builds it into
a shared library with a plain C interface at first use (into ``vfisr_tpu_torch/_build/``,
keyed by a hash of the source), and ctypes loads it. No PyTorch header is
compiled, so the build takes seconds.

Semantics (identical to the Pallas kernel's): each output tile (32x256 by
default; ``tile`` as the Pallas wrapper's) reads a window placed at the
tile's rounded mean displacement; each pixel samples
bilinearly at ``p + t*flow[p]``, clipped to the content (replicate border)
or to r px past it over zeros (constant border), with its offset inside the
window clamped to ``[0, nsh-1.001]``. So the warp is exact wherever a
pixel's displacement stays within (ry, rx) of its tile's mean, and clamps
to the window edge beyond that. With ``compute_dtype=bfloat16`` the window
values, horizontal weights and horizontal sums are bf16, one more vertical
tap is added (``nsh_y = 2ry+3``) and the window row origin is rounded down
to even, as the TPU kernel's bf16 path does.

Each kernel computes its tiles' window origins itself (bit for bit as
``window_origins``), so a call is one launch and the wrappers run no torch
op besides allocating their outputs (and K2's ``ct.contiguous()``).
``kernel_origins`` returns the origins the kernels compute, for the checks
that hold them against ``window_origins``. What bounds the kernels on the
H100 is bytes: see the note in the CUDA source.

Channels: K1 and K2 take any C, as the Pallas wrapper does by chunking. A
window of all C channels that does not fit in shared memory (past 9
channels for an f32 image at r = 8 in K1, 10 in K2, such as SAFA's
176-channel feature warps) takes the channel-group kernel: each CTA owns a
16x16 block of a tile's pixels and walks a chunk of 16-byte channel groups
through a ring in shared memory, copying only the rows and columns its
taps reach. K1's grouped launch has the same bits as the whole-C one. K2
sums each pixel's channels in channel order in one thread and writes its
outputs in one launch; only a plan with several chunks per tile has each
chunk's partial sums go to an f32 scratch that ``launch_grad`` allocates,
added in chunk order by a second kernel (deterministic, no atomics).
``plan`` says how the kernels take a launch.

Tiles. The kernels above are built for the 32x256 tile (``TILE``); every
call at that tile goes to them. A call at any other ``tile`` goes to
``csrc/warp_tiled.cu`` (its own library, ``build_tiled``), K1 and K2 from
one template with (th, tw) at run time: a CTA walks a band of a tile's
columns in slabs of rows through a ring of image rows in shared memory
(whole C), or channel chunks of a narrower block through two slots; it
computes its tile's origin in its prologue where it holds the whole tile,
else an origins pass fills a table first (``tiled_plan``). Its launches add to
``launches``/``grad_launches`` as the others' do, and to
``tiled_launches``/``tiled_grad_launches``. ``launch_tiled`` and
``launch_grad_tiled`` launch it at any tile, 32x256 included (the checks
that hold it against the 32x256 kernels). The reference's
``_timing_skip_roll`` (a TPU timing flag whose output is wrong by design)
and ``interpret`` (the plain twin on the CPU here) are not carried over.

``warp_windowed_plain`` (with its ``weight_mode``) and
``warp_windowed_grad_plain`` are the same functions in plain PyTorch. The
wrappers use them for tensors on the CPU; on a CUDA tensor they launch the
kernel or raise.

``warp_windowed`` goes through the custom op
``torch.ops.vfisr_tpu_torch.warp_windowed`` (registered when this module
is imported): its CUDA kernel is ``launch``, its CPU kernel
``warp_windowed_plain``, each chosen by the tensors' device, and a fake
kernel gives ``torch.export`` the output's shape, so an exported program
(``utils/aot.py``) holds K1 as one node and launches the kernel when it
runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "warp_windowed.cu"
TILED_SOURCE = _PKG / "csrc" / "warp_tiled.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
TILE = (32, 256)  # the kernels' kTh, kTw

# Kernel launches so far (K1, K2); a run sets them to 0 and reads them to
# show which path it went through. Only the CUDA launches below add to them.
launches = 0
grad_launches = 0
# the launches of warp_tiled.cu alone (also counted in the two above)
tiled_launches = 0
tiled_grad_launches = 0

_lib = None
_tiled_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the windowed "
        "warp kernels are built from csrc/warp_windowed.cu at first use on the GPU")


def _compile(source: Path) -> Path:
    """nvcc ``source`` into a shared library under BUILD_DIR, once per hash
    of the source and the flags; returns its path."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    return so


def build() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernels' library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_compile(SOURCE)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    t_args = [p, f, i]  # t pointer (or None), t_scalar, t_stride
    lib.warp_windowed_launch.argtypes = [p, p, *t_args, p] + [i] * 14 + [f] * 6 + [p]
    lib.warp_windowed_grad_launch.argtypes = [p, p, *t_args, p, p, p, p] + [i] * 14 + [f] * 6 + [p]
    lib.warp_windowed_origins_launch.argtypes = [p, *t_args, p] + [i] * 9 + [p]
    lib.warp_windowed_plan.argtypes = [i] * 8 + [p]
    for fn in (lib.warp_windowed_launch, lib.warp_windowed_grad_launch,
               lib.warp_windowed_origins_launch, lib.warp_windowed_plan):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def build_tiled() -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/warp_tiled.cu``'s
    library: the kernels at any tile."""
    global _tiled_lib
    if _tiled_lib is not None:
        return _tiled_lib
    lib = ctypes.CDLL(str(_compile(TILED_SOURCE)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.warp_tiled_origins_launch.argtypes = [p, p, f, i, p, p] + [i] * 11 + [p]
    lib.warp_tiled_launch.argtypes = [p, p, p, f, i, p, p, p, p, p, p] + [i] * 17 + [f] * 6 + [p]
    lib.warp_tiled_plan.argtypes = [i] * 10 + [p]
    for fn in (lib.warp_tiled_origins_launch, lib.warp_tiled_launch, lib.warp_tiled_plan):
        fn.restype = ctypes.c_int
    _tiled_lib = lib
    return lib


def _radii(r) -> Tuple[int, int]:
    return (int(r), int(r)) if isinstance(r, int) else (int(r[0]), int(r[1]))


def _tile(tile) -> Tuple[int, int]:
    th, tw = int(tile[0]), int(tile[1])
    if th <= 0 or tw <= 0:
        raise ValueError(f"tile must be two positive ints; got {tile!r}")
    return th, tw


def _content_origin(ry, rx, tile=TILE):
    """(PT, PL): where the content starts inside the reference's padded
    canvas, in which window origins and source coordinates are expressed
    (pallas warp.py:262-263, for the output tile (th, tw))."""
    th, tw = tile
    return ((th + ry + 1 + th - 1) // th) * th, ((tw + rx + 1 + tw - 1) // tw) * tw


def _geometry(h, w, ry, rx, bf16, border, tile=TILE):
    """Canvas offsets, tap counts and clip bounds (pallas warp.py:246-336)."""
    pt, pl = _content_origin(ry, rx, tile)
    nsh_y = 2 * ry + 2 + (1 if bf16 else 0)
    nsh_x = 2 * rx + 2
    if border == "constant":
        clip = (float(pt - ry), float(pt + h - 1 + ry), float(pl - rx), float(pl + w - 1 + rx))
    else:
        clip = (float(pt), float(pt + h - 1), float(pl), float(pl + w - 1))
    return pt, pl, nsh_y, nsh_x, clip


def _t_array(t, n: int, device) -> torch.Tensor:
    if isinstance(t, (int, float)):
        return torch.full((n,), float(t), dtype=torch.float32, device=device)
    return torch.as_tensor(t, dtype=torch.float32, device=device).reshape(-1).expand(n).contiguous()


def window_origins(flow: torch.Tensor, t_arr: torch.Tensor, ry: int, rx: int,
                   bf16: bool, tile=TILE) -> torch.Tensor:
    """Effective window origin (oy, ox) per output tile (th, tw), canvas
    coordinates: [N, TY, TX, 2] int32.

    The tile mean is taken over the flow edge-padded to tile multiples, in
    f32, by the same chain of 2x2 halvings and final reduce as the
    reference (pallas warp.py:292-304), so rounding ties fall the same way;
    then scaled by t, rounded half-even, offset by -(r+1) and clamped into
    the canvas. In bf16 the TPU's window rolls drop the odd row slack, so
    the row origin is rounded down to even.
    """
    n, h, w, _ = flow.shape
    th, tw = _tile(tile)
    ph_c, pw_c = (-h) % th, (-w) % tw
    pt, pl = _content_origin(ry, rx, (th, tw))
    m = flow.permute(0, 3, 1, 2).float()
    if ph_c or pw_c:
        m = torch.nn.functional.pad(m, (0, pw_c, 0, ph_c), mode="replicate")
    g = 1
    while th % (2 * g) == 0 and tw % (2 * g) == 0:
        g *= 2
    for _ in range(g.bit_length() - 1):
        m = (((m[..., 0::2, 0::2] + m[..., 0::2, 1::2]) + m[..., 1::2, 0::2])
             + m[..., 1::2, 1::2]) * 0.25
    ky, kx = th // g, tw // g
    if (ky, kx) != (1, 1):
        b, c2, hh, ww = m.shape
        blocks = m.reshape(b, c2, hh // ky, ky, ww // kx, kx)
        acc = None
        for i in range(ky):  # row-major window order
            for j in range(kx):
                term = blocks[:, :, :, i, :, j]
                acc = term if acc is None else acc + term
        m = acc * (g * g / (th * tw))
    hc, wc = h + ph_c, w + pw_c
    ty_n, tx_n = hc // th, wc // tw
    mean_vx = m[:, 0] * t_arr[:, None, None]
    mean_vy = m[:, 1] * t_arr[:, None, None]
    dev = flow.device
    ty0 = (pt + torch.arange(ty_n, device=dev) * th)[None, :, None]
    tx0 = (pl + torch.arange(tx_n, device=dev) * tw)[None, None, :]
    oy = torch.clamp(ty0 + torch.round(mean_vy).to(torch.int64) - (ry + 1), 0, pt + hc)
    ox = torch.clamp(tx0 + torch.round(mean_vx).to(torch.int64) - (rx + 1), 0, pl + wc)
    if bf16:
        oy = oy - (oy & 1)
    return torch.stack([oy, ox], dim=-1).to(torch.int32).contiguous()


def _check(img, flow, border, compute_dtype):
    if img.ndim != 4 or flow.ndim != 4 or flow.shape[-1] != 2 or flow.shape[:3] != img.shape[:3]:
        raise ValueError(f"need img [N,H,W,C] and flow [N,H,W,2]; got {tuple(img.shape)}, {tuple(flow.shape)}")
    if img.dtype not in (torch.float32, torch.bfloat16) or flow.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"img/flow must be float32 or bfloat16; got {img.dtype}, {flow.dtype}")
    if border not in ("replicate", "constant"):
        raise ValueError(f"border must be 'replicate' or 'constant'; got {border!r}")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16; got {compute_dtype}")
    if img.device != flow.device:
        raise ValueError(f"img on {img.device}, flow on {flow.device}")


def _check_cuda(name: str, img: torch.Tensor, flow: torch.Tensor) -> None:
    """Raises unless img and flow are contiguous CUDA tensors."""
    if img.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {img.device}")
    if not (img.is_contiguous() and flow.is_contiguous()):
        raise ValueError(f"{name} needs contiguous img and flow")


def _t_args(t, n: int, device) -> tuple:
    """The kernels' (t pointer or None, t_scalar, t_stride) and the tensor
    the pointer points into (kept alive across the launch). A Python
    number goes as t_scalar; an f32 tensor of 1 or n elements on the
    device, as it is; anything else through ``_t_array``."""
    if isinstance(t, (int, float)):
        return (None, float(t), 0), None
    if not (torch.is_tensor(t) and t.dtype == torch.float32 and t.device == device
            and t.numel() in (1, n) and t.is_contiguous()):
        t = _t_array(t, n, device)
    return (t.data_ptr(), 0.0, int(t.numel() == n and n > 1)), t


@functools.lru_cache(maxsize=None)
def _shape_args(n, h, w, c, img_bf16, flow_bf16, ry, rx, bf16, border, tile=TILE) -> tuple:
    """The launch arguments K1 and K2 share, after their pointers."""
    pt, pl, nsh_y, nsh_x, clip = _geometry(h, w, ry, rx, bf16, border, tile)
    return (n, h, w, c, int(img_bf16), int(flow_bf16), int(bf16), int(border == "constant"),
            ry, rx, pt, pl, nsh_y, nsh_x, *clip, nsh_y - 1.001, nsh_x - 1.001)


def _launch_args(img, flow, r, border, compute_dtype, tile=TILE) -> tuple:
    return _shape_args(*img.shape, img.dtype == torch.bfloat16, flow.dtype == torch.bfloat16,
                       *_radii(r), compute_dtype == torch.bfloat16, border, tuple(tile))


PLAN_FIELDS = ("split", "rows", "grouped", "groups", "cg", "smem", "ctas", "chunks", "pixels",
               "stages")


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, n, h, w, c, img_bf16: bool, nsh_y, nsh_x, grad: bool):
    lib = build()
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    with torch.cuda.device(device_index):
        err = lib.warp_windowed_plan(n, h, w, c, int(img_bf16), nsh_y, nsh_x, int(grad), out)
    return None if err else dict(zip(PLAN_FIELDS, out))


def plan(img: torch.Tensor, r, compute_dtype: torch.dtype, grad: bool = False):
    """How the kernel takes img [N,H,W,C] on its CUDA card: a dict of
    PLAN_FIELDS, or None where the kernel refuses the launch. K1
    (grad=False) and K2 (grad=True) split a window of all C channels that
    does not fit in shared memory into channel groups (``grouped`` 1).

    split: CTAs per tile (row slices; grouped: pixel blocks); rows: output
    rows per CTA (grouped: a block's rows); groups, cg: channel
    groups per pixel and channels per group (whole C: 1 and C; grouped:
    16-byte groups); smem: shared memory bytes per CTA; ctas: CTAs of the
    launch; chunks: runs of groups per tile, each its own CTA (K2 with
    more than one launches a second pass); pixels: output pixels per CTA;
    stages: ring slots (whole C: 1)."""
    ry, rx = _radii(r)
    bf16 = compute_dtype == torch.bfloat16
    _, _, nsh_y, nsh_x, _ = _geometry(img.shape[1], img.shape[2], ry, rx, bf16, "replicate")
    return _plan(img.device.index if img.device.index is not None else torch.cuda.current_device(),
                 *img.shape, img.dtype == torch.bfloat16, nsh_y, nsh_x, grad)


TILED_PLAN_FIELDS = ("rows", "cols", "bands", "segments", "slabs", "chunked", "chunk", "chunks",
                     "slots", "ring_rows", "smem", "ctas", "ctas_per_sm", "fused")
SMS = 132  # the H100's SMs: tiled_plan's default card
# csrc/warp_tiled.cu's plan constants
_T_MAX_W, _T_MAX_R, _T_CHUNK_W, _T_CHUNK_R = 256, 32, 32, 16
_T_MAX_VEC, _T_WAVE, _T_CELLS, _T_FUSE_CELLS = 8, 4, 256, 64
_T_SMEM_CTA, _T_SMEM_SM, _T_STATIC = 72 * 1024, 228 * 1024, 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r16(b: int) -> int:
    return _cdiv(b, 16) * 16


def _tiled_layout(q: dict, nsh_y: int, nsh_x: int, c: int, b: int, grad: bool) -> int:
    """warp_tiled.cu's ``layout``: the ring, its row offsets, K2's
    cotangent slots and K1's staging; returns the shared bytes."""
    f, wf = q["rows"] + nsh_y - 1, q["cols"] + nsh_x - 1
    if not q["chunked"]:
        q["ring_rows"] = 2 * q["rows"] + nsh_y - 1 if q["slabs"] > 1 else f
        pitch = _r16(wf * c * b) + 32
        ct_pitch = _r16(q["cols"] * c * b) + 32
    else:
        q["ring_rows"] = q["slots"] * f
        px = q["cvec"] * 16 + (0 if q["cvec"] & 1 else 16)
        pitch, ct_pitch = wf * px, q["cols"] * px
    ct_slots = q["slots"] if grad else 0
    stage_off = (_r16(4 * q["ring_rows"]) + q["ring_rows"] * pitch
                 + _r16(4 * ct_slots * q["rows"]) + ct_slots * q["rows"] * ct_pitch)
    stage = 0 if grad else 8 * 32 * (q["cvec"] * (16 // b) if q["chunked"] else c) * b
    return stage_off + stage


def tiled_plan(shape, img_dtype: torch.dtype, r, compute_dtype: torch.dtype, tile,
               grad: bool = False, sms: int = SMS):
    """How ``csrc/warp_tiled.cu`` takes a launch on img of ``shape``
    [N,H,W,C] at ``tile`` on a card of ``sms`` SMs: a dict of
    TILED_PLAN_FIELDS, or None where the kernels refuse it. The same
    integer arithmetic as the C plan (``warp_tiled_plan``; the CUDA tests
    hold the two equal), so the CPU tests reach it.

    Per tile, ``bands`` bands of ``cols`` columns and ``segments`` row
    segments, one CTA each, walked in ``slabs`` slabs of ``rows`` rows
    through a ring of ``ring_rows`` image rows; ``chunked`` 1: channel
    chunks of ``chunk`` channels, ``chunks`` per pixel, through ``slots``
    ring slots; ``smem`` dynamic shared bytes per CTA, ``ctas`` of the
    launch, ``ctas_per_sm`` by shared memory; ``fused`` 1: one CTA per
    tile computes its origin in its prologue (else an origins pass)."""
    n, h, w, c = (int(v) for v in shape)
    th, tw = _tile(tile)
    ry, rx = _radii(r)
    b = 2 if img_dtype == torch.bfloat16 else 4
    nsh_y = 2 * ry + 2 + (1 if compute_dtype == torch.bfloat16 else 0)
    nsh_x = 2 * rx + 2
    if min(n, h, w, c) <= 0 or min(nsh_y, nsh_x) < 2 or sms <= 0:
        return None
    tiles = n * _cdiv(h, th) * _cdiv(w, tw)
    th_e, tw_e = min(th, h), min(tw, w)
    q = dict(chunked=0, cvec=0, chunks=1, slots=1)
    q["bands"] = _cdiv(tw_e, _T_MAX_W)
    q["cols"] = tw_e if q["bands"] == 1 else _cdiv(_cdiv(tw_e, q["bands"]), 32) * 32
    q["bands"] = _cdiv(tw_e, q["cols"])
    # a whole tile's CTA fuses its origin only where that is one batch of
    # cells per warp; else the tile is cut in two bands (or segments)
    g = 1
    while th % (2 * g) == 0 and tw % (2 * g) == 0:
        g *= 2
    segs = 1
    if q["bands"] == 1 and (th // g) * (tw // g) > _T_FUSE_CELLS:
        if tw_e >= 64:
            q["cols"] = _cdiv(_cdiv(tw_e, 2), 32) * 32
            q["bands"] = _cdiv(tw_e, q["cols"])
        elif th_e >= 2:
            segs = 2
    while tiles * q["bands"] * segs < _T_WAVE * sms and segs < th_e:
        segs *= 2
    q["seg_rows"] = _cdiv(th_e, segs)
    q["segments"] = _cdiv(th_e, q["seg_rows"])
    best = 0
    for rows in range(1, min(_T_MAX_R, q["seg_rows"]) + 1):
        q["rows"], q["slabs"] = rows, _cdiv(q["seg_rows"], rows)
        q["slots"] = 2 if q["slabs"] > 1 else 1
        if _tiled_layout(q, nsh_y, nsh_x, c, b, grad) <= _T_SMEM_CTA:
            best = rows
    if best:
        q["slabs"] = _cdiv(q["seg_rows"], best)
        q["rows"] = _cdiv(q["seg_rows"], q["slabs"])
        q["slabs"] = _cdiv(q["seg_rows"], q["rows"])
        q["slots"] = 2 if q["slabs"] > 1 else 1
    else:
        q["chunked"] = 1
        q["cols"] = min(tw_e, _T_CHUNK_W)
        q["bands"] = _cdiv(tw_e, q["cols"])
        groups = _cdiv(c * b, 16)
        fit, rows = False, min(th_e, _T_CHUNK_R)
        while rows >= 1 and not fit:
            q["rows"] = rows
            v = _T_MAX_VEC
            while v >= 1:
                if not (v > groups and v > 1):
                    q["cvec"], q["chunks"] = v, _cdiv(groups, v)
                    q["slots"] = 2 if q["chunks"] > 1 else 1
                    if _tiled_layout(q, nsh_y, nsh_x, c, b, grad) <= _T_SMEM_CTA:
                        fit = True
                        break
                v //= 2
            rows //= 2
        if not fit:
            return None
        q["seg_rows"] = q["rows"]
        q["segments"] = _cdiv(th_e, q["rows"])
        q["slabs"] = 1
    q["fused"] = int(q["bands"] == 1 and q["segments"] == 1)
    smem = _tiled_layout(q, nsh_y, nsh_x, c, b, grad)
    if q["fused"]:
        smem = max(smem, 2 * _T_CELLS * 8)
    if _cdiv(h, th) * q["segments"] > 65535:
        return None
    chunk = q["cvec"] * (16 // b) if q["chunked"] else c
    return dict(rows=q["rows"], cols=q["cols"], bands=q["bands"], segments=q["segments"],
                slabs=q["slabs"], chunked=q["chunked"], chunk=min(chunk, c),
                chunks=q["chunks"], slots=q["slots"], ring_rows=q["ring_rows"], smem=smem,
                ctas=tiles * q["segments"] * q["bands"],
                ctas_per_sm=_T_SMEM_SM // (smem + _T_STATIC + 1024), fused=q["fused"])


@functools.lru_cache(maxsize=None)
def _card_tiled_plan(device_index: int, n, h, w, c, img_bf16: bool, th, tw, nsh_y, nsh_x,
                     grad: bool):
    lib = build_tiled()
    out = (ctypes.c_longlong * len(TILED_PLAN_FIELDS))()
    with torch.cuda.device(device_index):
        err = lib.warp_tiled_plan(n, h, w, c, int(img_bf16), th, tw, nsh_y, nsh_x, int(grad), out)
    return None if err else dict(zip(TILED_PLAN_FIELDS, out))


def card_tiled_plan(img: torch.Tensor, r, compute_dtype: torch.dtype, tile, grad: bool = False):
    """``warp_tiled.cu``'s own plan (``warp_tiled_plan``) of a launch on
    img [N,H,W,C] on its CUDA card: what ``tiled_plan`` mirrors."""
    ry, rx = _radii(r)
    th, tw = _tile(tile)
    _, _, nsh_y, nsh_x, _ = _geometry(img.shape[1], img.shape[2], ry, rx,
                                      compute_dtype == torch.bfloat16, "replicate", (th, tw))
    return _card_tiled_plan(img.device.index if img.device.index is not None
                            else torch.cuda.current_device(), *img.shape,
                            img.dtype == torch.bfloat16, th, tw, nsh_y, nsh_x, grad)


def warp_windowed(img: torch.Tensor, flow: torch.Tensor, t=1.0, r=8,
                  border: str = "replicate",
                  compute_dtype: torch.dtype = torch.float32, tile=TILE) -> torch.Tensor:
    """Backward-warp img [N,H,W,C] by t*flow (flow [N,H,W,2] = (dx, dy)).

    t: scalar or [N]; r: int or (ry, rx) residual radius; border:
    'replicate' or 'constant'; compute_dtype: window dtype (bf16 as in the
    TPU kernel's compute_dtype); tile: the output tile (th, tw) each window
    serves, as the Pallas wrapper's. Any C (in channel groups where the
    window needs them, ``plan``). Returns img's dtype. Goes through the
    custom op ``torch.ops.vfisr_tpu_torch.warp_windowed``, which
    ``torch.export`` keeps as one node: CPU tensors take
    ``warp_windowed_plain``, CUDA tensors the kernel (``warp_tiled.cu``
    at a tile other than ``TILE``).
    """
    _check(img, flow, border, compute_dtype)
    if img.device.type != "cpu":
        _check_cuda("warp_windowed", img, flow)
    ry, rx = _radii(r)
    th, tw = _tile(tile)
    if isinstance(t, (int, float)):
        t_tensor, t_scalar = None, float(t)
    else:
        t_tensor, t_scalar = torch.as_tensor(t, dtype=torch.float32, device=img.device), 0.0
    return torch.ops.vfisr_tpu_torch.warp_windowed(img, flow, t_tensor, t_scalar, ry, rx, border,
                                                   compute_dtype, th, tw)


# The op's schema: warp_windowed's arguments with t split into a tensor (or
# None) and a number, r into (ry, rx) and tile into (th, tw). Defined with torch.library's
# Library API: torch.library.custom_op wraps each kernel in a guard that
# imports torch._dynamo at the op's first call (seconds per process).
_LIB = torch.library.Library("vfisr_tpu_torch", "DEF")
_LIB.define("warp_windowed(Tensor img, Tensor flow, Tensor? t, float t_scalar, int ry, int rx, "
            "str border, ScalarType compute_dtype, int th=32, int tw=256) -> Tensor")


def _warp_windowed_cuda(img, flow, t, t_scalar, ry, rx, border, compute_dtype, th=32, tw=256):
    """The op on CUDA tensors: one launch of K1 (``launch`` at ``TILE``,
    ``launch_tiled`` at any other tile)."""
    out = torch.empty_like(img)
    t = t_scalar if t is None else t
    if (th, tw) == TILE:
        launch(img, flow, t, out, (ry, rx), border, compute_dtype)
    else:
        launch_tiled(img, flow, t, out, (ry, rx), border, compute_dtype, (th, tw))
    return out


def _warp_windowed_cpu(img, flow, t, t_scalar, ry, rx, border, compute_dtype, th=32, tw=256):
    return warp_windowed_plain(img, flow, t_scalar if t is None else t, (ry, rx), border,
                               compute_dtype, tile=(th, tw))


_LIB.impl("warp_windowed", _warp_windowed_cuda, "CUDA")
_LIB.impl("warp_windowed", _warp_windowed_cpu, "CPU")


@torch.library.register_fake("vfisr_tpu_torch::warp_windowed")
def _warp_windowed_fake(img, flow, t, t_scalar, ry, rx, border, compute_dtype, th=32, tw=256):
    return torch.empty_like(img)


def launch(img: torch.Tensor, flow: torch.Tensor, t, out: torch.Tensor, r, border: str,
           compute_dtype: torch.dtype, tile=TILE) -> None:
    """Launch K1 on checked CUDA tensors (``warp_windowed`` checks them):
    t a number or a tensor of 1 or N elements, out like img. The kernel
    computes the window origins itself. A tile other than ``TILE`` goes to
    ``launch_tiled``."""
    global launches
    if tuple(tile) != TILE:
        launch_tiled(img, flow, t, out, r, border, compute_dtype, tile)
        return
    lib = build()
    t_args, _keep = _t_args(t, img.shape[0], img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.warp_windowed_launch(
            img.data_ptr(), flow.data_ptr(), *t_args, out.data_ptr(),
            *_launch_args(img, flow, r, border, compute_dtype), stream)
    if err != 0:
        raise RuntimeError(f"warp_windowed kernel launch failed: cudaError {err}")
    launches += 1


def warp_windowed_grad(img: torch.Tensor, flow: torch.Tensor, t, ct: torch.Tensor, r=8,
                       border: str = "replicate",
                       compute_dtype: torch.dtype = torch.float32, tile=TILE
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flow gradient of ``warp_windowed`` (K2): ``(grad_flow, cg)``.

    ct is the cotangent of the warp's output (img's shape and dtype). cg
    [N,H,W,2] f32 is (d loss/d sx, d loss/d sy), the channel sums of ct
    times the Pallas kernel's 'grad_x' and 'grad_y' outputs; grad_flow =
    cg * t in flow's dtype. The window origins are those of the forward
    and constant. Any C (in channel groups where the window needs them,
    ``plan(grad=True)``); tile as for ``warp_windowed``. CPU tensors go to
    ``warp_windowed_grad_plain``; CUDA tensors to the kernel.
    """
    _check(img, flow, border, compute_dtype)
    if ct.shape != img.shape or ct.dtype != img.dtype or ct.device != img.device:
        raise ValueError(f"ct must be like img {tuple(img.shape)} {img.dtype}; got "
                         f"{tuple(ct.shape)} {ct.dtype} on {ct.device}")
    tile = _tile(tile)
    if img.device.type == "cpu":
        return warp_windowed_grad_plain(img, flow, t, ct, r, border, compute_dtype, tile)
    _check_cuda("warp_windowed_grad", img, flow)
    grad_flow = torch.empty_like(flow)
    cg = torch.empty(flow.shape, dtype=torch.float32, device=flow.device)
    # autograd hands back cotangents of permuted outputs (rife.py's NCHW
    # views): the kernel reads ct as [N,H,W,C] contiguous
    launch_grad(img, flow, t, ct.contiguous(), grad_flow, cg, r, border, compute_dtype, tile)
    return grad_flow, cg


def launch_grad(img: torch.Tensor, flow: torch.Tensor, t, ct: torch.Tensor,
                grad_flow: torch.Tensor, cg: torch.Tensor, r, border: str,
                compute_dtype: torch.dtype, tile=TILE) -> None:
    """Launch K2 on checked CUDA tensors (``warp_windowed_grad`` prepares
    them): t as for ``launch``, ct contiguous like img, grad_flow like flow
    and cg [N,H,W,2] f32, both fresh allocations (written as aligned
    pairs). The kernel recomputes the forward's window origins. A launch in
    channel groups whose plan takes several chunks per tile also takes an
    f32 scratch [chunks, N, H, W, 2] for the chunks' partial sums,
    allocated here. A tile other than ``TILE`` goes to
    ``launch_grad_tiled``."""
    global grad_launches
    if tuple(tile) != TILE:
        launch_grad_tiled(img, flow, t, ct, grad_flow, cg, r, border, compute_dtype, tile)
        return
    lib = build()
    t_args, _keep = _t_args(t, img.shape[0], img.device)
    pl = plan(img, r, compute_dtype, grad=True)
    part = (torch.empty((pl["chunks"], *flow.shape), dtype=torch.float32, device=flow.device)
            if pl is not None and pl["grouped"] and pl["chunks"] > 1 else None)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.warp_windowed_grad_launch(
            img.data_ptr(), flow.data_ptr(), *t_args, ct.data_ptr(), grad_flow.data_ptr(),
            cg.data_ptr(), None if part is None else part.data_ptr(),
            *_launch_args(img, flow, r, border, compute_dtype), stream)
    if err != 0:
        raise RuntimeError(f"warp_windowed_grad kernel launch failed: cudaError {err}")
    grad_launches += 1


def kernel_origins(flow: torch.Tensor, t, r, compute_dtype: torch.dtype,
                   tile=TILE) -> torch.Tensor:
    """The window origins K1 and K2 compute in their prologue, from the
    same device function, for flow [N,H,W,2] on a CUDA card: [N, TY, TX, 2]
    int32 (oy, ox), canvas coordinates, as ``window_origins`` gives them
    (at a tile other than ``TILE``: ``warp_tiled.cu``'s, ``_tiled_origins``).
    A check of the kernels (chip_smoke.py, the CUDA tests): the warp's
    output alone can hide an origin one pixel off. The main path never
    calls it. Raises on a CPU tensor: the kernels have no CPU mode."""
    if flow.device.type != "cuda" or flow.ndim != 4 or flow.shape[-1] != 2:
        raise ValueError(f"kernel_origins needs a CUDA flow [N,H,W,2]; got {tuple(flow.shape)} "
                         f"on {flow.device}")
    if flow.dtype not in (torch.float32, torch.bfloat16) or not flow.is_contiguous():
        raise ValueError(f"kernel_origins needs a contiguous f32 or bf16 flow; got {flow.dtype}")
    tile = _tile(tile)
    if tile != TILE:
        return _tiled_origins(flow, t, r, compute_dtype, tile)
    n, h, w, _ = flow.shape
    ry, rx = _radii(r)
    pt, pl = _content_origin(ry, rx)
    th, tw = TILE
    origin = torch.empty((n, -(-h // th), -(-w // tw), 2), dtype=torch.int32, device=flow.device)
    lib = build()
    t_args, _keep = _t_args(t, n, flow.device)
    with torch.cuda.device(flow.device):
        stream = torch.cuda.current_stream(flow.device).cuda_stream
        err = lib.warp_windowed_origins_launch(
            flow.data_ptr(), *t_args, origin.data_ptr(), n, h, w,
            int(flow.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16), ry, rx, pt,
            pl, stream)
    if err != 0:
        raise RuntimeError(f"warp_windowed_origins kernel launch failed: cudaError {err}")
    return origin


def _origin_scratch(n: int, h: int, w: int, tile, device) -> tuple:
    """The origins pass's outputs for flow [n,h,w,2] at tile: (cells, f32
    [n, TY, TX, (th/g)*(tw/g), 2], the cell means; origin [n, TY, TX, 2]
    int32)."""
    th, tw = tile
    g = 1
    while th % (2 * g) == 0 and tw % (2 * g) == 0:
        g *= 2
    ty_n, tx_n = -(-h // th), -(-w // tw)
    cells = torch.empty((n, ty_n, tx_n, (th // g) * (tw // g), 2), dtype=torch.float32,
                        device=device)
    return cells, torch.empty((n, ty_n, tx_n, 2), dtype=torch.int32, device=device)


def _tiled_origins(flow: torch.Tensor, t, r, compute_dtype: torch.dtype, tile) -> torch.Tensor:
    """The window origins ``warp_tiled.cu``'s kernels compute, for flow
    [N,H,W,2] on its CUDA card at tile (th, tw): origin [N, TY, TX, 2] int32
    (oy, ox); by ``tile_origin`` (the fused prologue's function) where a tile
    has at most 64 cells, else by the origins pass a launch runs first."""
    n, h, w, _ = flow.shape
    ry, rx = _radii(r)
    pt, pl = _content_origin(ry, rx, tile)
    th, tw = tile
    cells, origin = _origin_scratch(n, h, w, tile, flow.device)
    lib = build_tiled()
    t_args, _keep = _t_args(t, n, flow.device)
    with torch.cuda.device(flow.device):
        stream = torch.cuda.current_stream(flow.device).cuda_stream
        err = lib.warp_tiled_origins_launch(
            flow.data_ptr(), *t_args, cells.data_ptr(), origin.data_ptr(), n, h, w,
            int(flow.dtype == torch.bfloat16), int(compute_dtype == torch.bfloat16), th, tw, ry,
            rx, pt, pl, stream)
    if err != 0:
        raise RuntimeError(f"warp_tiled origins launch failed: cudaError {err}")
    return origin


def _tiled(img, flow, t, r, border, compute_dtype, tile, ct=None, out=None, cg=None,
           grad_flow=None) -> None:
    """Launch ``warp_tiled.cu``'s K1 (out) or, with ct, K2 (cg, grad_flow)
    at tile, on checked contiguous CUDA tensors; where its plan is not
    fused, the call first runs the origins pass into scratch allocated
    here (the cell means and the origin table)."""
    tile = _tile(tile)
    lib = build_tiled()
    t_args, _keep_t = _t_args(t, img.shape[0], img.device)
    grad = ct is not None
    args = _launch_args(img, flow, r, border, compute_dtype, tile)
    n, h, w, c, img_bf16, flow_bf16, bf16, constant, ry, rx, pt, pl, nsh_y, nsh_x = args[:14]
    clip = args[14:]
    pl_ = card_tiled_plan(img, r, compute_dtype, tile, grad)
    if pl_ is None:
        raise RuntimeError(f"warp_tiled refuses img {tuple(img.shape)} at tile {tile}, r {r}")
    cells, origin = (None, None) if pl_["fused"] else _origin_scratch(n, h, w, tile, img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.warp_tiled_launch(
            img.data_ptr(), flow.data_ptr(), *t_args,
            None if cells is None else cells.data_ptr(),
            None if origin is None else origin.data_ptr(),
            ct.data_ptr() if grad else None, None if grad else out.data_ptr(),
            cg.data_ptr() if grad else None, grad_flow.data_ptr() if grad else None,
            n, h, w, c, img_bf16, flow_bf16, bf16, constant, int(grad), tile[0], tile[1], ry, rx,
            pt, pl, nsh_y, nsh_x, *clip, stream)
    if err != 0:
        raise RuntimeError(f"warp_tiled {'grad ' if grad else ''}kernel launch failed: "
                           f"cudaError {err}")


def launch_tiled(img: torch.Tensor, flow: torch.Tensor, t, out: torch.Tensor, r, border: str,
                 compute_dtype: torch.dtype, tile) -> None:
    """Launch K1 of ``warp_tiled.cu`` at any tile (32x256 included) on
    checked CUDA tensors, as ``launch`` takes them."""
    global launches, tiled_launches
    _tiled(img, flow, t, r, border, compute_dtype, tile, out=out)
    launches += 1
    tiled_launches += 1


def launch_grad_tiled(img: torch.Tensor, flow: torch.Tensor, t, ct: torch.Tensor,
                      grad_flow: torch.Tensor, cg: torch.Tensor, r, border: str,
                      compute_dtype: torch.dtype, tile) -> None:
    """Launch K2 of ``warp_tiled.cu`` at any tile (32x256 included) on
    tensors prepared as for ``launch_grad``."""
    global grad_launches, tiled_grad_launches
    _tiled(img, flow, t, r, border, compute_dtype, tile, ct=ct, cg=cg, grad_flow=grad_flow)
    grad_launches += 1
    tiled_grad_launches += 1


WEIGHT_MODES = ("interp", "grad_y", "grad_x")


def warp_windowed_plain(img: torch.Tensor, flow: torch.Tensor, t=1.0, r=8,
                        border: str = "replicate",
                        compute_dtype: torch.dtype = torch.float32,
                        weight_mode: str = "interp", tile=TILE) -> torch.Tensor:
    """``warp_windowed`` in plain PyTorch: the same taps, weights and
    rounding steps as the kernel, as whole-tensor ops on any device.

    weight_mode (as the Pallas kernel's): 'interp' is the warp; 'grad_y'
    and 'grad_x' return d out/d sy and d out/d sx per pixel and channel,
    that axis' hat replaced by its floor-consistent derivative (-1 at the
    lower tap, +1 at the upper) and masked to 0 where the forward
    saturates: the source coordinate outside [lo, hi) or the residual
    outside [0, nsh-1.001). tile: the output tile (th, tw), which places
    the windows (``window_origins``) and the content origin. Returns img's
    dtype.
    """
    _check(img, flow, border, compute_dtype)
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight_mode must be one of {WEIGHT_MODES}; got {weight_mode!r}")
    n, h, w, c = img.shape
    ry, rx = _radii(r)
    bf16 = compute_dtype == torch.bfloat16
    th, tw = _tile(tile)
    pt, pl, nsh_y, nsh_x, (ylo, yhi, xlo, xhi) = _geometry(h, w, ry, rx, bf16, border, (th, tw))
    dev = img.device
    t_arr = _t_array(t, n, dev)
    origin = window_origins(flow, t_arr, ry, rx, bf16, (th, tw)).long()
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    oy = origin[..., 0][:, ys // th][:, :, xs // tw]  # [N,H,W]
    ox = origin[..., 1][:, ys // th][:, :, xs // tw]
    rows = (ys % th)[None, :, None]
    cols = (xs % tw)[None, None, :]
    # p + flow*t as one fused multiply-add, rounded once to f32 (the
    # kernel's fmaf; XLA contracts the reference's expression the same way)
    f = flow.double()
    tb = t_arr.double()[:, None, None]
    sy_raw = ((pt + ys).double()[None, :, None] + f[..., 1] * tb).float()
    sx_raw = ((pl + xs).double()[None, None, :] + f[..., 0] * tb).float()
    ry_raw = (sy_raw.clamp(ylo, yhi) - oy.float()) - rows.float()
    rx_raw = (sx_raw.clamp(xlo, xhi) - ox.float()) - cols.float()
    # the residual bound nsh-1.001 rounded to f32, as the reference's and
    # the kernel's clamps and validity masks take it
    ry_max, rx_max = (torch.tensor(nsh - 1.001, dtype=torch.float32).item()
                      for nsh in (nsh_y, nsh_x))
    ryf = ry_raw.clamp(0.0, ry_max)
    rxf = rx_raw.clamp(0.0, rx_max)
    a0 = torch.floor(ryf)
    b0 = torch.floor(rxf)
    wy0 = 1.0 - (ryf - a0)
    wy1 = 1.0 - ((a0 + 1.0) - ryf)
    wx0 = 1.0 - (rxf - b0)
    wx1 = 1.0 - ((b0 + 1.0) - rxf)
    if weight_mode == "grad_y":
        vy = ((sy_raw >= ylo) & (sy_raw < yhi) & (ry_raw >= 0.0) & (ry_raw < ry_max)).float()
        wy0, wy1 = -vy, vy
    elif weight_mode == "grad_x":
        vx = ((sx_raw >= xlo) & (sx_raw < xhi) & (rx_raw >= 0.0) & (rx_raw < rx_max)).float()
        wx0, wx1 = -vx, vx
    yi0 = oy + rows + a0.long() - pt
    xi0 = ox + cols + b0.long() - pl

    win = img.to(compute_dtype).reshape(n, h * w, c)

    def tap(yi, xi):
        yc, xc = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
        v = torch.gather(win, 1, (yc * w + xc).reshape(n, -1, 1).expand(-1, -1, c))
        v = v.reshape(n, h, w, c)
        if border == "constant":
            valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            v = v * valid[..., None].to(v.dtype)
        return v

    wx0c, wx1c = wx0[..., None].to(compute_dtype), wx1[..., None].to(compute_dtype)
    inner = [(wx0c * tap(yi0 + a, xi0) + wx1c * tap(yi0 + a, xi0 + 1)).float() for a in (0, 1)]
    out = wy0[..., None] * inner[0] + wy1[..., None] * inner[1]
    return out.to(img.dtype)


def warp_windowed_grad_plain(img: torch.Tensor, flow: torch.Tensor, t, ct: torch.Tensor, r=8,
                             border: str = "replicate",
                             compute_dtype: torch.dtype = torch.float32, tile=TILE
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``warp_windowed_grad`` in plain PyTorch, on the grad weight modes:
    the two per-channel derivatives, each times ct and summed over
    channels in f32, then scaled by t."""
    gx, gy = (warp_windowed_plain(img, flow, t, r, border, compute_dtype, mode, tile)
              for mode in ("grad_x", "grad_y"))
    ctf = ct.float()
    cg = torch.stack([(ctf * gx.float()).sum(-1), (ctf * gy.float()).sum(-1)], -1)
    t_arr = _t_array(t, img.shape[0], img.device)
    return (cg * t_arr[:, None, None, None]).to(flow.dtype), cg
