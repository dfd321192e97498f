"""Shared helpers for the tests that hold vfisr_tpu_torch against vfisr_tpu.

Inputs are made with numpy from a seed and handed to both packages.
``windowed_reference`` makes the JAX package run the windowed (Pallas)
warp on the CPU, in interpret mode, with one fix to the interpret path:

The Pallas kernel's bf16 path folds the odd part of a window's row slack
into the vertical radius (``oy_eff = oy + (row_slack & ~1)``) and, compiled
for the TPU, rolls the window by the even part only (bitcast roll of row
pairs). The interpret path has no bitcast and rolls by the full slack, so
for tiles with an odd slack it samples one row below the compiled kernel
(vfisr_tpu/ops/pallas/warp.py:103-107 against :170-172). The fix clears the
slack's low bit as the kernel body reads it, which makes the interpret
path roll by the even part, as the compiled kernel does. f32 windows have
no fold and are untouched. f32 warps of many channels go to the interpret
path in slices of channels (``REF_SLICE``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest


class _EvenRowSlack:
    """Read-only view of the packed origin table with row_slack's low bit
    (bit 7 of oy/8<<17 | ox/128<<11 | row_slack<<7 | col_slack) cleared."""

    def __init__(self, ref):
        self.ref = ref

    def __getitem__(self, idx):
        return self.ref[idx] & ~(1 << 7)


# An f32 warp of more channels goes to the interpret-mode kernel in slices
# of REF_SLICE channels: its windows and weights depend on the flow alone,
# so each channel's output is the same in any slice (bit for bit at 40 and
# 176 channels, tests/test_torch_warp.py), and a narrow kernel compiles in
# seconds where a 32-channel chunk of the reference's takes half a minute.
REF_SLICE = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for a test module's torch CPU ops, where the
    module imports this fixture: under the suite's parallel workers the
    cores are busy, and OpenMP barriers would wait on descheduled threads
    (one data-pipeline file took 977 worker-seconds on the default count)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def windowed_reference(backend: bool = True):
    """Run vfisr_tpu's windowed warp in interpret mode (bf16 fix above).

    backend=True also routes vfisr_tpu.core.warp.backward_warp to it (the
    TPU's default), and the port's backward_warp to its windowed path.
    """
    import jax

    import vfisr_tpu.core.warp as jcore
    import vfisr_tpu.ops.pallas.warp as pw
    import vfisr_tpu_torch.core.warp as tcore

    orig_kernel = pw._warp_kernel
    orig_warp = pw.warp_windowed

    def kernel(packed_ref, *args, fold_odd_row=False, bitcast_roll=False, **kw):
        if fold_odd_row and not bitcast_roll:
            packed_ref = _EvenRowSlack(packed_ref)
        return orig_kernel(packed_ref, *args, fold_odd_row=fold_odd_row,
                           bitcast_roll=bitcast_roll, **kw)

    def interpreted(*args, **kw):
        # interpret=True whether it comes by keyword or, as the reference's
        # channel chunking passes it, as the seventh positional argument
        if len(args) > 6:
            args = args[:6] + (True,) + args[7:]
        else:
            kw["interpret"] = True
        img = args[0]
        dtype = args[7] if len(args) > 7 else kw.get("compute_dtype", jax.numpy.float32)
        if img.shape[-1] > REF_SLICE and dtype == jax.numpy.float32:
            return jax.numpy.concatenate(
                [orig_warp(img[..., k:k + REF_SLICE], *args[1:], **kw)
                 for k in range(0, img.shape[-1], REF_SLICE)], axis=-1)
        return orig_warp(*args, **kw)

    # jit caches hold traces made with and without the patch: clear them
    # on the way in and out, so neither side sees the other's
    jax.clear_caches()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pw, "_warp_kernel", kernel)
            if backend:
                mp.setattr(pw, "warp_windowed", interpreted)
                mp.setattr(jcore, "default_warp_backend", lambda: "pallas")
                mp.setattr(tcore, "default_warp_backend", lambda device: "windowed")
            yield orig_warp
    finally:
        jax.clear_caches()


def noisy_params(params, seed: int, scale: float = 0.05):
    """(flat, tree): Flax params with seeded normal noise added to every
    leaf, so that zero-init heads carry signal. flat ('/'-joined keys,
    numpy) goes to the port's ``params_from_jax``; tree (jnp) to Flax."""
    import jax.numpy as jnp

    from vfisr_tpu.utils.checkpoint import _flatten

    rng = np.random.default_rng(seed)
    flat = {k: (np.asarray(v) + scale * rng.normal(size=v.shape)).astype(np.float32)
            for k, v in _flatten(params).items()}
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
    return flat, tree


def rel_err(got, ref) -> float:
    """Largest |got - ref| over max(1, the largest |ref|): the tests'
    tolerance scale."""
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / max(1.0, np.abs(ref).max()))


def smooth_frames(rng: np.random.Generator, n: int, h: int, w: int, c: int = 3,
                  cell: int = 8) -> np.ndarray:
    """Low-frequency random frames [n,h,w,c] in [0,1] (bilinear upsample of
    a coarse random grid): resampling-friendly content."""
    gh, gw = h // cell + 2, w // cell + 2
    coarse = rng.random((n, gh, gw, c)).astype(np.float64)
    ys = (np.arange(h) + 0.5) / cell
    xs = (np.arange(w) + 0.5) / cell
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    a = coarse[:, y0][:, :, x0]
    b = coarse[:, y0][:, :, x0 + 1]
    cc = coarse[:, y0 + 1][:, :, x0]
    d = coarse[:, y0 + 1][:, :, x0 + 1]
    out = (a * (1 - fx) + b * fx) * (1 - fy) + (cc * (1 - fx) + d * fx) * fy
    return out.astype(np.float32)


def smooth_flow(rng: np.random.Generator, n: int, h: int, w: int, amp: float,
                noise: float = 0.5) -> np.ndarray:
    """Smooth flow field [n,h,w,2] (dx, dy) with per-pixel noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = amp * np.sin(xx / 17.0 + yy / 23.0)
    fy = 0.5 * amp * np.cos(yy / 9.0) - 0.5
    base = np.stack([fx, fy], -1)[None]
    return (base + rng.normal(0.0, noise, (n, h, w, 2))).astype(np.float32)


def game_frames(n: int, h: int, w: int, step: float = 3.0) -> np.ndarray:
    """[n,h,w,3] uint8 synthetic gameplay: a smooth gradient background, a
    textured rectangle moving right by ``step`` px per frame, and a static
    HUD box in the top-left corner."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = np.stack([xx / w, yy / h, 0.5 + 0.25 * np.sin(xx / 9.0) * np.cos(yy / 7.0)], -1)
    out = np.empty((n, h, w, 3), np.float32)
    rh, rw = h // 3, w // 4
    for i in range(n):
        f = bg.copy()
        x0 = int(round(w // 8 + i * step))
        y0 = h // 3
        # texture in the rectangle's own coordinates: it moves rigidly
        tex = 0.5 + 0.4 * (np.sin(xx[:rh, :rw] / 3.0) * np.cos(yy[:rh, :rw] / 4.0))[..., None] \
            * np.array([1.0, 0.6, 0.2])
        f[y0:y0 + rh, x0:x0 + rw] = tex[:, :max(0, min(rw, w - x0))]
        f[: h // 6, : w // 5] = (0.9, 0.9, 0.1)  # HUD
        out[i] = f
    return np.clip(np.floor(out * 255.0 + 0.5), 0, 255).astype(np.uint8)


def adversarial_flow(kind: str, rng: np.random.Generator, n: int, h: int, w: int):
    """(flow [n,h,w,2] f32, t) for one edge case of the window origin.

    tie: every tile mean times t lands exactly on .5 (t = 0.5, odd integer
    tile flows, and a zero-sum checkerboard of +-6 whose pixels sit past
    the radius under one rounding of the tie and inside it under the
    other); large: uniform flows of +-300 px, where the order of the f32
    sums decides the last bits of the mean; ragged: a smooth flow;
    per_batch_t: a smooth flow and a t per image; odd_row: integer tile
    flows (plus noise) whose row origin is odd before bf16 rounds it
    down to even.
    """
    yy, xx = np.mgrid[0:h, 0:w]
    ty, tx = yy // 32, xx // 256
    if kind == "tie":
        t = 0.5
        k = rng.integers(-4, 5, (n, 2, 1, 1)) + np.stack([3 * ty - tx, tx - 2 * ty])[None]
        check = np.where((yy % 2) == (xx % 2), 6.0, -6.0)
        flow = (2 * k + 1) + check[None, None]  # (k + 0.5) / t, +-6
        return np.ascontiguousarray(np.moveaxis(flow, 1, -1), np.float32), t
    if kind == "large":
        return rng.uniform(-300.0, 300.0, (n, h, w, 2)).astype(np.float32), 1.0
    if kind == "odd_row":
        k = rng.integers(0, 6, (n, 2, 1, 1)) + np.stack([tx + ty, ty])[None]
        flow = k + rng.normal(0.0, 0.2, (n, 2, h, w))
        return np.ascontiguousarray(np.moveaxis(flow, 1, -1), np.float32), 1.0
    flow = smooth_flow(rng, n, h, w, 6.0, 1.0)
    if kind == "per_batch_t":
        return flow, np.linspace(0.3, 1.7, n).astype(np.float32)
    if kind == "ragged":
        return flow, 1.0
    raise ValueError(f"unknown adversarial flow {kind!r}")


RIFE_NARROW = dict(channels=(32, 24, 16, 16), num_convs=2)


def narrow_rife(seed: int, **cfg):
    """(JAX RIFEModel, port RIFEModel) on the CPU: a narrow IFNet (f32, f32
    warp windows unless cfg says otherwise) with the same seeded normal
    parameters in both packages, without running Flax's init (seconds to
    minutes on the CPU): ``jax.eval_shape`` gives the shapes."""
    import jax
    import jax.numpy as jnp
    import torch

    from vfisr_tpu.models.sota import rife as jrife
    from vfisr_tpu_torch.models.sota import rife as trife
    from vfisr_tpu_torch.utils.checkpoint import params_from_jax

    kw = dict(RIFE_NARROW, **cfg)
    jcfg = jrife.RIFEConfig(**{"warp_dtype": jnp.float32, **kw})
    net = jrife.IFNet(jcfg)
    z = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), z, z, jnp.asarray([0.5]))["params"]
    flat, tree = noisy_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), seed)
    jr = jrife.RIFEModel(device="cpu", config=jcfg)
    jr.params = tree
    jr._apply = jax.jit(lambda p, a, b, s: net.apply({"params": p}, a, b, s))
    tr = trife.RIFEModel(device="cpu", config=trife.RIFEConfig(**{"warp_dtype": torch.float32,
                                                                 **kw}))
    tr.module = trife.IFNet(tr.CONFIG)
    tr.module.load_state_dict(params_from_jax(flat))
    tr.module.eval().requires_grad_(False)
    jr._loaded = tr._loaded = True
    return jr, tr


def sweep_interval(pans, seed: int = 0, h: int = 144, w: int = 256):
    """(keyframes, midpoints) of an interval for the experiment harnesses:
    h x w uint8 windows of a wide smooth canvas at the cumulative pan
    offsets (px per pair), the midpoints at the half offsets, a static HUD
    box on top."""
    offs = np.concatenate([[0], np.cumsum(pans)]).astype(int)
    canvas = smooth_frames(np.random.default_rng(seed), 1, h, w + offs[-1] + 8, cell=12)[0]
    canvas = np.clip(np.floor(canvas * 255 + 0.5), 0, 255).astype(np.uint8)

    def window(x):
        f = canvas[:, x:x + w].copy()
        f[: h // 6, : w // 5] = (230, 230, 40)
        return f

    kfs = [window(o) for o in offs]
    mids = [window((a + b) // 2) for a, b in zip(offs[:-1], offs[1:])]
    return kfs, mids
