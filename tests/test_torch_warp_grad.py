"""The windowed warp's backward in vfisr_tpu_torch held against vfisr_tpu's.

- Grad modes: ``warp_windowed_plain(weight_mode='grad_y'|'grad_x')`` (the
  plain twin of the flow-gradient kernel, K2) against the Pallas kernel in
  interpret mode with the same weight mode, as
  tests/test_pallas_warp.py::TestGradWeightModes drives it: random, zero,
  integer flows and flows past the radius, both borders, f32 and bf16
  windows.
- Autograd: the gradients of ``backward_warp(backend='windowed')`` with
  respect to img, flow and t against ``jax.vjp`` of ``_pallas_warp_diff``.
  A per-batch t is held sample by sample: the reference's VJP cannot take a
  per-batch t (its image cotangent broadcasts t [N] against [N,H,W];
  ROADMAP §3), and its warp treats every sample alone.

Tolerances: 1e-5 with f32 windows, 2/255 with bf16 windows, relative to
max(1, the reference's largest magnitude): the twin takes the kernel's taps,
weights and rounding steps; sums may round in another order.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from _torch_port import rel_err, smooth_flow, windowed_reference
from vfisr_tpu.core import warp as jcore
from vfisr_tpu_torch.core import warp as tcore
from vfisr_tpu_torch.ops.cuda import warp as tw

TOL = {"f32": 1e-5, "bf16": 2.0 / 255.0}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _flow(rng, kind, n, h, w):
    if kind == "zero":
        return np.zeros((n, h, w, 2), np.float32)
    if kind == "integer":
        return rng.integers(-3, 4, (n, h, w, 2)).astype(np.float32)
    if kind == "past_r":
        return smooth_flow(rng, n, h, w, 25.0, 4.0)
    return smooth_flow(rng, n, h, w, 4.0, 0.5)


@pytest.fixture(scope="module")
def jax_warp():
    with windowed_reference(backend=False) as warp:
        yield warp


# each (flow, border, dtype) compiles two interpret-mode kernels, so the
# cases cover the axes without taking their full product
GRAD_PARAMS = [
    ("random", "replicate", "f32"), ("random", "constant", "bf16"),
    ("zero", "replicate", "bf16"), ("zero", "constant", "f32"),
    ("integer", "replicate", "f32"), ("integer", "constant", "bf16"),
    ("past_r", "replicate", "bf16"), ("past_r", "constant", "f32"),
]


@pytest.mark.parametrize("kind,border,dt", GRAD_PARAMS)
def test_grad_modes_match_pallas_interpret(jax_warp, kind, border, dt):
    rng = np.random.default_rng(zlib.crc32(f"{kind}/{border}/{dt}".encode()))
    n, h, w, c, r, t = 2, 40, 300, 3, (2, 4), 0.8
    img = rng.random((n, h, w, c), np.float32)
    flow = _flow(rng, kind, n, h, w)
    jdt, tdt = DTYPES[dt]
    for mode in ("grad_y", "grad_x"):
        ref = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), t, r=r, border=border,
                                  interpret=True, compute_dtype=jdt, weight_mode=mode))
        out = tw.warp_windowed_plain(torch.from_numpy(img), torch.from_numpy(flow), t, r, border,
                                     tdt, weight_mode=mode)
        assert out.dtype == torch.float32 and out.shape == img.shape
        assert np.abs(ref).max() > 0.1, mode  # the case has a derivative to check
        assert rel_err(out.numpy(), ref) <= TOL[dt], (mode, rel_err(out.numpy(), ref))


def test_grad_modes_zero_flow_is_floor_consistent():
    """At exact integer coordinates the derivative is v[k+1] - v[k] (the
    reference's half-open dhat), not 0: zero-init flow heads train on it."""
    img = torch.arange(40 * 300, dtype=torch.float32).reshape(1, 40, 300, 1) % 7.0
    flow = torch.zeros(1, 40, 300, 2)
    gx = tw.warp_windowed_plain(img, flow, 1.0, (2, 4), "replicate", weight_mode="grad_x")
    gy = tw.warp_windowed_plain(img, flow, 1.0, (2, 4), "replicate", weight_mode="grad_y")
    assert torch.equal(gx[0, :, :-1, 0], img[0, :, 1:, 0] - img[0, :, :-1, 0])
    assert torch.equal(gy[0, :-1, :, 0], img[0, 1:, :, 0] - img[0, :-1, :, 0])
    # the replicate clip saturates at the last row and column: no gradient
    assert gx[0, :, -1].abs().max() == 0 and gy[0, -1].abs().max() == 0


def _jax_vjp(img, flow, t, ct, border, r, jdt):
    def f(i, fl, tt):
        return jcore._pallas_warp_diff(i, fl, tt, border, r, jdt, "gather")

    out, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(flow), jnp.asarray(t, jnp.float32))
    return [np.asarray(x, np.float32) for x in (out, *vjp(jnp.asarray(ct)))]


def _port_grads(img, flow, t, ct, border, r, tdt, wrap=None):
    x = torch.from_numpy(img).requires_grad_(True)
    f = torch.from_numpy(flow).requires_grad_(True)
    tt = torch.tensor(t, dtype=torch.float32, requires_grad=True)

    def warp(x, f, tt):
        return tcore.backward_warp(x, f, tt, border=border, backend="windowed", radius=r,
                                   compute_dtype=tdt)

    out = wrap(warp, x, f, tt) if wrap else warp(x, f, tt)
    out.backward(torch.from_numpy(ct))
    return [v.detach().float().numpy() for v in (out, x.grad, f.grad, tt.grad)]


@pytest.mark.parametrize("border,dt,r", [("replicate", "f32", (2, 4)), ("constant", "bf16", (3, 4))])
def test_windowed_vjp_matches_jax(border, dt, r):
    rng = np.random.default_rng(zlib.crc32(f"vjp/{border}/{dt}".encode()))
    n, h, w, c = 2, 36, 270, 3
    img = rng.random((n, h, w, c), np.float32)
    flow = smooth_flow(rng, n, h, w, 3.0, 0.5)
    ct = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)
    jdt, tdt = DTYPES[dt]
    with windowed_reference():
        ref = _jax_vjp(img, flow, 0.7, ct, border, r, jdt)
    got = _port_grads(img, flow, 0.7, ct, border, r, tdt)
    for name, g, e in zip(("out", "img", "flow", "t"), got, ref):
        assert g.shape == e.shape, name
        assert rel_err(g, e) <= TOL[dt], (name, rel_err(g, e))


def test_windowed_vjp_per_batch_t_matches_jax():
    rng = np.random.default_rng(21)
    n, h, w, c, r = 2, 36, 270, 3, (2, 4)
    img = rng.random((n, h, w, c), np.float32)
    flow = smooth_flow(rng, n, h, w, 3.0, 0.5)
    ct = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)
    t = np.array([0.3, 0.9], np.float32)
    got = _port_grads(img, flow, t, ct, "replicate", r, torch.float32)
    with windowed_reference():
        per = [_jax_vjp(img[k:k + 1], flow[k:k + 1], t[k], ct[k:k + 1], "replicate", r,
                        jnp.float32) for k in range(n)]
    for j, name in enumerate(("out", "img", "flow")):
        assert rel_err(got[j], np.concatenate([p[j] for p in per])) <= TOL["f32"], name
    assert got[3].shape == (n,)
    assert rel_err(got[3], np.array([p[3] for p in per])) <= TOL["f32"]


def test_windowed_warp_recomputes_under_checkpoint():
    """The autograd Function saves its inputs, so torch.utils.checkpoint
    recomputes it and the gradients are those of the plain backward."""
    rng = np.random.default_rng(4)
    n, h, w, c = 1, 40, 64, 3
    img = rng.random((n, h, w, c), np.float32)
    flow = smooth_flow(rng, n, h, w, 2.0, 0.3)
    ct = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)
    plain = _port_grads(img, flow, 1.0, ct, "replicate", (2, 4), torch.float32)
    remat = _port_grads(img, flow, 1.0, ct, "replicate", (2, 4), torch.float32,
                        wrap=lambda fn, *a: checkpoint(fn, *a, use_reentrant=False))
    for a, b in zip(plain, remat):
        np.testing.assert_array_equal(a, b)


def test_warp_windowed_grad_cpu_takes_plain_twin():
    """On CPU tensors the K2 wrapper is its plain twin: grad_flow = cg * t
    in flow's dtype, cg the channel sums of ct times the grad modes."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.random((2, 33, 70, 3), np.float32))
    flow = torch.from_numpy(smooth_flow(rng, 2, 33, 70, 2.0)).bfloat16()
    ct = torch.from_numpy(rng.normal(0, 1, (2, 33, 70, 3)).astype(np.float32))
    t = torch.tensor([0.5, 2.0])
    gflow, cg = tw.warp_windowed_grad(img, flow, t, ct, (2, 4), "constant", torch.float32)
    gx = tw.warp_windowed_plain(img, flow, t, (2, 4), "constant", weight_mode="grad_x")
    gy = tw.warp_windowed_plain(img, flow, t, (2, 4), "constant", weight_mode="grad_y")
    assert cg.dtype == torch.float32 and gflow.dtype == torch.bfloat16
    torch.testing.assert_close(cg, torch.stack([(ct * gx).sum(-1), (ct * gy).sum(-1)], -1))
    torch.testing.assert_close(gflow, (cg * t[:, None, None, None]).bfloat16())
    with pytest.raises(ValueError):
        tw.warp_windowed_grad(img, flow, t, ct[..., :2], (2, 4), "constant", torch.float32)
