"""The windowed warp's image cotangent in vfisr_tpu_torch held against
vfisr_tpu's: the dense shifted adjoint and ``img_grad``.

- ``warp_transpose_shifted`` against ``vfisr_tpu.core.warp.
  warp_transpose_shifted`` (both borders, t a number or [N], max_disp 8 and
  3, flows within max_disp, small flows whose offsets the port skips, and a
  zero flow), and against autograd of the exact ``flow_warp``: the adjoint
  identity <warp x, ct> = <x, warp^T ct>, which holds wherever
  |t*flow| <= max_disp. 1e-5 relative to max(1, the reference's largest
  magnitude): the same weights, summed in the same order of offsets.
- ``backward_warp(img_grad='shifted:8')`` on the windowed path: the output
  and the gradients of img, flow and t against ``jax.vjp`` of the JAX
  function with the same ``img_grad``, the Pallas kernel in interpret mode
  (``_torch_port.windowed_reference``), with flows clipped to +-8 (some on
  the bound), as SAFA's are, at 12 channels (an interpret-mode kernel's
  compile time grows with its channels; the channels are independent, and
  tests/test_torch_safa.py holds the port at 40 against the reference). 1e-5
  relative to max(1, the reference's largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, rel_err, smooth_flow, windowed_reference
from vfisr_tpu.core import warp as jcore
from vfisr_tpu_torch.core import warp as tcore

TOL = 1e-5


def _case(seed, n, h, w, c, amp, noise, max_disp):
    """A normal cotangent and a smooth flow clipped to +-max_disp (amp 0:
    a zero flow)."""
    rng = np.random.default_rng(seed)
    ct = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)
    flow = np.clip(smooth_flow(rng, n, h, w, amp, noise), -max_disp, max_disp) * (amp > 0)
    return ct, flow.astype(np.float32)


@pytest.mark.parametrize("border", ["replicate", "constant"])
@pytest.mark.parametrize("t", [1.0, "per_batch"])
@pytest.mark.parametrize("amp,noise,max_disp", [(6.0, 3.0, 8), (2.0, 2.0, 3), (0.4, 0.2, 8),
                                                (0.0, 0.0, 8)])
def test_transpose_shifted_matches_jax(border, t, amp, noise, max_disp):
    n, h, w, c = 2, 22, 29, 5
    ct, flow = _case(int(10 * amp) + max_disp, n, h, w, c, amp, noise, max_disp)
    tv = np.array([1.0, 0.6], np.float32) if t == "per_batch" else t
    ref = np.asarray(jcore.warp_transpose_shifted(jnp.asarray(ct), jnp.asarray(flow),
                                                  jnp.asarray(tv), border, max_disp))
    got = tcore.warp_transpose_shifted(torch.from_numpy(ct), torch.from_numpy(flow),
                                       torch.from_numpy(np.asarray(tv)), border, max_disp)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert rel_err(got.numpy(), ref) <= TOL
    if amp == 0.0:  # the identity: each pixel's cotangent stays where it is
        assert np.array_equal(got.numpy(), ct)


@pytest.mark.parametrize("border", ["replicate", "constant"])
def test_transpose_shifted_is_the_warps_adjoint(border):
    """<flow_warp(x), ct> = <x, warp_transpose_shifted(ct)>, as autograd of
    the exact warp gives it, for |t*flow| <= max_disp."""
    n, h, w, c = 2, 24, 31, 4
    ct, flow = _case(7, n, h, w, c, 7.0, 3.0, 8)
    t = torch.tensor([0.9, 1.0]).reshape(-1, 1, 1)
    x = torch.from_numpy(np.random.default_rng(8).random((n, h, w, c), np.float32))
    x.requires_grad_(True)
    out = tcore.flow_warp(x, torch.from_numpy(flow), t, border=border)
    (g_ref,) = torch.autograd.grad(out, x, torch.from_numpy(ct))
    got = tcore.warp_transpose_shifted(torch.from_numpy(ct), torch.from_numpy(flow),
                                       t.reshape(-1), border, 8)
    assert rel_err(got.numpy(), g_ref.numpy()) <= TOL
    lhs = (out * torch.from_numpy(ct)).sum().item()
    rhs = (x.detach() * got).sum().item()
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)


def test_windowed_vjp_with_shifted_img_grad_matches_jax():
    n, h, w, c = 2, 24, 40, 12
    rng = np.random.default_rng(31)
    img = rng.random((n, h, w, c), np.float32)
    flow = np.clip(smooth_flow(rng, n, h, w, 9.0, 2.0), -8.0, 8.0).astype(np.float32)
    assert (np.abs(flow) == 8.0).mean() > 0.05  # flows on the clamp
    ct = rng.normal(0.0, 1.0, (n, h, w, c)).astype(np.float32)

    def f(i, fl, tt):
        return jcore.backward_warp(i, fl, tt, border="replicate", radius=8,
                                   img_grad="shifted:8")

    with windowed_reference():
        out, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(flow), jnp.asarray(0.9, jnp.float32))
        ref = [np.asarray(v, np.float32) for v in (out, *vjp(jnp.asarray(ct)))]
        x = torch.from_numpy(img).requires_grad_(True)
        fl = torch.from_numpy(flow).requires_grad_(True)
        tt = torch.tensor(0.9, requires_grad=True)
        got = tcore.backward_warp(x, fl, tt, border="replicate", radius=8, img_grad="shifted:8")
        got.backward(torch.from_numpy(ct))
    for name, g, e in zip(("out", "img", "flow", "t"), (got, x.grad, fl.grad, tt.grad), ref):
        g = g.detach().numpy()
        assert g.shape == e.shape, name
        assert np.abs(e).max() > 0, name
        assert rel_err(g, e) <= TOL, (name, rel_err(g, e))


def test_img_grad_is_checked():
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="img_grad"):
        tcore.backward_warp(x, torch.zeros((1, 8, 8, 2)), 1.0, img_grad="scatter")

