"""What the bf16 row-slack fix of ``_torch_port.windowed_reference`` changes.

The Pallas kernel's bf16 path folds a window's odd row slack into the
vertical radius. Compiled for the TPU it rolls the window by the even part
of the slack only; in interpret mode it rolls by the whole slack, so on a
tile with an odd slack it samples one row below (vfisr_tpu/ops/pallas/
warp.py:103-107 against :165-172). This file runs the reference as it
stands, without the fix, beside the port, and shows that the two differ
only on tiles with an odd row slack, and there by exactly one row: the
reference equals the port run on the image moved up by one row. With the
fix the reference equals the port on every tile.

Replicate border only: with the constant border the zero padding above the
content does not move with the image, so the one-row picture holds only
away from the top edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, smooth_flow, windowed_reference
from vfisr_tpu.ops.pallas import warp as pw
from vfisr_tpu_torch.ops.cuda import warp as tw

TOL = 2.0 / 255.0  # bf16 windows, as in test_torch_warp.py
R = (2, 2)
TH, TWD = tw.TILE


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    n, h, w, c = 2, 96, 512, 3
    # rough content: a one-row move changes most pixels by far more than TOL
    img = rng.random((n, h, w, c), np.float32)
    flow = smooth_flow(rng, n, h, w, 6.0, 0.3)
    return img, flow


def _odd_slack_pixels(flow: torch.Tensor, h: int, w: int) -> np.ndarray:
    """[N,H,W] bool: pixels of tiles whose window row origin is odd before
    the bf16 path rounds it down (the origin table without that rounding)."""
    n = flow.shape[0]
    oy = tw.window_origins(flow, torch.ones(n), *R, bf16=False)[..., 0].numpy()
    odd = (oy & 1).astype(bool)
    return np.repeat(np.repeat(odd, TH, axis=1), TWD, axis=2)[:, :h, :w]


def _reference(img, flow):
    return np.asarray(pw.warp_windowed(jnp.asarray(img), jnp.asarray(flow), 1.0, r=R,
                                       border="replicate", interpret=True,
                                       compute_dtype=jnp.bfloat16), np.float32)


def test_unfixed_reference_is_one_row_off_on_odd_tiles(case):
    img, flow = case
    n, h, w, _ = img.shape
    jax.clear_caches()  # no trace made under the fix
    ref = _reference(img, flow)
    t_img, t_flow = torch.from_numpy(img), torch.from_numpy(flow)
    port = tw.warp_windowed_plain(t_img, t_flow, 1.0, r=R, border="replicate",
                                  compute_dtype=torch.bfloat16).numpy()
    # the image moved up by one row (the last row repeated): sampling it at
    # row y reads the source's row y + 1
    up = torch.cat([t_img[:, 1:], t_img[:, -1:]], dim=1)
    port_up = tw.warp_windowed_plain(up, t_flow, 1.0, r=R, border="replicate",
                                     compute_dtype=torch.bfloat16).numpy()
    odd = _odd_slack_pixels(t_flow, h, w)
    assert odd.any() and not odd.all(), "the case needs tiles of both parities"
    err_even = np.abs(ref - port).max(-1)[~odd].max()
    err_odd_up = np.abs(ref - port_up).max(-1)[odd].max()
    err_odd = np.abs(ref - port).max(-1)[odd].max()
    assert err_even <= TOL, err_even
    assert err_odd_up <= TOL, err_odd_up
    assert err_odd > 0.1, err_odd  # the odd tiles really are off by a row


def test_fixed_reference_matches_port_on_every_tile(case):
    img, flow = case
    with windowed_reference(backend=False) as warp:
        ref = np.asarray(warp(jnp.asarray(img), jnp.asarray(flow), 1.0, r=R,
                              border="replicate", interpret=True,
                              compute_dtype=jnp.bfloat16), np.float32)
    port = tw.warp_windowed_plain(torch.from_numpy(img), torch.from_numpy(flow), 1.0, r=R,
                                  border="replicate", compute_dtype=torch.bfloat16).numpy()
    assert np.abs(ref - port).max() <= TOL
