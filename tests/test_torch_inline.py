"""vfisr_tpu_torch/methods/inline.py held against vfisr_tpu/methods/inline.py.

Every name of ``methods.__all__`` on the same uint8 frames (a textured
rectangle moving 3 px per pair under a HUD box that changes colour, 72x128,
made with numpy), each package on the CPU with its exact gather warps.

Tolerances: uint8 frames differ on at most 1% of the bytes, by 1 LSB on all
but 0.1% of them and by at most 4 LSB anywhere. The same f32 arithmetic,
summed in another order, lands a value on the other side of a .5 now and
then. Where the HUD box changes colour, Farneback's 2x2 solve is nearly
singular (flows of ~440 px) and the packages' flows differ there by up to
0.3 px, which moves a tap across the box's edge: 3 LSB on 2 of 27648 bytes
(flow_interpolate at t = 0.25). The UI mask equal;
``calc_motion``, the complexity and the uncertainty within 1e-4 (relative
for the means: one mean of ~1e4 f32 terms), flows within 1e-3 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import game_frames, one_torch_thread
from vfisr_tpu import methods as jm
from vfisr_tpu.ops.flow import farneback_flow as jflow
from vfisr_tpu_torch import methods as tm

H, W = 72, 128


@pytest.fixture(scope="module")
def pair():
    f = game_frames(2, H, W, step=3.0)
    f[1, : H // 6, : W // 5] = (40, 200, 240)  # the HUD changes: UI for UAFI's mask
    return f[0], f[1]


def _gray(f):
    return (0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]).astype(np.float32)


def _close_u8(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.dtype == ref.dtype == np.uint8 and out.shape == ref.shape
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 4 and (d > 1).mean() <= 1e-3 and (d > 0).mean() <= 0.01, (
        d.max(), (d > 1).mean(), (d > 0).mean())


def test_all_names_ported():
    assert tm.__all__ == jm.__all__
    assert all(callable(getattr(tm, n)) for n in tm.__all__)


@pytest.mark.parametrize("name,t", [("linear_blend", 0.25), ("linear_blend", 0.5),
                                    ("linear_blend", 0.75), ("flow_interpolate", 0.25),
                                    ("ui_aware_interpolate", 0.25),
                                    ("ui_aware_interpolate", 0.75)])
def test_frame_methods_match(pair, name, t):
    f0, f1 = pair
    _close_u8(getattr(tm, name)(f0, f1, t, device="cpu"), getattr(jm, name)(f0, f1, t))


def test_frame_dup_and_edge_enhance(pair):
    f0, f1 = pair
    assert np.array_equal(tm.frame_dup(f0, f1, 0.5), jm.frame_dup(f0, f1, 0.5))
    for s in (1.3, 1.5):
        _close_u8(tm.edge_enhance(f0, s, device="cpu"), jm.edge_enhance(f0, s))
    assert tm.edge_enhance(f0, 0.0, device="cpu") is f0


def test_ughi_matches(pair):
    f0, f1 = pair
    for t in (0.5,):  # the reference compiles its program per timestep
        out, u = tm.ughi_interpolate(f0, f1, t, device="cpu")
        ref, ju = jm.ughi_interpolate(f0, f1, t)
        _close_u8(out, ref)
        assert u == pytest.approx(ju, rel=1e-4, abs=1e-6)


def test_motion_and_complexity_match(pair):
    f0, f1 = pair
    g0, g1 = _gray(f0), _gray(f1)
    m = tm.calc_motion(g0, g1, device="cpu")
    assert m > 0.1 and m == pytest.approx(jm.calc_motion(g0, g1), rel=1e-4)
    c, flow = tm.estimate_motion_complexity(g0, g1, device="cpu")
    jc, jflow_ = jm.estimate_motion_complexity(g0, g1)
    assert 0.0 < c <= 1.0 and c == pytest.approx(jc, rel=1e-4)
    assert flow.shape == (H, W, 2) and np.abs(flow - jflow_).max() <= 1e-3


@pytest.mark.parametrize("complexity,tier", [(0.1, "linear"), (0.5, "flow"), (0.9, "flow")])
def test_mcar_tiers_match(pair, complexity, tier):
    """No RIFE model: the top tier takes the flow warp, as in the reference."""
    f0, f1 = pair
    flow = np.asarray(jflow(jnp.asarray(_gray(f0)), jnp.asarray(_gray(f1)), 0.5, 1, 15, 1, 5, 1.1))
    out, got = tm.mcar_interpolate_cached(f0, f1, 0.5, complexity, flow, None, device="cpu")
    ref, jtier = jm.mcar_interpolate_cached(f0, f1, 0.5, complexity, flow, None)
    assert got == jtier == tier
    _close_u8(out, ref)


def test_mcar_rife_tier_calls_the_model(pair):
    f0, f1 = pair
    calls = []

    class Fake:
        def interpolate(self, a, b, num_frames=1, timestamps=None):
            calls.append(timestamps)
            return [a]

    flow = np.zeros((H, W, 2), np.float32)
    out, tier = tm.mcar_interpolate_cached(f0, f1, 0.25, 0.9, flow, Fake(), device="cpu")
    assert tier == "rife" and calls == [[0.25]] and out is f0


def test_ui_mask_and_uncertainty_match(pair):
    f0, f1 = pair
    g0, g1 = jnp.asarray(_gray(f0)), jnp.asarray(_gray(f1))
    fwd = np.asarray(jflow(g0, g1, 0.5, 3, 15, 3, 5, 1.2))
    bwd = np.asarray(jflow(g1, g0, 0.5, 3, 15, 3, 5, 1.2))
    mask = tm.detect_ui_mask(f0, f1, fwd, device="cpu")
    assert mask.dtype == np.uint8 and mask.shape == (H, W)
    assert np.array_equal(mask, np.asarray(jm.detect_ui_mask(f0, f1, fwd)))
    assert mask[: H // 6, : W // 5].any()  # the HUD box changed: UI
    unc = tm.estimate_uncertainty(f0, f1, fwd, bwd, device="cpu")
    assert np.abs(unc - np.asarray(jm.estimate_uncertainty(f0, f1, fwd, bwd))).max() <= 1e-4


def test_methods_default_to_the_card(pair):
    """Without device= the methods run on CUDA: here, with no card, that
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    f0, f1 = pair
    with pytest.raises((RuntimeError, AssertionError)):
        tm.linear_blend(f0, f1, 0.5)
