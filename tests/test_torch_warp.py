"""vfisr_tpu_torch's warps held against vfisr_tpu's.

Windowed: ``warp_windowed_plain`` (what the CUDA wrapper runs for CPU
tensors) against the Pallas kernel in interpret mode. Tolerances: 1e-5 in
f32 (the same taps, weights and rounding steps; only sums may round
differently); 2/255 in bf16 (bf16 windows and horizontal sums, ~2 bf16 ulps
of a [0,1] pixel). Exact: the gather warp against ``flow_warp``, 1e-5.
The kernel itself is held against the plain version on the card by
test_torch_kernels_cuda.py and chip_smoke.py.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import adversarial_flow, smooth_flow, windowed_reference
from vfisr_tpu.core.warp import flow_warp as jax_flow_warp
from vfisr_tpu_torch.core import warp as tcore
from vfisr_tpu_torch.ops.cuda import warp as tw

TOL = {"f32": 1e-5, "bf16": 2.0 / 255.0}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

# (n, h, w, c, r, amp, noise, t): small and ragged shapes, radii of the
# flagship's launches, per-batch t, and a "past r" case whose intra-tile
# flow deviates from the tile mean by far more than the radius (clamping)
WINDOWED_CASES = {
    "sym_r8": (1, 64, 256, 1, 8, 3.0, 0.5, 0.7),
    "level_r22": (2, 40, 300, 3, (2, 2), 2.0, 0.3, 1.0),
    "final_r34": (4, 48, 260, 3, (3, 4), 4.0, 0.5, 1.0),
    "farneback_r8_c5": (1, 34, 60, 5, 8, 2.0, 0.5, 1.0),
    "per_batch_t": (2, 33, 100, 3, (3, 4), 3.0, 0.5, (0.25, 0.75)),
    "past_r": (2, 64, 300, 3, (2, 2), 25.0, 4.0, 1.0),
}


# each (case, border, dtype) compiles its own interpret-mode kernel, so the
# cases cover the axes without taking their full product
WINDOWED_PARAMS = [
    ("sym_r8", "replicate", "f32"), ("sym_r8", "constant", "bf16"),
    ("level_r22", "replicate", "bf16"), ("level_r22", "constant", "f32"),
    ("final_r34", "replicate", "bf16"), ("final_r34", "constant", "f32"),
    ("farneback_r8_c5", "replicate", "f32"),
    ("per_batch_t", "replicate", "bf16"), ("per_batch_t", "constant", "f32"),
    ("past_r", "replicate", "f32"), ("past_r", "replicate", "bf16"),
    ("past_r", "constant", "bf16"),
]


@pytest.fixture(scope="module")
def jax_warp():
    with windowed_reference(backend=False) as warp:
        yield warp


@pytest.mark.parametrize("case,border,dt", WINDOWED_PARAMS)
def test_windowed_plain_matches_pallas_interpret(jax_warp, case, border, dt):
    n, h, w, c, r, amp, noise, t = WINDOWED_CASES[case]
    rng = np.random.default_rng(zlib.crc32(f"{case}/{border}/{dt}".encode()))
    img = rng.random((n, h, w, c), np.float32)
    flow = smooth_flow(rng, n, h, w, amp, noise)
    jdt, tdt = DTYPES[dt]
    ref = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), jnp.asarray(t, jnp.float32),
                              r=r, border=border, interpret=True, compute_dtype=jdt))
    out = tw.warp_windowed(torch.from_numpy(img), torch.from_numpy(flow), torch.tensor(t),
                           r=r, border=border, compute_dtype=tdt)
    assert out.dtype == torch.float32 and out.shape == img.shape
    err = np.abs(out.numpy() - ref.astype(np.float32)).max()
    assert err <= TOL[dt], err


# the window origin's edge cases (_torch_port.adversarial_flow): (kind,
# (n, h, w, c), r, border, dtype). The kernels compute the origin that the
# plain twin takes from window_origins; these pin its semantics to the
# Pallas kernel's on the CPU
ADVERSARIAL_PARAMS = [
    ("tie", (2, 64, 512, 3), (2, 2), "replicate", "f32"),
    ("tie", (1, 64, 300, 3), (2, 2), "replicate", "bf16"),
    ("large", (2, 40, 300, 3), (3, 4), "replicate", "f32"),
    ("ragged", (1, 270, 48, 1), 8, "replicate", "f32"),
    ("ragged", (1, 48, 300, 3), (2, 2), "constant", "bf16"),
    ("per_batch_t", (3, 33, 100, 3), (3, 4), "replicate", "f32"),
    ("odd_row", (2, 96, 300, 3), (2, 2), "replicate", "bf16"),
    ("odd_row", (1, 64, 260, 3), (3, 4), "constant", "bf16"),
]


@pytest.mark.parametrize("kind,shape,r,border,dt", ADVERSARIAL_PARAMS)
def test_windowed_plain_matches_pallas_interpret_adversarial(jax_warp, kind, shape, r, border,
                                                             dt):
    n, h, w, c = shape
    rng = np.random.default_rng(zlib.crc32(f"{kind}/{shape}/{border}/{dt}".encode()))
    img = rng.random((n, h, w, c), np.float32)
    flow, t = adversarial_flow(kind, rng, n, h, w)
    jdt, tdt = DTYPES[dt]
    ref = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), jnp.asarray(t, jnp.float32),
                              r=r, border=border, interpret=True, compute_dtype=jdt))
    out = tw.warp_windowed(torch.from_numpy(img), torch.from_numpy(flow), torch.tensor(t),
                           r=r, border=border, compute_dtype=tdt)
    err = np.abs(out.numpy() - ref.astype(np.float32)).max()
    assert err <= TOL[dt], err


def test_tie_case_pins_the_rounding(monkeypatch):
    """Every tile mean of the tie case lands on .5, and rounding it half up
    instead of half-even moves origins and changes the warp."""
    n, h, w, c = 2, 64, 512, 3
    rng = np.random.default_rng(8)
    flow, t = adversarial_flow("tie", rng, n, h, w)
    flow_t = torch.from_numpy(flow)
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32))
    means = flow_t.reshape(n, 2, 32, 2, 256, 2).mean(dim=(2, 4)) * t
    assert torch.equal(means - torch.floor(means), torch.full_like(means, 0.5))
    even = tw.window_origins(flow_t, torch.full((n,), t), 2, 2, bf16=False)
    out_even = tw.warp_windowed_plain(img, flow_t, t, r=(2, 2))
    monkeypatch.setattr(torch, "round", lambda x: torch.floor(x + 0.5))
    up = tw.window_origins(flow_t, torch.full((n,), t), 2, 2, bf16=False)
    out_up = tw.warp_windowed_plain(img, flow_t, t, r=(2, 2))
    assert not torch.equal(even, up)
    assert (out_even - out_up).abs().max() > 0.05


def test_odd_row_case_has_odd_row_origins():
    """The odd_row case gives odd f32 row origins, which bf16 rounds down."""
    rng = np.random.default_rng(9)
    flow, t = adversarial_flow("odd_row", rng, 2, 96, 300)
    flow_t = torch.from_numpy(flow)
    f32 = tw.window_origins(flow_t, torch.full((2,), t), 2, 2, bf16=False)[..., 0]
    bf16 = tw.window_origins(flow_t, torch.full((2,), t), 2, 2, bf16=True)[..., 0]
    assert (f32 % 2 == 1).any() and (f32 % 2 == 0).any()
    assert torch.equal(bf16, f32 - f32 % 2)


def test_past_r_case_clamps():
    """The past-r case really leaves the exact warp (so it tests clamping)."""
    n, h, w, c, r, amp, noise, t = WINDOWED_CASES["past_r"]
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((n, h, w, c), np.float32))
    flow = torch.from_numpy(smooth_flow(rng, n, h, w, amp, noise))
    windowed = tw.warp_windowed_plain(img, flow, t, r=r)
    exact = tcore.flow_warp(img, flow, t, border="replicate")
    assert (windowed - exact).abs().max() > 0.1


def test_bf16_input_keeps_dtype(jax_warp):
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.random((2, 40, 64, 3), np.float32)).bfloat16()
    flow = torch.from_numpy(smooth_flow(rng, 2, 40, 64, 2.0)).bfloat16()
    out = tw.warp_windowed(img, flow, 1.0, r=(3, 4), compute_dtype=torch.bfloat16)
    ref = jax_warp(jnp.asarray(img.float().numpy(), jnp.bfloat16),
                   jnp.asarray(flow.float().numpy(), jnp.bfloat16), 1.0, r=(3, 4),
                   interpret=True, compute_dtype=jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - np.asarray(ref, np.float32)).max() <= TOL["bf16"]


def test_cpu_wrapper_counts_no_launch():
    before = tw.launches
    img = torch.rand(1, 32, 48, 3)
    tw.warp_windowed(img, torch.zeros(1, 32, 48, 2))
    assert tw.launches == before


def test_wrapper_rejects_bad_inputs():
    img = torch.rand(1, 32, 48, 3)
    with pytest.raises(ValueError):
        tw.warp_windowed(img, torch.zeros(1, 32, 40, 2))
    with pytest.raises(ValueError):
        tw.warp_windowed(img, torch.zeros(1, 32, 48, 2), border="reflect")
    with pytest.raises(TypeError):
        tw.warp_windowed(img.double(), torch.zeros(1, 32, 48, 2))


def test_window_origins_tile_mean_rounding():
    """Tile origins: tile-mean x t rounded half-even, minus (r+1), clamped;
    bf16 rounds the row origin down to even."""
    flow = torch.zeros(1, 64, 256, 2)
    flow[..., 1] = 2.5  # ties round to even: 2
    flow[..., 0] = -3.5  # -> -4
    org = tw.window_origins(flow, torch.ones(1), 2, 3, bf16=False)
    assert org.shape == (1, 2, 1, 2)
    pt, pl = 64, 512
    assert org[0, 0, 0].tolist() == [pt + 2 - 3, pl - 4 - 4]
    assert org[0, 1, 0].tolist() == [pt + 32 + 2 - 3, pl - 4 - 4]
    org16 = tw.window_origins(flow, torch.ones(1), 2, 3, bf16=True)
    assert org16[0, 0, 0].tolist() == [pt + 2 - 3 - 1, pl - 8]


@pytest.mark.parametrize("border", ["constant", "replicate", "reflect"])
def test_exact_matches_flow_warp(border):
    rng = np.random.default_rng(5)
    img = rng.random((2, 30, 44, 3), np.float32)
    flow = smooth_flow(rng, 2, 30, 44, 6.0, 1.0)
    ref = np.asarray(jax_flow_warp(jnp.asarray(img), jnp.asarray(flow), 0.6, border=border))
    out = tcore.flow_warp(torch.from_numpy(img), torch.from_numpy(flow), 0.6, border=border)
    assert np.abs(out.numpy() - ref).max() <= 1e-5


def test_backward_warp_dispatch(monkeypatch):
    rng = np.random.default_rng(6)
    img = torch.from_numpy(rng.random((1, 32, 64, 3), np.float32))
    flow = torch.from_numpy(smooth_flow(rng, 1, 32, 64, 12.0, 3.0))
    exact = tcore.flow_warp(img, flow, 1.0, border="replicate")
    windowed = tw.warp_windowed_plain(img, flow, 1.0, r=2)
    assert tcore.default_warp_backend(torch.device("cpu")) == "exact"
    assert tcore.default_warp_backend(torch.device("cuda")) == "windowed"
    assert torch.equal(tcore.backward_warp(img, flow, border="replicate", radius=2), exact)
    assert torch.equal(tcore.backward_warp(img, flow, border="replicate", radius=2,
                                           backend="windowed"), windowed)
    monkeypatch.setattr(tcore, "default_warp_backend", lambda device: "windowed")
    assert torch.equal(tcore.backward_warp(img, flow, border="replicate", radius=2), windowed)
    # reflect has no windowed form: it always takes the exact gather
    assert torch.equal(tcore.backward_warp(img, flow, border="reflect", radius=2),
                       tcore.flow_warp(img, flow, 1.0, border="reflect"))


def test_exact_bf16_keeps_pixel_grid():
    """The reference's gather warp builds its pixel grid in img's dtype, so
    a bf16 image 1920 px wide warps by zero flow onto rounded columns; the
    port keeps the grid in f32 (ROADMAP §3)."""
    img = torch.rand(1, 4, 1920, 1).bfloat16()
    zero = torch.zeros(1, 4, 1920, 2, dtype=torch.bfloat16)
    assert torch.equal(tcore.flow_warp(img, zero, 1.0, border="replicate"), img)
    ref = jax_flow_warp(jnp.asarray(img.float().numpy(), jnp.bfloat16),
                        jnp.asarray(zero.float().numpy(), jnp.bfloat16), 1.0, border="replicate")
    assert not np.array_equal(np.asarray(ref, np.float32), img.float().numpy())
