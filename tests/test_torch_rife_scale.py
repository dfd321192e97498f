"""RIFE at its coarser pyramid scales: the port's ``RIFEModel`` at native
scales 0.5 and 0.25 held against JAX's ``_apply_for_scale``
(``interpolate_batch(..., scale=s)``), ``uhd_mode``,
``interpolate_recursive`` and ``get_rife_model``.

A narrow IFNet (channels 32/24/16/16, 2 convs per block) with the same
seeded parameters in both packages, f32 with f32 warp windows, each
package's exact CPU warp. The coarsest block needs an input of at least 8
px, so scale 0.5 (levels 16/8/4/2) runs at 128 rows and 0.25 (32/16/8/4) at
256; widths that need padding. Tolerance 1e-4 on frames in [0, 1], as
tests/test_torch_rife.py: the same network, convolution sums in another
order; uint8 frames within 1 LSB.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import narrow_rife, one_torch_thread, smooth_frames
from vfisr_tpu_torch.models.sota import rife as trife
from vfisr_tpu_torch.utils.checkpoint import load_npz
from vfisr_tpu_torch.utils.paths import default_weights

TS = (0.25, 0.5, 0.75)


@pytest.fixture(scope="module")
def models():
    return narrow_rife(5)


@pytest.mark.parametrize("scale,hw,levels", [(0.5, (128, 176), (16, 8, 4, 2)),
                                             (0.25, (256, 272), (32, 16, 8, 4))])
def test_coarser_pyramid_matches(models, scale, hw, levels):
    jr, tr = models
    assert tr.scales_for(scale) == levels == jr._apply_for_scale(scale)[1].scales
    f = smooth_frames(np.random.default_rng(6), 4, *hw)
    ref = np.asarray(jr.interpolate_batch(jnp.asarray(f[:2]), jnp.asarray(f[2:]), TS, scale=scale))
    out = tr.interpolate_batch(torch.from_numpy(f[:2]), torch.from_numpy(f[2:]), TS, scale=scale)
    assert out.shape == ref.shape == (2, 3, *hw, 3)
    assert float(np.abs(out.numpy() - ref).max()) <= 1e-4
    assert tr.scales_for(1.0) == tr.scales_for(None) == (8, 4, 2, 1)
    full = tr.interpolate_batch(torch.from_numpy(f[:2]), torch.from_numpy(f[2:]), TS)
    assert float((full - out).abs().max()) > 1e-3  # a coarser pyramid is another result


def test_scales_must_match_the_blocks(models):
    _, tr = models
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(ValueError, match="pyramid scales"):
        tr.module(x, x, torch.tensor([0.5]), scales=(8, 4, 2))


def test_uhd_mode_and_explicit_scale(models):
    jr, tr = models
    f = (smooth_frames(np.random.default_rng(7), 2, 128, 160) * 255).astype(np.uint8)
    tr.uhd_mode = jr.uhd_mode = True
    try:
        uhd = tr.interpolate(f[0], f[1], num_frames=1)
        juhd = jr.interpolate(f[0], f[1], num_frames=1)
        half = tr.interpolate(f[0], f[1], num_frames=1, scale=0.5)
        full = tr.interpolate(f[0], f[1], num_frames=1, scale=1.0)  # an explicit scale wins
    finally:
        tr.uhd_mode = jr.uhd_mode = False
    assert np.array_equal(uhd[0], half[0])
    assert np.abs(uhd[0].astype(int) - np.asarray(juhd[0]).astype(int)).max() <= 1
    assert np.array_equal(full[0], tr.interpolate(f[0], f[1], num_frames=1)[0])


def test_interpolate_recursive_matches(models):
    jr, tr = models
    f = (smooth_frames(np.random.default_rng(8), 2, 64, 96) * 255).astype(np.uint8)
    assert tr.interpolate_recursive(f[0], f[1], factor=1) == []
    out = tr.interpolate_recursive(f[0], f[1], factor=4)
    ref = jr.interpolate_recursive(f[0], f[1], factor=4)
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        assert a.dtype == np.uint8 and np.abs(a.astype(int) - np.asarray(b).astype(int)).max() <= 1


@pytest.mark.parametrize("lite,weights", [(False, "rife"), (True, "rife_lite")])
def test_get_rife_model(lite, weights):
    model = trife.get_rife_model(lite=lite, device="cpu")
    assert type(model) is (trife.RIFELiteModel if lite else trife.RIFEModel) and model._loaded
    path = default_weights(weights)
    if path is not None:
        assert model.param_count() == sum(v.size for v in load_npz(path).values())
    assert model.device == torch.device("cpu")
