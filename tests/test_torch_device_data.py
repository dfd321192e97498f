"""vfisr_tpu_torch's on-device synthetic scenes held against vfisr_tpu's.

- ``resize_cubic`` against ``jax.image.resize(..., 'cubic')`` at the
  generator's texture sizes: 1e-5 relative to max(1, the reference).
- ``render_scene`` fed the JAX function's own ``jax.random`` draws (made
  from the key by the split order of device_data.py:50-141) against
  ``device_synthetic_batch`` on that key, at detail 0.35 and 0.0, with the
  exact warp on both sides and with the windowed warp on both sides (the
  JAX package's Pallas kernel in interpret mode, the port's plain twin):
  1e-5 (f32 windows). Crop 68, the smallest the HUD placement allows.
- The port's own generator: deterministic per seed, values in [0, 1], and
  a HUD that is the same in all three frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rel_err, windowed_reference
from vfisr_tpu.train.device_data import device_synthetic_batch as jax_batch
from vfisr_tpu_torch.train import device_data as tdd

CROP, BATCH = 68, 2


@pytest.mark.parametrize("coarse,size", [(8, 136), (34, 136), (5, 68), (22, 68), (2, 16)])
def test_resize_cubic_matches_jax(coarse, size):
    x = np.random.default_rng(coarse).random((2, coarse, coarse, 3), np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, size, size, 3), "cubic")
    assert rel_err(tdd.resize_cubic(torch.from_numpy(x), size).numpy(), ref) <= 1e-5


def jax_draws(key, n: int, c: int, detail: float) -> dict:
    """The random arrays vfisr_tpu's device_synthetic_batch draws from key,
    in the port's draw_scene layout."""
    ks = jax.random.split(key, 16)
    u = jax.random.uniform
    bg0, bg1, fg0, fg1, gate = tdd._bg_grids(c)
    d = dict(
        wmix=u(ks[8], (n, 1, 1, 1), minval=0.25, maxval=0.75),
        tex_bg=(u(ks[0], (n, bg0, bg0, 3)), u(ks[1], (n, bg1, bg1, 3))),
        tex_fg=(u(ks[2], (n, fg0, fg0, 3)), u(ks[3], (n, fg1, fg1, 3))),
        ctr=u(ks[4], (n, 2, 1, 1), minval=0.3 * c, maxval=0.7 * c),
        rad=u(ks[5], (n, 1, 1), minval=c / 8, maxval=c / 3),
        t=u(ks[6], (n,), minval=0.1, maxval=0.9),
        bgd=u(ks[7], (n, 2), minval=-12.0, maxval=12.0),
        fgd=u(ks[9], (n, 2), minval=-20.0, maxval=20.0),
        hud_u=u(ks[10], (n, 1, 1)),
        hx=u(ks[11], (n, 2, 1, 1), minval=4.0, maxval=max(5.0, c - 64.0)),
    )
    if detail > 0.0:
        dk = jax.random.split(ks[12], 6)
        d.update(per=jax.random.randint(dk[0], (n, 1, 1), 2, 5).astype(jnp.float32),
                 gate=u(dk[1], (n, gate, gate, 3)),
                 pitch=jax.random.randint(dk[2], (n, 1, 1), 24, 96).astype(jnp.float32),
                 speck=u(dk[3], (n, 2 * c, 2 * c)),
                 amp=u(dk[4], (n, 1, 1, 1), minval=0.5, maxval=1.0),
                 tone=u(dk[5], (n, 1, 1, 3), minval=0.2, maxval=1.0))
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), d)


@pytest.mark.parametrize("detail", [0.35, 0.0])
@pytest.mark.parametrize("windowed", [False, True])
def test_render_scene_matches_jax(detail, windowed):
    key = jax.random.PRNGKey(2)  # one sample with a HUD, one without
    draws = jax_draws(key, BATCH, CROP, detail)
    if windowed:
        with windowed_reference():
            ref = jax_batch(key, BATCH, CROP, detail)
            got = tdd.render_scene(draws, CROP, detail)
    else:
        ref = jax_batch(key, BATCH, CROP, detail)
        got = tdd.render_scene(draws, CROP, detail)
    assert set(got) == set(ref)
    assert bool(draws["hud_u"].lt(0.5).any())  # a HUD is drawn in this batch
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape and got[k].dtype == torch.float32, k
        assert rel_err(got[k].numpy(), ref[k]) <= 1e-5, (k, rel_err(got[k].numpy(), ref[k]))


def test_port_generator_deterministic_in_range_static_hud():
    def batch(seed):
        return tdd.device_synthetic_batch(torch.Generator().manual_seed(seed), 4, 96)

    a, b, c = batch(1), batch(1), batch(3)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["gt"], c["gt"])
    frames = torch.stack([a["img0"], a["gt"], a["img1"]])
    assert frames.shape == (3, 4, 96, 96, 3)
    assert frames.min() >= 0.0 and frames.max() <= 1.0
    assert bool(((a["t"] >= 0.1) & (a["t"] <= 0.9)).all())
    # the HUD box is where the draws put it, and the same in all frames
    d = tdd.draw_scene(torch.Generator().manual_seed(1), 4, 96)
    hy, hx = d["hx"][:, 0, 0, 0].ceil().long(), d["hx"][:, 1, 0, 0].ceil().long()
    on = d["hud_u"][:, 0, 0] < 0.5
    assert bool(on.any())
    for i in torch.nonzero(on).flatten().tolist():
        box = frames[:, i, hy[i]:hy[i] + 19, hx[i]:hx[i] + 55]
        assert torch.equal(box[0], box[1]) and torch.equal(box[1], box[2])
        assert not torch.equal(frames[0, i], frames[2, i])  # the scene itself moves
