"""One narrow SAFA train step on the windowed warp, in vfisr_tpu_torch and
in vfisr_tpu: the path that SAFA trains through on the card.

On the JAX side the Pallas warp runs in interpret mode with the TPU's
default backend (``_torch_port.windowed_reference``): the forward warps
through the kernel, the flow gradient through its grad modes, and the
feature warps' image gradient through the dense shifted adjoint
(``img_grad='shifted:8'``), clipped flows and all. On the port's side the
same warps take the windowed path on the CPU: K1's and K2's plain twins and
``warp_transpose_shifted``, counted here. c = 8 and crop 32: each
interpret-mode kernel variant compiles for seconds, whatever its channels.

Tolerance: the loss within 1e-4 relative, every parameter's gradient
within 1e-4 of its tensor's largest (f32 on both sides; the convolutions'
and the adjoint's sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import noisy_params, one_torch_thread, smooth_frames, windowed_reference
from vfisr_tpu.models.sota import safa as jsafa
from vfisr_tpu.train import train as jtrain
from vfisr_tpu.utils.checkpoint import _flatten, _unflatten
from vfisr_tpu_torch.core import warp as tcore
from vfisr_tpu_torch.models.sota import safa as tsafa
from vfisr_tpu_torch.ops.cuda import warp as tw
from vfisr_tpu_torch.train import train as ttrain
from vfisr_tpu_torch.utils.checkpoint import params_from_jax

TOL = 1e-4
NARROW = dict(c=8, num_dec_blocks=2)


def test_windowed_safa_train_step_matches_jax():
    rng = np.random.default_rng(4)
    n, crop = 2, 32
    f = smooth_frames(rng, 2 * n, crop, crop, cell=5)
    gt = smooth_frames(rng, n, 2 * crop, 2 * crop, cell=10)
    batch = {"img0": f[:n], "img1": f[n:], "gt": gt,
             "t": rng.uniform(0.2, 0.8, n).astype(np.float32)}
    jnet = jsafa.SAFANet(**NARROW)
    init = jnet.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in
                                              (f[:1], f[:1], np.array([0.5], np.float32))))
    flat, _ = noisy_params(init["params"], 9)

    def forward(params, b):
        return jtrain.vfi_loss(jnet.apply({"params": params}, b["img0"], b["img1"], b["t"]),
                               b["gt"])

    net = tsafa.SAFANet(**NARROW)
    net.load_state_dict(params_from_jax(flat))
    net.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = {"K1": 0, "K2": 0, "adjoint": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    with windowed_reference(), pytest.MonkeyPatch.context() as mp:
        jloss, jgrads = jax.value_and_grad(jax.checkpoint(forward))(
            jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)),
            {k: jnp.asarray(v) for k, v in batch.items()})
        mp.setattr(tw, "warp_windowed", counted("K1", tw.warp_windowed))
        mp.setattr(tw, "warp_windowed_grad", counted("K2", tw.warp_windowed_grad))
        mp.setattr(tcore, "warp_transpose_shifted",
                   counted("adjoint", tcore.warp_transpose_shifted))
        loss = torch.utils.checkpoint.checkpoint(
            lambda *a: ttrain.vfi_loss(net(*a[:3]), a[3]), tb["img0"], tb["img1"], tb["t"],
            tb["gt"], use_reentrant=False)
        loss.backward()
    # 8 warps, recomputed once; the flow gradient of all but stage 0's two
    # feature warps (their flow is a constant 0); the image gradient of the
    # 6 feature warps
    assert calls == {"K1": 16, "K2": 6, "adjoint": 6}
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    jg = params_from_jax(_flatten(jax.device_get(jgrads)))
    named = dict(net.named_parameters())
    assert set(named) == set(jg)
    for k, g in jg.items():
        ref = g.numpy()
        assert np.abs(ref).max() > 0, k
        err = np.abs(named[k].grad.numpy() - ref).max() / np.abs(ref).max()
        assert err <= TOL, (k, err)
