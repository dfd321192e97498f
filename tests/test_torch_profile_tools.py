"""The port's eight ``profile_*`` tools on the CPU at small sizes: their
numerics against the JAX package where they compute something of their
own, every case of each tool run end to end, and a failing case raising.

Tolerances: the conv forms against ``jax.lax.conv_general_dilated`` in f32
1e-4 of the output's scale (nine or one GEMM against XLA's conv: sums in
another order); the dense-matmul resize against the port's tap gather and
the reference's ``_resize_f`` 1e-5 (f32, TF32 off: the same weights
summed in another order); the radius tool's PSNR 0.02 dB (f32 narrow nets
whose frames agree to ~1e-6 before the uint8 truncation); the pairs step's
midpoints 1e-4 and its uint8 frames 1 LSB. Times on the CPU are the host's
and are not read.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import narrow_rife, one_torch_thread  # noqa: F401
from vfisr_tpu_torch import (profile_adaptive, profile_components, profile_conv, profile_flagship,
                             profile_pairs, profile_radius, profile_resize, profile_warp_tiles)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def narrow():
    """(JAX RIFEModel, port RIFEModel): a narrow f32 IFNet with the same
    seeded parameters in both packages."""
    return narrow_rife(5)


@pytest.mark.parametrize("c", [8, 16])
def test_conv_forms_match_jax(c):
    rng = np.random.default_rng(c)
    x = rng.random((2, 12, 20, c), np.float32)
    k = (rng.standard_normal((3, 3, c, c)) * 0.05).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST))
    scale = np.abs(ref).max()
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    for form in (profile_conv.im2col, profile_conv.taps9):
        assert np.abs(form(xt, kt).numpy() - ref).max() <= 1e-4 * scale
    nat = profile_conv.native(xt.permute(0, 3, 1, 2), kt.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    assert np.abs(nat.numpy() - ref).max() <= 1e-4 * scale


@pytest.mark.parametrize("shape,out_hw,method", [((2, 30, 40, 3), (40, 52), "lanczos4"),
                                                 ((2, 36, 48, 3), (18, 24), "area")])
def test_dense_resize_matches_gather_and_jax(shape, out_hw, method):
    from vfisr_tpu.core.resize import _resize_f
    from vfisr_tpu_torch.core.resize import resize

    x = np.random.default_rng(1).random(shape, np.float32)
    wh = profile_resize.dense_weights(shape[1], out_hw[0], method, "cpu")
    ww = profile_resize.dense_weights(shape[2], out_hw[1], method, "cpu")
    dense = profile_resize.resize_dense(torch.from_numpy(x), wh, ww).numpy()
    gather = resize(torch.from_numpy(x), out_hw, method).numpy()
    ref = np.asarray(_resize_f(jnp.asarray(x), out_hw[0], out_hw[1], method, "high"))
    assert dense.shape == ref.shape == (shape[0], *out_hw, 3)
    assert np.abs(dense - gather).max() <= 1e-5
    assert np.abs(dense - ref).max() <= 1e-5


def test_radius_psnr_matches_jax(narrow):
    """The radius tool's PSNR of a narrow net's midpoints on two 64 px
    held-out scenes against the same computation in JAX (the reference's
    uint8 conversion and compute_psnr_simple)."""
    from vfisr_tpu.evaluation.metrics import compute_psnr_simple as jpsnr

    jr, tr = narrow
    batch = profile_radius.held_out(987, 2, 64)
    got = profile_radius.midpoint_psnr(tr.module, batch, CPU)
    merged = np.asarray(jr._apply(jr.params, *(jnp.asarray(batch[k])
                                               for k in ("img0", "img1", "t")))[0])
    want = float(np.mean([jpsnr((np.clip(m, 0, 1) * 255).astype(np.uint8),
                                (g * 255).astype(np.uint8)) for m, g in zip(merged, batch["gt"])]))
    assert math.isfinite(got) and abs(got - want) <= 0.02, (got, want)


def test_pairs_step_matches_jax(narrow):
    """profile_pairs' pipeline step at P = 2 against the reference's
    (pad, repeat over the timesteps, IFNet, unpad, Lanczos4 SR, uint8)."""
    from vfisr_tpu.core.frames import pad_to_multiple, to_uint8, unpad
    from vfisr_tpu.core.resize import resize

    jr, tr = narrow
    rng = np.random.default_rng(4)
    x0, x1 = (rng.random((2, 40, 72, 3), np.float32) for _ in range(2))
    up, mids = profile_pairs.pipeline_step(tr.module, torch.from_numpy(x0), torch.from_numpy(x1),
                                           (54, 96))
    a, _ = pad_to_multiple(jnp.asarray(x0), 32)
    b, _ = pad_to_multiple(jnp.asarray(x1), 32)
    ts = jnp.tile(jnp.asarray(profile_pairs.TS, jnp.float32), (2,))
    merged = jr._apply(jr.params, jnp.repeat(a, 3, axis=0), jnp.repeat(b, 3, axis=0), ts)[0]
    ref_mids = unpad(merged, 40, 72)
    ref_up = to_uint8(resize(jnp.concatenate([jnp.asarray(x0), ref_mids]), (54, 96), "lanczos4"))
    assert np.abs(mids.numpy() - np.asarray(ref_mids)).max() <= 1e-4
    assert up.shape == (8, 54, 96, 3)
    assert np.abs(up.numpy().astype(int) - np.asarray(ref_up).astype(int)).max() <= 1


def _numbers(line):
    for v in line.values():
        if isinstance(v, dict):
            yield from _numbers(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v


def _tool_cases(name, narrow):
    """Each tool's cases at small shapes on the CPU (narrow nets where a
    tool would load the full-width checkpoint, except the radius tool,
    which loads it per radius pair)."""
    module = narrow[1].module
    small = dict(reps=1, warmup=0)
    if name == "flagship":
        return profile_flagship.cases(CPU, hw=(64, 96), out_hw=(96, 128), module=module, **small)
    if name == "pairs":
        return profile_pairs.cases(CPU, hw=(40, 72), out_hw=(54, 96), module=module, **small)
    if name == "components":
        return profile_components.cases(CPU, hw=(64, 320), frame_hw=(40, 72), out_hw=(54, 96),
                                        modules={"f32": module, "bf16": module,
                                                 "deploy": module}, **small)
    if name == "adaptive":
        return profile_adaptive.cases(CPU, hw=(64, 96), out_hw=(96, 128), analysis_hw=(32, 48),
                                      module=module, **small)
    if name == "conv":
        return profile_conv.cases(CPU, shapes=(("tiny_c16", (3, 10, 12, 16)),), **small)
    if name == "resize":
        return profile_resize.cases(CPU, resize_cases_=(("sr", (2, 30, 40, 3), (40, 52),
                                                         "lanczos4"),
                                                        ("degrade", (2, 30, 40, 3), (15, 20),
                                                         "area")), **small)
    if name == "radius":
        return profile_radius.cases(CPU, hw=(40, 72), batch=profile_radius.held_out(987, 2, 64),
                                    **small)
    return profile_warp_tiles.cases(CPU, hw=(48, 700), **small)


# the cases each tool yields at full size: the reference's list, plus
# profile_components' whole step
CASE_COUNTS = {"flagship": 3, "pairs": 3, "components": 10, "adaptive": 3, "conv": 5,
               "resize": 6, "radius": 6, "warp_tiles": 10}


@pytest.mark.parametrize("name", sorted(CASE_COUNTS))
def test_tool_cases_run_small(name, narrow):
    lines = list(_tool_cases(name, narrow))
    want = CASE_COUNTS[name] if name != "conv" else 5  # five forms at the one tiny shape
    assert len(lines) == want
    for line in lines:
        nums = list(_numbers(line))
        assert nums and all(math.isfinite(v) for v in nums), line
    if name in ("components", "warp_tiles"):
        warps = [ln for ln in lines if "kernel" in ln]
        assert warps and all(ln["kernel"] == "plain twin" and ln["launches"] == 0 for ln in warps)
    if name == "conv":
        assert all(v["max_err_vs_native"] <= 0.05 for ln in lines for v in ln.values())
    if name == "resize":
        errs = {k: v["max_err_vs_gather"] for ln in lines for k, v in ln.items()}
        assert errs["sr_gather"] == 0 and max(errs.values()) <= 1e-5


def test_failing_case_raises_and_the_tool_prints_no_line(monkeypatch, capsys):
    """A failed case raises out of main (the reference prints "FAIL ..." in
    its place and exits 0), and a missing checkpoint fails the radius tool
    (the reference goes on with random weights)."""
    def broken(*args, **kwargs):
        raise RuntimeError("case failed")
        yield

    monkeypatch.setattr(profile_conv, "conv_cases", broken)
    with pytest.raises(RuntimeError, match="case failed"):
        profile_conv.main(["--device", "cpu", "--reps", "1"])
    assert capsys.readouterr().out == ""
    with pytest.raises(FileNotFoundError):
        next(profile_radius.cases(CPU, 1, 0, hw=(40, 72), batch=profile_radius.held_out(987, 1, 64),
                                  weights=profile_radius.WEIGHTS.parent / "missing.npz"))


def test_main_prints_a_json_line_per_case(monkeypatch, capsys):
    """main on the CPU: one JSON line per case with the device's name."""
    import json

    monkeypatch.setattr(profile_conv, "SHAPES", (("tiny", (1, 6, 8, 8)),))
    assert profile_conv.main(["--device", "cpu", "--reps", "1", "--warmup", "0"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 5 and all(ln["device"] == "cpu (host clock)" for ln in lines)
    assert [next(iter(ln)) for ln in lines] == [f"tiny_{f}" for f in (
        "native", "native_no_cudnn", "native_channels_last", "im2col", "taps9")]
