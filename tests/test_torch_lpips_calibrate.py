"""vfisr_tpu_torch/evaluation/lpips_calibrate.py held against
vfisr_tpu/evaluation/lpips_calibrate.py, and the calibrate_lpips CLI.

The same numpy seeds feed both packages; the port runs with
``device="cpu"`` on one intra-op thread.

Tolerances:
- ``make_base_patches``, every ``distort`` family at every severity and
  ``build_pairs``: within 1e-6 (float32 values in [0, 1]; the cubic,
  linear and area resizes and the blur take another float order than
  cv2's; the warp family's remap and the "A7" label are bit-equal), and
  the same pairs.
- ``_tap_distances`` at 64x64: within 1e-4 of each tap's largest value
  (the f32 AlexNet convs of XLA against torch's).
- Five Adam steps of ``train_heads`` from the reference's own initial
  logits (JAX's PRNG, passed to the port as ``theta0``): heads within rel
  1e-4, the final loss within rel 1e-4 (optax's and torch's Adam round
  differently; the taps differ as above).
- ``evaluate_heads`` and ``severity_spearman`` of the shipped heads on the
  reference's pinned sets (``build_pairs(default_rng(99), n_patches=4,
  cross_per_patch=6)``; ``default_rng(7)``, ``n_patches=2``): equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)
from vfisr_tpu.evaluation import lpips_calibrate as J
from vfisr_tpu.evaluation.lpips import LPIPS as JLPIPS
from vfisr_tpu_torch import calibrate_lpips as cli
from vfisr_tpu_torch.evaluation import lpips_calibrate as T
from vfisr_tpu_torch.evaluation.lpips import HEADS_PATH


@pytest.fixture(scope="module")
def pinned_pairs():
    """The reference test's 2AFC set, from both packages."""
    return (J.build_pairs(np.random.default_rng(99), n_patches=4, cross_per_patch=6),
            T.build_pairs(np.random.default_rng(99), n_patches=4, cross_per_patch=6,
                          device="cpu"))


@pytest.fixture(scope="module")
def shipped_heads():
    data = np.load(HEADS_PATH)
    return {k: data[k] for k in data.files}


def test_patches_and_distortions_match():
    ref = J.make_base_patches(np.random.default_rng(3), 8)
    got = T.make_base_patches(np.random.default_rng(3), 8, "cpu")
    assert got.dtype == ref.dtype and np.abs(got - ref).max() <= 1e-6
    for b in ref[:4]:  # one patch of each kind
        for fam in J.FAMILIES:
            for sev in J.SEVERITIES:
                r1, r2 = np.random.default_rng(sev), np.random.default_rng(sev)
                a, c = J.distort(b, fam, sev, r1), T.distort(b, fam, sev, r2, "cpu")
                assert a.shape == c.shape and a.dtype == c.dtype, (fam, sev)
                assert np.abs(a - c).max() <= 1e-6, (fam, sev)
                assert r1.bit_generator.state == r2.bit_generator.state
    with pytest.raises(ValueError):
        T.distort(ref[0], "sharpen", 1, np.random.default_rng(0), "cpu")


def test_pairs_and_taps_match(pinned_pairs):
    ref, got = pinned_pairs
    for a, c in zip(ref, got):
        assert a.shape == c.shape and np.abs(a - c).max() <= 1e-6
    refs, near, _ = ref
    jt = J._tap_distances(JLPIPS(weights_path="__nonexistent__", seed=0, load_calibrated=False),
                          near[:32], refs[:32])
    tt = T._tap_distances(T.random_features("cpu"), near[:32], refs[:32])
    assert len(tt) == T.N_TAPS
    for a, c in zip(jt, tt):
        assert a.shape == c.shape and np.abs(a - c).max() <= 1e-4 * np.abs(a).max()


def test_five_adam_steps_match_optax(pinned_pairs):
    refs, near, far = pinned_pairs[0]
    ref = J.train_heads(refs, near, far, steps=5, seed=0)
    dims = [ref[f"lin{i}_w"].shape[0] for i in range(T.N_TAPS)]
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    theta0 = [np.asarray(jnp.full((d,), -2.0) + 0.01 * jax.random.normal(k, (d,)))
              for d, k in zip(dims, keys)]
    got = T.train_heads(refs, near, far, steps=5, seed=0, device="cpu", theta0=theta0)
    for i in range(T.N_TAPS):
        a, c = ref[f"lin{i}_w"], got[f"lin{i}_w"]
        assert np.abs(a - c).max() <= 1e-4 * np.abs(a).max(), i
        # the five steps moved the heads off their start
        assert np.abs(c - np.log1p(np.exp(theta0[i]))).max() > 1e-3
    assert abs(float(got["final_loss"]) - float(ref["final_loss"])) <= 1e-4 * float(ref["final_loss"])


def test_shipped_heads_rank_as_in_the_reference(pinned_pairs, shipped_heads):
    (refs, near, far), (trefs, tnear, tfar) = pinned_pairs
    ref = J.evaluate_heads(shipped_heads, refs, near, far)
    got = T.evaluate_heads(shipped_heads, trefs, tnear, tfar, device="cpu")
    assert got == ref and got["accuracy_2afc"] >= 0.85
    ref = J.severity_spearman(shipped_heads, np.random.default_rng(7), n_patches=2)
    got = T.severity_spearman(shipped_heads, np.random.default_rng(7), n_patches=2, device="cpu")
    assert got == ref and np.mean(list(got.values())) >= 0.9 and min(got.values()) >= 0.6
    assert {k: v.tolist() for k, v in T.uniform_heads().items()} == {
        k: np.asarray(v).tolist() for k, v in J.uniform_heads().items()}


def test_cli_refuses_the_shipped_heads_and_writes_beside_out(tmp_path, monkeypatch):
    spearman = T.severity_spearman
    monkeypatch.setattr(T, "severity_spearman", lambda heads, device: spearman(
        heads, n_patches=1, device=device))  # one patch per ladder: the CLI's plumbing only
    with pytest.raises(SystemExit, match="shipped heads file"):
        T.calibrate(HEADS_PATH, device="cpu")
    with pytest.raises(SystemExit, match="shipped heads file"):
        cli.main(["--out", "weights/lpips_heads.npz", "--device", "cpu"])
    out = tmp_path / "cal" / "heads.npz"
    report = cli.main(["--patches", "2", "--steps", "3", "--out", str(out), "--device", "cpu"])
    heads = np.load(out)
    assert sorted(heads.files) == [f"lin{i}_w" for i in range(T.N_TAPS)]
    assert all((heads[k] >= 0).all() for k in heads.files)
    doc = (tmp_path / "cal" / "LPIPS_CALIBRATION.md").read_text()
    assert f"{report['holdout']['accuracy_2afc']:.3f}" in doc
    assert set(report["spearman"]) == set(T.FAMILIES)
