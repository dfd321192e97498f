"""Two faults of the port against the reference, held repaired.

- TF32: every model's ``load`` turns cuDNN's and matmul's TF32 off, so f32
  configs keep the reference's f32 arithmetic on the card. ``rife`` and
  ``rife_lite`` (``RIFEModel.load``) and the traditional baselines
  (``_Traditional.load``) once left them as they found them;
  ``FlagshipVFI.load`` (``flagship``) turned them off with no test to hold
  it.
- ``core/frames.py::pad_to_multiple`` reflects as ``jnp.pad(mode="reflect")``
  does, also where a pad is as wide as the side (``F.pad`` refuses that).

Tolerance: the padded frames are equal, element for element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfisr_tpu.core.frames import pad_to_multiple as jpad
from vfisr_tpu_torch.core.frames import pad_to_multiple as tpad
from vfisr_tpu_torch.models.registry import get_model


@pytest.fixture
def tf32_flags():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("name", ["rife", "rife_lite", "optical_flow", "bicubic", "lanczos",
                                  "flagship"])
def test_load_turns_tf32_off(name, tf32_flags):
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    get_model(name, device="cpu", load=True)
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


def _sweep(tmp):
    from vfisr_tpu_torch.harness.experiments import run_experiment_sweep

    run_experiment_sweep("none", [], [], output_dir=str(tmp / "out"), use_lpips=False,
                         device="cpu")


def _benchmarks(tmp):
    from vfisr_tpu_torch.harness.triplet import run_benchmarks

    run_benchmarks(str(tmp), str(tmp / "out"), models="lanczos", device="cpu")


def _experiments_cli(tmp):
    from vfisr_tpu_torch.run_experiments import main

    main(["--output-dir", str(tmp / "out"), "--device", "cpu"])


def _benchmark_cli(tmp):
    from vfisr_tpu_torch.benchmark import main

    main(["-d", str(tmp), "-o", str(tmp / "out"), "-m", "lanczos", "--device", "cpu"])


@pytest.mark.parametrize("entry", [_sweep, _benchmarks, _experiments_cli, _benchmark_cli])
def test_harness_entry_points_turn_tf32_off(entry, tf32_flags, tmp_path):
    """The sweep, the triplet benchmark and their CLIs turn TF32 off before
    any work (here each stops early: no interval, no clip)."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        entry(tmp_path)
    except SystemExit:
        pass
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("shape,multiple", [((1, 16, 20, 3), 32), ((5, 5, 3), 16),
                                            ((2, 33, 7, 3), 8)])
def test_pad_to_multiple_matches_jnp_pad(shape, multiple):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    jout, jpads = jpad(jnp.asarray(x), multiple)
    tout, tpads = tpad(torch.from_numpy(x), multiple)
    assert tpads == jpads
    assert tout.shape == jout.shape and np.array_equal(tout.numpy(), np.asarray(jout))
