"""Three faults of the port against the reference, held repaired.

- TF32: every model's ``load`` turns cuDNN's and matmul's TF32 off, so f32
  configs keep the reference's f32 arithmetic on the card. ``rife`` and
  ``rife_lite`` (``RIFEModel.load``) and the traditional baselines
  (``_Traditional.load``) once left them as they found them;
  ``FlagshipVFI.load`` (``flagship``) turned them off with no test to hold
  it.
- ``core/frames.py::pad_to_multiple`` reflects as ``jnp.pad(mode="reflect")``
  does, also where a pad is as wide as the side (``F.pad`` refuses that).
- The import rule: the port's device paths import torch, numpy and the
  standard library, and none of scipy, pandas, matplotlib or yaml
  (``evaluation/statistics.py`` imports scipy for the statistics only).

Tolerance: the padded frames are equal, element for element.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfisr_tpu.core.frames import pad_to_multiple as jpad
from vfisr_tpu_torch.core.frames import pad_to_multiple as tpad
from vfisr_tpu_torch.models.registry import get_model
from _torch_port import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


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


def _extract_cli(tmp):
    from vfisr_tpu_torch.extract_intervals import main

    with pytest.raises(ValueError, match="not found"):  # no clip registered
        main(["--clip-id", "none", "--data-dir", str(tmp), "--device", "cpu"])


def _eval_vfi_cli(tmp):
    from vfisr_tpu_torch.eval_vfi_quality import main

    main(["--models", "lanczos", "--samples", "1", "--crop", "64", "--device", "cpu"])


def _eval_sr_cli(tmp):
    from vfisr_tpu_torch.eval_sr_quality import main

    main(["--models", "bicubic", "--samples", "1", "--crop", "64", "--device", "cpu"])


def _gate_cli(tmp):
    from vfisr_tpu_torch.gate_checkpoint import main

    main(["--candidate", "rife", "--incumbent", "rife_lite", "--weights", str(tmp / "none.npz"),
          "--demote-to", str(tmp / "aside.npz"), "--device", "cpu"])


def _calibrate_router_cli(tmp):
    from vfisr_tpu_torch.calibrate_router import main

    main(["--out", "weights/router_gate.json", "--device", "cpu"])


def _calibrate_lpips_cli(tmp):
    from vfisr_tpu_torch.calibrate_lpips import main

    main(["--out", "weights/lpips_heads.npz", "--device", "cpu"])


@pytest.mark.parametrize("entry", [_sweep, _benchmarks, _experiments_cli, _benchmark_cli,
                                   _extract_cli, _eval_vfi_cli, _eval_sr_cli, _gate_cli,
                                   _calibrate_router_cli, _calibrate_lpips_cli])
def test_harness_entry_points_turn_tf32_off(entry, tf32_flags, tmp_path):
    """The sweep, the triplet benchmark, the interval extraction (Farneback's
    f32 convolutions), their CLIs and the held-out evaluation and gate CLIs
    turn TF32 off before any work (here the harnesses stop early: no
    interval, no clip; the gate has no checkpoint to score; the calibrations
    refuse to write over the shipped gate and heads)."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        entry(tmp_path)
    except SystemExit:
        pass
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


# the port's device paths: the streaming pipeline and its CLIs, the benches,
# the harnesses and their CLIs, the trainer, the interval extraction and the
# held-out evaluation and gate CLIs, the clip renderer and the calibrations
DEVICE_PATHS = ("pipeline", "pipeline.flagship", "pipeline.streaming", "process",
                "batch_process", "bench", "benchmark", "run_experiments", "train.__main__",
                "harness", "harness.experiments", "harness.device_sweep", "harness.triplet",
                "data.extract_intervals", "data.draw", "train.data", "eval_vfi_quality",
                "eval_sr_quality", "gate_checkpoint", "data.synthetic_clip", "make_synthetic_clip",
                "calibrate_router", "evaluation.lpips_calibrate", "calibrate_lpips")


def test_device_paths_import_no_scipy_pandas_matplotlib_or_yaml():
    """The card's machine may lack these: only analysis/ and the statistics
    CLIs (evaluation/statistics.py imports scipy) may pull them in."""
    code = (
        "import importlib, sys\n"
        f"for m in {DEVICE_PATHS!r}:\n"
        "    importlib.import_module('vfisr_tpu_torch.' + m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('scipy', 'pandas', 'matplotlib', 'yaml'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("shape,multiple", [((1, 16, 20, 3), 32), ((5, 5, 3), 16),
                                            ((2, 33, 7, 3), 8)])
def test_pad_to_multiple_matches_jnp_pad(shape, multiple):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    jout, jpads = jpad(jnp.asarray(x), multiple)
    tout, tpads = tpad(torch.from_numpy(x), multiple)
    assert tpads == jpads
    assert tout.shape == jout.shape and np.array_equal(tout.numpy(), np.asarray(jout))
