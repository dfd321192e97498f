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


def _compile_aot_cli(tmp):
    from vfisr_tpu_torch.compile_aot import main

    with pytest.raises(FileNotFoundError):  # no artifact to run
        main(["--load", str(tmp / "none.pt2"), "--device", "cpu"])


def _blind_study_cli(module):
    def entry(tmp):
        import importlib

        main = importlib.import_module(f"vfisr_tpu_torch.gui.{module}").main
        with pytest.raises(FileNotFoundError, match="interval not found"):  # no clip
            main(["--clip", "none", "--data-dir", str(tmp), "--output-dir", str(tmp / "out"),
                  "--device", "cpu"])

    entry.__name__ = f"_{module}_cli"
    return entry


def _web_app(tmp):
    from vfisr_tpu_torch.gui.web_app import build

    _, server = build(["--data-dir", str(tmp), "--out-dir", str(tmp / "out"), "--host",
                       "127.0.0.1", "--port", "0", "--device", "cpu"])
    server.server_close()


def _blind_study_app(tmp):
    from vfisr_tpu_torch.gui.blind_study_app import main

    main([str(tmp), "--device", "cpu"])  # SystemExit: no display (or no tkinter)


def _lpips_ordering_study(tmp):
    from vfisr_tpu_torch.lpips_ordering_study import main

    main(["--hard-clip", str(tmp / "none.y4m"), "--device", "cpu"])  # SystemExit: no clip


def _check_expert_downscale(tmp):
    from vfisr_tpu_torch.check_expert_downscale import main

    assert main(["--clips", str(tmp / "none.y4m"), "--device", "cpu"]) == 1  # no pairs


def _dryrun_rank(tmp):
    """A rank of the dry run (the data-parallel step of an f32 RIFE), here
    the one rank of a gloo group of one."""
    import torch.distributed as dist

    from vfisr_tpu_torch.parallel.dryrun import _rank

    dist.init_process_group("gloo", init_method=f"file://{tmp / 'store'}", rank=0, world_size=1)
    try:
        assert _rank(0, 1, "cpu")["differing"] == 0
    finally:
        dist.destroy_process_group()


PROFILE_TOOLS = ("profile_flagship", "profile_pairs", "profile_components", "profile_adaptive",
                 "profile_conv", "profile_resize", "profile_radius", "profile_warp_tiles")


def _verify_setup(tmp):
    from vfisr_tpu_torch.verify_setup import main

    assert main(["--device", "cpu"]) == 0


def _graft_entry(tmp):
    from vfisr_tpu_torch.graft_entry import entry

    entry("cpu")


def _profile_tool(name):
    def entry(tmp):
        import importlib

        with pytest.raises(SystemExit, match="needs a CUDA card"):  # no card here
            importlib.import_module(f"vfisr_tpu_torch.{name}").main([])

    entry.__name__ = f"_{name}"
    return entry


@pytest.mark.parametrize("entry", [_sweep, _benchmarks, _experiments_cli, _benchmark_cli,
                                   _extract_cli, _eval_vfi_cli, _eval_sr_cli, _gate_cli,
                                   _calibrate_router_cli, _calibrate_lpips_cli, _compile_aot_cli,
                                   _blind_study_cli("benchmark_proper"),
                                   _blind_study_cli("benchmark_all"),
                                   _blind_study_cli("generate_clips"), _dryrun_rank,
                                   _web_app, _blind_study_app, _lpips_ordering_study,
                                   _check_expert_downscale, _verify_setup, _graft_entry,
                                   *map(_profile_tool, PROFILE_TOOLS)])
def test_harness_entry_points_turn_tf32_off(entry, tf32_flags, tmp_path):
    """The sweep, the triplet benchmark, the interval extraction (Farneback's
    f32 convolutions), their CLIs, the held-out evaluation and gate CLIs,
    the export CLI, the blind study's CLIs (RIFE and the flow model), a
    rank of the data-parallel dry run, the study servers' renders (web_app
    and the Tk client), the LPIPS and expert-downscale studies, the setup
    check, the export entry and the eight profile tools turn TF32 off
    before any work (here
    the harnesses stop early: no interval, no clip; the gate has no
    checkpoint to score; the calibrations refuse to write over the shipped
    gate and heads; the export has no artifact to run)."""
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        entry(tmp_path)
    except SystemExit:
        pass
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)


# the port's device paths: the streaming pipeline and its CLIs, the benches,
# the harnesses and their CLIs, the trainer (with its VFIMamba path), the
# interval extraction and the held-out evaluation and gate CLIs, the clip
# renderer and the calibrations, the export and its CLI, the scale-out, the
# blind study's clip generation, the JPEG codec, the study servers and the
# study scripts (and the host-only report, whose figures import matplotlib
# on call), the setup, probe and entry files and the profile tools
DEVICE_PATHS = ("pipeline", "pipeline.flagship", "pipeline.streaming", "process",
                "batch_process", "bench", "benchmark", "run_experiments", "train.__main__",
                "harness", "harness.experiments", "harness.device_sweep", "harness.triplet",
                "data.extract_intervals", "data.draw", "train.data", "eval_vfi_quality",
                "eval_sr_quality", "gate_checkpoint", "data.synthetic_clip", "make_synthetic_clip",
                "calibrate_router", "evaluation.lpips_calibrate", "calibrate_lpips",
                "models.sota.vfimamba", "utils.aot", "compile_aot", "parallel",
                "parallel.mesh", "parallel.launch", "parallel.dryrun", "gui",
                "gui.benchmark_proper", "gui.benchmark_all", "gui.generate_clips",
                "prepare_blind_study", "data.jpeg", "gui.web_app", "gui.video_blind_study",
                "gui.blind_study_app", "lpips_ordering_study", "check_expert_downscale",
                "generate_comprehensive_report", "verify_setup", "probe_system", "graft_entry",
                "generate_figures") + PROFILE_TOOLS


def test_device_paths_import_no_scipy_pandas_matplotlib_or_yaml():
    """The card's machine may lack these: only analysis/ and the statistics
    CLIs (evaluation/statistics.py imports scipy) may pull them in, and
    utils/config.py and analysis/data_analysis.py import yaml and matplotlib
    on call only (tests/test_torch_config_analysis.py)."""
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
