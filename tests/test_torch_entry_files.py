"""The port's environment and entry files against the repository's:
``graft_entry`` (``__graft_entry__.py``), ``probe_system``,
``verify_setup``, ``generate_figures`` (``scripts/generate_figures.py``)
and ``evaluate_quality`` on JPEG frames (``scripts/evaluate_quality.py``).

Tolerances: the IFNet forward of ``entry()`` against the reference's with
the same parameters 1e-4 (f32, exact warps on the CPU in both packages;
sums in another order through four IFBlocks); the exported program against
the eager module 1e-6; PSNR 1e-9, SSIM 1e-5 and LPIPS 1e-5 relative on the
same decoded frames (tests/test_torch_metrics.py's for QualityEvaluator).
"""

import importlib.util
import json
import subprocess

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, smooth_frames  # noqa: F401
from vfisr_tpu_torch import evaluate_quality, generate_figures, graft_entry, verify_setup
from vfisr_tpu_torch import probe_system as tprobe
from vfisr_tpu_torch.utils.paths import REPO_ROOT


def test_entry_matches_the_reference_and_exports():
    """entry()'s IFNet forward with the reference's parameters (carried by
    params_from_jax) against the reference's entry() fn, on random frames;
    its exported program against the eager module."""
    from flax.traverse_util import flatten_dict

    import __graft_entry__ as ref_entry
    from vfisr_tpu_torch.utils.aot import export_program
    from vfisr_tpu_torch.utils.checkpoint import params_from_jax

    ref_fn, (params, *_) = ref_entry.entry()
    fn, (img0, img1, t) = graft_entry.entry("cpu")
    assert img0.shape == (1, 256, 256, 3) and t.tolist() == [0.5]
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    fn.module.load_state_dict(params_from_jax(flat))
    rng = np.random.default_rng(0)
    x0, x1 = (rng.random((1, 256, 256, 3), np.float32) for _ in range(2))
    want = np.asarray(jax.jit(ref_fn)(params, jnp.asarray(x0), jnp.asarray(x1),
                                      jnp.asarray([0.5], jnp.float32)))
    with torch.no_grad():
        got = fn(torch.from_numpy(x0), torch.from_numpy(x1), t)
        exported = export_program(fn, img0, img1, t).module()(torch.from_numpy(x0),
                                                              torch.from_numpy(x1), t)
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert (exported - got).abs().max().item() <= 1e-6


def test_dryrun_multichip_on_gloo(capsys):
    out = graft_entry.dryrun_multichip(2, "cpu", timeout=300)
    assert out["pairs"] == 2 and out["backend"] == "gloo"
    assert out["mids_err"] <= graft_entry.MIDS_TOL and out["up_err"] <= 1
    text = capsys.readouterr().out
    assert "one train step" in text and "matches one process" in text


def _reports():
    """Reports in both packages' layout that move every rule of the score."""
    base = {"python": {"version": "3.12.1"},
            "accelerator": {"platform": "gpu", "devices": [{"id": 0, "kind": "card"}],
                            "error": None},
            "dependencies": {"a": "1", "b": "2"},
            "system": {"ram_gb": 64.0, "disk_free_gb": 100.0, "ffmpeg": True}}
    variants = [
        {},
        {"accelerator": {"platform": None, "devices": [], "error": "probe hung"}},
        {"accelerator": {"platform": "cpu", "devices": [{"id": 0, "kind": "cpu"}],
                         "error": None}},
        {"system": {"ram_gb": 8.0, "disk_free_gb": 5.0, "ffmpeg": False}},
        {"dependencies": {"a": None, "b": None, "c": "1"}},
        {"python": {"version": "3.9.7"}, "system": {"ram_gb": 15.9, "disk_free_gb": 20.0,
                                                     "ffmpeg": False}},
    ]
    return [dict(base, **v) for v in variants]


@pytest.mark.parametrize("i", range(6))
def test_compute_score_matches_the_reference(i):
    """The port's rules are the reference's, the TPU read as the card:
    the same score and as many recommendations and warnings."""
    spec = importlib.util.spec_from_file_location("_ref_probe", REPO_ROOT / "probe_system.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)  # jax only inside its probe's subprocess
    report = _reports()[i]
    got, want = tprobe.compute_score(report), ref.compute_score(report)
    assert got[0] == want[0] and len(got[1]) == len(want[1]) and len(got[2]) == len(want[2])


def test_probe_system_json_keys(capsys):
    assert tprobe.main(["--json", "--probe-timeout", "120"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert list(report) == ["python", "accelerator", "dependencies", "system",
                            "compatibility_score", "recommendations", "warnings"]
    assert report["accelerator"]["platform"] == "cpu" and "nvcc" in report["accelerator"]
    assert report["compatibility_score"] == tprobe.compute_score(report)[0]


def test_verify_setup_cpu_fails_on_a_failed_check(monkeypatch, capsys):
    """--device cpu: the CUDA build prints as not run; a check made to fail
    prints [FAIL] and the run exits 1."""
    def broken():
        raise RuntimeError("no round trip")

    monkeypatch.setattr(verify_setup, "_video_io", broken)
    assert verify_setup.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] video IO round-trip — RuntimeError: no round trip" in out
    assert "[skip] nvcc build of the warp kernels — not run (--device cpu)" in out
    assert "[PASS] torch allocation probe (cpu)" in out and "1 check(s) FAILED." in out


@pytest.mark.parametrize("rcs,want", [((0, 0), 0), ((3,), 3), ((0, 4), 4)])
def test_generate_figures_propagates_a_childs_rc(monkeypatch, rcs, want):
    calls = []

    def call(cmd):
        calls.append(cmd)
        return rcs[len(calls) - 1]

    monkeypatch.setattr(subprocess, "call", call)
    assert generate_figures.main(["--results", "r.json", "--output-dir", "figs"]) == want
    assert len(calls) == len(rcs)
    for cmd, module in zip(calls, generate_figures.SCRIPTS):
        assert cmd[1:] == ["-m", module, "--results", "r.json", "--output-dir", "figs"]


def test_evaluate_quality_reads_jpeg_frames_as_the_reference(tmp_path, monkeypatch):
    """A JPEG-only directory (cv2.imwrite) through the port's CLI on the CPU
    against the reference's script on the same files."""
    rng = np.random.default_rng(6)
    dirs = {}
    for name in ("pred", "gt"):
        d = tmp_path / name
        d.mkdir()
        frames = (smooth_frames(rng, 2, 96, 128) * 255).astype(np.uint8)
        for i, f in enumerate(frames):
            cv2.imwrite(str(d / f"f_{i:04d}.jpg"), f)
        dirs[name] = d
    args = ["--pred-dir", str(dirs["pred"]), "--gt-dir", str(dirs["gt"])]
    evaluate_quality.main(args + ["--output", str(tmp_path / "port.json"), "--device", "cpu"])
    spec = importlib.util.spec_from_file_location("_ref_eval",
                                                  REPO_ROOT / "scripts" / "evaluate_quality.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr("sys.argv", ["evaluate_quality.py", *args, "--output",
                                     str(tmp_path / "ref.json")])
    ref.main()
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert got["frames"] == want["frames"] == 2 and got["lpips_mode"] == want["lpips_mode"]
    assert abs(got["psnr"] - want["psnr"]) <= 1e-9
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert abs(got["lpips"] / want["lpips"] - 1) <= 1e-5


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_evaluate_quality_decodes_jpeg_on_its_device(tmp_path, monkeypatch, device):
    """``--device`` reaches ``data/jpeg.py::decode`` for every JPEG frame
    (its block transforms run there), and the frames come back as the same
    numpy arrays: the real decode on the CPU, recorded around it."""
    from vfisr_tpu_torch.data import jpeg

    rng = np.random.default_rng(8)
    frames = (smooth_frames(rng, 2, 48, 64) * 255).astype(np.uint8)
    for name in ("pred", "gt"):
        (tmp_path / name).mkdir()
        for i, f in enumerate(frames):
            cv2.imwrite(str(tmp_path / name / f"f_{i:04d}.jpg"), f)
    want = [cv2.cvtColor(f, cv2.COLOR_BGR2RGB)
            for f in (cv2.imread(str(tmp_path / "gt" / f"f_{i:04d}.jpg")) for i in range(2))]
    seen, real = [], jpeg.decode

    def decode(data, device="cuda"):
        seen.append(str(device))
        return real(data, device="cpu")

    monkeypatch.setattr(jpeg, "decode", decode)
    got = evaluate_quality.load_dir(tmp_path / "gt", device)
    assert seen == [device] * 2
    assert all(isinstance(g, np.ndarray) and np.array_equal(g, w) for g, w in zip(got, want))
    # through the CLI: every frame of both directories on --device; the
    # metrics stay on the CPU here
    seen.clear()
    monkeypatch.setattr("vfisr_tpu_torch.evaluation.QualityEvaluator.__init__",
                        lambda self, dev: setattr(self, "_dev", dev) or None)
    monkeypatch.setattr("vfisr_tpu_torch.evaluation.QualityEvaluator.evaluate",
                        lambda self, p, g: type("R", (), dict(psnr=1.0, ssim=1.0, lpips=0.0))())
    monkeypatch.setattr("vfisr_tpu_torch.evaluation.QualityEvaluator.lpips_mode", "stub",
                        raising=False)
    evaluate_quality.main(["--pred-dir", str(tmp_path / "pred"), "--gt-dir", str(tmp_path / "gt"),
                           "--device", device])
    assert seen == [device] * 4
