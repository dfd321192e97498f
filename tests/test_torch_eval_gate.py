"""vfisr_tpu_torch/{eval_vfi_quality,eval_sr_quality,gate_checkpoint}.py, the
ports of the scripts of the same names.

The gate's four decisions run with ``heldout_psnr`` patched, as
tests/test_gate_checkpoint.py runs the reference's; one unpatched
``heldout_psnr`` and both eval CLIs run on the CPU with classical models
(2 samples at crop 64, one intra-op thread). The held-out frames they score
are the reference's ``synthetic_batch`` from the same seed: within 2 LSB
with >= 99% equal (tests/test_torch_train_data.py's tolerance).
"""

import json

import numpy as np
import pytest
import torch

from vfisr_tpu.train import data as jdata
from vfisr_tpu_torch import eval_sr_quality, eval_vfi_quality
from vfisr_tpu_torch import gate_checkpoint as gate


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_gate(monkeypatch, argv, scores):
    """main() with heldout_psnr stubbed to pop from scores; returns its calls
    and the record."""
    calls = []

    def fake_psnr(model_name, samples, crop, seed, weights_path=None, device="cuda"):
        calls.append((model_name, weights_path, device))
        return scores.pop(0)

    monkeypatch.setattr(gate, "heldout_psnr", fake_psnr)
    record = gate.main(argv + ["--device", "cpu"])
    return calls, record


def test_gate_skips_without_a_checkpoint(tmp_path, monkeypatch):
    rec = tmp_path / "rec.json"
    calls, record = _run_gate(monkeypatch, [
        "--candidate", "rife", "--incumbent", "rife_lite", "--weights", str(tmp_path / "no.npz"),
        "--demote-to", str(tmp_path / "aside.npz"), "--record", str(rec)], scores=[])
    assert calls == [] and "skip" in record["decision"]
    assert json.loads(rec.read_text()) == record


def test_gate_keeps_a_better_candidate(tmp_path, monkeypatch):
    w = tmp_path / "cand.npz"
    w.write_bytes(b"candidate")
    calls, record = _run_gate(monkeypatch, [
        "--candidate", "rife", "--incumbent", "rife_lite", "--weights", str(w),
        "--demote-to", str(tmp_path / "aside.npz")], scores=[29.8, 27.9])
    assert calls == [("rife", str(w), "cpu"), ("rife_lite", None, "cpu")]
    assert record["decision"].startswith("kept") and record["candidate_psnr_db"] == 29.8
    assert w.read_bytes() == b"candidate" and not (tmp_path / "aside.npz").exists()


def test_gate_demotes_a_worse_candidate(tmp_path, monkeypatch):
    w, aside = tmp_path / "cand.npz", tmp_path / "aside.npz"
    w.write_bytes(b"candidate")
    _, record = _run_gate(monkeypatch, [
        "--candidate", "rife", "--incumbent", "rife_lite", "--weights", str(w),
        "--demote-to", str(aside), "--margin", "0.5"], scores=[27.3, 27.9])
    assert not w.exists() and aside.read_bytes() == b"candidate"
    assert record["decision"].startswith("demoted")


def test_gate_demotion_restores_the_incumbent_file(tmp_path, monkeypatch):
    """Same-model gating: the incumbent is scored as the candidate's model
    with its file, and on demotion its copy takes the candidate's path."""
    w, snap, aside = tmp_path / "rife.npz", tmp_path / "rife_8k.npz", tmp_path / "aside.npz"
    w.write_bytes(b"resumed-12k")
    snap.write_bytes(b"snapshot-8k")
    rec = tmp_path / "out" / "rec.json"
    calls, record = _run_gate(monkeypatch, [
        "--candidate", "rife", "--incumbent", "rife", "--incumbent-weights", str(snap),
        "--weights", str(w), "--demote-to", str(aside), "--record", str(rec)],
        scores=[25.0, 29.0])
    assert calls == [("rife", str(w), "cpu"), ("rife", str(snap), "cpu")]
    assert aside.read_bytes() == b"resumed-12k" and w.read_bytes() == b"snapshot-8k"
    assert snap.read_bytes() == b"snapshot-8k"
    assert not (tmp_path / "rife.npz.gate_restore").exists()
    assert "restored incumbent" in json.loads(rec.read_text())["decision"]


def test_heldout_psnr_on_the_cpu():
    p = gate.heldout_psnr("lanczos", 2, 64, 123, device="cpu")
    assert np.isfinite(p) and 5.0 < p < 60.0
    with pytest.raises(SystemExit, match="takes no weights path"):
        gate.heldout_psnr("lanczos", 1, 64, 123, weights_path="any.npz", device="cpu")


def _scored_frames(monkeypatch):
    """Patches the PSNR that the CLIs import when they run, to record the
    frames they score."""
    from vfisr_tpu_torch.evaluation import metrics

    seen, real = [], metrics.compute_psnr_simple

    def recording(pred, gt, device="cuda"):
        seen.append(gt.copy())
        return real(pred, gt, device)

    monkeypatch.setattr(metrics, "compute_psnr_simple", recording)
    return seen


def _reference_frames(seed: int, samples: int, crop: int) -> np.ndarray:
    return (jdata.synthetic_batch(np.random.default_rng(seed), samples, crop)["gt"]
            * 255).astype(np.uint8)


def _close_to(frames: list, ref: np.ndarray) -> None:
    d = np.abs(np.stack(frames).astype(int) - ref.astype(int))
    assert d.max() <= 2 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())


def test_eval_vfi_quality_on_the_cpu(monkeypatch, capsys):
    seen = _scored_frames(monkeypatch)
    rows = eval_vfi_quality.main(["--models", "lanczos,optical_flow", "--samples", "2",
                                  "--crop", "64", "--device", "cpu"])
    assert list(rows) == ["lanczos", "optical_flow"]
    assert all(np.isfinite(v).all() for v in rows.values())
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == ["model", "PSNR", "SSIM"] and "optical_flow" in out
    _close_to(seen[:2], _reference_frames(123, 2, 64))


@pytest.mark.parametrize("scene", ["smooth", "detail"])
def test_eval_sr_quality_on_the_cpu(scene, monkeypatch, capsys):
    seen = _scored_frames(monkeypatch)
    rows = eval_sr_quality.main(["--models", "lanczos,bicubic_x4", "--samples", "2",
                                 "--crop", "64", "--device", "cpu", "--scene", scene])
    assert list(rows) == ["lanczos", "bicubic_x4"]
    assert all(np.isfinite(v).all() for v in rows.values())
    assert capsys.readouterr().out.startswith(f"scene={scene}\n")
    if scene == "smooth":
        _close_to(seen[:2], _reference_frames(321, 2, 64))
    else:  # the port's own draws: crisp structure, one frame per sample
        assert len(seen) == 4 and all(f.shape == (64, 64, 3) for f in seen)
