"""vfisr_tpu_torch/data/draw.py held against cv2, vfisr_tpu_torch/train/data.py
against vfisr_tpu/train/data.py, and the trainer's --data and
--data-source host.

The JAX side of this file is numpy and cv2 (no JAX program is compiled);
the port's torch ops run on one intra-op thread.

Tolerances:
- ``warp_affine``: uint8 equal to cv2.warpAffine on every pixel; float32
  within 1e-6. ``fill_circle``, ``fill_rectangle``, the HUD label and its
  box: equal. ``rotation_matrix_2d``: within 1e-12.
- ``synthetic_batch``: ``t`` equal; img0/img1/gt within 2 LSB (x255) with
  >= 99% of values equal (cv2's fixed-point INTER_CUBIC textures against
  ``core/resize.py``'s f32 taps: at most 1 LSB on >= 99.95% of a texture);
  the generator's state equal afterwards, so the draws are the same.
- ``synthetic_sr_batch``: hr as ``synthetic_batch``; lr within 1e-6 of
  cv2's INTER_AREA of the port's own hr (area decimation at an integer
  factor), and within 2/255 of the reference's lr.
- ``augment_vfi_batch``: equal, generator state equal.
- ``TripletCropDataset``: the same entries; inputs and ``t`` equal; the GT,
  area-resized 4/3 from 144x256 to 108x192, within 2 LSB (cv2's INTER_AREA
  against f32 taps); the ``random.Random`` state equal after 5 batches, so
  the crops were drawn at the same positions.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from vfisr_tpu.train import data as jdata
from vfisr_tpu_torch.data import draw
from vfisr_tpu_torch.train import __main__ as tcli
from vfisr_tpu_torch.train import data as tdata


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU ops (the suite's other
    workers keep the cores busy: OpenMP barriers would wait on them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canvas(rng, c):
    base = rng.integers(0, 256, (2 * c // 8, 2 * c // 8, 3), np.uint8)
    return cv2.resize(base, (2 * c, 2 * c), interpolation=cv2.INTER_CUBIC)


def _matrices(rng, c):
    """Rotations with zooms and subpixel shifts (the scenes' background),
    a sheared far shift, and subpixel translations (the foreground)."""
    out = []
    for _ in range(3):
        bx, by = rng.uniform(-12, 12, 2) + c // 2
        m = cv2.getRotationMatrix2D((c / 2 + bx, c / 2 + by), float(rng.uniform(-2, 2)),
                                    1 + float(rng.uniform(-0.03, 0.03)))
        m[:, 2] -= (bx, by)
        out.append(m)
    dx, dy = rng.uniform(-40, 40, 2)
    out.append(np.float64([[1.02, 0.05, dx], [-0.05, 0.98, dy]]))
    fx, fy = rng.uniform(-20, 20, 2)
    out.append(np.float32([[1, 0, fx], [0, 1, fy]]))
    return out


@pytest.mark.parametrize("border", ["reflect", "constant"])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_warp_affine_matches_cv2(kind, border):
    rng = np.random.default_rng(7)
    cv_border = cv2.BORDER_REFLECT if border == "reflect" else cv2.BORDER_CONSTANT
    worst = 0.0
    for c in (64, 96, 72, 50):  # 72 and 50: columns past cv2's vector blocks
        canvas = _canvas(rng, c)
        mask = np.zeros((c, c), np.uint8)
        cv2.circle(mask, (c // 2, c // 2), int(rng.integers(c // 8, c // 3)), 1, -1)
        src = canvas if kind == "uint8" else mask.astype(np.float32)
        for m in _matrices(rng, c):
            ref = cv2.warpAffine(src, m, (c, c), flags=cv2.INTER_LINEAR, borderMode=cv_border)
            got = draw.warp_affine(src, m, (c, c), border)
            assert got.dtype == ref.dtype and got.shape == ref.shape
            worst = max(worst, float(np.abs(got.astype(np.float64) - ref).max()))
    assert worst <= (0.0 if kind == "uint8" else 1e-6), worst


def test_fill_circle_matches_cv2():
    for c in (64, 96, 192, 256, 384):
        for r in range(c // 8, c // 3):
            ref = cv2.circle(np.zeros((c, c), np.uint8), (c // 2, c // 2), r, 1, -1)
            got = draw.fill_circle(np.zeros((c, c), np.uint8), (c // 2, c // 2), r, 1)
            assert np.array_equal(got, ref), (c, r)


def test_fill_rectangle_and_hud_label_match_cv2():
    rng = np.random.default_rng(3)
    for _ in range(8):
        img = rng.integers(0, 256, (96, 128, 3), np.uint8)
        pts = [tuple(int(v) for v in rng.integers(-10, 140, 2)) for _ in range(2)]
        ref = cv2.rectangle(img.copy(), pts[0], pts[1], (255, 255, 255), -1)
        assert np.array_equal(draw.fill_rectangle(img.copy(), pts[0], pts[1], (255, 255, 255)), ref)
    for x0, y0 in ((0, 0), (3, 11), (60, 40), (67, 71)):
        img = rng.integers(0, 256, (96, 128, 3), np.uint8)
        ref = img.copy()
        cv2.rectangle(ref, (x0, y0), (x0 + 56, y0 + 20), (255, 255, 255), -1)
        cv2.putText(ref, "HP", (x0 + 4, y0 + 16), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1)
        assert np.array_equal(draw.put_hud_label(img.copy(), x0, y0), ref), (x0, y0)


def test_rotation_matrix_matches_cv2():
    rng = np.random.default_rng(4)
    for _ in range(20):
        center = tuple(float(v) for v in rng.uniform(-50, 400, 2))
        angle, scale = float(rng.uniform(-180, 180)), float(rng.uniform(0.5, 2.0))
        ref = cv2.getRotationMatrix2D(center, angle, scale)
        assert np.abs(draw.rotation_matrix_2d(center, angle, scale) - ref).max() <= 1e-12


def _close_frames(got: dict, ref: dict, keys=("img0", "img1", "gt")) -> None:
    for k in keys:
        d = np.abs(np.rint(got[k] * 255).astype(int) - np.rint(ref[k] * 255).astype(int))
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape
        assert d.max() <= 2 and (d == 0).mean() >= 0.99, (k, d.max(), (d == 0).mean())


@pytest.mark.parametrize("crop", [64, 96])
def test_synthetic_batch_matches_reference(crop):
    rj, rt = np.random.default_rng(11 + crop), np.random.default_rng(11 + crop)
    ref = jdata.synthetic_batch(rj, 3, crop)
    got = tdata.synthetic_batch(rt, 3, crop)
    assert np.array_equal(got["t"], ref["t"]) and got["t"].dtype == np.float32
    _close_frames(got, ref)
    assert rt.bit_generator.state == rj.bit_generator.state


def test_synthetic_sr_batch_matches_reference():
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    ref = jdata.synthetic_sr_batch(rj, 4, 66, scale=2)
    got = tdata.synthetic_sr_batch(rt, 4, 66, scale=2)
    assert rt.bit_generator.state == rj.bit_generator.state
    assert got["hr"].shape == ref["hr"].shape == (4, 66, 66, 3)
    _close_frames({"hr": got["hr"]}, {"hr": ref["hr"]}, keys=("hr",))
    own = np.stack([cv2.resize(h, (33, 33), interpolation=cv2.INTER_AREA) for h in got["hr"]])
    assert got["lr"].dtype == np.float32 and np.abs(got["lr"] - own).max() <= 1e-6
    assert np.abs(got["lr"] - ref["lr"]).max() <= 2 / 255


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (2, 12, 20, 3)])
def test_augment_vfi_batch_is_exact(shape):
    """Square crops draw the transpose's number, other crops do not: the
    generators stay in step either way."""
    src = np.random.default_rng(0)
    batch = {k: src.random(shape, dtype=np.float32) for k in ("img0", "img1", "gt")}
    batch["t"] = src.random(shape[0], dtype=np.float32)
    rj, rt = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(24):
        ref, got = jdata.augment_vfi_batch(rj, batch), tdata.augment_vfi_batch(rt, batch)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    assert rt.bit_generator.state == rj.bit_generator.state


def test_synthetic_pool_iter_matches_reference():
    rj, rt = np.random.default_rng(21), np.random.default_rng(21)
    for ref, got in zip(jdata.synthetic_pool_iter(rj, 2, 64, 10),
                        tdata.synthetic_pool_iter(rt, 2, 64, 10), strict=True):
        assert np.array_equal(got["t"], ref["t"])
        _close_frames(got, ref)
    assert rt.bit_generator.state == rj.bit_generator.state


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """Two clips of 3 input frames (108x192) and 9 GT frames (144x256), each
    with 2 triplets of 3 intermediates, written by cv2."""
    root = tmp_path_factory.mktemp("torch_triplets")
    rng = np.random.default_rng(0)
    for clip in ("b_clip", "a_clip"):  # sorted: a_clip's entries come first
        inp, gt = root / clip / "input_1080p30" / "frames", root / clip / "ground_truth" / "frames"
        inp.mkdir(parents=True)
        gt.mkdir(parents=True)
        for d, hw, n in ((inp, (108, 192), 3), (gt, (144, 256), 9)):
            for i in range(n):
                noise = rng.integers(0, 256, (*hw, 3), np.uint8)
                cv2.imwrite(str(d / f"frame_{i:05d}.png"), cv2.GaussianBlur(noise, (0, 0), 2))
        triplets = [{"input_frame_0": f"frame_{i:05d}.png",
                     "input_frame_1": f"frame_{i + 1:05d}.png",
                     "gt_intermediate": [f"frame_{k:05d}.png" for k in range(4 * i + 1, 4 * i + 4)],
                     "temporal_positions": [0.25, 0.5, 0.75]} for i in range(2)]
        (root / clip / "triplets.json").write_text(json.dumps(triplets))
    return root


def test_triplet_dataset_matches_reference(processed):
    ref = jdata.TripletCropDataset(processed, crop=64, seed=3)
    got = tdata.TripletCropDataset(processed, crop=64, seed=3, device="cpu")
    assert len(got) == len(ref) == 12 and got.entries == ref.entries
    for rb, gb in zip(ref.batches(4, 5), got.batches(4, 5), strict=True):
        gb = {k: v.numpy() for k, v in gb.items()}
        for k in ("img0", "img1", "t"):
            assert gb[k].dtype == np.float32 and np.array_equal(gb[k], rb[k]), k
        d = np.abs(np.rint(gb["gt"] * 255) - np.rint(rb["gt"] * 255))
        assert gb["gt"].shape == rb["gt"].shape == (4, 64, 64, 3) and d.max() <= 2
    assert got.rng.getstate() == ref.rng.getstate()


def test_cli_trains_rife_on_triplets(processed, tmp_path):
    out = tmp_path / "rife_data.npz"
    res = tcli.run(["--model", "rife", "--data", str(processed), "--steps", "2", "--batch", "2",
                    "--crop", "64", "--device", "cpu", "--out", str(out)])
    assert np.isfinite(res["loss"]) and out.is_file()
    assert len(res["step_s"]) == len(res["wait_s"]) == 2


@pytest.mark.parametrize("model", ["rife_lite", "span"])
def test_cli_trains_on_host_scenes(model, tmp_path, capsys):
    out = tmp_path / f"{model}.npz"
    loss = tcli.main(["--model", model, "--data-source", "host", "--steps", "2", "--batch", "2",
                      "--crop", "64", "--device", "cpu", "--out", str(out)])
    assert np.isfinite(loss) and out.is_file()
    assert "made on the host" in capsys.readouterr().out


@pytest.mark.parametrize("model,reason", [
    ("span", "--model span trains on LR/HR pairs"),
    ("span_x4", "--model span_x4 trains on LR/HR pairs"),
    ("safa", "safa joint training needs GT at 2x")])
def test_cli_refuses_triplets_for_sr_and_joint_models(model, reason):
    with pytest.raises(SystemExit, match=reason):
        tcli.main(["--model", model, "--data", "data/processed", "--device", "cpu"])


def test_cli_fails_on_a_missing_frame(processed, tmp_path, capsys):
    """An error in the batch producer fails the run: no "Done" line."""
    clip = tmp_path / "proc" / "clip"
    clip.mkdir(parents=True)
    for sub in ("input_1080p30", "ground_truth"):
        (clip / sub).symlink_to(processed / "a_clip" / sub)
    (clip / "triplets.json").write_text(json.dumps([{
        "input_frame_0": "frame_00000.png", "input_frame_1": "frame_00001.png",
        "gt_intermediate": ["frame_00042.png"], "temporal_positions": [0.5]}]))
    with pytest.raises(FileNotFoundError, match="frame_00042.png"):
        tcli.main(["--model", "rife_lite", "--data", str(tmp_path / "proc"), "--steps", "2",
                   "--batch", "1", "--crop", "64", "--device", "cpu",
                   "--out", str(tmp_path / "r.npz")])
    assert "Done" not in capsys.readouterr().out and not (tmp_path / "r.npz").exists()


def test_prefetch_stops_its_producer():
    """A consumer that stops early ends the producer thread."""
    import threading

    made = []

    def batches():
        for i in range(100):
            made.append(i)
            yield {"i": i}

    it = tcli.prefetch(batches())
    assert next(it) == {"i": 0}
    it.close()
    for t in threading.enumerate():
        if t.name == "batch-producer":
            t.join(timeout=5)
            assert not t.is_alive()
    assert len(made) < 100
