"""vfisr_tpu_torch/data/jpeg.py held against OpenCV's JPEG codec (libjpeg-
turbo), which the JAX package's web_app.py and lpips_ordering_study.py
call (``cv2.imencode('.jpg', ..., [IMWRITE_JPEG_QUALITY, q])``,
``cv2.imdecode``).

Frames: smooth (pre-blurred) content at odd sizes, so both libjpeg edge
paddings and the dummy blocks are taken, and a gameplay frame with hard
edges. The port reproduces libjpeg-turbo's integer arithmetic, so the
tolerance is zero: the port's file is OpenCV's byte for byte, cv2 decodes
it to cv2's own round trip, and the port decodes OpenCV's files (4:2:0 and
4:4:4) to exactly ``cv2.imdecode``'s pixels. cv2 is imported by this test
only; the port never imports it.
"""

import cv2
import numpy as np
import pytest
import torch

from _torch_port import game_frames, one_torch_thread, smooth_frames
from vfisr_tpu_torch.data import jpeg

SIZES = [(271, 483), (64, 96), (17, 9), (5, 3)]


def _frame(h, w, seed=0):
    return (smooth_frames(np.random.default_rng(seed), 1, h, w, cell=6)[0] * 255).round() \
        .astype(np.uint8)


def _cv2_encode(rgb, q, *flags):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, q, *flags])
    assert ok
    return buf.tobytes()


def _cv2_decode(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("q", [92, 28])
def test_encode_equals_opencv(hw, q):
    f = _frame(*hw)
    ref = _cv2_encode(f, q)
    got = jpeg.encode(f, q, device="cpu")
    assert got == ref  # tolerance 0: the same bytes
    assert np.array_equal(_cv2_decode(got), _cv2_decode(ref))


@pytest.mark.parametrize("q", [92, 28])
def test_gameplay_frame_round_trip(q):
    f = game_frames(1, 72, 120)[0]
    got = jpeg.encode(torch.from_numpy(f), q, device="cpu")
    assert got == _cv2_encode(f, q)
    dec = jpeg.decode(got, device="cpu")
    assert dec.dtype == torch.uint8 and dec.shape == (72, 120, 3)
    assert np.array_equal(dec.numpy(), _cv2_decode(got))


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("q,sampling", [(92, 0x221111), (28, 0x221111), (92, 0x111111)])
def test_decode_equals_opencv(hw, q, sampling):
    data = _cv2_encode(_frame(*hw, seed=1), q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling)
    assert np.array_equal(jpeg.decode(data, device="cpu").numpy(), _cv2_decode(data))


@pytest.mark.parametrize("flags,match", [
    ((cv2.IMWRITE_JPEG_PROGRESSIVE, 1), "progressive"),
    ((cv2.IMWRITE_JPEG_RST_INTERVAL, 4), "restart markers"),
    ((cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111), "sampling layout"),
])
def test_unsupported_files_raise_by_name(flags, match):
    data = _cv2_encode(_frame(40, 56), 80, *flags)
    with pytest.raises(jpeg.UnsupportedJPEG, match=match):
        jpeg.decode(data, device="cpu")


def test_gray_and_bad_input_raise():
    ok, gray = cv2.imencode(".jpg", _frame(16, 16)[..., 0])
    with pytest.raises(jpeg.UnsupportedJPEG, match="sampling layout"):
        jpeg.decode(gray.tobytes(), device="cpu")
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"\x89PNG....", device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        jpeg.encode(np.zeros((8, 8, 3), np.float32), 90, device="cpu")


def test_quant_tables_and_huffman_tables_are_opencvs():
    """The DQT and DHT segments of OpenCV's file are the module's tables."""
    for q in (1, 28, 50, 92, 100):
        info = jpeg.parse(_cv2_encode(_frame(16, 16), q))
        luma, chroma = jpeg.quant_tables(q)
        assert np.array_equal(info["q"][0], luma) and np.array_equal(info["q"][1], chroma)
        assert {k: (bytes(b), bytes(v)) for k, (b, v) in info["huff"].items()} == jpeg.STD_HUFFMAN
