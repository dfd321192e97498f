"""The blind-study servers of vfisr_tpu_torch/gui/ (web_app.py,
video_blind_study.py, blind_study_app.py) held against the reference's
gui/web_app.py and gui/video_blind_study.py.

- The image-pair study: the same seed gives the reference's pairs, sides,
  scores and ``results()``. Renders of control, degraded and lanczos_blend
  are held to the reference's cv2 path (PNG read, INTER_AREA to 72 rows,
  the blend, cv2.imencode at quality 92): on these frames the JPEG files
  are equal byte for byte (tolerance 0; the area taps and the JPEG
  arithmetic agree with cv2's here). The HTTP flow runs against a live
  server on 127.0.0.1.
- The video study: Range requests (206, Content-Range, the bytes), the
  quiz under one seed on both sides, the results' suffix stripping,
  ``new_interval``'s cut of Y4M full videos, the 409 guard.
- One test per reference fault not copied: a missing ground-truth midpoint
  answers 404 (the reference shows a blend scored as the ground truth); a
  re-benchmark that exits non-zero is reported failed (the reference says
  "done"); ``new_interval`` answers in one form.
- The Tk client: its JPEG -> PPM conversion, its keys and the state they
  drive (no display here: the window itself never runs).
"""

import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from _torch_port import game_frames, one_torch_thread
from vfisr_tpu_torch.data import jpeg
from vfisr_tpu_torch.data.png import write_png
from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter
from vfisr_tpu_torch.gui import blind_study_app as tapp
from vfisr_tpu_torch.gui import video_blind_study as tvbs
from vfisr_tpu_torch.gui import web_app as tweb

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "gui"))  # the reference's new_interval imports benchmark_proper
from gui import video_blind_study as jvbs  # noqa: E402
from gui import web_app as jweb  # noqa: E402

CLIP = "g"
CHEAP = ["control", "degraded", "lanczos_blend"]


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """A processed clip: 6 triplets over 120x200 PNG frames, 72-row renders
    (an area downscale by 5/3)."""
    root = tmp_path_factory.mktemp("processed")
    frames = game_frames(13, 120, 200, step=4.0)
    d_in = root / CLIP / "input_1080p30" / "frames"
    d_gt = root / CLIP / "ground_truth" / "frames"
    d_in.mkdir(parents=True)
    d_gt.mkdir(parents=True)
    triplets = []
    for i in range(6):
        write_png(d_in / f"f_{i:04d}.png", frames[2 * i])
        write_png(d_gt / f"g_{i:04d}.png", frames[2 * i + 1])
        triplets.append({"triplet_id": i, "input_frame_0": f"f_{i:04d}.png",
                         "input_frame_1": f"f_{i + 1:04d}.png",
                         "gt_intermediate": [f"g_{i:04d}.png"] if i < 5 else []})
    write_png(d_in / "f_0006.png", frames[12])
    (root / CLIP / "triplets.json").write_text(json.dumps(triplets))
    return root


def _states(processed, tmp_path, methods=None, seed=7):
    kw = dict(methods=methods or list(tweb.DEFAULT_METHODS), num_pairs=4, proc_height=72,
              seed=seed)
    return (tweb.StudyState(processed, tmp_path / "t", device="cpu", **kw),
            jweb.StudyState(processed, tmp_path / "j", **kw))


def test_seed_gives_the_reference_study(processed, tmp_path):
    t, j = _states(processed, tmp_path)
    assert t.clips() == j.clips() == [CLIP]
    t.set_clip(CLIP)
    j.set_clip(CLIP)
    assert t.pair_list() == j.pair_list() and len(t.pairs) == 4
    assert [p["triplet"] for p in t.pairs] == [p["triplet"] for p in j.pairs]
    assert t.shuffle() == j.shuffle()
    for k, choice in enumerate(("left", "same", "right", "left")):
        idx = t.pair_list()[k]["idx"]
        assert t.guess(idx, choice) == j.guess(idx, choice)
    assert t.guess(99, "left") == j.guess(99, "left")
    assert t.results() == j.results()
    assert t.save()["sessions"] == 1 and t.save()["sessions"] == 2


def _decoded(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB).astype(int)


def test_cheap_renders_match_the_reference(processed, tmp_path):
    t, j = _states(processed, tmp_path, methods=CHEAP, seed=3)
    for s in (t, j):
        s.set_clip(CLIP)
        s.pairs = [{"idx": i, "triplet": s.pairs[0]["triplet"], "model_a": a, "model_b": b}
                   for i, (a, b) in enumerate([("degraded", "lanczos_blend")])]
    for pos in ("left", "right", "gt"):
        got, ref = t.render(0, pos), j.render(0, pos)
        assert _decoded(got).shape == (72, 120, 3) and got == ref, pos
    key = f"{CLIP}_{t.pairs[0]['triplet']['triplet_id']}_control_72.jpg"
    assert (t.cache_dir / key).is_file() and (j.cache_dir / key).is_file()
    assert t.render(0, "gt") == (t.cache_dir / key).read_bytes()  # from the cache


class _Server:
    def __init__(self, handler):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()

    def call(self, path, body=None, headers=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data, headers=headers or {},
                                     method="GET" if body is None else "POST")
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, dict(r.headers), r.read()
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), e.read()


def test_web_app_http_flow(processed, tmp_path):
    state = tweb.StudyState(processed, tmp_path / "s", methods=CHEAP, num_pairs=3,
                            proc_height=72, seed=1, device="cpu")
    with _Server(tweb.make_handler(state)) as srv:
        code, hdr, page = srv.call("/")
        assert code == 200 and b"VFI Blind Study" in page
        assert json.loads(srv.call("/api/clips")[2]) == {"clips": [CLIP]}
        assert json.loads(srv.call("/api/clip", {"clip": CLIP})[2]) == {"status": "ok", "pairs": 3}
        pairs = json.loads(srv.call("/api/pairs")[2])["pairs"]
        for p in pairs:
            for pos in ("left", "right", "gt"):
                code, hdr, data = srv.call(f"/api/frame/{p['idx']}/{pos}?123")
                assert code == 200 and hdr["Content-Type"] == "image/jpeg"
                assert jpeg.decode(data, "cpu").shape == (72, 120, 3)
        pairs = json.loads(srv.call("/api/shuffle", {})[2])["pairs"]
        r = json.loads(srv.call("/api/guess", {"pair_idx": pairs[0]["idx"], "choice": "left"})[2])
        assert r["total"] == 1 and r["score"] in (0, 1)
        assert srv.call("/api/guess", {"pair_idx": 42, "choice": "left"})[0] == 400
        res = json.loads(srv.call("/api/results")[2])
        assert res["total"] == 1 and res["clip"] == CLIP
        saved = json.loads(srv.call("/api/save", {})[2])
        assert Path(saved["path"]).is_file() and saved["sessions"] == 1
        assert srv.call("/api/frame/9/left")[0] == 404
        assert srv.call("/api/nothing")[0] == 404


def test_missing_ground_truth_is_404_not_a_blend(processed, tmp_path):
    """Reference fault (gui/web_app.py:288-289): with the GT midpoint gone,
    it serves a linear blend as the 'control' stimulus, which its scoring
    ranks 100. The port answers 404 naming the missing file."""
    gone = processed / CLIP / "ground_truth" / "frames" / "g_0002.png"
    t, j = _states(processed, tmp_path, methods=CHEAP, seed=3)
    saved = gone.read_bytes()
    gone.unlink()
    try:
        for s in (t, j):
            s.set_clip(CLIP)
            s.pairs = [{"idx": 0, "model_a": "degraded", "model_b": "lanczos_blend",
                        "triplet": {"triplet_id": 2, "input_frame_0": "f_0002.png",
                                    "input_frame_1": "f_0003.png",
                                    "gt_intermediate": ["g_0002.png"]}}]
        assert j.render(0, "gt") == j.render(0, "right")  # the reference's blend as 'control'
        with _Server(tweb.make_handler(t)) as srv:
            code, _, body = srv.call("/api/frame/0/gt")
        assert code == 404 and str(gone) in json.loads(body)["error"]
        assert not list(t.cache_dir.glob("*control*"))
    finally:
        gone.write_bytes(saved)


@pytest.fixture()
def study_videos(tmp_path):
    """A benchmark dir with two Y4M method videos and its metadata, a full
    dir of 3 s Y4M videos, and an experiment_results.json."""
    bench, full = tmp_path / "bench", tmp_path / "full"
    frames = game_frames(30, 48, 64, step=1.0)
    videos = {}
    for name, n, d in (("control", 6, bench), ("lanczos", 6, bench), ("control", 30, full),
                       ("lanczos", 30, full)):
        p = d / f"{name}.y4m"
        w = VideoWriter(str(p), 64, 48, 10)
        for f in frames[:n]:
            w.write(f)
        w.close()
        if d == bench:
            videos[name] = str(p)
    (bench / "clips_metadata.json").write_text(json.dumps(
        {"clips": {CLIP: {"videos": videos, "metrics": {}}}}))
    results = tmp_path / "experiment_results.json"
    results.write_text(json.dumps({"experiments": [
        {"name": "rife_default_1440p@90", "vfi_psnr": 30.0},
        {"name": "lanczos_blend_4K@120"}, {"name": "degraded"}]}))
    return bench, full, results


def _video_states(study_videos, tmp_path, seed=5):
    bench, full, results = study_videos
    kw = dict(full_dir=str(full), duration=0.5, out_dir=str(tmp_path / "out"))
    t = tvbs.AppState(str(bench), str(results), device="cpu", **kw)
    j = jvbs.AppState(str(bench), str(results), **kw)
    t.rng, j.rng = random.Random(seed), random.Random(seed)
    return t, j


def test_video_study_http_range_quiz_and_results(study_videos, tmp_path):
    t, j = _video_states(study_videos, tmp_path)
    assert t.experiment_results() == j.experiment_results()
    assert [e["base_name"] for e in t.experiment_results()["experiments"]] == [
        "rife_default", "lanczos_blend", "degraded"]
    assert t.models() == j.models() == ["control", "lanczos"]
    for _ in range(3):
        tok_t, tok_j = t.quiz_start(), j.quiz_start()
        assert tok_t == tok_j and t.quiz[tok_t] == j.quiz[tok_j]
        assert t.quiz_guess(tok_t, "lanczos") == j.quiz_guess(tok_j, "lanczos")
    assert t.quiz_guess("nope", "x") == j.quiz_guess("nope", "x")
    video = Path(study_videos[0] / "control.y4m").read_bytes()
    with _Server(tvbs.make_handler(t)) as srv:
        code, hdr, body = srv.call("/api/video/control", headers={"Range": "bytes=100-1099"})
        assert code == 206 and hdr["Content-Range"] == f"bytes 100-1099/{len(video)}"
        assert body == video[100:1100] and hdr["Content-Type"] == "video/x-yuv4mpeg"
        code, hdr, body = srv.call("/api/video/control")
        assert code == 200 and body == video and hdr["Accept-Ranges"] == "bytes"
        assert srv.call("/api/video/missing")[0] == 404
        tok = json.loads(srv.call("/api/quiz/start", {})[2])["token"]
        code, _, body = srv.call(f"/api/quiz/video?t={tok}", headers={"Range": "bytes=0-9"})
        assert code == 206 and body == b"YUV4MPEG2 "
        r = json.loads(srv.call("/api/quiz/guess", {"token": tok, "guess": "control"})[2])
        assert r["total"] == 4
        assert Path(json.loads(srv.call("/api/quiz/save", {})[2])["path"]).is_file()
        assert json.loads(srv.call("/api/available-clips")[2]) == {"clips": [CLIP], "active": None}
        assert json.loads(srv.call("/api/switch-clip", {"clip": CLIP})[2]) == {"active": CLIP}
        assert srv.call("/")[0] == 200


def test_new_interval_cuts_the_full_videos(study_videos, tmp_path):
    t, _ = _video_states(study_videos, tmp_path)
    body, code = t.new_interval()
    assert code == 200 and body["status"] == "done" and 1 <= body["start_time"] <= 1.5
    meta = t.metadata()["clips"]["full"]["videos"]
    assert set(meta) == {"control", "lanczos"}
    start = int(round(body["start_time"] * 10))
    with VideoReader(str(study_videos[1] / "control.y4m")) as src, \
            VideoReader(meta["control"]) as cut:
        frames = [src.read_i420() for _ in range(30)]
        assert cut.frame_count == 5
        got = [cut.read_i420() for _ in range(5)]
    # the cut starts at the rounded start frame of the unrounded start
    assert any(all(np.array_equal(g, frames[s + i]) for i, g in enumerate(got))
               for s in (start - 1, start, start + 1))


def test_new_interval_answers_in_one_form(study_videos, tmp_path, monkeypatch):
    """Reference fault (gui/video_blind_study.py:313-317): new_interval
    returns a bare dict on two branches and a (dict, 409) tuple on the
    third. The port returns (body, status) on every branch."""
    t, j = _video_states(study_videos, tmp_path)
    t.full_dir = j.full_dir = tmp_path / "none"
    monkeypatch.setattr(tvbs.AppState, "start_reprocess", lambda self, args: True)
    monkeypatch.setattr(jvbs.AppState, "start_reprocess", lambda self, args: True)
    assert j.new_interval() == {"status": "fallback"}
    assert t.new_interval() == ({"status": "fallback"}, 200)
    monkeypatch.setattr(tvbs.AppState, "start_reprocess", lambda self, args: False)
    monkeypatch.setattr(jvbs.AppState, "start_reprocess", lambda self, args: False)
    assert j.new_interval() == ({"error": "Already processing"}, 409)
    assert t.new_interval() == ({"error": "Already processing"}, 409)
    with _Server(tvbs.make_handler(t)) as srv:
        code, _, body = srv.call("/api/new-interval", {})
        assert code == 409 and json.loads(body) == {"error": "Already processing"}


class _FakeProc:
    def __init__(self, lines, code):
        self.stdout, self.code = iter(lines), code

    def wait(self):
        return self.code

    @property
    def returncode(self):
        return self.code


def _wait_idle(state):
    for _ in range(600):
        if not state.processing["active"]:
            return state.processing
        time.sleep(0.1)
    raise AssertionError("the re-benchmark did not end")


def test_reprocess_failure_is_reported_failed(study_videos, tmp_path, monkeypatch):
    """Reference fault (gui/video_blind_study.py:325-341): a child that
    exits non-zero is reported "done (exit N)" at progress 100. The port
    reports it failed, with the exit code and the child's last line."""
    t, j = _video_states(study_videos, tmp_path)
    lines = ["Benchmarking 40%\n", "error: the interval is gone\n"]
    cmds = []

    def fake(cmd, **kw):
        cmds.append(cmd)
        return _FakeProc(list(lines), 3)

    monkeypatch.setattr(jvbs.subprocess, "Popen", fake)
    assert j.start_reprocess([])
    assert _wait_idle(j) == {"active": False, "progress": 100, "message": "done (exit 3)"}
    monkeypatch.setattr(tvbs.subprocess, "Popen", fake)
    assert t.start_reprocess(["--clip", CLIP])
    st = _wait_idle(t)
    assert st["failed"] and st["exit_code"] == 3 and st["progress"] == 40
    assert st["message"] == "failed (exit 3): error: the interval is gone"
    assert cmds[-1][1:] == ["-m", "vfisr_tpu_torch.gui.benchmark_proper", "--clip", CLIP,
                            "--device", "cpu"]


def test_reprocess_runs_the_ports_module_and_guards(study_videos, tmp_path):
    """The real child: benchmark_proper with no --clip exits 2 (argparse);
    while it runs, a second start is refused (409 over HTTP)."""
    t, _ = _video_states(study_videos, tmp_path)
    with _Server(tvbs.make_handler(t)) as srv:
        assert json.loads(srv.call("/api/reprocess", {"args": []})[2]) == {"started": True}
        assert srv.call("/api/reprocess", {"args": []})[0] == 409
        st = _wait_idle(t)
        status = json.loads(srv.call("/api/processing-status")[2])
    assert st["failed"] and st["exit_code"] == 2 and "--clip" in st["message"]
    assert status == st


def test_tk_client_ppm_and_keys(processed, tmp_path):
    f = game_frames(1, 90, 160)[0]
    data = jpeg.encode(f, 92, device="cpu")
    ppm = tapp.jpeg_to_ppm(data, max_h=45)
    header, pixels = ppm[:ppm.index(b"255\n") + 4], ppm[ppm.index(b"255\n") + 4:]
    assert header == b"P6\n80 45\n255\n" and len(pixels) == 80 * 45 * 3
    from vfisr_tpu_torch.core.resize import resize

    want = resize(jpeg.decode(data, "cpu"), (45, 80), "cubic").numpy()
    assert np.array_equal(np.frombuffer(pixels, np.uint8).reshape(45, 80, 3), want)

    state = tweb.StudyState(processed, tmp_path / "tk", methods=CHEAP, num_pairs=3,
                            proc_height=72, seed=2, device="cpu")
    state.set_clip(CLIP)
    ctl = tapp.StudyController(state)
    assert set(tapp.KEYS.values()) == {"next_pair", "start_quiz", "left", "same", "right", "save"}
    assert [p for p, _ in ctl.views()] == ["left", "gt", "right"]
    assert ctl.act(tapp.KEYS["s"]).startswith("LEARNING")  # no guess while learning
    ctl.act(tapp.KEYS["<space>"])
    assert ctl.i == 1 and state.total == 0
    assert ctl.act(tapp.KEYS["q"]).startswith("QUIZ") and ctl.i == 0
    assert [p for p, _ in ctl.views()] == ["left", None, "right"]
    for key in ("a", "s", "b"):
        status = ctl.act(tapp.KEYS[key])
    assert status.startswith("DONE") and ctl.phase == "done" and state.total == 3
    assert [a["choice"] for a in state.answers] == ["left", "same", "right"]
    assert "saved ->" in ctl.act(tapp.KEYS["w"])


def test_tk_client_refuses_without_tkinter_or_display(processed, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(SystemExit, match="web_app") as e:
        tapp.main([str(processed), "--device", "cpu"])
    assert "tkinter" in str(e.value) or "no display" in str(e.value)
    assert not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32)
