"""The video blind study server (port of ``gui/video_blind_study.py``).

    python -m vfisr_tpu_torch.gui.video_blind_study
        [--benchmark-dir outputs/benchmark] [--results outputs/experiment_results.json]
        [--full-dir outputs/full_processed] [--raw-video RAW] [--duration 10]
        [--port 5001] [--device cuda]

Four modes over the per-method study videos that
``python -m vfisr_tpu_torch.gui.benchmark_proper`` writes: learn (labelled
playback with metrics), compare (two players side by side), quiz (an
unlabelled video, name its method; running score, saved sessions) and
results (the experiment results, quality suffixes stripped).

HTTP surface, on the standard library's ``ThreadingHTTPServer``:
    GET  /                        the study page
    GET  /api/metadata            clips_metadata.json
    GET  /api/experiment-results  experiment results, suffixes stripped
    GET  /api/video/<model>       the video, with HTTP Range (206)
    GET  /api/available-clips     clips with study videos
    POST /api/switch-clip         change the active clip
    POST /api/reprocess           re-run benchmark_proper in the background (409 busy)
    GET  /api/processing-status   its progress; a child that exits non-zero is failed
    POST /api/new-interval        re-cut the pre-generated full videos at a random
                                  start (benchmark_proper.extract_clip), else regenerate
    POST /api/quiz/start          begin a quiz round
    GET  /api/quiz/video          the round's video
    POST /api/quiz/guess          a guess: the answer and the score
    POST /api/quiz/save           append the session to the results JSON

Study videos are ``.mp4`` or ``.y4m`` (``video_io.writable_suffix``), and
both are looked for and served, each with the content type of its suffix.
The re-benchmark runs ``python -m vfisr_tpu_torch.gui.benchmark_proper``
with the server's ``--device``.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

CHUNK = 1 << 20
VIDEO_TYPES = {".mp4": "video/mp4", ".y4m": "video/x-yuv4mpeg"}

HTML_PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>Video Blind Study</title>
<style>
 body{background:#14161a;color:#e8e8e8;font-family:system-ui,sans-serif;
      margin:0;padding:1rem;max-width:1500px;margin:auto}
 h1{font-size:1.25rem}
 nav button{background:#22262c;color:#dfe3e8;border:0;border-radius:6px;
      padding:.5rem 1rem;margin-right:.4rem;cursor:pointer;font-size:.95rem}
 nav button.active{background:#2d6cdf;color:#fff}
 select,button.act{background:#2d6cdf;color:#fff;border:0;border-radius:6px;
      padding:.45rem .9rem;margin:.2rem;font-size:.95rem;cursor:pointer}
 select{background:#22262c}
 video{width:100%;border-radius:8px;background:#000}
 .row{display:flex;gap:.8rem}.col{flex:1}
 .muted{color:#9aa0a8}.ok{color:#4fc26b}.bad{color:#e05d5d}
 table{border-collapse:collapse;margin-top:.6rem}
 td,th{border:1px solid #2a2e34;padding:.3rem .7rem;text-align:left;font-size:.9rem}
 #quizFeedback{font-weight:600;min-height:1.4rem}
 .pill{display:inline-block;background:#22262c;border-radius:999px;
       padding:.15rem .7rem;margin-left:.5rem;font-size:.9rem}
</style></head><body>
<h1>Gaming VFI+SR video study
 <span class="pill" id="clipPill"></span>
 <span class="pill" id="scorePill" hidden></span></h1>
<nav>
 <button id="nav-learn" onclick="mode('learn')">Learn</button>
 <button id="nav-compare" onclick="mode('compare')">Compare</button>
 <button id="nav-quiz" onclick="mode('quiz')">Quiz</button>
 <button id="nav-results" onclick="mode('results')">Results</button>
 <button class="act" onclick="newInterval()" style="float:right">New interval ⟳</button>
</nav>
<div id="learn" class="pane">
 <p><select id="learnSel" onchange="loadLearn()"></select>
    <span class="muted" id="learnMetrics"></span></p>
 <video id="learnVid" controls loop></video>
</div>
<div id="compare" class="pane" hidden>
 <div class="row">
  <div class="col"><select id="cmpA" onchange="loadCmp()"></select>
    <video id="vidA" controls loop muted></video></div>
  <div class="col"><select id="cmpB" onchange="loadCmp()"></select>
    <video id="vidB" controls loop muted></video></div>
 </div>
 <button class="act" onclick="syncPlay()">▶ Play both</button>
</div>
<div id="quiz" class="pane" hidden>
 <p class="muted">Which method produced this video?</p>
 <video id="quizVid" controls loop muted></video>
 <div id="quizBtns"></div>
 <div id="quizFeedback"></div>
 <button class="act" onclick="quizStart()">Next round</button>
 <button class="act" onclick="quizSave()">Save session</button>
 <span id="quizSaveMsg" class="muted"></span>
</div>
<div id="results" class="pane" hidden>
 <h3>Experiment results</h3><div id="resultsBody" class="muted">loading…</div>
</div>
<script>
let models=[],score=0,total=0,quizToken=null;
const $=id=>document.getElementById(id);
async function j(u,o){const r=await fetch(u,o);return r.json()}
function mode(m){
 for(const p of document.querySelectorAll('.pane'))p.hidden=true;
 for(const b of document.querySelectorAll('nav button'))b.classList.remove('active');
 $(m).hidden=false;const nb=$('nav-'+m);if(nb)nb.classList.add('active');
 if(m==='results')loadResults();
 if(m==='quiz'&&!quizToken)quizStart();
}
async function init(){
 const meta=await j('/api/metadata');
 const clips=Object.keys(meta.clips||{});
 $('clipPill').textContent=clips.length?clips[0]:'no clips — run python -m vfisr_tpu_torch.gui.benchmark_proper';
 const clip=clips[0];
 models=clip?Object.keys(meta.clips[clip].videos||{}):[];
 window.metrics=clip?(meta.clips[clip].metrics||{}):{};
 const opts=models.map(m=>`<option>${m}</option>`).join('');
 $('learnSel').innerHTML=opts;$('cmpA').innerHTML=opts;$('cmpB').innerHTML=opts;
 if(models.length>1)$('cmpB').selectedIndex=1;
 $('quizBtns').innerHTML=models.map(m=>
   `<button class="act" onclick="quizGuess('${m}')">${m}</button>`).join('');
 mode('learn');loadLearn();loadCmp();
}
function loadLearn(){
 const m=$('learnSel').value;if(!m)return;
 $('learnVid').src='/api/video/'+m;
 const s=window.metrics[m]||{};
 $('learnMetrics').textContent=
   `psnr ${s.psnr?s.psnr.toFixed(2):'—'} dB · ssim ${s.ssim?s.ssim.toFixed(4):'—'} · ${s.bitrate_kbps||'—'} kbps`;
}
function loadCmp(){
 if($('cmpA').value)$('vidA').src='/api/video/'+$('cmpA').value;
 if($('cmpB').value)$('vidB').src='/api/video/'+$('cmpB').value;
}
function syncPlay(){
 $('vidA').currentTime=0;$('vidB').currentTime=0;
 $('vidA').play();$('vidB').play();
}
async function quizStart(){
 const r=await j('/api/quiz/start',{method:'POST'});
 quizToken=r.token;$('quizFeedback').textContent='';
 $('quizVid').src='/api/quiz/video?t='+r.token;
 $('scorePill').hidden=false;$('scorePill').textContent=`${score} / ${total}`;
}
async function quizGuess(m){
 if(!quizToken)return;
 const r=await j('/api/quiz/guess',{method:'POST',
   headers:{'Content-Type':'application/json'},
   body:JSON.stringify({token:quizToken,guess:m})});
 score=r.score;total=r.total;
 $('scorePill').textContent=`${score} / ${total}`;
 $('quizFeedback').innerHTML=r.correct
   ?`<span class="ok">Correct — ${r.answer}</span>`
   :`<span class="bad">It was ${r.answer}</span>`;
 quizToken=null;
}
async function quizSave(){
 const r=await j('/api/quiz/save',{method:'POST'});
 $('quizSaveMsg').textContent='saved to '+r.path;
}
async function loadResults(){
 const r=await j('/api/experiment-results');
 const exps=r.experiments||[];
 if(!exps.length){$('resultsBody').textContent='no experiment results yet';return}
 const rows=exps.map(e=>
  `<tr><td>${e.base_name||e.name}</td><td>${fmt(e.vfi_psnr)}</td>
   <td>${fmt(e.overall_psnr)}</td><td>${fmt(e.ssim,4)}</td>
   <td>${fmt(e.time_seconds,1)}</td></tr>`).join('');
 $('resultsBody').innerHTML=
  `<table><tr><th>experiment</th><th>VFI PSNR</th><th>overall PSNR</th>
   <th>SSIM</th><th>time s</th></tr>${rows}</table>`;
}
function fmt(v,d=2){return (v===undefined||v===null)?'—':(+v).toFixed(d)}
async function newInterval(){
 $('clipPill').textContent='cutting new interval…';
 const r=await j('/api/new-interval',{method:'POST'});
 if(r.status==='done'){$('clipPill').textContent=`new interval @ ${r.start_time}s`;init()}
 else if(r.status==='fallback'){$('clipPill').textContent='regenerating (see status)…'}
 else{$('clipPill').textContent=r.error||'new-interval failed'}
}
init();
</script></body></html>"""


class AppState:
    def __init__(self, benchmark_dir: str = "outputs/benchmark",
                 results_path: str = "outputs/experiment_results.json",
                 full_dir: str = "outputs/full_processed",
                 raw_video: str | None = None,
                 duration: float = 10.0,
                 out_dir: str = "outputs/blind_study",
                 device: str = "cuda"):
        self.benchmark_dir = Path(benchmark_dir)
        self.results_path = Path(results_path)
        self.full_dir = Path(full_dir)
        self.raw_video = raw_video
        self.duration = duration
        self.out_dir = Path(out_dir)
        self.device = device
        self.active_clip = None
        self.processing = {"active": False, "progress": 0, "message": ""}
        self.lock = threading.Lock()
        self.rng = random.Random()
        self.quiz = {}  # token -> model
        self.quiz_answers = []
        self.quiz_score = 0

    def metadata(self):
        p = self.benchmark_dir / "clips_metadata.json"
        if p.exists():
            return json.loads(p.read_text())
        return {"clips": {}}

    def experiment_results(self):
        if not self.results_path.exists():
            return {"experiments": []}
        data = json.loads(self.results_path.read_text())
        for e in data.get("experiments", []):  # quality-level suffixes stripped
            e["base_name"] = re.sub(r"_(4K@120|1440p@90|1080p@60)$", "", e.get("name", ""))
        return data

    def _active_videos(self) -> dict:
        clips = self.metadata().get("clips", {})
        clip = self.active_clip or (next(iter(clips)) if clips else None)
        return clips.get(clip, {}).get("videos", {}) if clip else {}

    def models(self):
        return sorted(self._active_videos())

    def video_path(self, model: str):
        videos = self._active_videos()
        if model in videos:
            return Path(videos[model])
        for suffix in VIDEO_TYPES:
            p = self.benchmark_dir / f"{model}{suffix}"
            if p.exists():
                return p
        return None

    # ---- quiz ----
    def quiz_start(self):
        models = self.models()
        if not models:
            return None
        token = f"q{len(self.quiz_answers)}_{self.rng.randrange(1 << 30)}"
        self.quiz[token] = self.rng.choice(models)
        return token

    def quiz_guess(self, token: str, guess: str):
        answer = self.quiz.pop(token, None)
        if answer is None:
            return {"error": "unknown or already-answered token"}, 400
        correct = guess == answer
        self.quiz_score += int(correct)
        self.quiz_answers.append({"answer": answer, "guess": guess, "correct": correct})
        return {"correct": correct, "answer": answer, "score": self.quiz_score,
                "total": len(self.quiz_answers)}, 200

    def quiz_save(self):
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "video_study_results.json"
        existing = json.loads(path.read_text()) if path.exists() else {"sessions": []}
        existing["sessions"].append({
            "timestamp": time.time(),
            "score": self.quiz_score,
            "total": len(self.quiz_answers),
            "answers": self.quiz_answers,
        })
        path.write_text(json.dumps(existing, indent=2))
        return {"path": str(path), "sessions": len(existing["sessions"])}

    # ---- interval switching ----
    def full_videos(self) -> list:
        """The pre-generated full-length method videos (.mp4 and .y4m)."""
        if not self.full_dir.exists():
            return []
        return sorted(p for p in self.full_dir.iterdir() if p.suffix in VIDEO_TYPES)

    def new_interval(self):
        """(body, status): re-cut every full video at one random start
        (``extract_clip``) where they are long enough, else start the
        regeneration in the background (409 while one runs)."""
        from vfisr_tpu_torch.gui.benchmark_proper import extract_clip, get_full_video_duration

        method_videos = self.full_videos()
        if method_videos:
            full_duration = get_full_video_duration(method_videos[0])
            if full_duration > self.duration + 2:
                start = self.rng.uniform(1, full_duration - self.duration - 1)
                self.benchmark_dir.mkdir(parents=True, exist_ok=True)
                meta_path = self.benchmark_dir / "clips_metadata.json"
                meta = json.loads(meta_path.read_text()) if meta_path.exists() else {"clips": {}}
                entry = meta["clips"].setdefault(self.active_clip or "full",
                                                 {"videos": {}, "metrics": {}})
                ok_all = True
                for vid in method_videos:
                    out = self.benchmark_dir / vid.name
                    if extract_clip(vid, self.raw_video, start, self.duration, out):
                        entry["videos"][vid.stem] = str(out)
                    else:
                        ok_all = False
                meta_path.write_text(json.dumps(meta, indent=2))
                if ok_all:
                    return {"status": "done", "start_time": round(start, 1)}, 200
        if not self.start_reprocess([]):
            return {"error": "Already processing"}, 409
        return {"status": "fallback"}, 200

    def start_reprocess(self, args) -> bool:
        """Run ``python -m vfisr_tpu_torch.gui.benchmark_proper`` (args, the
        device) in a thread, its progress parsed from its output. False
        while one runs. A child that exits non-zero leaves the status
        failed, with its exit code and last line."""
        with self.lock:
            if self.processing["active"]:
                return False
            self.processing = {"active": True, "progress": 0, "message": "starting"}

        def run():
            last, status = "", {}
            try:
                cmd = [sys.executable, "-m", "vfisr_tpu_torch.gui.benchmark_proper", *args,
                       "--device", self.device]
                root = str(Path(__file__).resolve().parents[2])  # vfisr_tpu_torch's parent
                env = {**os.environ,
                       "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True, env=env)
                for line in proc.stdout:
                    m = re.search(r"(\d+)%", line)
                    if m:
                        self.processing["progress"] = int(m.group(1))
                    if line.strip():
                        last = line.strip()[:200]
                        self.processing["message"] = last
                code = proc.wait()
                if code == 0:
                    status = {"progress": 100, "message": "done (exit 0)"}
                else:
                    status = {"failed": True, "exit_code": code,
                              "message": f"failed (exit {code}): {last}"}
            except Exception as e:  # noqa: BLE001 (reported in the status)
                status = {"failed": True, "message": f"error: {e}"}
            finally:
                self.processing = {**self.processing, **status, "active": False}

        threading.Thread(target=run, daemon=True).start()
        return True


def make_handler(state: AppState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj, default=str).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream_video(self, path: Path):
            size = path.stat().st_size
            range_header = self.headers.get("Range")
            start, end = 0, size - 1
            code = 200
            if range_header:
                m = re.match(r"bytes=(\d*)-(\d*)", range_header)
                if m:
                    if m.group(1):
                        start = int(m.group(1))
                    if m.group(2):
                        end = int(m.group(2))
                    code = 206
            end = min(end, size - 1)
            length = end - start + 1
            self.send_response(code)
            self.send_header("Content-Type", VIDEO_TYPES.get(path.suffix, "application/octet-stream"))
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Length", str(length))
            if code == 206:
                self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
            self.end_headers()
            with open(path, "rb") as f:
                f.seek(start)
                remaining = length
                while remaining > 0:
                    chunk = f.read(min(CHUNK, remaining))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    remaining -= len(chunk)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = HTML_PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path == "/api/metadata":
                return self._json(state.metadata())
            if url.path == "/api/experiment-results":
                return self._json(state.experiment_results())
            if url.path == "/api/processing-status":
                return self._json(state.processing)
            if url.path == "/api/available-clips":
                return self._json({"clips": list(state.metadata().get("clips", {})),
                                   "active": state.active_clip})
            if url.path == "/api/quiz/video":
                token = parse_qs(url.query).get("t", [""])[0]
                model = state.quiz.get(token)
                path = state.video_path(model) if model else None
                if path is None or not path.exists():
                    return self._json({"error": "no active quiz round"}, 404)
                return self._stream_video(path)
            if url.path.startswith("/api/video/"):
                model = url.path.split("/api/video/", 1)[1]
                path = state.video_path(model)
                if path is None or not path.exists():
                    return self._json({"error": f"no video for {model}"}, 404)
                return self._stream_video(path)
            self._json({"error": "unknown endpoint"}, 404)

        def do_POST(self):
            url = urlparse(self.path)
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if url.path == "/api/switch-clip":
                state.active_clip = body.get("clip")
                return self._json({"active": state.active_clip})
            if url.path == "/api/reprocess":
                if not state.start_reprocess(body.get("args", [])):
                    return self._json({"error": "processing already active"}, 409)
                return self._json({"started": True})
            if url.path == "/api/new-interval":
                return self._json(*state.new_interval())
            if url.path == "/api/quiz/start":
                token = state.quiz_start()
                if token is None:
                    return self._json({"error": "no videos available"}, 404)
                return self._json({"token": token})
            if url.path == "/api/quiz/guess":
                obj, code = state.quiz_guess(str(body.get("token", "")),
                                             str(body.get("guess", "")))
                return self._json(obj, code)
            if url.path == "/api/quiz/save":
                return self._json(state.quiz_save())
            self._json({"error": "unknown endpoint"}, 404)

    return Handler


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.gui.video_blind_study",
                                     description="Video blind study server")
    parser.add_argument("--benchmark-dir", default="outputs/benchmark")
    parser.add_argument("--results", default="outputs/experiment_results.json")
    parser.add_argument("--full-dir", default="outputs/full_processed",
                        help="pre-generated full-length method videos for /api/new-interval")
    parser.add_argument("--raw-video", default=None,
                        help="source video for audio in re-cut intervals")
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5001)
    parser.add_argument("--device", default="cuda",
                        help="torch device of a re-benchmark (benchmark_proper --device)")
    args = parser.parse_args(argv)
    state = AppState(args.benchmark_dir, args.results, args.full_dir, args.raw_video,
                     args.duration, device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(state))
    print(f"Video blind study on http://localhost:{server.server_address[1]}")
    server.serve_forever()


if __name__ == "__main__":
    main()
