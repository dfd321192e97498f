"""The image-pair blind study server (port of ``gui/web_app.py``).

    python -m vfisr_tpu_torch.gui.web_app [--data-dir data/processed]
        [--out-dir outputs/blind_study] [--methods ...] [--num-pairs 10]
        [--proc-height 540] [--port 5000] [--seed N] [--device cuda]

Two phases over a processed clip's triplets (``triplets.json`` and its
PNG frames): learning shows labelled method outputs beside the ground-truth
midpoint; the quiz shuffles pairs and sides and scores each pick against
the fixed method ranking. Each method predicts the t = 0.5 midpoint of the
keyframe pair at ``--proc-height`` (both keyframes area-resized there on
the device) through the port's models (``get_model``) or
``methods/inline.py::linear_blend``; outputs are cached as quality-92 JPEGs
(``data/jpeg.py``) under the output directory, with the reference's cache
key.

Endpoints, on the standard library's ``ThreadingHTTPServer``:
    GET  /                         the study page
    GET  /api/clips                processed clips
    POST /api/clip                 select a clip, draw its pairs
    GET  /api/pairs                the pair list
    POST /api/shuffle              shuffle pairs and sides, reset the score
    GET  /api/frame/<idx>/<pos>    JPEG: pos = left | right | gt
    POST /api/guess                record a pick: correctness and score
    GET  /api/results              the session's summary
    POST /api/save                 append the session to the results JSON

Pairs, sides and scores draw from ``random.Random(seed)`` in the
reference's order, so a seed gives the reference's study. Where a
ground-truth midpoint (or a keyframe) is missing, the frame endpoint
answers 404 naming the missing file; it never shows another frame in its
place.
"""

from __future__ import annotations

import argparse
import json
import random
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

import numpy as np
import torch

from vfisr_tpu_torch.core.frames import to_device
from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data import jpeg
from vfisr_tpu_torch.data.png import read_png

# the method ranking a pick is scored against (the reference's)
QUALITY_RANKING = {
    "control": 100,  # the ground-truth midpoint
    "rife_default": 12,
    "adaptive_default": 10,
    "lanczos_blend": 9,
    "optical_flow_basic": 8,
    "bicubic_blend": 5,
    "degraded": 1,
}
DEFAULT_METHODS = ["rife_default", "lanczos_blend", "optical_flow_basic",
                   "bicubic_blend", "degraded"]
JPEG_QUALITY = 92
# method -> the registry model that renders it
MODEL_OF = {"bicubic_blend": "bicubic", "optical_flow_basic": "optical_flow",
            "rife_default": "rife", "adaptive_default": "adaptive"}


HTML_PAGE = """<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>VFI Blind Study</title>
<style>
 body{background:#14161a;color:#e8e8e8;font-family:system-ui,sans-serif;
      margin:0;padding:1.2rem;max-width:1400px;margin:auto}
 h1{font-size:1.3rem;font-weight:600} .muted{color:#9aa0a8}
 button{background:#2d6cdf;color:#fff;border:0;border-radius:6px;
        padding:.55rem 1.1rem;margin:.25rem;font-size:1rem;cursor:pointer}
 button:disabled{background:#3a3f46;cursor:default}
 button.secondary{background:#3a3f46}
 .imgrow{display:flex;gap:.6rem;margin-top:.8rem}
 .imgcol{flex:1;text-align:center}
 .imgcol img{width:100%;border-radius:6px;border:1px solid #2a2e34}
 .lbl{margin:.3rem 0;font-weight:600}
 #feedback{min-height:1.6rem;font-weight:600;margin-top:.5rem}
 .ok{color:#4fc26b}.bad{color:#e05d5d}
 .pill{display:inline-block;background:#22262c;border-radius:999px;
       padding:.2rem .8rem;margin-left:.5rem}
 table{border-collapse:collapse;margin-top:.6rem}
 td,th{border:1px solid #2a2e34;padding:.35rem .7rem;text-align:left}
</style></head><body>
<h1>VFI+SR blind study
  <span class="pill" id="phasePill">setup</span>
  <span class="pill" id="scorePill" hidden></span></h1>
<div id="setup">
  <p class="muted">Pick a clip. Learning shows labeled method outputs;
  the quiz hides labels and shuffles sides.</p>
  <select id="clipSel"></select>
  <button onclick="startStudy()">Start study</button>
</div>
<div id="study" hidden>
  <div class="imgrow" id="row">
    <div class="imgcol"><div class="lbl" id="lblL">A</div><img id="imgL"></div>
    <div class="imgcol" id="gtCol"><div class="lbl">Ground truth</div><img id="imgG"></div>
    <div class="imgcol"><div class="lbl" id="lblR">B</div><img id="imgR"></div>
  </div>
  <div id="learnCtl">
    <button onclick="nextPair()">Next pair</button>
    <button class="secondary" onclick="startQuiz()">Start quiz →</button>
  </div>
  <div id="quizCtl" hidden>
    <button onclick="guess('left')">◀ A is better</button>
    <button onclick="guess('same')">Same</button>
    <button onclick="guess('right')">B is better ▶</button>
    <div id="feedback"></div>
  </div>
</div>
<div id="results" hidden>
  <h2>Results</h2><div id="resultBody"></div>
  <button onclick="saveResults()">Save results</button>
  <span id="saveMsg" class="muted"></span>
</div>
<script>
let pairs=[],idx=0,phase='setup';
const $=id=>document.getElementById(id);
async function j(url,opts){const r=await fetch(url,opts);return r.json()}
async function init(){
  const c=await j('/api/clips');
  $('clipSel').innerHTML=c.clips.map(x=>`<option>${x}</option>`).join('');
  if(!c.clips.length)$('setup').innerHTML='<p class="bad">No processed clips. Run python -m vfisr_tpu_torch.preprocess_video first.</p>';
}
async function startStudy(){
  await j('/api/clip',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({clip:$('clipSel').value})});
  pairs=(await j('/api/pairs')).pairs;idx=0;phase='learning';
  $('setup').hidden=true;$('study').hidden=false;$('phasePill').textContent='learning';
  show();
}
function show(){
  const p=pairs[idx%pairs.length];
  $('imgL').src=`/api/frame/${p.idx}/left?${Date.now()}`;
  $('imgR').src=`/api/frame/${p.idx}/right?${Date.now()}`;
  $('imgG').src=`/api/frame/${p.idx}/gt?${Date.now()}`;
  const showLbl=phase==='learning';
  $('lblL').textContent=showLbl?p.model_a:'A';
  $('lblR').textContent=showLbl?p.model_b:'B';
}
function nextPair(){idx++;show()}
async function startQuiz(){
  pairs=(await j('/api/shuffle',{method:'POST'})).pairs;idx=0;phase='quiz';
  $('phasePill').textContent='quiz';$('learnCtl').hidden=true;
  $('quizCtl').hidden=false;$('gtCol').hidden=true;$('scorePill').hidden=false;
  $('scorePill').textContent='0 / 0';show();
}
async function guess(choice){
  const p=pairs[idx%pairs.length];
  const r=await j('/api/guess',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({pair_idx:p.idx,choice})});
  $('feedback').innerHTML=r.correct
    ?`<span class="ok">Correct!</span> (${r.model_a} vs ${r.model_b})`
    :`<span class="bad">Not quite</span> — better: ${r.correct_choice} (${r.model_a} vs ${r.model_b})`;
  $('scorePill').textContent=`${r.score} / ${r.total}`;
  idx++;
  if(idx>=pairs.length){await finish()}else{setTimeout(()=>{$('feedback').textContent='';show()},1200)}
}
async function finish(){
  const r=await j('/api/results');phase='results';
  $('study').hidden=true;$('results').hidden=false;$('phasePill').textContent='done';
  let rows=Object.entries(r.per_method).map(([m,s])=>
    `<tr><td>${m}</td><td>${s.shown}</td><td>${s.preferred}</td></tr>`).join('');
  $('resultBody').innerHTML=
    `<p>Score: <b>${r.score} / ${r.total}</b> (${Math.round(100*r.accuracy)}%)</p>
     <table><tr><th>method</th><th>shown</th><th>preferred</th></tr>${rows}</table>`;
}
async function saveResults(){
  const r=await j('/api/save',{method:'POST'});
  $('saveMsg').textContent='saved to '+r.path;
}
init();
</script></body></html>"""


class MissingFrame(FileNotFoundError):
    """A frame the study needs is not on disk."""


class StudyState:
    """The study's data, its method renders and its scoring."""

    def __init__(self, data_dir="data/processed", out_dir="outputs/blind_study",
                 methods=None, num_pairs=10, proc_height=540, seed=None, device="cuda"):
        self.data_dir = Path(data_dir)
        self.out_dir = Path(out_dir)
        self.cache_dir = self.out_dir / "cache"
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.methods = methods or DEFAULT_METHODS
        self.num_pairs = num_pairs
        self.proc_height = proc_height
        self.device = device
        self.rng = random.Random(seed)
        self.clip = None
        self.pairs = []
        self.score = 0
        self.total = 0
        self.answers = []
        self._models = {}

    # ---- data ----
    def clips(self):
        if not self.data_dir.exists():
            return []
        return [d.name for d in sorted(self.data_dir.iterdir())
                if (d / "triplets.json").exists()]

    def set_clip(self, clip: str):
        self.clip = clip
        with open(self.data_dir / clip / "triplets.json") as f:
            triplets = json.load(f)
        usable = [t for t in triplets if t.get("gt_intermediate")]
        chosen = self.rng.sample(usable, min(self.num_pairs, len(usable)))
        self.pairs = []
        for i, t in enumerate(chosen):
            a, b = self.rng.sample(self.methods, 2)
            self.pairs.append({"idx": i, "triplet": t, "model_a": a, "model_b": b})
        self.score = 0
        self.total = 0
        self.answers = []

    def pair_list(self):
        return [{k: p[k] for k in ("idx", "model_a", "model_b")} for p in self.pairs]

    def shuffle(self):
        self.rng.shuffle(self.pairs)
        for p in self.pairs:
            if self.rng.random() < 0.5:
                p["model_a"], p["model_b"] = p["model_b"], p["model_a"]
        self.score = 0
        self.total = 0
        self.answers = []
        return self.pair_list()

    # ---- rendering ----
    def _frame(self, sub: str, name: str) -> np.ndarray:
        path = self.data_dir / self.clip / sub / "frames" / name
        if not path.is_file():
            raise MissingFrame(f"missing frame {path}")
        return read_png(path)

    def _small(self, img: np.ndarray) -> np.ndarray:
        """img area-resized on the device to proc_height rows (the width
        keeps the aspect, rounded)."""
        h, w = img.shape[:2]
        if h == self.proc_height:
            return img
        nw = int(round(w * self.proc_height / h))
        return resize(to_device(img, self.device), (self.proc_height, nw), "area").cpu().numpy()

    def _get_model(self, name):
        if name not in self._models:
            from vfisr_tpu_torch.models.registry import get_model

            self._models[name] = get_model(name, load=True, device=self.device)
        return self._models[name]

    def render(self, pair_idx: int, position: str) -> bytes | None:
        """The JPEG of a pair's position (left, right or gt), rendered once
        and cached; None for an unknown pair. A missing frame raises
        MissingFrame naming it."""
        p = next((q for q in self.pairs if q["idx"] == pair_idx), None)
        if p is None:
            return None
        t = p["triplet"]
        method = {"left": p["model_a"], "right": p["model_b"], "gt": "control"}[position]
        key = f"{self.clip}_{t['triplet_id']}_{method}_{self.proc_height}.jpg"
        cached = self.cache_dir / key
        if cached.exists():
            return cached.read_bytes()
        f0 = self._small(self._frame("input_1080p30", t["input_frame_0"]))
        f1 = self._small(self._frame("input_1080p30", t["input_frame_1"]))
        gt = None
        if method == "control":
            mid = t["gt_intermediate"][len(t["gt_intermediate"]) // 2]
            gt = self._small(self._frame("ground_truth", mid))
        data = jpeg.encode(self._render_method(method, f0, f1, gt), JPEG_QUALITY, self.device)
        cached.write_bytes(data)
        return data

    def _render_method(self, method, f0, f1, gt):
        """The t = 0.5 midpoint by ``method``, uint8 HWC."""
        from vfisr_tpu_torch.methods.inline import linear_blend

        if method == "control":
            return gt
        if method == "degraded":
            return f0.copy()  # frame duplication
        if method == "lanczos_blend":
            return linear_blend(f0, f1, 0.5, self.device)
        if method in MODEL_OF:
            return self._get_model(MODEL_OF[method]).interpolate(f0, f1, num_frames=1)[0]
        raise ValueError(f"unknown method {method}")

    # ---- scoring against QUALITY_RANKING ----
    def guess(self, pair_idx: int, choice: str):
        p = next((q for q in self.pairs if q["idx"] == pair_idx), None)
        if p is None:
            return {"error": "invalid pair index"}, 400
        ra = QUALITY_RANKING.get(p["model_a"], 0)
        rb = QUALITY_RANKING.get(p["model_b"], 0)
        correct_choice = "left" if ra > rb else ("right" if rb > ra else "same")
        is_correct = choice == correct_choice
        self.total += 1
        self.score += int(is_correct)
        self.answers.append({
            "pair_idx": pair_idx, "model_a": p["model_a"], "model_b": p["model_b"],
            "choice": choice, "correct_choice": correct_choice,
            "correct": is_correct,
        })
        return {
            "correct": is_correct, "correct_choice": correct_choice,
            "score": self.score, "total": self.total,
            "model_a": p["model_a"], "model_b": p["model_b"],
        }, 200

    def results(self):
        per_method = {}
        for a in self.answers:
            for side, m in (("left", a["model_a"]), ("right", a["model_b"])):
                s = per_method.setdefault(m, {"shown": 0, "preferred": 0})
                s["shown"] += 1
                if a["choice"] == side:
                    s["preferred"] += 1
        return {
            "clip": self.clip, "score": self.score, "total": self.total,
            "accuracy": self.score / self.total if self.total else 0.0,
            "per_method": per_method, "answers": self.answers,
        }

    def save(self):
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "blind_study_results.json"
        existing = json.loads(path.read_text()) if path.exists() else {"sessions": []}
        existing["sessions"].append({"timestamp": time.time(), **self.results()})
        path.write_text(json.dumps(existing, indent=2))
        return {"path": str(path), "sessions": len(existing["sessions"])}


def make_handler(state: StudyState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, data, ctype):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            url = urlparse(self.path)
            parts = [p for p in url.path.split("/") if p]
            if url.path == "/":
                return self._bytes(HTML_PAGE.encode(), "text/html; charset=utf-8")
            if url.path == "/api/clips":
                return self._json({"clips": state.clips()})
            if url.path == "/api/pairs":
                return self._json({"pairs": state.pair_list()})
            if url.path == "/api/results":
                return self._json(state.results())
            if len(parts) == 4 and parts[:2] == ["api", "frame"]:
                try:
                    data = state.render(int(parts[2]), parts[3])
                except MissingFrame as e:
                    return self._json({"error": str(e)}, 404)
                except Exception as e:  # noqa: BLE001 (the page shows the error)
                    return self._json({"error": str(e)}, 500)
                if data is None:
                    return self._json({"error": "not found"}, 404)
                return self._bytes(data, "image/jpeg")
            self._json({"error": "unknown endpoint"}, 404)

        def do_POST(self):
            url = urlparse(self.path)
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if url.path == "/api/clip":
                state.set_clip(body["clip"])
                return self._json({"status": "ok", "pairs": len(state.pairs)})
            if url.path == "/api/shuffle":
                return self._json({"pairs": state.shuffle()})
            if url.path == "/api/guess":
                obj, code = state.guess(int(body.get("pair_idx", -1)),
                                        body.get("choice", "same"))
                return self._json(obj, code)
            if url.path == "/api/save":
                return self._json(state.save())
            self._json({"error": "unknown endpoint"}, 404)

    return Handler


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.gui.web_app",
                                     description="Image-pair blind study server")
    parser.add_argument("--data-dir", default="data/processed")
    parser.add_argument("--out-dir", default="outputs/blind_study")
    parser.add_argument("--methods", default=",".join(DEFAULT_METHODS))
    parser.add_argument("--num-pairs", type=int, default=10)
    parser.add_argument("--proc-height", type=int, default=540,
                        help="working resolution, the same for every method")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device of the renders")
    return parser


def build(argv=None):
    """(state, server) of the command line, not yet serving. Turns TF32 off:
    the methods' models run f32 convs."""
    args = make_parser().parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = StudyState(args.data_dir, args.out_dir, [m.strip() for m in args.methods.split(",")],
                       args.num_pairs, args.proc_height, args.seed, args.device)
    return state, ThreadingHTTPServer((args.host, args.port), make_handler(state))


def main(argv=None) -> None:
    state, server = build(argv)
    print(f"Blind study app on http://localhost:{server.server_address[1]} "
          f"({len(state.clips())} clips, device {state.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
