"""The desktop (tkinter) variant of the image-pair blind study (port of
``gui/blind_study_app.py``): the learning and quiz flow of
``gui/web_app.py`` in a local window, over the same ``StudyState``.

    python -m vfisr_tpu_torch.gui.blind_study_app [DATA_DIR] [--device cuda]

Keys: space/n = next pair, q = start the quiz, a / s / b = left / same /
right is better, w = save the results. It needs tkinter and a display, and
raises naming what is missing; without them use ``gui/web_app.py``. The
served JPEGs are decoded with ``data/jpeg.py``, scaled to PANEL_H rows and
handed to Tk as a binary PPM, which ``tk.PhotoImage(data=...)`` reads
without PIL.
"""

from __future__ import annotations

import argparse

import torch

from vfisr_tpu_torch.core.resize import resize
from vfisr_tpu_torch.data import jpeg
from vfisr_tpu_torch.gui.web_app import StudyState

PANEL_H = 360
# key -> action of StudyController
KEYS = {"<space>": "next_pair", "n": "next_pair", "q": "start_quiz", "a": "left",
        "s": "same", "b": "right", "w": "save"}


def jpeg_to_ppm(data: bytes, max_h: int = PANEL_H, device="cpu") -> bytes:
    """A JPEG scaled to max_h rows (cubic, the aspect kept) as a binary
    PPM (P6)."""
    img = jpeg.decode(data, device)
    h, w = img.shape[:2]
    out = resize(img, (max_h, int(w * max_h / h)), "cubic").cpu().numpy()
    return f"P6\n{out.shape[1]} {out.shape[0]}\n255\n".encode() + out.tobytes()


class StudyController:
    """The window's state machine over a StudyState, without Tk: each
    action returns the status line; ``views`` gives the panels to show."""

    def __init__(self, state: StudyState):
        self.state = state
        self.phase, self.i = "learning", 0
        self.status = "LEARNING — space: next pair, q: start quiz"

    def _pair(self):
        pairs = self.state.pair_list()
        return pairs[self.i % len(pairs)]

    def views(self) -> list:
        """[(position or None, caption)] of the three panels: left, the
        ground truth (learning only) and right."""
        p, learning = self._pair(), self.phase == "learning"
        return [("left", p["model_a"] if learning else "A"),
                ("gt", "ground truth") if learning else (None, ""),
                ("right", p["model_b"] if learning else "B")]

    def act(self, action: str) -> str:
        if action == "next_pair":
            self.i += 1
        elif action == "start_quiz":
            self.state.shuffle()
            self.phase, self.i = "quiz", 0
            self.status = "QUIZ — a: left better, s: same, b: right better"
        elif action in ("left", "same", "right"):
            if self.phase == "quiz":
                self._guess(action)
        elif action == "save":
            out = self.state.save()
            self.status = f"saved -> {out['path']} ({out['sessions']} sessions)"
        else:
            raise ValueError(f"unknown action {action!r}")
        return self.status

    def _guess(self, choice: str) -> None:
        res, _ = self.state.guess(self._pair()["idx"], choice)
        verdict = "Correct" if res["correct"] else f"No — {res['correct_choice']}"
        self.status = (f"{verdict} ({res['model_a']} vs {res['model_b']}) — "
                       f"score {res['score']}/{res['total']}   [w: save]")
        self.i += 1
        if self.i >= len(self.state.pairs):
            self.phase = "done"
            r = self.state.results()
            self.status = (f"DONE — {r['score']}/{r['total']} "
                           f"({100 * r['accuracy']:.0f}%)   [w: save]")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.gui.blind_study_app",
                                     description="Desktop image-pair blind study")
    parser.add_argument("data_dir", nargs="?", default="data/processed")
    parser.add_argument("--device", default="cuda", help="torch device of the renders")
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        import tkinter as tk
    except ImportError as e:
        raise SystemExit(f"tkinter is not installed ({e}); use the web variant: "
                         "python -m vfisr_tpu_torch.gui.web_app") from None
    try:
        root = tk.Tk()
    except tk.TclError as e:
        raise SystemExit(f"no display for the Tk window ({e}); use the web variant: "
                         "python -m vfisr_tpu_torch.gui.web_app") from None

    state = StudyState(args.data_dir, device=args.device)
    clips = state.clips()
    if not clips:
        root.destroy()
        raise SystemExit(f"no processed clips in {args.data_dir}")
    state.set_clip(clips[0])
    ctl = StudyController(state)
    root.title(f"VFI Blind Study — {clips[0]}")
    row = tk.Frame(root)
    row.pack()
    panels, captions = [], []
    for col in range(3):
        f = tk.Frame(row)
        f.grid(row=0, column=col, padx=4, pady=4)
        captions.append(tk.Label(f, font=("TkDefaultFont", 11, "bold")))
        captions[-1].pack()
        panels.append(tk.Label(f))
        panels[-1].pack()
    status = tk.Label(root, text=ctl.status)
    status.pack(pady=4)

    def show():
        if ctl.phase == "done":
            return
        p = ctl._pair()
        for col, (pos, caption) in enumerate(ctl.views()):
            data = state.render(p["idx"], pos) if pos else None
            photo = tk.PhotoImage(data=jpeg_to_ppm(data, device=args.device)) if data else None
            captions[col].configure(text=caption)
            panels[col].configure(image=photo or "")
            panels[col].image = photo

    def on_key(action):
        def handler(_event=None):
            status.configure(text=ctl.act(action))
            show()
        return handler

    for key, action in KEYS.items():
        root.bind(key, on_key(action))
    show()
    root.mainloop()


if __name__ == "__main__":
    main()
