"""Setup verification of the port (counterpart of the repository's
``verify_setup.py``):

    python -m vfisr_tpu_torch.verify_setup [--device cuda|cpu]

Prints one ``[PASS]``, ``[FAIL]`` or ``[warn]`` line per check and exits 1
if any check failed. The checks: Python >= 3.10; torch and an allocation
probe in a bounded subprocess (``sum(ones(256, 256)) == 65536`` on the
device, the card's name); the nvcc build of both kernel sources
(``csrc/warp_windowed.cu``, ``csrc/warp_tiled.cu``); a Y4M round trip
through ``data/video_io.py``; the port's registry; ``utils/config.py``'s
``load_config``; the project directories; the weights (a warning). The
packages the card's machine may lack (cv2, ffmpeg, matplotlib, tkinter,
pandas, yaml, psutil) are warnings; without PyYAML the config check is a
warning that names it. With ``--device cpu`` the probe runs on the CPU and
the CUDA and nvcc checks print ``[skip]``: not run, not passed.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from vfisr_tpu_torch.utils.paths import REPO_ROOT

PASS, FAIL, WARN, SKIP = "[PASS]", "[FAIL]", "[warn]", "[skip]"
OPTIONAL = ("cv2", "matplotlib", "tkinter", "pandas", "yaml", "psutil")
_PROBE = ("import sys, torch; d = torch.device(sys.argv[1]); "
          "v = float(torch.ones((256, 256), device=d).sum()); assert v == 65536.0, v; "
          "print(torch.cuda.get_device_name(d) if d.type == 'cuda' else 'cpu')")


class Report:
    """The lines of a run and its count of failed checks."""

    def __init__(self):
        self.failures = 0

    def check(self, label: str, fn, warn_only: bool = False) -> None:
        try:
            detail = fn()
        except Exception as e:  # a failed check is reported, and the run goes on
            if not warn_only:
                self.failures += 1
            print(f"{WARN if warn_only else FAIL} {label} — {type(e).__name__}: {e}")
            return
        print(f"{PASS} {label}" + (f" — {detail}" if detail else ""))

    @staticmethod
    def skip(label: str, why: str) -> None:
        print(f"{SKIP} {label} — not run ({why})")


def _python() -> str:
    if sys.version_info < (3, 10):
        raise RuntimeError(f"need >= 3.10, have {sys.version.split()[0]}")
    return sys.version.split()[0]


def _alloc_probe(device: str, timeout: float) -> str:
    """The allocation probe in a child process: a wedged card hangs the
    child, not this run."""
    try:
        proc = subprocess.run([sys.executable, "-c", _PROBE, device], capture_output=True,
                              text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"the {device} probe hung > {timeout:.0f} s") from None
    if proc.returncode != 0:
        lines = proc.stderr.strip().splitlines()
        raise RuntimeError(lines[-1] if lines else f"probe exited {proc.returncode}")
    return f"torch {torch.__version__}, {proc.stdout.strip()}"


def _kernels() -> str:
    from vfisr_tpu_torch.ops.cuda import warp

    warp.build()
    warp.build_tiled()
    return f"{warp.SOURCE.name} and {warp.TILED_SOURCE.name} built into {warp.BUILD_DIR.name}/"


def _video_io() -> str:
    from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter

    frames = [np.full((48, 64, 3), 40 * i, np.uint8) for i in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "probe.y4m")
        with VideoWriter(path, 64, 48, 30) as w:
            for f in frames:
                w.write(f)
        with VideoReader(path) as r:
            got = [r.read() for _ in frames]
    if any(g is None or g.shape != (48, 64, 3) for g in got):
        raise RuntimeError("the Y4M written was not read back")
    return "Y4M written and read"


def _registry(device: str) -> str:
    from vfisr_tpu_torch.models.registry import get_model, list_models

    model = get_model("lanczos", load=True, device=device)
    if model.info.name != "Lanczos":
        raise RuntimeError(f"lanczos loads as {model.info.name!r}")
    return f"{len(list_models())} models registered"


def _config() -> str:
    from vfisr_tpu_torch.utils.config import DEFAULT_CONFIG_PATH, load_config

    value = load_config()["adaptive"]["scene_change_threshold"]
    if value != 0.65:
        raise RuntimeError(f"adaptive.scene_change_threshold is {value}, not 0.65")
    return f"{DEFAULT_CONFIG_PATH.relative_to(REPO_ROOT)} parsed"


def _dirs() -> str:
    made = []
    for d in ("data/clips", "data/processed", "outputs"):
        p = REPO_ROOT / d
        if not p.exists():
            p.mkdir(parents=True, exist_ok=True)
            made.append(d)
    return f"created {', '.join(made)}" if made else "all present"


def _weights() -> str:
    found = sorted((REPO_ROOT / "weights").glob("*.npz"))
    if not found:
        raise RuntimeError("no weights in weights/: neural models run from a seeded init")
    return f"{len(found)} weight file(s)"


def _package(name: str) -> str:
    return getattr(importlib.import_module(name), "__version__", "ok")


def _ffmpeg() -> str:
    path = shutil.which("ffmpeg")
    if path is None:
        raise RuntimeError("no ffmpeg on PATH: video I/O takes Y4M (cv2 for other containers)")
    return path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.verify_setup",
                                     description="Verify the port's setup")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--probe-timeout", type=float, default=120.0,
                        help="seconds before the allocation probe counts as hung")
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("Verifying setup...\n")
    rep = Report()
    rep.check("Python >= 3.10", _python)
    rep.check(f"torch allocation probe ({args.device})",
              lambda: _alloc_probe(args.device, args.probe_timeout))
    if args.device == "cuda":
        rep.check("nvcc build of the warp kernels", _kernels)
    else:
        rep.skip("nvcc build of the warp kernels", "--device cpu")
    rep.check("package numpy", lambda: _package("numpy"))
    for name in OPTIONAL:
        rep.check(f"package {name}", lambda n=name: _package(n), warn_only=True)
    rep.check("ffmpeg binary", _ffmpeg, warn_only=True)
    rep.check("video IO round-trip", _video_io)
    rep.check("model registry", lambda: _registry(args.device))
    has_yaml = importlib.util.find_spec("yaml") is not None
    rep.check("config system" + ("" if has_yaml else " (needs PyYAML)"), _config,
              warn_only=not has_yaml)
    rep.check("project directories", _dirs)
    rep.check("neural weights", _weights, warn_only=True)
    print(f"\n{'All checks passed.' if rep.failures == 0 else f'{rep.failures} check(s) FAILED.'}")
    return 1 if rep.failures else 0


if __name__ == "__main__":
    sys.exit(main())
