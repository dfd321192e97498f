"""System probe of the port (counterpart of the repository's
``probe_system.py``):

    python -m vfisr_tpu_torch.probe_system [--json]

Reports the Python, the CUDA card, the dependencies and the system's
resources, then a 0-100 compatibility score with recommendations and
warnings (the reference's keys: ``python``, ``accelerator``,
``dependencies``, ``system``, ``compatibility_score``, ``recommendations``,
``warnings``). The card is probed in a bounded subprocess (a wedged card
hangs the child, not the prober): its name, memory, compute capability and
power limit (``nvidia-smi --query-gpu=name,power.limit``), the torch and
CUDA versions and nvcc. Memory and disk come from ``os.sysconf``,
``/proc/meminfo`` and ``shutil.disk_usage`` (psutil may be missing on the
card's machine). ``compute_score`` keeps the reference's rules with the
TPU read as the CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import platform
import shutil
import subprocess
import sys

from vfisr_tpu_torch.utils.paths import REPO_ROOT

DEPENDENCIES = ("torch", "numpy", "scipy", "einops", "cv2", "pandas", "matplotlib", "yaml",
                "psutil")

_ACCEL_PROBE = r"""
import json, shutil, subprocess
info = {"platform": None, "devices": [], "memory_gb": None, "power_limit": None, "error": None}
try:
    import torch
    info["torch_version"] = torch.__version__
    info["cuda_version"] = torch.version.cuda
    if torch.cuda.is_available():
        info["platform"] = "cuda"
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            info["devices"].append({"id": i, "kind": p.name,
                                    "memory_gb": round(p.total_memory / 1e9, 1),
                                    "compute_capability": f"{p.major}.{p.minor}"})
        info["memory_gb"] = info["devices"][0]["memory_gb"]
        smi = shutil.which("nvidia-smi")
        if smi:
            out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=30).stdout.strip()
            info["power_limit"] = out.splitlines()[0] if out else None
    else:
        info["platform"] = "cpu"
        info["devices"].append({"id": 0, "kind": "cpu"})
except Exception as e:
    info["error"] = f"{type(e).__name__}: {e}"
print(json.dumps(info))
"""


def probe_python() -> dict:
    return {
        "version": platform.python_version(),
        "executable": sys.executable,
        "in_venv": sys.prefix != getattr(sys, "base_prefix", sys.prefix),
    }


def _nvcc() -> str | None:
    """nvcc's release line, or None where there is no nvcc."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            out = subprocess.run([cand, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout
            lines = [ln for ln in out.splitlines() if "release" in ln]
            return lines[-1].strip() if lines else cand
    return None


def probe_accelerator(timeout_s: float = 120.0) -> dict:
    """The CUDA card, probed in a bounded subprocess; a failure, a hang or
    garbled output comes back as an ``error`` entry, never raised."""
    try:
        proc = subprocess.run([sys.executable, "-c", _ACCEL_PROBE], capture_output=True,
                              text=True, timeout=timeout_s)
        info = None
        for line in reversed(proc.stdout.strip().splitlines()):
            if line.startswith("{"):
                info = json.loads(line)
                break
        if info is None:
            err = (proc.stderr.strip().splitlines() or ["no probe output"])[-1]
            info = {"platform": None, "devices": [], "memory_gb": None, "error": err}
    except subprocess.TimeoutExpired:
        info = {"platform": None, "devices": [], "memory_gb": None,
                "error": f"device probe hung > {timeout_s:.0f} s"}
    except (OSError, json.JSONDecodeError) as e:
        info = {"platform": None, "devices": [], "memory_gb": None,
                "error": f"device probe failed: {e}"}
    info["nvcc"] = _nvcc()
    return info


def probe_dependencies() -> dict:
    deps = {}
    for mod in DEPENDENCIES:
        try:
            deps[mod] = getattr(importlib.import_module(mod), "__version__", "ok")
        except ImportError:
            deps[mod] = None
    return deps


def _meminfo_gb(key: str) -> float | None:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(key + ":"):
                    return round(int(line.split()[1]) * 1024 / 1e9, 1)
    except OSError:
        pass
    return None


def probe_system_resources() -> dict:
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    disk = shutil.disk_usage(REPO_ROOT)
    return {
        "os": f"{platform.system()} {platform.release()}",
        "cpu_count": os.cpu_count(),
        "ram_gb": round(total / 1e9, 1),
        "ram_available_gb": _meminfo_gb("MemAvailable"),
        "disk_free_gb": round(disk.free / 1e9, 1),
        "ffmpeg": shutil.which("ffmpeg") is not None,
    }


def compute_score(report: dict) -> tuple[int, list, list]:
    """The reference's scoring rules, the TPU read as the CUDA card."""
    score = 100
    recs, warns = [], []
    acc = report["accelerator"]
    if acc.get("error") or not acc.get("devices"):
        score -= 50
        warns.append("No CUDA card visible to torch — compute will run on CPU.")
    elif acc.get("platform") == "cpu":
        score -= 30
        recs.append("Running on the CPU; attach a CUDA card for production throughput.")
    sysres = report["system"]
    if sysres["ram_gb"] < 16:
        score -= 10
        warns.append("Less than 16 GB RAM — large-clip preprocessing may swap.")
    if sysres["disk_free_gb"] < 20:
        score -= 10
        warns.append("Less than 20 GB free disk — interval caches are PNG-heavy.")
    if not sysres["ffmpeg"]:
        recs.append("ffmpeg binary not found; video IO takes Y4M, and OpenCV (mp4v) for "
                    "other containers. Install ffmpeg for x264/NVENC-grade encoding.")
    missing = [k for k, v in report["dependencies"].items() if v is None]
    if missing:
        score -= 5 * len(missing)
        warns.append(f"Missing python deps: {', '.join(missing)}")
    py = report["python"]
    if tuple(int(x) for x in py["version"].split(".")[:2]) < (3, 10):
        score -= 20
        warns.append("Python >= 3.10 required.")
    return max(score, 0), recs, warns


def probe(timeout_s: float = 120.0) -> dict:
    """The whole report, score included."""
    report = {
        "python": probe_python(),
        "accelerator": probe_accelerator(timeout_s),
        "dependencies": probe_dependencies(),
        "system": probe_system_resources(),
    }
    score, recs, warns = compute_score(report)
    report["compatibility_score"] = score
    report["recommendations"] = recs
    report["warnings"] = warns
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m vfisr_tpu_torch.probe_system",
                                     description="Probe system compatibility")
    parser.add_argument("--json", action="store_true", help="Emit JSON")
    parser.add_argument("--probe-timeout", type=float, default=120.0,
                        help="seconds before the device probe is declared hung")
    args = parser.parse_args(argv)
    report = probe(args.probe_timeout)
    if args.json:
        print(json.dumps(report, indent=2))
        return 0
    print("=" * 60)
    print("SYSTEM PROBE")
    print("=" * 60)
    sysres, acc = report["system"], report["accelerator"]
    print(f"OS: {sysres['os']} | CPUs: {sysres['cpu_count']} | RAM: {sysres['ram_gb']} GB")
    if acc["devices"]:
        kinds = ", ".join(d["kind"] for d in acc["devices"])
        print(f"Accelerator: {acc['platform']} ({kinds}) x{len(acc['devices'])}"
              + (f", memory {acc['memory_gb']} GB" if acc.get("memory_gb") else "")
              + (f", {acc['power_limit']}" if acc.get("power_limit") else ""))
    else:
        print(f"Accelerator: NONE ({acc.get('error')})")
    print(f"torch {acc.get('torch_version')}, CUDA {acc.get('cuda_version')}, "
          f"nvcc: {acc.get('nvcc') or 'not found'}")
    print(f"Python: {report['python']['version']} (venv={report['python']['in_venv']})")
    deps = report["dependencies"]
    missing = [k for k, v in deps.items() if v is None]
    print(f"Dependencies: {len(deps) - len(missing)}/{len(deps)} present"
          + (f" (missing: {', '.join(missing)})" if missing else ""))
    for w in report["warnings"]:
        print(f"  [warn] {w}")
    for r in report["recommendations"]:
        print(f"  [rec]  {r}")
    print(f"\nCompatibility score: {report['compatibility_score']}/100")
    return 0


if __name__ == "__main__":
    sys.exit(main())
