"""The triplet benchmark (port of ``vfisr_tpu/harness/triplet.py``).

Per model and clip: warm-up calls (kernel builds, cuDNN's plans), then per
triplet ``model.process_pair`` -> quality against the ground-truth
intermediates (``QualityEvaluator``: PSNR, SSIM, LPIPS) -> the mean, std,
min, max and percentiles, and ``throughput_fps = 1000 / mean_ms * 5`` (two
endpoints and three intermediates per pair). The output is
``benchmark_results.json`` in the reference's schema.

Frames are PNG, read and written with ``data/png.py`` (no OpenCV). A
failure anywhere in a model's run, a triplet's included, becomes that
(clip, model)'s ``{"error": ...}`` row: no metric is made up in its place.
"""

from __future__ import annotations

import gc
import json
from dataclasses import asdict
from datetime import datetime
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from vfisr_tpu_torch.data.png import read_png, write_png
from vfisr_tpu_torch.evaluation.metrics import QualityEvaluator, safe_round
from vfisr_tpu_torch.models.base import reset_peak
from vfisr_tpu_torch.models.registry import get_available_models


def load_image(path) -> np.ndarray:
    """A PNG as HWC uint8 RGB (FileNotFoundError where there is none)."""
    return read_png(path)


def load_clip_data(clip_dir: Path) -> dict:
    clip_dir = Path(clip_dir)
    with open(clip_dir / "metadata.json") as f:
        metadata = json.load(f)
    with open(clip_dir / "triplets.json") as f:
        triplets = json.load(f)
    return {
        "metadata": metadata,
        "triplets": triplets,
        "input_dir": clip_dir / "input_1080p30" / "frames",
        "gt_dir": clip_dir / "ground_truth" / "frames",
    }


def _aggregate(values: List[float]) -> dict:
    values = [v for v in values if v is not None and np.isfinite(v)]
    if not values:
        return {"mean": None}
    return {
        "mean": float(np.mean(values)),
        "std": float(np.std(values)),
        "min": float(np.min(values)),
        "max": float(np.max(values)),
        "p50": float(np.percentile(values, 50)),
        "p95": float(np.percentile(values, 95)),
        "p99": float(np.percentile(values, 99)),
    }


def run_model_benchmark(
    model,
    clip_data: dict,
    evaluator: QualityEvaluator,
    max_triplets: Optional[int] = None,
    save_outputs: bool = False,
    output_dir: Optional[Path] = None,
    verbose: bool = True,
) -> dict:
    """One model on one clip. Raises on a triplet that fails (a frame that
    does not load, a model or evaluator error, an intermediate count other
    than the ground truth's)."""
    triplets = clip_data["triplets"]
    if max_triplets:
        triplets = triplets[:max_triplets]
    input_dir, gt_dir = clip_data["input_dir"], clip_data["gt_dir"]
    num_intermediate = triplets[0]["num_intermediate"] if triplets else 3
    target_scale = clip_data["metadata"]["spatial_scale"]

    quality_results, speed_results = [], []
    for triplet in triplets:
        frame0 = load_image(input_dir / triplet["input_frame_0"])
        frame1 = load_image(input_dir / triplet["input_frame_1"])
        result = model.process_pair(frame0, frame1, num_intermediate=num_intermediate,
                                    target_scale=target_scale)
        gt_frames = [load_image(gt_dir / name) for name in triplet["gt_intermediate"]]
        pred_intermediate = result.frames[1:-1]
        if len(pred_intermediate) != len(gt_frames):
            raise ValueError(f"triplet {triplet['triplet_id']}: predicted "
                             f"{len(pred_intermediate)} frames, GT has {len(gt_frames)}")
        quality_results.append(evaluator.evaluate(pred_intermediate, gt_frames).to_dict())
        speed_results.append({"inference_time_ms": result.inference_time_ms,
                              "vram_peak_mb": result.vram_peak_mb})
        if save_outputs and output_dir:
            tdir = Path(output_dir) / f"triplet_{triplet['triplet_id']:04d}"
            tdir.mkdir(parents=True, exist_ok=True)
            for i, frame in enumerate(result.frames):
                write_png(tdir / f"frame_{i:02d}.png", frame)

    if not quality_results:
        return {"error": "No successful evaluations"}

    times = [r["inference_time_ms"] for r in speed_results]
    vram = [r["vram_peak_mb"] for r in speed_results]
    return {
        "model": model.info.name,
        "model_info": asdict(model.info),
        "num_triplets": len(quality_results),
        "quality_summary": {
            "psnr": _aggregate([q["psnr"] for q in quality_results]),
            "ssim": _aggregate([q["ssim"] for q in quality_results]),
            "lpips": _aggregate([q["lpips"] for q in quality_results]),
        },
        "speed_summary": {
            "time_ms": {
                "mean": float(np.mean(times)),
                "std": float(np.std(times)),
                "p50": float(np.percentile(times, 50)),
                "p95": float(np.percentile(times, 95)),
                "p99": float(np.percentile(times, 99)),
            },
            "vram_mb": {"mean": float(np.mean(vram)), "max": float(np.max(vram))},
            # 5 output frames per pair (2 endpoints + 3 intermediates)
            "throughput_fps": 1000 / np.mean(times) * 5 if times else 0,
        },
        "quality_per_triplet": quality_results,
        "speed_per_triplet": speed_results,
    }


def merge_benchmark_outputs(prev, fresh: dict) -> dict:
    """A targeted re-run's rows merged into a prior benchmark_results
    payload, as a new dict (prev is left as it was): fresh rows replace the
    same (clip, model) rows, every other row of prev stays. The timestamp
    stays prev's (it labels most rows); merged_models and merged_at record
    the re-run. Without a valid prev, fresh is returned."""
    if not (isinstance(prev, dict) and isinstance(prev.get("results"), dict)):
        return fresh
    merged = {clip: dict(per_model) for clip, per_model in prev["results"].items()}
    for clip_name, per_model in fresh["results"].items():
        merged.setdefault(clip_name, {}).update(per_model)
    out = dict(prev)
    out["results"] = merged
    out["models"] = sorted(set(prev.get("models", [])) | set(fresh["models"]))
    out["lpips_mode"] = fresh.get("lpips_mode", prev.get("lpips_mode"))
    out["merged_models"] = fresh["models"]
    out["merged_at"] = fresh["timestamp"]
    return out


def run_benchmarks(
    data_dir: str,
    output_dir: str,
    models: str = "all",
    clips: str = "all",
    max_triplets: Optional[int] = None,
    save_outputs: bool = False,
    warmup: int = 3,
    merge: bool = False,
    device: str = "cuda",
) -> dict:
    """Every selected model on every clip of data_dir, on ``device`` (TF32
    off), into ``output_dir/benchmark_results.json``. ``merge``: update the
    selected rows of an existing file instead of replacing it. Each model's
    peak memory is its own (``reset_peak`` after its warm-up)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    data_dir, output_dir = Path(data_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    available = get_available_models()
    if models == "all":
        models_to_test = list(available)
    else:
        models_to_test = [m.strip() for m in models.split(",")]
        unknown = [m for m in models_to_test if m not in available]
        if unknown:
            raise SystemExit(f"Error: unknown model(s) {unknown}; available: {sorted(available)}")

    clip_dirs = sorted(d for d in data_dir.iterdir() if (d / "triplets.json").exists())
    if clips != "all":
        wanted = {c.strip() for c in clips.split(",")}
        clip_dirs = [d for d in clip_dirs if d.name in wanted]
    if not clip_dirs:
        raise SystemExit(f"No preprocessed clips found in {data_dir}")

    evaluator = QualityEvaluator(device)
    all_results = {}
    for clip_dir in clip_dirs:
        clip_name = clip_dir.name
        print(f"\nClip: {clip_name}")
        clip_data = load_clip_data(clip_dir)
        print(f"  Triplets: {len(clip_data['triplets'])}")
        print(f"  Target scale: {clip_data['metadata']['spatial_scale']:.2f}x")
        all_results[clip_name] = {}
        for model_name in models_to_test:
            print(f"\n  Model: {model_name}")
            model = None
            try:
                model = available[model_name](device=device)
                print("    Loading...")
                model.ensure_loaded()
                if warmup > 0 and clip_data["triplets"]:
                    print(f"    Warming up ({warmup} iterations)...")
                    t0 = clip_data["triplets"][0]
                    f0 = load_image(clip_data["input_dir"] / t0["input_frame_0"])
                    f1 = load_image(clip_data["input_dir"] / t0["input_frame_1"])
                    for _ in range(warmup):
                        model.process_pair(f0, f1, num_intermediate=t0["num_intermediate"],
                                           target_scale=clip_data["metadata"]["spatial_scale"])
                mdir = output_dir / "model_outputs" / clip_name / model_name if save_outputs else None
                reset_peak()  # this model's run only: the warm-up absorbed the builds
                result = run_model_benchmark(model, clip_data, evaluator,
                                             max_triplets=max_triplets,
                                             save_outputs=save_outputs, output_dir=mdir)
                all_results[clip_name][model_name] = result
                if "error" not in result:
                    q, s = result["quality_summary"], result["speed_summary"]
                    print(f"    PSNR: {q['psnr']['mean']:.2f} dB | LPIPS: {q['lpips']['mean']:.4f}")
                    print(f"    Time: {s['time_ms']['mean']:.1f} ms | "
                          f"Throughput: {s['throughput_fps']:.1f} fps")
                else:
                    print(f"    Error: {result['error']}")
            except Exception as e:  # the (clip, model) row records it; the sweep goes on
                print(f"    Failed: {e!r}")
                all_results[clip_name][model_name] = {"error": str(e)}
            finally:
                # the next model's peak is its own, not the union with this one's
                del model
                gc.collect()

    output = {
        "timestamp": datetime.now().isoformat(),
        "data_dir": str(data_dir),
        "models": models_to_test,
        "lpips_mode": evaluator.lpips_mode,
        "results": all_results,
    }
    results_path = output_dir / "benchmark_results.json"
    if merge and results_path.exists():
        try:
            prev = json.loads(results_path.read_text())
        except (OSError, json.JSONDecodeError):
            prev = None
        output = merge_benchmark_outputs(prev, output)
    with open(results_path, "w") as f:
        json.dump(output, f, indent=2, default=str)
    print(f"\nResults saved to {results_path}")

    print("\n" + "=" * 76)
    print(f"{'Clip':<20}{'Model':<18}{'PSNR':>8}{'SSIM':>8}{'LPIPS':>8}{'ms':>8}{'fps':>6}")
    print("-" * 76)
    for clip_name, per_model in all_results.items():
        for model_name, r in per_model.items():
            if "error" in r:
                print(f"{clip_name:<20}{model_name:<18}  error: {r['error'][:38]}")
                continue
            q, s = r["quality_summary"], r["speed_summary"]
            print(f"{clip_name:<20}{model_name:<18}"
                  f"{safe_round(q['psnr']['mean'], 2)!s:>8}"
                  f"{safe_round(q['ssim']['mean'], 4)!s:>8}"
                  f"{safe_round(q['lpips']['mean'], 4)!s:>8}"
                  f"{s['time_ms']['mean']:>8.1f}{s['throughput_fps']:>6.1f}")
    print("=" * 76)
    return output
