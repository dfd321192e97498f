"""The experiment sweep's CLI (port of ``scripts/run_experiments.py``).

    python -m vfisr_tpu_torch.run_experiments --clip ID [--intervals 0,1] [--heavy]
    python -m vfisr_tpu_torch.run_experiments --raw clip.y4m --experiment lanczos_blend

Cached mode reads ``<data-dir>/clips/<ID>/intervals/interval_%04d/`` (PNG
keyframes and midpoints, ``meta.json``); legacy mode (``--raw``) extracts
them from a video (Y4M without OpenCV). Results go to
``<output-dir>/experiment_results.json`` and its log; ``--write-videos``
writes ``<output-dir>/videos/<name>_i<interval>.y4m``. Runs on ``--device``
(``cuda`` by default; ``cpu`` for small runs) with TF32 off.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run VFI+SR experiments on cached intervals")
    parser.add_argument("--clip", default=None, help="Registered clip id (cached mode)")
    parser.add_argument("--raw", default=None, help="Raw video path (legacy mode)")
    parser.add_argument("--start", type=float, default=0.0,
                        help="Legacy mode: start offset seconds")
    parser.add_argument("--duration", type=float, default=5.0,
                        help="Legacy mode: clip duration seconds")
    parser.add_argument("--intervals", default="0",
                        help="Comma-separated interval indices (default: 0)")
    parser.add_argument("--experiment", default=None,
                        help="Experiment name(s), comma-separated (default: all light)")
    parser.add_argument("--heavy", action="store_true", help="Include heavy (RIFE) experiments")
    parser.add_argument("--quality-test", action="store_true",
                        help="Run core experiments across all quality levels")
    parser.add_argument("--resume", action="store_true",
                        help="Skip (name, interval) pairs already in the checkpoint")
    parser.add_argument("--replace", action="store_true",
                        help="Re-run exactly the selected (experiment, interval) rows in place, "
                        "keeping all other checkpoint rows (targeted refresh)")
    parser.add_argument("--write-videos", action="store_true", help="Write output videos (Y4M)")
    parser.add_argument("--max-frames", type=int, default=None,
                        help="Cap keyframes per interval (quick tests)")
    parser.add_argument("--no-lpips", action="store_true", help="Skip LPIPS sampling")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--output-dir", default="outputs")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu (small runs)")
    args = parser.parse_args(argv)

    import torch

    from vfisr_tpu_torch.harness.experiments import (
        CORE_HEAVY,
        CORE_LIGHT,
        EXPERIMENTS,
        HEAVY_EXPERIMENTS,
        LIGHT_EXPERIMENTS,
        ExperimentCheckpoint,
        drop_rows,
        generate_quality_experiments,
        generate_reference,
        run_experiment,
        run_experiment_sweep,
        summarize,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.quality_test:
        experiments = generate_quality_experiments(CORE_LIGHT + (CORE_HEAVY if args.heavy else []))
    elif args.experiment:
        names = [n.strip() for n in args.experiment.split(",") if n.strip()]
        experiments = [e for e in EXPERIMENTS if e["name"] in names]
        missing = set(names) - {e["name"] for e in experiments}
        if missing:
            raise SystemExit(f"Unknown experiment(s) {sorted(missing)}; "
                             f"known: {', '.join(e['name'] for e in EXPERIMENTS)}")
    else:
        experiments = LIGHT_EXPERIMENTS + (HEAVY_EXPERIMENTS if args.heavy else [])

    if args.raw:
        keyframes, midpoints = generate_reference(args.raw, args.start, args.duration,
                                                  device=args.device)
        out_dir = Path(args.output_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        checkpoint = ExperimentCheckpoint(out_dir / "experiment_results.json")
        # rows of a raw video carry a clip_id of their own, so they never
        # collide with (or, under --replace, drop) a cached clip's rows
        raw_clip_id = f"raw_{Path(args.raw).stem}"
        if args.replace:
            checkpoint.data["experiments"] = drop_rows(
                checkpoint.data.get("experiments", []), [e["name"] for e in experiments], [0],
                clip_id=raw_clip_id)
            checkpoint.save()
        done = checkpoint.completed_keys() if args.resume else set()
        for experiment in experiments:
            if (raw_clip_id, experiment["name"], 0) in done:
                print(f"  [skip] {experiment['name']} (done)")
                continue
            print(f"  Running {experiment['name']} (legacy mode)...")
            result = run_experiment(keyframes[: args.max_frames or None], midpoints, experiment,
                                    verbose=False, device=args.device)
            result["interval_idx"] = 0
            result["clip_id"] = raw_clip_id
            result["source"] = args.raw
            checkpoint.append(result)
            print(f"    VFI_PSNR: {result['vfi_psnr_db']} | {result['time_s']}s")
        print("\n" + summarize(checkpoint.data))
        return
    if not args.clip:
        raise SystemExit("need --clip (cached mode) or --raw (legacy mode)")
    results = run_experiment_sweep(
        clip_id=args.clip,
        intervals=[int(i) for i in args.intervals.split(",")],
        experiments=experiments,
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        resume=args.resume,
        replace=args.replace,
        write_videos=args.write_videos,
        max_frames=args.max_frames,
        use_lpips=not args.no_lpips,
        device=args.device,
    )
    print("\n" + summarize(results))


if __name__ == "__main__":
    main()
