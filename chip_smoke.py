"""Smoke run of the PyTorch port (vfisr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA card, nvcc (CUDA_HOME or PATH) and the repository's
vfisr_tpu_torch/ and weights/ beside this file; no network. It

1. prints the card's name and power limit (nvidia-smi);
2. builds the windowed-warp kernels (csrc/warp_windowed.cu, and
   csrc/warp_tiled.cu for step 27) with nvcc, one process per source;
3. loads FlagshipVFI(device="cuda") with weights/rife.npz (full-width RIFE,
   bf16 deploy config) and weights/router_gate.json;
4. drives the flagship fused step (fused_stream_step) over a stream of
   synthetic 1920x1080 gameplay frames (gradient, moving textured
   rectangle, static HUD box) to 2560x1440 uint8, with the kernel's launch
   count set to 0 before and read after (18 launches per pair), and with
   the wrapper's torch-op origin table (``window_origins``) swapped for a
   function that raises: the kernels compute their origins themselves;
5. checks the outputs: shapes and dtypes, the endpoint frame against its
   own upscale, the midpoints beating frame duplication against the
   synthetic scene's true in-between frames, and one pair against the same
   step with the kernel's plain PyTorch twin substituted;
6. holds the kernel against its plain twin at every launch of a pair of the
   main path (the inputs recorded as the path made them) and at synthetic
   cases of each launch shape, a constant border and a flow that leaves
   the window (tolerance 1e-5 in f32 windows, 2/255 in bf16 windows, both
   relative to the largest magnitude when it exceeds 1); holds the window
   origins the kernels compute (``kernel_origins``) equal to
   ``window_origins`` at each of those launches; and holds origins, K1 and
   K2 at the origin's edge cases (tile means on .5 after scaling by t,
   +-300 px flows, 1080 and 270 rows, a t per image, odd bf16 row origins,
   the constant border);
7. times the step (CUDA events, after warm-up), each of its stages alone,
   and, per launch shape, the kernel alone with its origin (CUDA-graph
   replay: device time), the wrapper's host time per call (enqueue, no
   synchronisation), the wrapper as the path calls it (CUDA events), the
   plain twin and torch's grid_sample (a yardstick only);
8. trains full-width RIFE (weights/rife.npz, taken for training) on
   synthetic scenes made on the card (batch 16, crop 192, detail 0.35, lr
   2e-4, remat), through the trainer's own entry points: one recorded
   step with both kernels' launch counts set to 0 before and read after
   (10 warp launches: 2 for the data, 4 in the forward, 4 in its
   recompute; 4 launches of the warp's flow-gradient kernel K2) and
   ``window_origins`` raising, the kernels' origins held equal to it at
   all 14 launches, K2 held
   against its plain twin at every recorded launch and at synthetic cases
   of each launch shape (constant border, flows past the radius, zero and
   integer flows), K1 at the training's launches, the whole step's loss
   and gradients with the kernels against the same step with both plain
   twins, TRAIN_STEPS timed steps with finite losses (ms/step, samples/s,
   peak memory), a save_npz/load round trip in a temporary directory, and
   per launch shape the kernels alone (CUDA-graph replay), the wrappers'
   host time, their bounds, plain twins and torch's grid_sample (forward,
   and its grid gradient for K2) as yardsticks;
9. loads the adaptive model through the registry, get_model("adaptive",
   load=True), with weights/rife.npz (full-width RIFE, f32, bf16 warp
   windows), weights/vfimamba.npz (d_model 256, 12 blocks, d_state 16, two
   refinement levels) and weights/router_gate.json by explicit path (strict;
   every parameter checked against its file; VFIMamba must stay enabled),
   and streams a 1920x1080 sequence with a static HUD through
   AdaptivePipeline.interpolate_batch (hosted), one pair per call: five 3 px
   pans fill the HUD ring, then a static pair, a 3 px pan, an 8 px pan and a
   cut, with K1's count set to 0 before and read after and
   ``window_origins`` raising. Checks: each pair's route equals bin_winner
   of its measured motion_mean (its K1 launches, 17 for RIFE, 19 for
   VFIMamba, 13 for a cut, say which expert ran), rife, vfimamba and
   scene_change all hit; HUD pixels equal their source where the composite
   applies and the cut's midpoints are its x0 elsewhere; the moving
   midpoints beat frame duplication; K1 and its origins at every launch
   against the twin and window_origins; the whole sequence with the kernel
   against it with the plain twin (2/255) and masked against hosted (1e-5),
   under deterministic cuDNN. Then process_pair once (5 frames at 2560x1440
   uint8), and the times: ms per pair and route, the analysis, RIFE and
   VFIMamba alone (the selective scan's share of VFIMamba), peak memory,
   VFIMamba's decoder conv with and without cuDNN, and K1 per launch shape
   as in step 7;
10. loads SAFA through the registry, get_model("safa", load=True)
   (weights/safa.npz, c 176, 8 decoder blocks; every parameter checked
   against the file; TF32 off after load), and runs three 1920x1080 pairs of
   step 9's scene (static, 3 px pan, 8 px pan) through
   SAFAModel.interpolate_batch with 3 midpoints: 12 tiles of 360x480 with
   48 px of context, each a batch-3 forward whose 6 feature warps
   ([3,114,144,176], K1 in channel groups) and 2 frame warps
   ([3,456,576,3]) go through K1: 96 launches per pair, counted with
   ``window_origins`` raising. Checks: finite [0, 1] frames; K1 against its
   twin and its origins at all 96 launches of a pair; the feature launches'
   plans take channel groups; the pair with the kernel against it with the
   plain twin (deterministic cuDNN, 1e-5); joint_process at 1.333 once (5
   frames at 2560x1440 uint8). Prints ms per pair, ms per tile forward and
   its conv FLOP, peak memory over resident, each distinct conv shape of a
   tile with cuDNN's heuristic plan and with cuDNN off, K1 per launch shape
   as in step 7 (for the feature warps in channel groups also a line with
   the kernel, its bound, grid_sample beside it and the plan), and the
   midpoints' PSNR against the scene's true frames and against frame
   duplication (printed only);
11. SPAN: get_model("span", load=True) (x2, weights/span_x2.npz, every
   parameter checked) upscales 4 frames of the scene 1920x1080 -> 2560x1440
   (ms, PSNR against Lanczos4, its conv shapes as in step 10);
   SPANModel(scale=4) once from 960x540; get_model("rife_span",
   load=True).process_pair once on a 1080p pair; and
   AdaptivePipeline(sr_model_name="span") runs interpolate_batch and
   upscale_batch on one pair (its SR equal to SPAN's);
12. holds K1 in channel groups against its twin at C in GROUPED_C, f32 and
   bf16 windows, both borders, at SAFA's feature shape (in step 6's phase),
   and shows that every K1 launch of steps 4, 8 and 9, and every K2 launch
   of step 8, keeps the whole-C layout (one channel group);
13. trains full-width SAFA (weights/safa.npz, taken for training; TF32 off)
   as ``python -m vfisr_tpu_torch.train --model safa`` does at its defaults:
   batch 16, crop 192 (scenes made on the card at 384, the endpoints
   area-resized to 192, the midpoint supervised at 384; the trainer's own
   ``batch_maker``), lr 2e-4, remat. One recorded step with both kernels'
   counts set to 0 before and read after and ``window_origins`` raising:
   18 K1 launches (12 feature warps [16,48,48,176] in channel groups, 4
   frame warps and 2 data warps whole-C), 6 K2 launches (4 feature warps in
   channel groups at 176 channels, 2 frame warps whole-C), 6 shifted
   adjoints (the features' gradient). Checks: origins at all 24 launches;
   K2 against its twin at every launch and at synthetic cases of each
   shape (1e-5 of the largest |cg| with f32 windows); K1 against its twin
   at every launch; each grouped K2 launch twice, bit-identical, and in
   one chunk per tile (one launch per call, no scratch); the whole
   step with the kernels against the same step with both plain twins
   (deterministic cuDNN; loss 1e-5 relative, gradients 1e-4 of each
   tensor's largest). Then SAFA_TRAIN_STEPS timed steps, counted (ms/step,
   samples/s, peak memory), the shifted adjoint per call at the step's own
   inputs and its share of a step, the adjoint and the step again with
   every offset of the radius instead of the offsets that the
   displacements' range (read back to the host) lets reach (the same
   values; timed steps with the read-back, every offset, the read-back
   again), every conv shape of a step forward and
   backward with cuDNN's plan and without (the path's forward choice
   printed), and per launch shape the kernels alone (CUDA-graph replay),
   their wrappers, bounds, plain twins and grid_sample (its grid gradient
   for K2), and for each launch shape in channel groups a line with the
   kernel, its bound, the library call and the plan;
14. trains SPAN x2 and x4 (weights/span_x2.npz, span_x4.npz) as the trainer
   does (``make_sr_train_step``, crisp scenes at 192, the input
   area-resized to 96 or 48; batch 16, no remat): SPAN_TRAIN_STEPS timed
   steps each (ms/step, samples/s, peak memory, no warp launched) and the
   conv table as in step 13;
15. streams a video through the port's entry point, process_video
   (pipeline/streaming.py), with the flagship: 13 frames of step 4's
   scene at 1920x1080 written to a 30 fps Y4M (the port's writer, in a
   temporary directory), process_video(method="flagship", target_fps=120,
   target_resolution=(2560, 1440)) with K1's count set to 0 before and
   read after and ``window_origins`` raising. Checks: the model the
   registry built holds every parameter of weights/rife.npz and the
   calibrated gate; the fused writer thread, yuv420 readback, 49 frames
   out, 18 K1 launches per pair; each pair's four frames read back from
   the output Y4M bit-equal to pack_i420(fused_stream_step(...)) computed
   directly on the decoded frames with the HUD history carried (K1
   against its twin and its origins at every launch of that), the final
   endpoint likewise; every midpoint above frame duplication against the
   rendered truth (PSNR over I420 bytes). Prints interpolated fps (3 x
   pairs / elapsed), realtime_x, every stage timer, and I420 -> RGB of a
   1080p frame on the host (VideoReader.read) and on the card (the
   stream's way);
16. streams step 9's sequence (pans, a static pair, a cut) as a 30 fps
   Y4M through process_video with the default model (method=None:
   get_model("adaptive", load=True)). Checks: full-width RIFE and VFIMamba
   holding every parameter of their files, a calibrated gate; each pair
   routed to bin_winner of its motion, every route hit, K1's launches
   equal to the routes' sum; the HUD and cut composites as in step 9;
   37 frames out. Prints fps and the timers as step 15;
17. evaluates with the evaluation library (vfisr_tpu_torch/evaluation/) on
   the card: EVAL_FRAMES (5) frames of step 4's 1920x1080 scene (its rectangle moving 8 px
   per frame under the HUD box) as ground truth, the odd ones interpolated
   from their neighbours by get_model("adaptive", load=True) (t = 0.5) as
   the prediction. With K1's count set to 0 before and read after and
   ``window_origins`` raising: QualityEvaluator("cuda").evaluate,
   evaluate_flolpips, evaluate_temporal_consistency,
   run_comprehensive_benchmark and detect_ui_regions (12 K1 launches per
   Farneback flow at 1080p, 4 flows per pair: 192). Checks: the launch
   count; QualityEvaluator leaves TF32 off; LPIPS in its calibrated-heads
   mode; finite metrics in range, PSNR inf at the endpoints and above 20 dB
   at the midpoints, the frame counts, UI masks covering the HUD; PSNR
   (1e-3 dB), SSIM, MS-SSIM, ssim_global (1e-4) and LPIPS (1e-4 relative)
   of each interpolated frame on the card against the same functions with
   device="cpu"; canny (two threshold pairs, with its iteration count) and
   the UI mask of two frames equal on both; K1 against its twin and its
   origins at every recorded launch. Prints ms per 1080p frame of each
   metric and of compute_optical_flow (evaluation/speed.py's measure: CUDA
   events), the whole sequence's evaluation and peak memory, the LPIPS
   AlexNet's conv lines (time_convs), and K1 per launch shape as in step 7;
18. runs the port's bench, vfisr_tpu_torch.bench.measure at its defaults
   (5 + 50 pairs of fused_stream_step 1080p -> 1440p, CUDA events per
   pair): once with 5 + BENCH_CHECK_PAIRS (10) pairs and every K1 launch
   held against its twin and its origins as it goes, then at its defaults
   counted with ``window_origins`` raising (18 K1
   launches per pair). Prints its record on an earlier line; requires a
   finite, positive value, 3000 / the median ms per pair;
19. runs the experiment sweep (harness/experiments.py, harness/device_sweep.py)
   on an interval made on the card: 11 keyframes of step 9's 1920x1080 scene
   (plane waves under a static HUD) panning SWEEP_PANS px per pair, their 10
   true midpoints, written as PNG (data/png.py) into a temporary
   clips/<id>/intervals/interval_0000/{keyframes,midpoints} with a
   meta.json and read back bit-equal by load_interval. The pans are chosen
   from weights/router_gate.json's 'sweep' bins. run_experiment_sweep over
   all 19 experiments at the default quality (2560x1440, 90 fps) with LPIPS
   (calibrated heads), full-width RIFE f32 (weights/rife.npz) and VFIMamba
   (weights/vfimamba.npz): once with every K1 launch held against its twin
   and its origins as it goes (the bench's _checking), then counted with
   ``window_origins`` raising and timed. Checks: 19 rows, none FAILED, 41
   frames each, 10 VFI frames evaluated and 1 LPIPS sample where VFI is
   evaluated, K1 launched by every method with a flow or RIFE and by no
   blend; each adaptive tier's expert_mix and rife_frames_pct equal to its
   threshold rule on the pairs' motions recomputed with _motion_chunk, and
   to bin_winner('sweep', ...) among rife, rife_fast and vfimamba for the
   quality-aware tier; adaptive_default both blends and takes RIFE, and
   adaptive_aggressive takes every expert the gate can give; on the first 5
   keyframes, run_experiment_batched against the per-frame run_experiment
   on the card for 8 experiments within the reference's tolerances (0.35
   dB / 0.01 SSIM for the blends, 1.0 dB for optical flow, 1.5 dB / 0.02 for
   UAFI, UGHI and MCAR), their K1 launches checked; a write_videos run of
   lanczos_blend_edge whose Y4M reads back as 41 frames at 2560x1440; ``python
   -m vfisr_tpu_torch.run_experiments`` as a subprocess (lanczos_blend_edge and
   rife_fast on 3 keyframes, on the card by default) writing its 2 rows.
   Prints per experiment time_s, fps_achieved, realtime_x, the PSNR, SSIM
   and LPIPS fields, expert_mix and its K1 launches per shape; the sweep's
   time and peak memory; RIFE per chunk at native scales 1.0 and 0.5; one
   _chunk_program per method (CUDA events); K1 per launch shape as in step
   7;
20. runs the triplet benchmark (harness/triplet.py) on a temporary
   processed clip: 3 input frames of step 9's scene at 1920x1080 panning 4
   px per frame, ground truth rendered at 2560x1440 at t = 0.25/0.5/0.75
   (3 per triplet), metadata.json with spatial_scale 1.3333, 2 triplets.
   run_benchmarks(models="lanczos,rife,adaptive,safa", warmup=1) once with
   every K1 launch (whole-C and grouped) checked as it goes, then counted
   with ``window_origins`` raising. Checks: no error row, 2 triplets per
   model, finite quality. Prints per model PSNR, SSIM, LPIPS, time_ms mean
   and p50, throughput_fps and vram_mb; then ``python -m
   vfisr_tpu_torch.benchmark -m lanczos --max-triplets 2`` as a subprocess,
   and a ``--merge`` run of bicubic that keeps its row; K1 per launch shape;
21. runs the dataset pipeline ("ingest": data/, its CLIs, analysis/) on a
   source clip made on the card: INGEST_FRAMES frames of step 9's scene at
   2560x1440 packed with pack_i420 into a 120 fps Y4M in a temporary
   data/raw/, panning 0, 2 and 8 px per frame over the three intervals that
   extract_intervals(count=3, duration=0.1) places (the pan's change points
   from the port's placement code: the floor of int(start_s * fps) puts them
   at source frames 0, 13 and 27). ``python -m vfisr_tpu_torch.register_clip``
   (the entry's size, fps, frames and duration checked); the 3 intervals
   extracted at 1920x1080 in-process on the card, once with every K1 launch
   (Farneback at 960x540 and its pyramid) held against its twin and its
   origins as it goes, then counted with ``window_origins`` raising and
   timed. Checks: 6/6, 7/6 and 7/6 keyframes/midpoints; interval 1's first
   two keyframes within 1 LSB of the CPU's crop and Lanczos4 of the
   host-decoded frames, its first pair's motion stats within rel 1e-3 of the
   CPU's; the static interval STATIC and mean_flow rising with the pan;
   each meta.json's difficulty that of its mean_flow; ``python -m
   vfisr_tpu_torch.validate_intervals`` on all three (exit 0) and
   list_intervals listing them. Each stage of a frame alone (decode,
   upload, I420 -> RGB, crop and Lanczos4, read-back, PNG encode beside
   zlib's default strategy on unfiltered rows; Farneback per pair by CUDA
   events). Then ``python -m vfisr_tpu_torch.preprocess_video`` (30 -> 120
   fps, input 1920x1080, ground truth 2560x1440), timed by its own print:
   10 input and 40 GT frames, 9 triplets equal to the reference's formula,
   each GT PNG equal to its decoded source frame. run_benchmarks(models="lanczos,rife") on that
   clip, its K1 launches checked as they go: 9 triplets per model, no error
   row. ``python -m vfisr_tpu_torch.run_full_benchmark`` (light experiments,
   all 3 intervals, --max-frames INGEST_FULL_KEYFRAMES): 12 rows per interval, none FAILED; analyze_statistics,
   normalize_data and final_analysis on its results, uafi_default and
   ughi_default with n = 3 paired intervals. ``python -m
   vfisr_tpu_torch.evaluate_quality --comprehensive`` on interval 1's
   keyframes against its midpoints. Prints each stage's seconds, fps of
   extraction and of preprocessing, peak memory, each interval's mean_flow
   against its known displacement, and K1 per launch shape;
22. trains on step 21's processed clip ("training data": 9 triplets, 27
   entries, 1920x1080 inputs, 2560x1440 ground truth; the directory lives
   until this step ends), all in this process. TripletCropDataset's first
   batch on the card (16 crops of 192^2, t 0.25/0.5/0.75): every crop, GT
   and t equal to the CPU's read_png, area resize and crop at a fresh
   random.Random(seed) replay of its draws, and read_png ms per 1080p and
   per 1440p frame. Then the trainer's run() at full width, batch 16, crop
   192: ``--model rife --data <clip> --steps 2``, and ``--data-source
   host`` for rife (4 steps: a fresh batch, then three augmented), span_x4
   (2) and safa (2); every K1 and K2 launch held against its twin (and K1's
   origins against window_origins) as it goes, counted with
   ``window_origins`` raising (8 K1 and 4 K2 per RIFE step, 16 and 6 per
   SAFA step: no data warps), finite losses, a checkpoint each; prints ms
   per step and the step loop's wait on the producer's queue per step, and
   synthetic_batch and augment_vfi_batch ms at batch 16, crop 192.
   eval_vfi_quality and eval_sr_quality (both scenes; --samples EVAL_CLI_SAMPLES) on
   the card (their tables; every PSNR and SSIM finite; the SR models
   launch no warp). gate_checkpoint on copies in a temporary directory: the
   2-step --data checkpoint as the candidate against a copy of
   weights/rife.npz as --incumbent-weights, --samples 8: its record, and
   the file at --weights afterwards byte-equal to whichever scored higher.
   No file under weights/ is written or moved. K1 and K2 per launch shape
   over the whole step.
23. calibrates on the card ("calibration"), in this process: renders a
   hard and a routing clip of 1 s at 1920x1080, 60 fps (``python -m
   vfisr_tpu_torch.make_synthetic_clip``, seeds 431 and 432) into a temporary
   directory, each 60 frames, the hard clip's HUD box equal in every frame,
   no two consecutive routing frames equal, and prints ms per frame of the
   textures, the composite and the Y4M write; runs ``calibrate_router`` on
   them at quality 2560x1440 with full-width RIFE and VFIMamba (``--pairs 4
   --stride 4 --native-pairs 4 --samples 4 --scene-worlds 2 --scene-seconds
   1``, ``--out`` in the temporary directory), every K1 launch held against
   its twin with equal origins as it goes, counted with ``window_origins``
   raising; prints each calibrated value beside the shipped file's (experts'
   dB, crossover px, ``warped_ssim_threshold``, bins: measurements, not
   gates); loads the file it wrote with ``FlagshipVFI.load(gate_path=...)``
   and ``get_model("adaptive", gate_path=...)`` and runs one 1080p pair of the
   hard clip through each; runs ``calibrate_lpips`` at its defaults (48
   patches, 600 steps) and requires the JAX package's pins on its pinned
   sets: held-out 2AFC >= 0.85, mean within-family Spearman >= 0.9, each
   family >= 0.6 (the shipped heads' numbers beside them). No file under
   weights/ is written. K1 per launch shape over the whole step.
24. trains VFIMamba and VFIMamba-S on the card at the trainer's defaults
   (batch 16, crop 192, scenes made on the card, lr 2e-4; each
   BiMambaBlock recomputed in the backward pass, ``MambaConfig.remat``, and
   no whole-forward remat, as scripts/train.py trains them): VFIMamba from
   weights/vfimamba.npz, VFIMamba-S from its seeded init (its file is not
   in the chip copy). Per model: the f32 conv shapes of a step forward and
   backward with cuDNN's plan and without (``time_convs``), before any timed
   step; one recorded step with both kernels' counts set to 0 before and
   read after and ``window_origins`` raising: 8 K1 launches (2 for the
   data, two per refinement level and two at full resolution) and 6 K2
   (each warp's flow gradient), all whole-C; origins, K1 and K2 against
   their twins at every launch and K2 at synthetic cases of each shape; the
   whole step with the kernels against the same step with both plain twins
   (deterministic cuDNN); the selective scan's Function (output and every
   gradient) against autograd through an unrolled loop without ``out=`` on
   rows 0-7 of block 0's first scan, its inputs taken from the step
   (tolerance 1e-4 of each tensor's largest); MAMBA_TRAIN_STEPS timed steps
   after one, counted (ms/step, samples/s, peak memory); then ``python -m
   vfisr_tpu_torch.train --model <name> --steps 3 --out <tmp>`` in process,
   every K1 and K2 launch held against its twin as it goes and counted with
   ``window_origins`` raising, finite losses, and its npz (the JAX
   package's layout) read back whole by ``VFIMambaModel.load``. Then the
   export: ``python -m vfisr_tpu_torch.compile_aot --model rife --precision
   bf16`` at 1920x1080, one pair, t = 0.25/0.5/0.75, to a temporary
   ``.pt2``; the artifact loaded with ``torch.export.load`` and run on step
   4's first pair with each K1 launch (through the custom op
   ``vfisr_tpu_torch::warp_windowed``) recorded and counted (4) with
   ``window_origins`` raising, origins and K1 against the twin at each; its
   frames against eager ``interpolate_batch`` of the same bf16 model (max
   abs diff at most 1e-5, printed); the exported program and the eager call
   timed; ``compile_stats`` and ``compile_aot --load`` printed; the host
   time of a K1 call through the op against ``launch`` alone. No file
   under weights/ is written. K1 and K2 per launch shape.
25. scale-out and the blind study. (a) The data-parallel train step
   (``make_train_step(..., mesh=)``, ``parallel/mesh.py``) of full-width
   RIFE from weights/rife.npz at the trainer's defaults (batch 16, crop 192,
   remat, lr 2e-4; f32 with TF32 off; deterministic cuDNN), one batch of
   scenes made on the card, DP_STEPS steps (the first at lr 0): in this
   process without a mesh (the reference), over NCCL on every visible card
   (world 1 on a one-card machine: this process is the rank), and over a
   gloo group of DP_GLOO_RANKS ranks spawned on one card
   (``parallel/launch.py``). Each rank's losses, its first step's averaged,
   clipped gradients and its parameters after the steps within DP_TOL
   (relative) of the reference's, every rank's parameters equal. The gloo
   ranks' reference is the blockwise step (``_blockwise_step``: the same
   two half-batch blocks in this process, their gradients summed and
   halved): at batch 8 the f32 convs take other algorithms than at 16, and
   the bf16 warp windows turn those last-bit differences into bf16 steps
   (printed: each run's distance from the whole-batch step). Every K1
   and K2 launch of every run (each rank's too) against its twin as it
   goes, counted with ``window_origins`` raising; ms per step of each
   (CUDA events, DP_TIMED steps): NCCL's against the reference's is the
   cost of the all-reduce. (b) In the gloo ranks, SPAN x2 (weights/span_x2.npz)
   on step 4's first 1920x1080 frame sharded on H over a data 1 x spatial 2
   mesh (``spatial_apply``: a halo of the model's 21-row reach from each
   neighbour) against the unsharded call (SHARD_TOL), ms of both. (c) The
   blind study on step 21's clip, its CLIs in process through their
   ``main(argv)``: ``gui.benchmark_proper`` over its five methods at
   2560x1440 / 120 fps on interval STUDY_INTERVAL cut to STUDY_KEYFRAMES
   keyframes, ``gui.generate_clips --preset sota``, ``prepare_blind_study``
   on the first's directory. Checks: every K1 launch against its twin;
   every video (Y4M where mp4 cannot be written) holds the keyframes and 3
   frames between each pair, the pairs twice the width; the metadata's
   PSNR and SSIM of degraded and lanczos against the same frames scored on
   the CPU; ``extract_clip``'s cut of a Y4M equal to the source's frames.
   Prints ms and K1 launches per method; K1 and K2 per launch shape.
26. the last modules of the port, every K1 launch counted (its count set
   to 0 before each part and read after) and held against its twin as it
   goes, with ``window_origins`` raising. (a) RIFE's RefineNet: full-width
   RIFE from weights/rife.npz in the bf16 deploy config with ``refine=True``
   and seeded normal RefineNet parameters (no checkpoint holds them; a
   fresh head adds zero); one 1080p pair through ``shared_flow_apply`` (5
   K1), the same call with the plain twin (the main path's tolerance), the
   anchor timestep changed by the head and the derived ones not; ms per
   pair with and without refine, in turns. (b) The per-timestep flagship
   step (``FlagshipConfig(shared_flow=False)``): 2 pairs counted (17 K1 per
   pair), one pair against the twin, ms per pair beside the shared step's
   in turns, and the midpoints' PSNR against the scene's true in-between
   frames (a result). (c) ``data/jpeg.py`` on a 1080p frame at quality 92
   and 28: the card's bytes and decoded pixels equal to the CPU run's; ms
   per frame, the card's share (CUDA events) apart from the host's. (d)
   ``gui/web_app.py``'s StudyState on step 21's processed clip, served on
   127.0.0.1 at an ephemeral port and walked over HTTP (clips, clip, pairs,
   every frame of 2 pairs rendered by RIFE and the flow model, a guess,
   results, save); the served JPEGs decode to 960x540, the control is the
   JPEG of its ground-truth frame at 540 rows, byte for byte. (e) ``gui/video_blind_study.py``'s AppState on step
   25's study videos: a 206 Range response, a quiz round, ``new_interval``
   cutting Y4M full videos written here. (f) ``lpips_ordering_study`` and
   ``check_expert_downscale`` at ``--pairs 2 --stride 1`` on 0.2 s clips the
   card renders (the hard and smooth presets at 1920x1080, 60 fps), their
   JSON summaries and VFIMamba's native-trunk peak memory at 2560x1440.
   (g) ``generate_comprehensive_report`` and ``generate_report_figures`` on
   step 21's experiment_results.json (without matplotlib the figures script
   must say so by name; its table is made then from the same rankings).
27. the last slice: (a) builds csrc/warp_tiled.cu (K1 and K2 at any output
   tile) and holds it against the plain twin at the same tile (K1 bit for
   bit), origins included, printing each launch's plan (ops/cuda/warp.py::
   card_tiled_plan), at every tile and shape the profile tools launch off 32x256
   (profile_components' 16x256 at r = 6, 4, 2 on [6,1088,1920,3] f32;
   profile_warp_tiles' seven tiles at r = (3,4) bf16 and its two half-size
   ones at (2,2)), at a constant border, a flow past the window, 176
   channels and a t per image, K2 at the reference's test tile 8x128, r = 6
   on 1080p frames (both borders), and at 32x256 bit for bit against the
   tile kernels; then counts the tiled K2 over those two 1080p launches;
   (b) runs the eight ``profile_*`` tools in process through their
   ``main`` at their full case lists (TILE_REPS timed calls after
   TILE_WARMUP), every JSON line parsed with a finite number in each case,
   every K1 launch counted by shape and tile and those of each tool's first
   case held against the twin, with ``window_origins`` raising; (c)
   ``verify_setup --device cuda`` (exit 0), ``probe_system --json`` (the
   card's name and power limit), ``graft_entry.entry()`` exported and run,
   the sharded flagship check over a gloo pair of ranks on the card,
   ``generate_figures`` on step 21's results (without matplotlib it exits
   non-zero naming it) and ``evaluate_quality`` on JPEGs ``data/jpeg.py``
   wrote (decoded on the card); the three CLIs and the two ranks are child
   processes started with the step, and the per-shape timing comes last,
   each tiled shape's line with its plan.

Any failure raises and the exit code is not 0. The line before the last is
{"kernels": [...]}: per kernel, its launches counted on every path that runs
it (K1: the flagship pairs, the flagship stream, the RIFE train steps, the
adaptive sequence, the adaptive stream, the SAFA pairs, the SAFA train
steps, the evaluation, the bench, the sweep, the triplet benchmark, the
counted extraction of the ingest, step 22's trainer, evaluation and gate
runs, step 23's calibration and gate loads, step 24's VFIMamba train steps
and trainer runs, the exported program's runs, step 25's compared
data-parallel steps and the blind study's CLIs, step 26's parts, step 27's
profile tools at 32x256; K2: the RIFE and the SAFA
train steps, step 22's trainer runs, step 24's VFIMamba steps and step 25's
compared steps; warp_tiled: step 27's profile tools at other tiles;
warp_tiled_grad: step 27's counted 8x128 launches)
and the device time, bound, plain-twin and grid_sample time of exactly
those launches (a stream's and the bench's launches at their shapes' times
from steps 7 and 9). The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PAIRS = 6  # timed pairs of the main path
TS = (0.25, 0.5, 0.75)
SCALE = 1440 / 1080  # the streaming pipeline's target_h / height
H, W = 1080, 1920
STEP_PX = 8  # rectangle motion per frame: quarter-frame positions are integers
LAUNCHES_PER_PAIR = 18
GRAPH_LAUNCHES = 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12  # non-tensor-core f32
# the training phase: scripts/train.py's defaults for full-width RIFE
TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL, TRAIN_LR = 16, 192, 0.35, 2e-4
TRAIN_STEPS = 10  # timed, after 2 warm-up steps
K1_PER_STEP = 10  # 2 data warps + 4 IFNet warps (levels 1-3, final) + their 4 recomputes
K2_PER_STEP = 4  # the backward of the 4 IFNet warps
ORIGIN_TABLE = None  # ops.cuda.warp.window_origins, once main() has imported it
# the adaptive phase: AdaptivePipeline (get_model("adaptive")) over a 1080p
# sequence with a static HUD. HISTORY_PAIRS 3 px pans fill the HUD ring,
# then the measured pairs: (name, x0, x1) as (pan offset px or cut scene)
HISTORY_PAIRS, PAN_PX = 5, 3
MEASURED = (("static", 15, 15), ("pan 3 px", 15, 18), ("pan 8 px", 18, 26), ("cut", 26, "cut"))
# K1 launches per pair and route: Farneback 12 + scene gate 1, then RIFE's
# 4 (s4, 2x s2, final; batch 6) or VFIMamba's 6 (two per refinement level
# and two at full res; batch 3)
K1_PER_ROUTE = {"rife": 17, "vfimamba": 19, "scene_change": 13}
K1_MASKED = 23  # both experts run on every pair
# the SAFA phase: 1920x1080 pairs of the adaptive phase's scene through
# SAFAModel.interpolate_batch (12 tiles of 360x480 + 48 px, batch 3); each
# tile's forward warps the features 6 times ([3,114,144,176]) and the frames
# twice ([3,456,576,3])
SAFA_PAIRS = (("static", 15, 15), ("pan 3 px", 15, 18), ("pan 8 px", 18, 26))
K1_PER_SAFA_PAIR = 96
GROUPED_C = (10, 16, 33, 176)  # K1 past the channels one window holds
# the SAFA training phase: scripts/train.py --model safa at its defaults
# (batch 16, crop 192: scenes at 384, the endpoints area-resized to 192, the
# midpoint supervised at 384; remat). Per step, K1: 2 data warps, then the
# 6 feature warps ([16,48,48,176], channel groups) and 2 frame warps
# ([16,192,192,3]) of the forward and of its recompute; K2: the flow
# gradients of the 4 feature warps whose flow is trained (flow stage 1 and
# the aggregation; stage 0 warps by a constant zero flow) and of the 2 frame
# warps; the features' gradient of all 6 feature warps through the shifted
# adjoint
SAFA_TRAIN_STEPS = 5  # timed, after 1 warm-up step
K1_PER_SAFA_STEP, K1_GROUPED_PER_SAFA_STEP = 18, 12
K2_PER_SAFA_STEP, K2_GROUPED_PER_SAFA_STEP = 6, 4
ADJOINTS_PER_SAFA_STEP = 6
SPAN_TRAIN_STEPS = 5  # SPAN x2 and x4 at batch 16, crop 192: timed, after 1 warm-up step


def require(ok: bool, what: str) -> None:
    """A check of this run (not an assert: it must also hold under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _phase(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"phase {name}: {now - t0:.3f} s", flush=True)
    return now


def game_frame(t: float, device, h: int = H, w: int = W, step: int = STEP_PX) -> torch.Tensor:
    """[h,w,3] uint8 synthetic gameplay frame at time t (frame units):
    gradient background, a textured rectangle moving ``step`` px per frame
    to the right, a static HUD box top left."""
    yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
    f = torch.stack([xx / w, yy / h, 0.5 + 0.25 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)], -1)
    rh, rw = h // 3, w // 4
    x0, y0 = w // 8 + int(round(t * step)), h // 3
    ly, lx = yy[:rh, :rw], xx[:rh, :rw]
    tex = 0.5 + 0.4 * (torch.sin(lx / 3.0) * torch.cos(ly / 4.0))[..., None]
    f[y0:y0 + rh, x0:x0 + rw] = tex * torch.tensor([1.0, 0.6, 0.2], device=device)
    f[: h // 6, : w // 5] = torch.tensor([0.9, 0.9, 0.1], device=device)
    return torch.clamp(torch.floor(f * 255.0 + 0.5), 0, 255).to(torch.uint8)


def scene_frame(x, device, h: int = H, w: int = W, waves: int = 24,
                scale: float = 1.0) -> torch.Tensor:
    """[h,w,3] uint8 frame of the adaptive phase's sequence: for a number x,
    a texture of seeded random plane waves (wavelengths 8-64 px) moved
    right by x px; for "cut", another scene (seeded random 2x2 px blocks at
    1920 wide, which no flow maps onto the first). A static HUD box top
    left in both. scale renders the same scene on a raster scale times
    finer (x stays in the unscaled raster's pixels)."""
    if x == "cut":
        gen = torch.Generator(device="cpu").manual_seed(1)
        blk = max(1, w // 960)
        blocks = torch.rand((h // blk + 1, w // blk + 1, 3), generator=gen).to(device)
        f = blocks.repeat_interleave(blk, 0).repeat_interleave(blk, 1)[:h, :w].contiguous()
    else:
        gen = torch.Generator(device="cpu").manual_seed(0)
        k = 2 * math.pi / (8.0 + 56.0 * torch.rand((waves,), generator=gen))
        ang = torch.rand((waves,), generator=gen) * 2 * math.pi
        kx, ky = (k * torch.cos(ang)).tolist(), (k * torch.sin(ang)).tolist()
        phase = (torch.rand((waves, 3), generator=gen) * 2 * math.pi).tolist()
        amp = (0.35 / math.sqrt(waves) * (0.5 + torch.rand((waves, 3), generator=gen))).tolist()
        yy, xx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                                torch.arange(w, device=device, dtype=torch.float32), indexing="ij")
        f = torch.full((h, w, 3), 0.5, device=device)
        for i in range(waves):
            arg = kx[i] * (xx / scale - x) + ky[i] * (yy / scale)
            for c in range(3):
                f[..., c] += amp[i][c] * torch.sin(arg + phase[i][c])
    f[: h // 6, : w // 5] = torch.tensor([0.9, 0.9, 0.1], device=device)
    return torch.clamp(torch.floor(f * 255.0 + 0.5), 0, 255).to(torch.uint8)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = ((a.float() - b.float()) ** 2).mean().item()
    return float("inf") if mse == 0 else 10.0 * torch.log10(torch.tensor(255.0 ** 2 / mse)).item()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_tolerance(ref: torch.Tensor, compute_dtype: torch.dtype) -> float:
    base = 2.0 / 255.0 if compute_dtype == torch.bfloat16 else 1e-5
    return base * max(1.0, ref.float().abs().max().item())


def launch_bound(a: dict) -> tuple:
    """(bound ms, 'bytes'|'operations') of one launch: img, flow and t read
    once, out written once, over HBM bandwidth; ~26 flops per pixel for
    coordinates and weights plus 9 per channel, over the f32 peak."""
    img, flow = a["img"], a["flow"]
    n, h, w, c = img.shape
    nbytes = 2 * img.numel() * img.element_size() + flow.numel() * flow.element_size() + 4 * n
    ops = n * h * w * (26 + 9 * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grad_launch_bound(a: dict) -> tuple:
    """(bound ms, 'bytes'|'operations') of one K2 launch: img, flow, ct and
    t read once, grad_flow and cg written once, over HBM bandwidth; ~30
    flops per pixel for coordinates, weights and masks plus ~20 per
    channel, over the f32 peak."""
    img, flow = a["img"], a["flow"]
    n, h, w, c = img.shape
    nbytes = (2 * img.numel() * img.element_size() + 2 * flow.numel() * flow.element_size()
              + 4 * flow.numel() + 4 * n)
    ops = n * h * w * (30 + 20 * c)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _grid(a: dict) -> torch.Tensor:
    """grid_sample's normalised grid for the warp of a (align_corners=True)."""
    img, flow = a["img"], a["flow"]
    n, h, w, c = img.shape
    t = torch.as_tensor(a["t"], dtype=torch.float32, device=img.device).reshape(-1, 1, 1)
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device, dtype=torch.float32),
                            torch.arange(w, device=img.device, dtype=torch.float32), indexing="ij")
    f = flow.float()
    gx = (xs + f[..., 0] * t) * (2.0 / max(w - 1, 1)) - 1.0
    gy = (ys + f[..., 1] * t) * (2.0 / max(h - 1, 1)) - 1.0
    return torch.stack([gx, gy], -1).to(img.dtype)


def grid_sample_grad_call(a: dict):
    """The grid gradient of torch's grid_sample (bilinear, border,
    align_corners=True) at the shape of a K2 launch: the library yardstick.
    The forward is built once outside the returned call, which runs the
    backward alone."""
    img = a["img"].permute(0, 3, 1, 2).contiguous()
    grid = _grid(a).requires_grad_(True)
    out = torch.nn.functional.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                                          align_corners=True)
    ct = a["ct"].permute(0, 3, 1, 2).contiguous()
    return lambda: torch.autograd.grad(out, grid, ct, retain_graph=True)


def grid_sample_call(a: dict):
    """torch's bilinear grid_sample (align_corners=True; border padding for
    the replicate border, zeros for the constant one) on the same warp: the
    library yardstick. Inputs are prepared outside the returned call."""
    grid = _grid(a)
    inp = a["img"].permute(0, 3, 1, 2).contiguous()
    pad = "zeros" if a["border"] == "constant" else "border"
    return lambda: torch.nn.functional.grid_sample(inp, grid, mode="bilinear",
                                                   padding_mode=pad, align_corners=True)


def host_ms(fn, iters: int = 20) -> float:
    """Host time of one call of fn (what the caller's thread spends to
    enqueue it; no synchronisation inside the timed loop), after warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def time_launch(kw, a: dict) -> dict:
    """Times of one recorded launch: the kernel alone, its origin included
    (GRAPH_LAUNCHES launches captured in a CUDA graph and replayed, so
    device time without host overhead), the wrapper's host time per call
    and the wrapper as the main path calls it (CUDA events), the plain
    twin, grid_sample, and the bound."""
    img, flow, r, cd = a["img"], a["flow"], a["r"], a["compute_dtype"]
    out = torch.empty_like(img)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            kw.launch(img, flow, a["t"], out, r, a["border"], cd)
    args = (img, flow, a["t"], r, a["border"], cd)
    bound, by = launch_bound(a)
    return dict(kernel=time_ms(graph.replay, 5) / GRAPH_LAUNCHES, bound=bound, by=by,
                host=host_ms(lambda: kw.warp_windowed(*args)),
                wrapper=time_ms(lambda: kw.warp_windowed(*args), 20),
                plain=time_ms(lambda: kw.warp_windowed_plain(*args), 5),
                library=time_ms(grid_sample_call(a), 20))


def synthetic_cases(device):
    """Kernel-vs-plain cases at each launch shape of a 1080p pair (random
    smooth inputs), plus a constant border and a flow past the radius."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def case(name, shape, dt, r, amp=4.0, noise=0.5, border="replicate"):
        n, h, w, c = shape
        img = torch.rand(shape, generator=gen).to(device=device, dtype=dt)
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        base = torch.stack([amp * torch.sin(xx / 17.0 + yy / 23.0),
                            0.5 * amp * torch.cos(yy / 9.0) - 0.5], -1)
        flow = (base + noise * torch.randn((n, h, w, 2), generator=gen)).to(device=device, dtype=dt)
        return dict(name=name, img=img, flow=flow, t=1.0, r=r, border=border, compute_dtype=dt)

    bf, f32 = torch.bfloat16, torch.float32
    return [
        case("ifnet_level_s4", (2, 272, 480, 3), bf, (2, 2)),
        case("ifnet_level_s2", (2, 544, 960, 3), bf, (2, 2)),
        case("ifnet_final", (2, 1088, 1920, 3), bf, (3, 4)),
        case("shared_flow", (4, 1088, 1920, 3), bf, (3, 4)),
        case("scene_gate", (1, 270, 480, 1), f32, 8),
        case("farneback_l0", (1, 270, 480, 5), f32, 8),
        case("farneback_l1", (1, 135, 240, 5), f32, 8),
        case("farneback_l2", (1, 68, 120, 5), f32, 8),
        case("farneback_l3", (1, 34, 60, 5), f32, 8),
        case("constant_border_bf16", (2, 544, 960, 3), bf, (2, 2), amp=12.0, border="constant"),
        case("constant_border_f32", (1, 270, 480, 5), f32, 8, amp=12.0, border="constant"),
        case("past_radius_bf16", (2, 272, 480, 3), bf, (2, 2), amp=25.0, noise=4.0),
        case("past_radius_f32", (1, 270, 480, 1), f32, 2, amp=25.0, noise=4.0),
    ]


def adversarial_cases(device) -> list:
    """The window origin's edge cases, at shapes of the path's launches:
    tile means that land exactly on .5 after scaling by t (t = 0.5, odd
    integer tile flows plus a zero-sum +-6 checkerboard), uniform +-300 px
    flows (the order of the f32 sums decides the mean's last bits), 1080
    and 270 rows (edge-padded tiles), a t per image, integer tile flows
    that give odd row origins before bf16 rounds them to even, and the
    constant border. Each carries a random cotangent for K2."""
    gen = torch.Generator(device="cpu").manual_seed(2)

    def case(name, kind, shape, img_dt, window_dt, r, border="replicate"):
        n, h, w, c = shape
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        ty, tx = yy // 32, xx // 256
        t = 1.0
        if kind == "tie":
            t = 0.5
            k = torch.randint(-4, 5, (n, 2, 1, 1), generator=gen) + torch.stack(
                [3 * ty - tx, tx - 2 * ty])
            flow = (2 * k + 1) + torch.where(yy % 2 == xx % 2, 6, -6)
        elif kind == "large":
            flow = torch.rand((n, 2, h, w), generator=gen) * 600.0 - 300.0
        elif kind == "odd_row":
            k = torch.randint(0, 6, (n, 2, 1, 1), generator=gen) + torch.stack([tx + ty, ty])
            flow = k + 0.2 * torch.randn((n, 2, h, w), generator=gen)
        else:  # smooth, with ragged shapes and a t per image
            flow = torch.stack([6.0 * torch.sin(xx / 17.0 + yy / 23.0),
                                3.0 * torch.cos(yy / 9.0) - 0.5])[None]
            flow = flow + torch.randn((n, 2, h, w), generator=gen)
            if kind == "per_batch_t":
                t = torch.linspace(0.3, 1.7, n, device=device)
        flow = flow.permute(0, 2, 3, 1).float().contiguous()
        return dict(name=name, img=torch.rand(shape, generator=gen).to(device, img_dt),
                    ct=torch.randn(shape, generator=gen).to(device, img_dt),
                    flow=flow.to(device, img_dt), t=t, r=r, border=border,
                    compute_dtype=window_dt)

    bf, f32 = torch.bfloat16, torch.float32
    return [
        case("tie_final", "tie", (2, 1088, 1920, 3), bf, bf, (3, 4)),
        case("tie_level", "tie", (32, 96, 96, 3), f32, bf, (2, 4)),
        case("large_farneback", "large", (1, 270, 480, 5), f32, f32, 8),
        case("large_train_final", "large", (32, 192, 192, 3), f32, bf, (4, 6)),
        case("ragged_1080", "ragged", (2, 1080, 1920, 3), bf, bf, (3, 4)),
        case("ragged_270_constant", "ragged", (1, 270, 480, 1), f32, f32, 8, "constant"),
        case("per_batch_t_level", "per_batch_t", (32, 48, 48, 3), f32, bf, (2, 4)),
        case("per_batch_t_data", "per_batch_t", (48, 192, 192, 4), f32, f32, 2, "constant"),
        case("odd_row_s2", "odd_row", (2, 544, 960, 3), bf, bf, (2, 2)),
        case("odd_row_constant", "odd_row", (2, 272, 480, 3), bf, bf, (2, 2), "constant"),
    ]


def check_origins(kw, label: str, a: dict) -> None:
    """The window origins the kernels compute equal window_origins', int
    for int (the output alone can hide an origin one pixel off)."""
    flow, r, cd = a["flow"], a["r"], a["compute_dtype"]
    ry, rx = (r, r) if isinstance(r, int) else r
    t_arr = torch.as_tensor(a["t"], dtype=torch.float32, device=flow.device)
    t_arr = t_arr.reshape(-1).expand(flow.shape[0]).contiguous()
    got = kw.kernel_origins(flow, a["t"], r, cd)
    ref = ORIGIN_TABLE(flow, t_arr, ry, rx, cd == torch.bfloat16)
    same = got.shape == ref.shape and torch.equal(got, ref)
    print(f"origins kernel vs window_origins {label}: {tuple(ref.shape[:3])} tiles "
          f"{'equal' if same else 'DIFFER'}")
    require(same, f"kernel origins vs window_origins {label}")


@contextlib.contextmanager
def origin_table_raises(kw):
    """Swaps the wrapper module's window_origins for a function that
    raises: a run inside shows that the kernels' path never reaches it."""
    def raising(*args, **kwargs):
        raise RuntimeError("window_origins reached on the kernels' path")

    kw.window_origins = raising
    try:
        yield
    finally:
        kw.window_origins = ORIGIN_TABLE


def _label(a: dict) -> str:
    return (f"{tuple(a['img'].shape)} {str(a['img'].dtype)[6:]} window "
            f"{str(a['compute_dtype'])[6:]} r={a['r']} {a['border']}")


def check_warp(kw, label: str, a: dict) -> float:
    """K1 against its plain twin on the inputs of a; returns the error."""
    args = (a["img"], a["flow"], a["t"], a["r"], a["border"], a["compute_dtype"])
    out = kw.warp_windowed(*args)
    ref = kw.warp_windowed_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref, a["compute_dtype"])
    print(f"kernel vs plain {label}: {_label(a)}: max_abs_err {err:.3e} tol {tol:.3e} "
          f"{'ok' if err <= tol else 'FAIL'}")
    require(err <= tol, f"kernel vs plain {label}")
    return err


def check_warp_grad(kw, label: str, a: dict) -> float:
    """K2 against its plain twin on the inputs of a (grad_flow and cg),
    within 1e-5 (f32 windows) or 2/255 (bf16) of the largest |cg|; returns
    the error."""
    args = (a["img"], a["flow"], a["t"], a["ct"], a["r"], a["border"], a["compute_dtype"])
    gflow, cg = kw.warp_windowed_grad(*args)
    ref_gflow, ref_cg = kw.warp_windowed_grad_plain(*args)
    torch.cuda.synchronize()
    err = max((gflow.float() - ref_gflow.float()).abs().max().item(),
              (cg - ref_cg).abs().max().item())
    # relative to the largest magnitude, not to max(1, it): the training's
    # cotangents are ~1e-7, so a floor of 1 would pass anything
    scale = ref_cg.abs().max().item()
    tol = (2.0 / 255.0 if a["compute_dtype"] == torch.bfloat16 else 1e-5) * scale
    require(scale > 0, f"{label} has a gradient to check")
    print(f"grad kernel vs plain {label}: {_label(a)}: max_abs_err {err:.3e} tol {tol:.3e} "
          f"{'ok' if err <= tol else 'FAIL'}")
    require(err <= tol, f"grad kernel vs plain {label}")
    return err


def grad_cases(recorded: list) -> list:
    """K2-vs-plain cases at each recorded launch shape: a constant border,
    flows past the radius, zero and integer flows (random img and ct)."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    cases, seen = [], set()
    for a in recorded:
        key = (tuple(a["img"].shape), a["r"], a["compute_dtype"])
        if key in seen:
            continue
        seen.add(key)
        n, h, w, c = a["img"].shape
        dev = a["img"].device

        def case(name, flow, border="replicate"):
            img = torch.rand((n, h, w, c), generator=gen).to(dev, a["img"].dtype)
            ct = torch.randn((n, h, w, c), generator=gen).to(dev, a["img"].dtype)
            return dict(a, name=f"{name} {key[0]}", img=img, ct=ct, border=border,
                        flow=flow.to(dev, a["flow"].dtype))

        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                torch.arange(w, dtype=torch.float32), indexing="ij")
        smooth = torch.stack([torch.sin(xx / 17.0 + yy / 23.0), torch.cos(yy / 9.0)], -1)
        cases += [
            case("constant_border", 12.0 * smooth + 0.5 * torch.randn((n, h, w, 2), generator=gen),
                 border="constant"),
            case("past_radius", 25.0 * smooth + 4.0 * torch.randn((n, h, w, 2), generator=gen)),
            case("zero_flow", torch.zeros((n, h, w, 2))),
            case("integer_flow", torch.randint(-3, 4, (n, h, w, 2), generator=gen).float()),
        ]
    return cases


def time_grad_launch(kw, a: dict) -> dict:
    """Times of one recorded K2 launch: the kernel alone, its origin
    included (GRAPH_LAUNCHES launches captured in a CUDA graph and
    replayed: device time), the wrapper's host time per call and the
    wrapper as the backward calls it, the plain twin, grid_sample's grid
    gradient, and the bound."""
    img, flow, r, cd = a["img"], a["flow"], a["r"], a["compute_dtype"]
    ct = a["ct"].contiguous()
    gflow = torch.empty_like(flow)
    cg = torch.empty(flow.shape, dtype=torch.float32, device=flow.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            kw.launch_grad(img, flow, a["t"], ct, gflow, cg, r, a["border"], cd)
    args = (img, flow, a["t"], ct, r, a["border"], cd)
    bound, by = grad_launch_bound(a)
    return dict(kernel=time_ms(graph.replay, 5) / GRAPH_LAUNCHES, bound=bound, by=by,
                host=host_ms(lambda: kw.warp_windowed_grad(*args)),
                wrapper=time_ms(lambda: kw.warp_windowed_grad(*args), 20),
                plain=time_ms(lambda: kw.warp_windowed_grad_plain(*args), 5),
                library=time_ms(grid_sample_grad_call(a), 20))


def path_numbers(launches: int, err: float, per_unit: dict, units: int) -> dict:
    """A path's numbers for the kernels JSON: its counted launches, the
    largest kernel-vs-plain error, and the device times of those launches
    (the per-pair or per-step totals times the pairs or steps counted)."""
    return dict(launches=launches, err=err, by=per_unit["by"],
                **{k: per_unit[k] * units for k in ("kernel", "plain", "bound", "library")})


def kernel_entry(name: str, paths: list,
                 source: str = "vfisr_tpu_torch/csrc/warp_windowed.cu") -> dict:
    """One kernel's object of the kernels JSON, summed over the paths that
    launch it."""
    by = {p["by"] for p in paths}
    return {"name": name, "route": "cuda", "source": source,
            "replaces": "vfisr_tpu/ops/pallas/warp.py:348",
            "launches": sum(p["launches"] for p in paths),
            "max_abs_err": max(p["err"] for p in paths),
            "ms": sum(p["kernel"] for p in paths), "plain_ms": sum(p["plain"] for p in paths),
            "bound_ms": sum(p["bound"] for p in paths),
            "bound_by": "bytes" if by == {"bytes"} else "operations",
            "library_ms": sum(p["library"] for p in paths)}


def shape_times(kw, recs: list, timer) -> dict:
    """Per distinct launch shape of recs: its count and the timer's numbers."""
    by_shape = {}
    for a in recs:
        key = shape_key(a)
        if key not in by_shape:
            by_shape[key] = dict(n=0, **timer(kw, a))
        by_shape[key]["n"] += 1
    return by_shape


def shape_key(a: dict) -> tuple:
    return (tuple(a["img"].shape), a["img"].dtype, a["compute_dtype"], a["r"], a["border"])


def plan_text(pl: dict) -> str:
    """A launch's plan (``ops/cuda/warp.py::plan``) in words."""
    if not pl["grouped"]:
        return f"whole-C, {pl['split']} row slice(s) of {pl['rows']} rows, {pl['ctas']} CTAs"
    return (f"channel groups, {pl['ctas']} CTAs: {pl['split']} block(s) of {pl['pixels']} "
            f"pixels per tile x {pl['chunks']} chunk(s) of {-(-pl['groups'] // pl['chunks'])} "
            f"groups of {pl['cg']} channels, {pl['stages']} ring slots, {pl['smem']} B shared")


def print_grouped(kw, label: str, unit: str, key: tuple, a: dict, v: dict, grad: bool) -> None:
    """One line per launch shape in channel groups: the kernel, its bound,
    the library call timed beside it, and the plan."""
    pl = kw.plan(a["img"], a["r"], a["compute_dtype"], grad)
    if not pl["grouped"]:
        return
    lib = "grid_sample grad" if grad else "grid_sample"
    print(f"grouped {'K2' if grad else 'K1'} {label} {key[0]} x{v['n']}/{unit}: kernel "
          f"{v['kernel']:.4f} ms, bound {v['bound']:.4f} ms ({v['kernel'] / v['bound']:.2f}x), "
          f"{lib} {v['library']:.4f} ms ({'faster' if v['kernel'] < v['library'] else 'SLOWER'}: "
          f"{v['library'] / v['kernel']:.2f}x); {plan_text(pl)}")


def _recording(kw, recs: list):
    """K1's wrapper, recording each launch's inputs (cloned) in recs."""
    real = kw.warp_windowed

    def recording(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        recs.append(dict(img=img.clone(), flow=flow.clone(),
                         t=t.clone() if torch.is_tensor(t) else t, r=r, border=border,
                         compute_dtype=compute_dtype))
        return real(img, flow, t, r, border, compute_dtype)

    return recording


def _recording_grad(kw, recs: list):
    """K2's wrapper, recording each launch's inputs (cloned) in recs."""
    real = kw.warp_windowed_grad

    def recording(img, flow, t, ct, r=8, border="replicate", compute_dtype=torch.float32):
        recs.append(dict(img=img.clone(), flow=flow.clone(),
                         t=t.clone() if torch.is_tensor(t) else t, ct=ct.contiguous().clone(),
                         r=r, border=border, compute_dtype=compute_dtype))
        return real(img, flow, t, ct, r, border, compute_dtype)

    return recording


def compare_step_with_twins(kw, module, fixed: dict, make_step, label: str) -> None:
    """The whole train step with the kernels against the same step with both
    plain twins: same batch, same params (an optimizer with lr 0 leaves
    them; the gradients compared are the step's, after its clip). cuDNN is
    made deterministic for it: its algorithms may vary run to run, and the
    warps can turn that into large gradient differences (the kernels' own
    run-to-run difference is printed with default and with deterministic
    cuDNN). Loss within 1e-5 relative, gradients within 1e-4 of each
    tensor's largest."""
    from vfisr_tpu_torch.train.train import TrainState

    real_warp, real_grad = kw.warp_windowed, kw.warp_windowed_grad
    probe = make_step(module, TrainState(torch.optim.AdamW(module.parameters(), lr=0.0),
                                         lambda k: 0.0))

    def loss_and_grads():
        value = probe(fixed).item()
        return value, {n: p.grad.clone() for n, p in module.named_parameters()}

    def rel_err(a, b):
        return max((a[n] - b[n]).abs().max().item() / max(b[n].abs().max().item(), 1e-30)
                   for n in b)

    loss_a, grads_a = loss_and_grads()
    loss_b, grads_b = loss_and_grads()
    print(f"{label} with kernels, twice, default cuDNN: loss {loss_a:.9f} vs {loss_b:.9f}, "
          f"gradients {rel_err(grads_a, grads_b):.3e} of each tensor's largest")
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, grads_k = loss_and_grads()
        loss_k2, grads_k2 = loss_and_grads()
        kw.warp_windowed = lambda img, flow, t=1.0, r=8, border="replicate", \
            compute_dtype=torch.float32: kw.warp_windowed_plain(img, flow, t, r, border,
                                                                compute_dtype)
        kw.warp_windowed_grad = kw.warp_windowed_grad_plain
        try:
            loss_p, grads_p = loss_and_grads()
        finally:
            kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
    finally:
        torch.backends.cudnn.deterministic = False
    grad_err = rel_err(grads_k, grads_p)
    print(f"{label} with kernels vs with plain twins (deterministic cuDNN): loss "
          f"{loss_k:.9f} vs {loss_p:.9f}, gradients max error {grad_err:.3e} of each tensor's "
          f"largest (tolerance: loss 1e-5 relative, gradients 1e-4); kernels vs kernels: loss "
          f"{loss_k2:.9f}, gradients {rel_err(grads_k, grads_k2):.3e}")
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), f"{label} loss, kernels vs twins")
    require(grad_err <= 1e-4, f"{label} gradients, kernels vs twins")


def train_phase(kw, rife_npz: Path) -> tuple:
    """Step 8 of the module docstring. Returns K1's and K2's numbers over
    the counted train steps (``path_numbers``)."""
    from vfisr_tpu_torch.models.sota.rife import RIFEModel
    from vfisr_tpu_torch.train.device_data import device_synthetic_batch
    from vfisr_tpu_torch.train.train import create_train_state, make_train_step
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax, params_to_jax, save_npz

    t0 = time.perf_counter()
    # f32 activations, as RIFEConfig says: no TF32 (as the trainer CLI sets)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = RIFEModel(device="cuda")
    model.load(weights_path=str(rife_npz))  # explicit path: strict
    module = model.trainable()
    require(module.config.channels == (256, 160, 112, 80) and module.config.scales == (8, 4, 2, 1),
            "full-width RIFE")
    state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                               total_steps=TRAIN_STEPS + 2)
    step = make_train_step(module, state)  # remat on, as scripts/train.py
    gen = torch.Generator(device="cuda").manual_seed(0)

    def batch():
        return device_synthetic_batch(gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)

    t0 = _phase("train_load", t0)

    # one step, every launch of both kernels recorded and counted
    real_warp, real_grad = kw.warp_windowed, kw.warp_windowed_grad
    rec1, rec2 = [], []
    kw.warp_windowed, kw.warp_windowed_grad = _recording(kw, rec1), _recording_grad(kw, rec2)
    try:
        with origin_table_raises(kw):
            kw.launches = kw.grad_launches = 0
            loss = step(batch()).item()
            k1, k2 = kw.launches, kw.grad_launches
    finally:
        kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
    print(f"one train step (batch {TRAIN_BATCH}, crop {TRAIN_CROP}): {k1} warp launches, "
          f"{k2} warp-gradient launches, loss {loss:.6f}")
    require(k1 == K1_PER_STEP and len(rec1) == k1, f"{k1} warp launches in a train step")
    require(k2 == K2_PER_STEP and len(rec2) == k2, f"{k2} warp-gradient launches in a train step")
    require(loss == loss and abs(loss) < float("inf"), "finite loss")
    require_whole_c(kw, "train step", rec1)
    require_whole_c(kw, "train step", rec2, grad=True)
    t0 = _phase("train_record", t0)

    # the kernels' origins, and the kernels against their plain twins, at
    # the step's launches
    for j, a in enumerate(rec1 + rec2):
        check_origins(kw, f"train-step launch {j}", a)
    max_err2 = 0.0
    for j, a in enumerate(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, f"train-step launch {j}", a))
    for a in grad_cases(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, a["name"], a))
    max_err1 = 0.0
    for j, a in enumerate(rec1):
        max_err1 = max(max_err1, check_warp(kw, f"train-step launch {j}", a))

    compare_step_with_twins(kw, module, batch(), make_train_step, "train step")
    t0 = _phase("train_checks", t0)

    # the training path, counted and timed
    step_ms, losses, k1_run, k2_run, peak_mb = timed_steps(kw, step, batch, TRAIN_STEPS)
    require(k1_run == K1_PER_STEP * TRAIN_STEPS, f"{k1_run} warp launches in {TRAIN_STEPS} steps")
    require(k2_run == K2_PER_STEP * TRAIN_STEPS,
            f"{k2_run} warp-gradient launches in {TRAIN_STEPS} steps")
    data_ms = time_ms(batch, 5)
    ms = sum(step_ms) / len(step_ms)
    print(f"train full-width RIFE, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, remat: ms/step {ms:.3f} "
          f"(data + step; steps: {', '.join(f'{x:.3f}' for x in step_ms)}); samples/s "
          f"{TRAIN_BATCH * 1000.0 / ms:.2f}; data alone {data_ms:.3f} ms; max_memory_allocated "
          f"{peak_mb:.1f} MB; losses {', '.join(f'{v:.5f}' for v in losses)}")
    t0 = _phase("train_main", t0)

    # the trained params through save_npz and back
    trained = module.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rife_trained.npz"
        save_npz(str(path), params_to_jax(trained))
        back = params_from_jax(load_npz(str(path)))
    require(set(back) == set(trained)
            and all(torch.equal(back[k], trained[k].cpu()) for k in trained), "save_npz round trip")
    shipped = params_from_jax(load_npz(str(rife_npz)))
    require(any(not torch.equal(shipped[k], trained[k].cpu()) for k in trained),
            "training moved the weights")
    print(f"save_npz round trip: {len(back)} arrays equal after load")

    # per launch shape: K2 then K1 at the training's shapes
    tot2 = per_shape_totals(kw, "train warp_windowed_grad", "step", rec2, time_grad_launch)
    tot1 = per_shape_totals(kw, "train warp_windowed", "step", rec1, time_launch)
    _phase("train_timing", t0)
    return (path_numbers(k1_run, max_err1, tot1, TRAIN_STEPS),
            path_numbers(k2_run, max_err2, tot2, TRAIN_STEPS))


def adaptive_phase(kw) -> tuple:
    """Step 9 of the module docstring. Returns K1's numbers over the counted
    sequence (``path_numbers``), and K1's numbers per pair of each route."""
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import scale_size
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.models.sota import vfimamba as tvm
    from vfisr_tpu_torch.models.sota.rife import RIFEConfig
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax
    from vfisr_tpu_torch.utils.router_gate import bin_winner, expert_bins

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    files = {"rife_weights": ROOT / "weights" / "rife.npz",
             "vfimamba_weights": ROOT / "weights" / "vfimamba.npz",
             "gate_path": ROOT / "weights" / "router_gate.json"}
    require(all(p.is_file() for p in files.values()), f"{list(files.values())} present")
    # the registry's entry point; explicit paths make every load strict
    model = get_model("adaptive", load=True, **{k: str(p) for k, p in files.items()})
    gate = str(files["gate_path"])
    require(model.enable_vfimamba, "VFIMamba enabled after load")
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after load")
    require(model._rife.CONFIG == RIFEConfig() and model._rife.CONFIG.channels == (256, 160, 112, 80),
            "full-width RIFE in RIFEModel's default config")
    require(model._vfimamba.variant == "full" and model._vfimamba.cfg == tvm.MambaConfig()
            and model._vfimamba.cfg.d_model == 256, "full VFIMamba")
    for expert, path in ((model._rife, files["rife_weights"]),
                         (model._vfimamba, files["vfimamba_weights"])):
        state, want = expert.module.state_dict(), params_from_jax(load_npz(str(path)))
        require(set(state) == set(want) and all(torch.equal(state[k].cpu(), want[k]) for k in want),
                f"every parameter of {path.name} loaded")
    require(model.router.scene_warp_ssim_threshold != 1.0 and expert_bins("native", gate),
            "calibrated scene gate and expert bins")
    print(f"adaptive: get_model('adaptive', load=True): RIFE {model._rife.info.parameters} and "
          f"VFIMamba {model._vfimamba.info.parameters} parameters, scene gate "
          f"{model.router.scene_warp_ssim_threshold}")

    seq = [(f"history {i}", PAN_PX * i, PAN_PX * (i + 1)) for i in range(HISTORY_PAIRS)]
    seq += list(MEASURED)
    u8 = {x: scene_frame(x, dev) for _, a, b in seq for x in (a, b)}

    def batched(x):
        return u8[x].float()[None] / 255.0

    sigs = []
    real_analyze = model.router.analyze_device

    def capture(x0, x1):
        sig = real_analyze(x0, x1)
        sigs.append(sig)
        return sig

    model.router.analyze_device = capture

    def run(pair_ms=None):
        """The sequence as a stream (one pair per call, the HUD ring
        carried); returns the outputs and each pair's K1 launches."""
        model.router.reset_history()
        model.reset_stats()
        sigs.clear()
        outs, counts = [], []
        for _, a, b in seq:
            k = kw.launches
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(model.interpolate_batch(batched(a), batched(b), TS))
            end.record()
            end.synchronize()
            if pair_ms is not None:
                pair_ms.append(start.elapsed_time(end))
            counts.append(kw.launches - k)
        return outs, counts

    t0 = _phase("adaptive_load", t0)

    # warm-up run, recording every launch's inputs for the checks
    recorded = []
    real_warp = kw.warp_windowed
    kw.warp_windowed = _recording(kw, recorded)
    try:
        with origin_table_raises(kw):
            run()
    finally:
        kw.warp_windowed = real_warp
    t0 = _phase("adaptive_record", t0)

    # the path, counted and timed
    pair_ms = []
    torch.cuda.reset_peak_memory_stats()
    with origin_table_raises(kw):
        kw.launches = 0
        outs, counts = run(pair_ms)
        launches = kw.launches
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    require(len(recorded) == launches == sum(counts), f"{launches} K1 launches in the sequence")
    require_whole_c(kw, "adaptive", recorded)
    t0 = _phase("adaptive_main", t0)

    # routes: each pair's equals bin_winner of its measured motion, and its
    # K1 launches say which expert ran
    routes = []
    for (name, a, b), sig, n in zip(seq, sigs, counts):
        mm = float(sig["motion_mean"][0])
        scene = bool(sig["is_scene_change"][0])
        route = "scene_change" if scene else bin_winner("native", mm, path=gate)
        routes.append(route)
        print(f"adaptive pair {name}: motion_mean {mm:.4f} px, motion_max "
              f"{float(sig['motion_max'][0]):.3f}, ssim {float(sig['ssim'][0]):.4f}, warped_ssim "
              f"{float(sig['warped_ssim'][0]):.4f}, hud_coverage {float(sig['hud_coverage'][0]):.4f}"
              f" -> {route}, {n} K1 launches")
        require(n == K1_PER_ROUTE[route], f"pair {name}: {n} K1 launches for route {route}")
    measured = routes[HISTORY_PAIRS:]
    require(measured[-1] == "scene_change" and set(measured) == set(K1_PER_ROUTE),
            f"the measured pairs hit every route: {measured}")
    stats = model.get_stats()
    require([stats["rife"], stats["vfimamba"], stats["scene_change"]]
            == [routes.count(r) for r in ("rife", "vfimamba", "scene_change")], f"stats {stats}")

    # outputs: finite frames in [0, 1]; HUD pixels their source where the
    # composite applies; the cut pair's midpoints x0 but there; the moving
    # midpoints above frame duplication against the true in-between frames
    gain = []
    for i, ((name, a, b), sig, out) in enumerate(zip(seq, sigs, outs)):
        require(tuple(out.shape) == (1, len(TS), H, W, 3) and bool(torch.isfinite(out).all())
                and float(out.min()) >= 0.0 and float(out.max()) <= 1.0, f"pair {name} output")
        x0, x1 = batched(a)[0], batched(b)[0]
        hud = sig["hud_mask"][0] & bool(sig["hud_coverage"][0] > 0.01)
        if i >= HISTORY_PAIRS:
            require(bool(hud.any()), f"pair {name}: the HUD composite engaged")
        for k, t in enumerate(TS):
            mid, src = out[0, k], (x0 if t < 0.5 else x1)
            require(torch.equal(mid[hud], src[hud]), f"pair {name} t={t}: HUD pixels")
            if routes[i] == "scene_change":
                require(torch.equal(mid[~hud], x0[~hud]), f"pair {name} t={t}: the cut holds x0")
            elif a != b:
                truth = scene_frame(a + t * (b - a), dev)
                p_mid, p_dup = psnr(to_uint8(mid), truth), psnr(u8[a], truth)
                gain.append(p_mid - p_dup)
                require(p_mid > p_dup, f"pair {name} t={t}: interpolated {p_mid:.2f} dB <= "
                                       f"duplicate {p_dup:.2f} dB")
    print(f"adaptive midpoint PSNR gain over frame duplication (dB): min {min(gain):.3f} "
          f"mean {sum(gain) / len(gain):.3f}")

    # K1 against its twin, and the kernels' origins, at every launch
    max_err = 0.0
    for j, a in enumerate(recorded):
        check_origins(kw, f"adaptive launch {j}", a)
        max_err = max(max_err, check_warp(kw, f"adaptive launch {j}", a))
    t0 = _phase("adaptive_checks", t0)

    # the whole sequence with the kernel against it with the plain twin, and
    # masked against hosted (deterministic cuDNN for all three runs)
    def plain_warp(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        return kw.warp_windowed_plain(img, flow, t, r, border, compute_dtype)

    torch.backends.cudnn.deterministic = True
    try:
        outs_k, _ = run()
        kw.warp_windowed = plain_warp
        try:
            outs_p, _ = run()
        finally:
            kw.warp_windowed = real_warp
        model.route_mode = "masked"
        try:
            outs_m, counts_m = run()
        finally:
            model.route_mode = "hosted"
    finally:
        torch.backends.cudnn.deterministic = False
    d_twin = max((o - p).abs().max().item() for o, p in zip(outs_k, outs_p))
    d_mask = max((o - m).abs().max().item() for o, m in zip(outs_k, outs_m))
    print(f"adaptive sequence with kernel vs with plain twin: max {d_twin:.3e} (tolerance 2/255, "
          f"K1's bound in bf16 windows); masked vs hosted: max {d_mask:.3e} (tolerance 1e-5), "
          f"{counts_m} K1 launches per pair masked")
    require(d_twin <= 2.0 / 255.0, "adaptive sequence, kernel vs twin")
    require(d_mask <= 1e-5, "adaptive masked vs hosted")
    require(all(n == K1_MASKED for n in counts_m), "masked mode runs both experts on every pair")

    # the per-pair numpy entry point once: 5 frames at 2560x1440 uint8
    _, a, b = MEASURED[2]
    out_hw = scale_size(H, W, SCALE)
    res = model.process_pair(u8[a].cpu().numpy(), u8[b].cpu().numpy(), 3, SCALE)
    require(len(res.frames) == 5 and all(str(f.dtype) == "uint8" and f.shape == (*out_hw, 3)
                                         for f in res.frames), "process_pair frames")
    print(f"adaptive process_pair (pan 8 px, 5 frames {res.frames[0].shape} {res.frames[0].dtype}): "
          f"{res.inference_time_ms:.3f} ms host clock, route "
          f"{res.extra_info['analysis']['recommended_model']}, peak {res.vram_peak_mb:.1f} MB")
    t0 = _phase("adaptive_entry", t0)

    # where a pair's time goes, per route, each stage alone after warm-up
    # (peaks: max_memory_allocated during the stage, over what was
    # allocated before it: weights, frames and this script's recordings)
    def over_resident(resident):
        return f"peak {(torch.cuda.max_memory_allocated() - resident) / 1e6:.1f} MB over " \
               f"{resident / 1e6:.1f} MB resident"

    x = {name: (batched(a), batched(b)) for name, a, b in MEASURED}
    for name, _, _ in MEASURED:
        x0, x1 = x[name]
        model.interpolate_batch(x0, x1, TS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ms = time_ms(lambda: model.interpolate_batch(x0, x1, TS), 3, warmup=0)
        print(f"adaptive stage interpolate_batch, pair {name}: {ms:.3f} ms, "
              f"{over_resident(resident)}")
    x0, x1 = x["pan 3 px"]
    print(f"adaptive stage analysis (analyze_device): {time_ms(lambda: real_analyze(x0, x1), 5):.3f} ms")
    print(f"adaptive stage rife (RIFEModel.interpolate_batch, f32): "
          f"{time_ms(lambda: model._rife.interpolate_batch(x0, x1, TS), 3):.3f} ms")
    scans, real_scan = [], tvm.selective_scan

    def timed_scan(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = real_scan(*args, **kwargs)
        end.record()
        scans.append((start, end))
        return y

    model._vfimamba.interpolate_batch(x0, x1, TS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    tvm.selective_scan = timed_scan
    try:
        fwd_ms = time_ms(lambda: model._vfimamba.interpolate_batch(x0, x1, TS), 2, warmup=0)
    finally:
        tvm.selective_scan = real_scan
    scan_ms = sum(s.elapsed_time(e) for s, e in scans) / 2
    print(f"adaptive stage vfimamba (VFIMambaModel.interpolate_batch, f32): {fwd_ms:.3f} ms, "
          f"selective_scan {scan_ms:.3f} ms in {len(scans) // 2} calls ({100 * scan_ms / fwd_ms:.1f}%),"
          f" {over_resident(resident)}")
    # why VFIMamba's decoder conv runs without cuDNN at this shape
    # (models/base.py::planned_conv; not in CUDNN_WINS): the conv each way
    conv = model._vfimamba.module.Conv_3
    feat = torch.randn((len(TS), conv.in_channels, -(-H // 32) * 4, -(-W // 32) * 4), device=dev)
    with torch.no_grad():
        for label, cudnn_on in (("cuDNN", True), ("PyTorch's own (the path)", False)):
            torch.backends.cudnn.enabled = cudnn_on
            try:
                conv(feat)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                ms = time_ms(lambda: conv(feat), 3, warmup=0)
            finally:
                torch.backends.cudnn.enabled = True
            print(f"adaptive stage vfimamba decoder conv {tuple(feat.shape)} -> {conv.out_channels}, "
                  f"f32, {label}: {ms:.3f} ms, {over_resident(resident)}")
    t0 = _phase("adaptive_breakdown", t0)

    # K1 per launch shape of the sequence, and per pair of each route
    by_shape = shape_times(kw, recorded, time_launch)
    for key, v in by_shape.items():
        print(f"adaptive launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} "
              f"{key[4]} x{v['n']}/sequence: kernel {v['kernel']:.4f} ms, bound {v['bound']:.4f} ms "
              f"({v['by']}), wrapper host {v['host']:.4f} ms, wrapper {v['wrapper']:.4f} ms, "
              f"plain {v['plain']:.4f} ms, grid_sample {v['library']:.4f} ms")
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    start = 0
    per_route = {}  # K1's numbers per pair of each route (the stream phase's launches)
    for (name, _, _), n, route in zip(seq, counts, routes):
        pair = [by_shape[shape_key(a)] for a in recorded[start:start + n]]
        start += n
        per_route.setdefault(route, dict(
            {f: sum(v[f] for v in pair) for f in fields},
            by="bytes" if {v["by"] for v in pair} == {"bytes"} else "operations"))
        if name in dict((m[0], m) for m in MEASURED):
            print(f"adaptive K1 per pair {name}: {n} launches, " + ", ".join(
                f"{f} {sum(v[f] for v in pair):.4f} ms" for f in fields))
    total = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    total["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    ms = sum(pair_ms[HISTORY_PAIRS:]) / len(MEASURED)
    print(f"adaptive sequence {W}x{H}, {len(TS)} midpoints, hosted: ms per measured pair "
          + ", ".join(f"{m[0]} {t:.3f}" for m, t in zip(MEASURED, pair_ms[HISTORY_PAIRS:]))
          + f" (mean {ms:.3f}); history pairs {', '.join(f'{t:.3f}' for t in pair_ms[:HISTORY_PAIRS])};"
          f" {launches} K1 launches; max_memory_allocated {peak_mb:.1f} MB")
    _phase("adaptive_timing", t0)
    return path_numbers(launches, max_err, total, 1), per_route


# the stream phases: the port's video-in, video-out entry point
# (pipeline/streaming.py::process_video) on Y4M files in a temporary directory
STREAM_FRAMES = 13  # flagship: 12 pairs, 49 output frames at 2560x1440
STREAM_OUT = (2560, 1440)
# adaptive: the adaptive phase's sequence as one stream (5 history pans, a
# static pair, a 3 px pan, an 8 px pan, a cut)
STREAM_SCENE = (0, 3, 6, 9, 12, 15, 15, 18, 26, "cut")


def write_y4m(path: Path, frames) -> None:
    """Device uint8 [H,W,3] frames into a 30 fps Y4M with the port's writer."""
    from vfisr_tpu_torch.data.video_io import VideoWriter

    h, w = frames[0].shape[:2]
    with VideoWriter(str(path), w, h, 30) as wr:
        for f in frames:
            wr.write(f.cpu().numpy())


def read_y4m_planes(path: Path) -> list:
    from vfisr_tpu_torch.data.video_io import VideoReader

    with VideoReader(str(path)) as rd:
        planes = []
        while (p := rd.read_i420()) is not None:
            planes.append(torch.from_numpy(p))
    return planes


def capturing_build(streaming, hook):
    """streaming._build_model, handing each model it builds to hook first."""
    real = streaming._build_model

    def build(*args, **kwargs):
        model = real(*args, **kwargs)
        hook(model)
        return model

    return build


def print_stream(label: str, stats: dict, pairs: int, card: str) -> None:
    fps = len(TS) * pairs / stats["elapsed_s"]
    print(f"stream {label} ({card}): {pairs} pairs in {stats['elapsed_s']:.3f} s, "
          f"interpolated fps {fps:.2f}, realtime_x {stats['realtime_x']:.4f}, "
          f"{stats['output_frames']} frames out, readback {stats['readback_format']} "
          f"{stats['readback_mb']} MB, device_busy_fraction {stats['device_busy_fraction']}")
    print(f"stream {label} timers: " + ", ".join(
        f"{k} {stats[k]}" for k in ("decode_wait_s", "dispatch_s", "first_dispatch_s",
                                     "enqueue_wait_s", "main_other_s", "device_materialize_s",
                                     "encode_s")))
    print(f"stream {label} stats: {stats}")


def stream_flagship_phase(kw, rife_npz: Path, card: str, per_pair: dict) -> dict:
    """Step 15 of the module docstring. Returns K1's numbers over the
    stream's counted launches, timed per pair in step 7."""
    from vfisr_tpu_torch.core.color import i420_to_rgb, rgb_to_i420
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.data.video_io import VideoReader, probe_video
    from vfisr_tpu_torch.pipeline import streaming
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    ow, oh = STREAM_OUT
    pairs = STREAM_FRAMES - 1
    built = []
    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "in.y4m", Path(tmp) / "out.y4m"
        write_y4m(src, [game_frame(i, dev) for i in range(STREAM_FRAMES)])
        meta = probe_video(str(src))
        require((meta.width, meta.height, meta.fps, meta.frame_count) == (W, H, 30.0, STREAM_FRAMES),
                f"input Y4M {meta}")
        # I420 -> RGB of a 1080p frame on the host (VideoReader.read) and on
        # the card (process_video): why the stream converts on the card
        with VideoReader(str(src)) as rd:
            buf = torch.from_numpy(rd.read_i420())
        on_host = host_ms(lambda: i420_to_rgb(buf, H, W), 5)
        on_card = buf.to(dev)
        print(f"stream decode I420 -> RGB of a {W}x{H} frame: host {on_host:.3f} ms, "
              f"on the card {time_ms(lambda: i420_to_rgb(on_card, H, W), 20):.4f} ms")
        t0 = _phase("stream_flagship_write", t0)

        real_build = streaming._build_model
        streaming._build_model = capturing_build(streaming, built.append)
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                stats = streaming.process_video(str(src), str(out), method="flagship",
                                                target_fps=120, target_resolution=STREAM_OUT)
                launches = kw.launches
        finally:
            streaming._build_model = real_build
        t0 = _phase("stream_flagship_run", t0)
        print_stream("flagship", stats, pairs, card)
        vfi = built[0]
        require(vfi._module.config.channels == (256, 160, 112, 80), "full-width RIFE")
        want = params_from_jax(load_npz(str(rife_npz)))
        state = vfi._module.state_dict()
        require(set(state) == set(want) and all(torch.equal(state[k].float().cpu(),
                                                            want[k].to(state[k].dtype).float())
                                                for k in want),
                f"every parameter of {rife_npz.name} loaded")
        require(vfi.base_config.scene_warp_ssim_threshold != 1.0, "calibrated scene gate loaded")
        require(stats["pipeline"] == "fused_writer_thread" and stats["readback_format"] == "yuv420"
                and stats["input_frames"] == STREAM_FRAMES
                and stats["output_frames"] == 4 * pairs + 1, f"stream stats {stats}")
        require(launches == LAUNCHES_PER_PAIR * pairs, f"{launches} K1 launches in the stream")
        planes = read_y4m_planes(out)
        require(len(planes) == 4 * pairs + 1 and probe_video(str(out)).frame_count == len(planes),
                f"{len(planes)} frames in the output Y4M")
        with VideoReader(str(src)) as rd:
            decoded = [torch.from_numpy(f).to(dev) for f in rd]

    # each pair's four frames against the fused step and the pack computed
    # directly, the HUD history carried the same way; K1 against its twin
    # and its origins at every launch of it
    vfi.reset_history()
    real_warp, max_err = kw.warp_windowed, 0.0
    gain = []
    scale = oh / H
    for i in range(pairs):
        recs = []
        kw.warp_windowed = _recording(kw, recs)
        try:
            up = vfi.fused_stream_step(decoded[i], decoded[i + 1], scale, TS)
        finally:
            kw.warp_windowed = real_warp
        want = streaming.pack_i420(up).cpu().reshape(len(TS) + 1, -1)
        got = torch.stack(planes[4 * i:4 * i + 4])
        require(torch.equal(got, want), f"stream pair {i}: the output planes are "
                                        f"pack_i420(fused_stream_step(...)) "
                                        f"(max {(got.int() - want.int()).abs().max().item()} LSB)")
        require(len(recs) == LAUNCHES_PER_PAIR, f"stream pair {i}: {len(recs)} K1 launches")
        for j, a in enumerate(recs):
            check_origins(kw, f"stream pair {i} launch {j}", a)
            max_err = max(max_err, check_warp(kw, f"stream pair {i} launch {j}", a))
        for k, t in enumerate(TS):
            truth = rgb_to_i420(to_uint8(resize(game_frame(i + t, dev).float()[None] / 255.0,
                                                (oh, ow), "lanczos4")))[0].cpu()
            p_mid, p_dup = psnr(got[1 + k], truth), psnr(got[0], truth)
            gain.append(p_mid - p_dup)
            require(p_mid > p_dup, f"stream pair {i} t={t}: interpolated {p_mid:.2f} dB <= "
                                   f"duplicate {p_dup:.2f} dB")
    last = rgb_to_i420(torch.from_numpy(vfi.upscale(decoded[-1].cpu().numpy(), scale))).cpu()
    require(torch.equal(planes[-1], last), "the final endpoint")
    print(f"stream flagship: every pair's planes equal pack_i420(fused_stream_step(...)); "
          f"midpoint PSNR gain over frame duplication (dB, I420 bytes against the rendered "
          f"truth): min {min(gain):.3f} mean {sum(gain) / len(gain):.3f}; K1 vs twin max_abs_err "
          f"{max_err:.3e} over {LAUNCHES_PER_PAIR * pairs} launches")
    _phase("stream_flagship_checks", t0)
    return path_numbers(launches, max_err, per_pair, pairs)


def stream_adaptive_phase(kw, card: str, per_route: dict, err: float) -> dict:
    """Step 16 of the module docstring. Returns K1's numbers over the
    stream's counted launches, timed per pair and route in step 9."""
    from vfisr_tpu_torch.models.sota import vfimamba as tvm
    from vfisr_tpu_torch.models.sota.rife import RIFEConfig
    from vfisr_tpu_torch.pipeline import streaming
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax
    from vfisr_tpu_torch.utils.router_gate import bin_winner, expert_bins

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    pairs = len(STREAM_SCENE) - 1
    built, calls = [], []

    def hook(model):
        """Record each pair's inputs, signals and midpoints."""
        real_analyze, real_interp = model.router.analyze_device, model.interpolate_batch

        def analyze(x0, x1):
            start = kw.launches
            sig = real_analyze(x0, x1)
            calls.append(dict(x0=x0, x1=x1, sig=sig, start=start))
            return sig

        def interpolate(x0, x1, timestamps):
            out = real_interp(x0, x1, timestamps)
            calls[-1].update(out=out, launches=kw.launches - calls[-1]["start"])
            return out

        model.router.analyze_device, model.interpolate_batch = analyze, interpolate
        built.append(model)

    with tempfile.TemporaryDirectory() as tmp:
        src, out = Path(tmp) / "in.y4m", Path(tmp) / "out.y4m"
        write_y4m(src, [scene_frame(x, dev) for x in STREAM_SCENE])
        t0 = _phase("stream_adaptive_write", t0)
        real_build = streaming._build_model
        streaming._build_model = capturing_build(streaming, hook)
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                stats = streaming.process_video(str(src), str(out), target_fps=120,
                                                target_resolution=STREAM_OUT)
                launches = kw.launches
        finally:
            streaming._build_model = real_build
        t0 = _phase("stream_adaptive_run", t0)
        print_stream("adaptive", stats, pairs, card)
        n_out = len(read_y4m_planes(out))
    model = built[0]
    gate = model.gate_path
    require(stats["pipeline"] == "writer_thread" and stats["readback_format"] == "yuv420"
            and stats["output_frames"] == n_out == 4 * pairs + 1, f"stream stats {stats}")
    require(model.enable_vfimamba and model._rife.CONFIG == RIFEConfig()
            and model._rife.CONFIG.channels == (256, 160, 112, 80)
            and model._vfimamba.variant == "full" and model._vfimamba.cfg == tvm.MambaConfig(),
            "the default model: full-width RIFE and VFIMamba")
    for expert, name in ((model._rife, "rife.npz"), (model._vfimamba, "vfimamba.npz")):
        state, want = expert.module.state_dict(), params_from_jax(load_npz(str(ROOT / "weights" / name)))
        require(set(state) == set(want) and all(torch.equal(state[k].cpu(), want[k]) for k in want),
                f"every parameter of {name} loaded")
    require(model.router.scene_warp_ssim_threshold != 1.0 and expert_bins("native", gate),
            "calibrated scene gate and expert bins")
    require(len(calls) == pairs, f"{len(calls)} pairs routed")
    routes = []
    for i, c in enumerate(calls):
        sig = c["sig"]
        mm = float(sig["motion_mean"][0])
        route = "scene_change" if bool(sig["is_scene_change"][0]) else bin_winner(
            "native", mm, path=gate)
        routes.append(route)
        print(f"stream adaptive pair {i} ({STREAM_SCENE[i]} -> {STREAM_SCENE[i + 1]}): "
              f"motion_mean {mm:.4f} px -> {route}, {c['launches']} K1 launches")
        require(c["launches"] == K1_PER_ROUTE[route], f"stream pair {i}: {c['launches']} K1 "
                                                      f"launches for route {route}")
        hud = sig["hud_mask"][0] & bool(sig["hud_coverage"][0] > 0.01)
        if i >= HISTORY_PAIRS:
            require(bool(hud.any()), f"stream pair {i}: the HUD composite engaged")
        x0, x1 = c["x0"][0], c["x1"][0]
        for k, t in enumerate(TS):
            mid, src_ = c["out"][0, k], (x0 if t < 0.5 else x1)
            require(torch.equal(mid[hud], src_[hud]), f"stream pair {i} t={t}: HUD pixels")
            if route == "scene_change":
                require(torch.equal(mid[~hud], x0[~hud]), f"stream pair {i} t={t}: the cut holds x0")
    require(routes[-1] == "scene_change" and set(routes) == set(K1_PER_ROUTE),
            f"the stream hits every route: {routes}")
    stats_routes = model.get_stats()
    require([stats_routes[r] for r in ("rife", "vfimamba", "scene_change")]
            == [routes.count(r) for r in ("rife", "vfimamba", "scene_change")],
            f"routing stats {stats_routes}")
    require(launches == sum(K1_PER_ROUTE[r] for r in routes),
            f"{launches} K1 launches, the routes' sum {sum(K1_PER_ROUTE[r] for r in routes)}")
    _phase("stream_adaptive_checks", t0)
    fields = ("kernel", "plain", "bound", "library")
    total = {f: sum(per_route[r][f] for r in routes) for f in fields}
    total["by"] = "bytes" if {per_route[r]["by"] for r in routes} == {"bytes"} else "operations"
    return path_numbers(launches, err, total, 1)


def require_whole_c(kw, label: str, recs: list, grad: bool = False) -> None:
    """Every K1 (grad: K2) launch of recs takes the whole-C layout (one
    channel group): the kernel's instantiation without channel groups."""
    name = "K2" if grad else "K1"
    plans = {shape_key(a): kw.plan(a["img"], a["r"], a["compute_dtype"], grad) for a in recs}
    require(all(p is not None and p["grouped"] == 0 and p["groups"] == 1 for p in plans.values()),
            f"{label}: every {name} launch takes the whole-C layout")
    print(f"{label}: all {len(recs)} {name} launches ({len(plans)} shapes) take the whole-C "
          f"layout (one channel group)")


def grouped_cases(device) -> list:
    """K1 past the channels one window holds: C in GROUPED_C at the shape of
    SAFA's feature warps, f32 and bf16 windows, both borders; flows as
    SAFA's (clamped to +-8) plus noise past the radius."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    n, h, w = 3, 114, 144
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    base = torch.stack([6.0 * torch.sin(xx / 17.0 + yy / 23.0), 3.0 * torch.cos(yy / 9.0)], -1)
    cases = []
    for c in GROUPED_C:
        for dt in (torch.float32, torch.bfloat16):
            for border in ("replicate", "constant"):
                flow = torch.clamp(base + 3.0 * torch.randn((n, h, w, 2), generator=gen), -8, 8)
                cases.append(dict(name=f"grouped C={c}", img=torch.rand((n, h, w, c), generator=gen)
                                  .to(device), flow=flow.to(device), t=1.0, r=8, border=border,
                                  compute_dtype=dt))
    return cases


def conv_calls(module, run) -> list:
    """(name, conv, input shape, cuDNN on) of every Conv2d call while run()
    runs, in call order (forward hooks; the last: whether the path ran that
    call's forward with cuDNN)."""
    calls, hooks = [], []
    for name, m in module.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: calls.append(
                    (name, mod, tuple(inp[0].shape), torch.backends.cudnn.enabled))))
    try:
        run()
    finally:
        for hk in hooks:
            hk.remove()
    return calls


def conv_flop(conv, shape) -> int:
    """Multiply-adds x 2 of one Conv2d call on an input of shape."""
    n, _, h, w = shape
    ho = (h + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1
    wo = (w + 2 * conv.padding[1] - conv.kernel_size[1]) // conv.stride[1] + 1
    return 2 * n * ho * wo * conv.out_channels * conv.in_channels * conv.kernel_size[0] * \
        conv.kernel_size[1]


def time_convs(label: str, calls: list, backward: bool = False) -> dict:
    """Each distinct conv shape of calls, timed with cuDNN's heuristic plan
    and with cuDNN off (PyTorch's own convolution), with the peak memory of
    each over what was resident; f32, TF32 off. backward: also the
    backward (input, weight and bias gradients of the same call), each
    with cuDNN on and off. Prints the path's own forward choice. Returns
    {name: (cudnn ms, own ms)} (forward) for the first call of each shape."""
    seen, out = {}, {}
    dev = torch.device("cuda")
    for name, conv, shape, path_cudnn in calls:
        key = (conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride, shape)
        if key in seen:
            seen[key].append(name)
            continue
        seen[key] = [name]
        feat = torch.rand(shape, device=dev, requires_grad=backward)
        weight, bias = (v.detach().requires_grad_(backward) for v in (conv.weight, conv.bias))

        def fwd():
            return torch.nn.functional.conv2d(feat, weight, bias, conv.stride, conv.padding)

        res = []
        with torch.set_grad_enabled(backward):
            for cudnn_on in (True, False):
                torch.backends.cudnn.enabled = cudnn_on
                try:
                    y = fwd()
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    resident = torch.cuda.memory_allocated()
                    ms = time_ms(fwd, 3, warmup=0)
                    bwd_ms = math.nan
                    if backward:
                        ct = torch.randn_like(y)
                        bwd_ms = time_ms(lambda: torch.autograd.grad(
                            y, (feat, weight, bias), ct, retain_graph=True), 3)
                    peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
                    del y
                finally:
                    torch.backends.cudnn.enabled = True
                res.append((ms, bwd_ms, peak))
        del feat
        out[name] = (res[0][0], res[1][0])
        gflop = conv_flop(conv, shape) / 1e9
        bwd = (f", backward {res[0][1]:.3f} ms / {res[1][1]:.3f} ms ({2 * gflop:.2f} GFLOP, f32 "
               f"bound {2 * gflop / F32_FLOP_PER_S * 1e12:.3f} ms)") if backward else ""
        print(f"{label} conv {name} {tuple(shape)} {conv.in_channels}->{conv.out_channels} "
              f"k{conv.kernel_size[0]} s{conv.stride[0]}, f32, {gflop:.2f} GFLOP: cuDNN "
              f"{res[0][0]:.3f} ms (peak {res[0][2]:.1f} MB over resident), cuDNN off "
              f"{res[1][0]:.3f} ms (peak {res[1][2]:.1f} MB); f32 bound "
              f"{gflop / F32_FLOP_PER_S * 1e12:.3f} ms{bwd}; the path's forward: "
              f"{'cuDNN' if path_cudnn else 'cuDNN off'} (the "
              f"{'faster' if (res[0][0] <= res[1][0]) == path_cudnn else 'slower'} here)")
    for key, names in seen.items():
        if len(names) > 1:
            print(f"{label} conv shape of {names[0]} also: {', '.join(names[1:])}")
    return out


def safa_phase(kw) -> dict:
    """Step 10 of the module docstring. Returns K1's numbers over the
    counted pairs (``path_numbers``)."""
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import resize, scale_size
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    npz = ROOT / "weights" / "safa.npz"
    require(npz.is_file(), f"{npz} present")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    model = get_model("safa", load=True)
    require(model.device.type == "cuda", "SAFA on the card")
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after SAFAModel.load")
    state, want = model.module.state_dict(), params_from_jax(load_npz(str(npz)))
    require(set(state) == set(want) and all(torch.equal(state[k].cpu(), want[k]) for k in want),
            f"every parameter of {npz.name} loaded")
    require(model.module.c == 176 and model.module.num_dec_blocks == 8, "full-width SAFA")
    print(f"safa: get_model('safa', load=True): {model.info.parameters} parameters, c "
          f"{model.module.c}, {model.module.num_dec_blocks} decoder blocks, tiles "
          f"{model.TILE_HW} + {model.OVERLAP} px, budget {model.tile_px_budget} px")
    u8 = {x: scene_frame(x, dev) for _, a, b in SAFA_PAIRS for x in (a, b)}

    def batched(x):
        return u8[x].float()[None] / 255.0

    t0 = _phase("safa_load", t0)

    # one pair recorded (warm-up): every K1 launch's inputs
    recorded = []
    real_warp = kw.warp_windowed
    kw.warp_windowed = _recording(kw, recorded)
    try:
        with origin_table_raises(kw):
            model.interpolate_batch(batched(SAFA_PAIRS[2][1]), batched(SAFA_PAIRS[2][2]), TS)
            torch.cuda.synchronize()
    finally:
        kw.warp_windowed = real_warp
    require(len(recorded) == K1_PER_SAFA_PAIR, f"{len(recorded)} K1 launches in a SAFA pair")
    t0 = _phase("safa_record", t0)

    # the path, counted and timed
    pair_ms, outs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with origin_table_raises(kw):
        kw.launches = 0
        for _, a, b in SAFA_PAIRS:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(model.interpolate_batch(batched(a), batched(b), TS))
            end.record()
            end.synchronize()
            pair_ms.append(start.elapsed_time(end))
        launches = kw.launches
    peak_mb = (torch.cuda.max_memory_allocated() - resident) / 1e6
    require(launches == K1_PER_SAFA_PAIR * len(SAFA_PAIRS),
            f"{launches} K1 launches in {len(SAFA_PAIRS)} SAFA pairs")
    t0 = _phase("safa_main", t0)

    # outputs: finite [0, 1] frames of the input's size; midpoint PSNR
    # against the scene's true in-between frames and against duplication
    # (printed only: the weights' quality is measured on their own data)
    for (name, a, b), out in zip(SAFA_PAIRS, outs):
        # the net's 2x frames are clipped to [0, 1]; Lanczos4 back to the
        # input's size may overshoot that a little, as in the reference
        require(tuple(out.shape) == (1, len(TS), H, W, 3) and bool(torch.isfinite(out).all())
                and float(out.min()) >= -0.25 and float(out.max()) <= 1.25,
                f"SAFA pair {name} output: {tuple(out.shape)}, {float(out.min())} to "
                f"{float(out.max())}")
        line = [f"range {float(out.min()):.4f} to {float(out.max()):.4f}"]
        for k, t in enumerate(TS):
            truth = scene_frame(a + t * (b - a), dev)
            line.append(f"t={t} {psnr(to_uint8(out[0, k]), truth):.3f} dB "
                        f"(duplicate {psnr(u8[a], truth):.3f})")
        print(f"safa pair {name}: midpoint PSNR against the true frame " + ", ".join(line))

    # K1 against its twin and the kernels' origins at every launch of the
    # recorded pair; the feature launches take channel groups
    max_err = 0.0
    for j, a in enumerate(recorded):
        check_origins(kw, f"safa launch {j}", a)
        max_err = max(max_err, check_warp(kw, f"safa launch {j}", a))
    for key in {shape_key(a): a for a in recorded}.values():
        p = kw.plan(key["img"], key["r"], key["compute_dtype"])
        print(f"safa K1 plan {_label(key)}: {p}")
        require(p["grouped"] == (key["img"].shape[-1] > 3), f"SAFA plan {_label(key)}")
    # the pair with the kernel against the pair with the plain twin
    # (deterministic cuDNN for both)
    x0, x1 = batched(SAFA_PAIRS[2][1]), batched(SAFA_PAIRS[2][2])

    def plain_warp(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        return kw.warp_windowed_plain(img, flow, t, r, border, compute_dtype)

    torch.backends.cudnn.deterministic = True
    try:
        out_k = model.interpolate_batch(x0, x1, TS)
        kw.warp_windowed = plain_warp
        try:
            out_p = model.interpolate_batch(x0, x1, TS)
        finally:
            kw.warp_windowed = real_warp
    finally:
        torch.backends.cudnn.deterministic = False
    d_twin = (out_k - out_p).abs().max().item()
    print(f"safa pair with kernel vs with plain twin (deterministic cuDNN): max {d_twin:.3e} "
          f"(tolerance 1e-5)")
    require(d_twin <= 1e-5, "SAFA pair, kernel vs twin")
    t0 = _phase("safa_checks", t0)

    # the joint entry point once: 5 frames at 2560x1440 uint8
    out_hw = scale_size(H, W, SCALE)
    start = time.perf_counter()
    frames = model.joint_process(u8[SAFA_PAIRS[2][1]].cpu().numpy(),
                                 u8[SAFA_PAIRS[2][2]].cpu().numpy(), 3, SCALE)
    jp_ms = (time.perf_counter() - start) * 1e3
    require(len(frames) == 5 and all(str(f.dtype) == "uint8" and f.shape == (*out_hw, 3)
                                     for f in frames), "SAFA joint_process frames")
    end_ref = to_uint8(resize(x0, out_hw, "lanczos4"))[0].cpu().numpy()
    print(f"safa joint_process (pan 8 px, 5 frames {frames[0].shape} {frames[0].dtype}, scale "
          f"{SCALE:.4f}): {jp_ms:.3f} ms host clock; endpoint t=0 vs Lanczos4 of x0: "
          f"{psnr(torch.from_numpy(frames[0]), torch.from_numpy(end_ref)):.3f} dB")
    t0 = _phase("safa_entry", t0)

    # where a pair's time goes: one tile's forward (batch 3), its convs
    th, tw = model.TILE_HW
    tile = (1, th + 2 * model.OVERLAP, tw + 2 * model.OVERLAP)
    a3 = x0[:, :tile[1], :tile[2]].repeat_interleave(len(TS), 0).contiguous()
    b3 = x1[:, :tile[1], :tile[2]].repeat_interleave(len(TS), 0).contiguous()
    ts3 = torch.tensor(TS, device=dev)
    model.net(a3, b3, ts3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    tile_ms = time_ms(lambda: model.net(a3, b3, ts3), 3, warmup=0)
    tile_peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
    calls = conv_calls(model.module, lambda: model.net(a3, b3, ts3))
    tile_flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
    n_tiles = -(-H // th) * -(-W // tw)
    print(f"safa tile forward {tuple(a3.shape)} x2 frames, batch {len(TS)}: {tile_ms:.3f} ms, peak "
          f"{tile_peak:.1f} MB over {resident / 1e6:.1f} MB resident; its {len(calls)} convs "
          f"{tile_flop / 1e12:.4f} TFLOP (f32 bound {tile_flop / F32_FLOP_PER_S * 1e3:.3f} ms); "
          f"{n_tiles} tiles per pair: {n_tiles * tile_flop / 1e12:.4f} TFLOP, f32 bound "
          f"{n_tiles * tile_flop / F32_FLOP_PER_S * 1e3:.3f} ms")
    time_convs("safa", calls)
    del a3, b3
    t0 = _phase("safa_breakdown", t0)

    # K1 per launch shape of a pair
    by_shape = shape_times(kw, recorded, time_launch)
    for key, v in by_shape.items():
        print(f"safa launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} "
              f"{key[4]} x{v['n']}/pair: kernel {v['kernel']:.4f} ms, bound {v['bound']:.4f} ms "
              f"({v['by']}), wrapper host {v['host']:.4f} ms, wrapper {v['wrapper']:.4f} ms, "
              f"plain {v['plain']:.4f} ms, grid_sample {v['library']:.4f} ms")
        print_grouped(kw, "safa", "pair", key, next(a for a in recorded if shape_key(a) == key),
                      v, False)
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    total = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    total["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    print(f"safa K1 per pair: {K1_PER_SAFA_PAIR} launches, " + ", ".join(
        f"{f} {total[f]:.4f} ms" for f in fields))
    print(f"safa {W}x{H} pairs, {len(TS)} midpoints (interpolate_batch, {n_tiles} tiles): ms per "
          f"pair " + ", ".join(f"{p[0]} {t:.3f}" for p, t in zip(SAFA_PAIRS, pair_ms))
          + f" (mean {sum(pair_ms) / len(pair_ms):.3f}); peak {peak_mb:.1f} MB over resident; "
          f"{launches} K1 launches")
    _phase("safa_timing", t0)
    return path_numbers(launches, max_err, total, len(SAFA_PAIRS))


def span_phase(kw) -> None:
    """Step 11 of the module docstring."""
    from vfisr_tpu_torch.core.resize import resize, scale_size
    from vfisr_tpu_torch.models.novel.adaptive_pipeline import AdaptivePipeline
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.models.sota.span import SPANModel
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    span = get_model("span", load=True)
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after SPANModel.load")
    npz = ROOT / "weights" / "span_x2.npz"
    state, want = span.module.state_dict(), params_from_jax(load_npz(str(npz)))
    require(span.scale == 2 and set(state) == set(want)
            and all(torch.equal(state[k].cpu(), want[k]) for k in want),
            f"every parameter of {npz.name} loaded")
    out_hw = scale_size(H, W, SCALE)
    four = torch.stack([scene_frame(x, dev) for x in (15, 18, 21, 26)]).float() / 255.0
    up = span.upscale_batch(four, SCALE)
    require(tuple(up.shape) == (4, *out_hw, 3) and bool(torch.isfinite(up).all())
            and float(up.min()) >= 0.0 and float(up.max()) <= 1.0, "SPAN x2 output")
    lanczos = resize(four, out_hw, "lanczos4").clamp(0.0, 1.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ms = time_ms(lambda: span.upscale_batch(four, SCALE), 3)
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
    net_ms = time_ms(lambda: span.module(four), 3)
    calls = conv_calls(span.module, lambda: span.module(four))
    flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
    print(f"span x2: 4 frames {W}x{H} -> {out_hw[1]}x{out_hw[0]} (upscale_batch: net, Lanczos4, "
          f"clip): {ms:.3f} ms ({ms / 4:.3f} per frame), the net alone {net_ms:.3f} ms, peak "
          f"{peak:.1f} MB over resident; convs {flop / 1e12:.4f} TFLOP (f32 bound "
          f"{flop / F32_FLOP_PER_S * 1e3:.3f} ms); PSNR against Lanczos4 "
          f"{psnr(up * 255.0, lanczos * 255.0):.3f} dB")
    time_convs("span x2", calls)
    t0 = _phase("span_x2", t0)

    x4 = SPANModel(scale=4, device="cuda")
    x4.load()
    small = resize(four[:1], (H // 2, W // 2), "area")
    up4 = x4.upscale_batch(small, H * SCALE / (H // 2))
    require(tuple(up4.shape) == (1, *out_hw, 3) and bool(torch.isfinite(up4).all()),
            "SPAN x4 output")
    ms4 = time_ms(lambda: x4.upscale_batch(small, H * SCALE / (H // 2)), 3)
    print(f"span x4: 1 frame {W // 2}x{H // 2} -> {out_hw[1]}x{out_hw[0]}: {ms4:.3f} ms; PSNR "
          f"against the 1440p Lanczos4 of the full frame "
          f"{psnr(up4[0] * 255.0, lanczos[0] * 255.0):.3f} dB")
    del x4, up4
    t0 = _phase("span_x4", t0)

    u8 = {x: scene_frame(x, dev).cpu().numpy() for x in (18, 26)}
    rs = get_model("rife_span", load=True)
    res = rs.process_pair(u8[18], u8[26], 3, SCALE)
    require(len(res.frames) == 5 and all(str(f.dtype) == "uint8" and f.shape == (*out_hw, 3)
                                         for f in res.frames), "rife_span process_pair frames")
    print(f"rife_span process_pair (pan 8 px, 5 frames {res.frames[0].shape}): "
          f"{res.inference_time_ms:.3f} ms host clock (VFI {res.extra_info['vfi_time_ms']:.3f}, "
          f"SR {res.extra_info['sr_time_ms']:.3f}), model {res.model_used}")
    del rs
    t0 = _phase("rife_span", t0)

    files = {"rife_weights": ROOT / "weights" / "rife.npz",
             "vfimamba_weights": ROOT / "weights" / "vfimamba.npz",
             "gate_path": ROOT / "weights" / "router_gate.json"}
    pipe = AdaptivePipeline(sr_model_name="span", **{k: str(p) for k, p in files.items()})
    pipe.load()
    require(isinstance(pipe._sr, SPANModel) and pipe._sr.scale == 2, "adaptive SPAN SR loaded")
    x0, x1 = (torch.from_numpy(u8[x]).to(dev).float()[None] / 255.0 for x in (18, 26))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    mids = pipe.interpolate_batch(x0, x1, TS)
    ups = pipe.upscale_batch(torch.cat([x0, mids[0]]), SCALE)
    end.record()
    end.synchronize()
    require(tuple(ups.shape) == (4, *out_hw, 3) and bool(torch.isfinite(ups).all())
            and (ups - span.upscale_batch(torch.cat([x0, mids[0]]), SCALE)).abs().max() <= 1e-5,
            "adaptive SPAN upscale_batch is SPAN's")
    print(f"adaptive (sr_model_name='span') pan 8 px: interpolate_batch + upscale_batch of 4 "
          f"frames to {out_hw[1]}x{out_hw[0]}: {start.elapsed_time(end):.3f} ms (first call), route "
          f"{pipe.get_stats()}")
    _phase("adaptive_span", t0)


def timed_steps(kw, step, batch, steps: int) -> tuple:
    """steps train steps after one warm-up, each timed with CUDA events
    (data and step), K1 and K2 counted from 0 with ``window_origins``
    raising: (ms per step, losses, K1 launches, K2 launches, peak MB)."""
    step(batch())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    with origin_table_raises(kw):
        kw.launches = kw.grad_launches = 0
        for _ in range(steps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(batch())
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(loss.item())
        k1, k2 = kw.launches, kw.grad_launches
    require(all(v == v and abs(v) < float("inf") for v in losses), "finite losses")
    return step_ms, losses, k1, k2, torch.cuda.max_memory_allocated() / 1e6


def per_shape_totals(kw, label: str, unit: str, recs: list, timer) -> dict:
    """Per launch shape of recs: prints the timer's numbers, and returns
    their totals over recs (each shape's numbers times its launches)."""
    by_shape = shape_times(kw, recs, timer)
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    for key, v in by_shape.items():
        a = next(r for r in recs if shape_key(r) == key)
        pl = kw.plan(a["img"], a["r"], a["compute_dtype"], timer is time_grad_launch)
        print(f"{label} shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} "
              f"{key[4]} x{v['n']}/{unit} ({'grouped' if pl['grouped'] else 'whole-C'}, "
              f"{pl['groups']} group(s) of {pl['cg']}, {pl['ctas']} CTAs): kernel "
              f"{v['kernel']:.4f} ms, bound {v['bound']:.4f} ms ({v['by']}), wrapper host "
              f"{v['host']:.4f} ms, wrapper {v['wrapper']:.4f} ms, plain {v['plain']:.4f} ms, "
              f"grid_sample{' grad' if timer is time_grad_launch else ''} {v['library']:.4f} ms")
        print_grouped(kw, label, unit, key, a, v, timer is time_grad_launch)
    tot = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    tot["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    print(f"{label} per {unit}: {len(recs)} launches, " + ", ".join(
        f"{f} {tot[f]:.4f} ms" for f in fields))
    return tot


def train_safa_phase(kw) -> tuple:
    """Step 13 of the module docstring. Returns K1's and K2's numbers over
    the counted train steps (``path_numbers``)."""
    from vfisr_tpu_torch.core import warp as core_warp
    from vfisr_tpu_torch.models.sota.safa import SAFAModel
    from vfisr_tpu_torch.train.__main__ import batch_maker
    from vfisr_tpu_torch.train.train import create_train_state, make_train_step

    t0 = time.perf_counter()
    npz = ROOT / "weights" / "safa.npz"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    model = SAFAModel(device="cuda")
    model.load(weights_path=str(npz))  # explicit path: strict
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "TF32 off after SAFAModel.load")
    module = model.trainable()
    require(module.c == 176 and module.num_dec_blocks == 8 and module.training
            and all(p.requires_grad for p in module.parameters()), "full-width SAFA, trainable")
    state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                               total_steps=SAFA_TRAIN_STEPS + 1)
    step = make_train_step(module, state)  # remat on, as scripts/train.py
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = batch_maker("safa", gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)
    b = batch()
    require(tuple(b["img0"].shape) == (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3)
            and tuple(b["gt"].shape) == (TRAIN_BATCH, 2 * TRAIN_CROP, 2 * TRAIN_CROP, 3),
            "SAFA batch: endpoints at the crop, the midpoint at 2x")
    print(f"train safa: {sum(p.numel() for p in module.parameters())} parameters, batch "
          f"{TRAIN_BATCH}, crop {TRAIN_CROP} (scenes and gt at {2 * TRAIN_CROP}), remat")
    t0 = _phase("train_safa_load", t0)

    # one step, every launch of both kernels and every shifted adjoint
    # recorded and counted
    real_warp, real_grad = kw.warp_windowed, kw.warp_windowed_grad
    real_adj = core_warp.warp_transpose_shifted
    rec1, rec2, rec_adj = [], [], []

    def rec_adjoint(ct, flow, t=1.0, border="replicate", max_disp=8):
        rec_adj.append(dict(ct=ct.clone(), flow=flow.clone(), t=t, border=border,
                            max_disp=max_disp))
        return real_adj(ct, flow, t, border, max_disp)

    kw.warp_windowed, kw.warp_windowed_grad = _recording(kw, rec1), _recording_grad(kw, rec2)
    core_warp.warp_transpose_shifted = rec_adjoint
    try:
        with origin_table_raises(kw):
            kw.launches = kw.grad_launches = 0
            loss = step(batch()).item()
            k1, k2 = kw.launches, kw.grad_launches
    finally:
        kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
        core_warp.warp_transpose_shifted = real_adj
    grouped1 = [a for a in rec1 if kw.plan(a["img"], a["r"], a["compute_dtype"])["grouped"]]
    grouped2 = [a for a in rec2
                if kw.plan(a["img"], a["r"], a["compute_dtype"], grad=True)["grouped"]]
    print(f"one safa train step: K1 {k1} launches ({len(grouped1)} in channel groups, "
          f"{k1 - len(grouped1)} whole-C), K2 {k2} launches ({len(grouped2)} in channel groups at "
          f"C = {sorted({a['img'].shape[-1] for a in grouped2})}, {k2 - len(grouped2)} whole-C), "
          f"{len(rec_adj)} shifted adjoints, loss {loss:.6f}")
    require(k1 == K1_PER_SAFA_STEP and len(rec1) == k1, f"{k1} K1 launches in a SAFA train step")
    require(k2 == K2_PER_SAFA_STEP and len(rec2) == k2, f"{k2} K2 launches in a SAFA train step")
    require(len(grouped1) == K1_GROUPED_PER_SAFA_STEP and len(grouped2) == K2_GROUPED_PER_SAFA_STEP
            and all(a["img"].shape[-1] == 176 for a in grouped1 + grouped2),
            "SAFA's feature warps take channel groups at 176 channels, in K1 and K2")
    require(len(rec_adj) == ADJOINTS_PER_SAFA_STEP, f"{len(rec_adj)} shifted adjoints")
    # grouped K2 in one chunk per tile: one launch per call, no scratch
    for a in grouped2:
        pl = kw.plan(a["img"], a["r"], a["compute_dtype"], grad=True)
        require(pl["chunks"] == 1, f"grouped K2 {_label(a)}: one chunk per tile ({plan_text(pl)})")
    require(loss == loss and abs(loss) < float("inf"), "finite loss")
    t0 = _phase("train_safa_record", t0)

    # origins, K2 and K1 against their twins at every launch of the step;
    # K2 at synthetic cases of each of its shapes; grouped K2 twice, the
    # same bits
    for j, a in enumerate(rec1 + rec2):
        check_origins(kw, f"safa train launch {j}", a)
    max_err2 = 0.0
    for j, a in enumerate(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, f"safa train launch {j}", a))
    for a in grad_cases(rec2):
        max_err2 = max(max_err2, check_warp_grad(kw, f"safa train {a['name']}", a))
    max_err1 = 0.0
    for j, a in enumerate(rec1):
        max_err1 = max(max_err1, check_warp(kw, f"safa train launch {j}", a))
    for j, a in enumerate(grouped2):
        args = (a["img"], a["flow"], a["t"], a["ct"], a["r"], a["border"], a["compute_dtype"])
        x, y = kw.warp_windowed_grad(*args), kw.warp_windowed_grad(*args)
        torch.cuda.synchronize()
        same = torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        print(f"grouped K2 twice, safa train launch {j} {_label(a)}: "
              f"{'bit-identical' if same else 'DIFFER'}")
        require(same, "grouped K2 deterministic")
    compare_step_with_twins(kw, module, batch(), make_train_step, "safa train step")
    t0 = _phase("train_safa_checks", t0)

    # the training path, counted and timed
    step_ms, losses, k1_run, k2_run, peak_mb = timed_steps(kw, step, batch, SAFA_TRAIN_STEPS)
    require(k1_run == K1_PER_SAFA_STEP * SAFA_TRAIN_STEPS,
            f"{k1_run} K1 launches in {SAFA_TRAIN_STEPS} SAFA steps")
    require(k2_run == K2_PER_SAFA_STEP * SAFA_TRAIN_STEPS,
            f"{k2_run} K2 launches in {SAFA_TRAIN_STEPS} SAFA steps")
    ms = sum(step_ms) / len(step_ms)
    data_ms = time_ms(batch, 3)
    print(f"train safa, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, remat: ms/step {ms:.3f} (data + "
          f"step; steps: {', '.join(f'{x:.3f}' for x in step_ms)}); samples/s "
          f"{TRAIN_BATCH * 1000.0 / ms:.2f}; data alone {data_ms:.3f} ms; max_memory_allocated "
          f"{peak_mb:.1f} MB; {k1_run} K1 and {k2_run} K2 launches; losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}")
    t0 = _phase("train_safa_main", t0)

    # the shifted adjoint per call, at the recorded step's inputs
    adj_ms = []
    for a in rec_adj:
        adj_ms.append(time_ms(lambda: real_adj(**a), 3))
        fl = a["flow"].float()
        print(f"safa train shifted adjoint {tuple(a['ct'].shape)} max_disp {a['max_disp']}, flow "
              f"{fl.min().item():.3f} to {fl.max().item():.3f}: {adj_ms[-1]:.3f} ms")
    print(f"safa train shifted adjoint per step: {len(adj_ms)} calls, {sum(adj_ms):.3f} ms "
          f"({100.0 * sum(adj_ms) / ms:.1f}% of the {ms:.3f} ms step)")

    # the adjoint's offsets bounded by the displacements' range, read back
    # to the host once per call (the path), against every offset of
    # max_disp with no read-back: the same values, per call, and the step
    # end to end (read-back, every offset, read-back)
    read_back = [real_adj(**a) for a in rec_adj]
    real_reach = core_warp._shift_reach
    core_warp._shift_reach = lambda dy, dx, big_r: [range(big_r, -big_r - 1, -1)] * 2
    try:
        every_ms = []
        for j, a in enumerate(rec_adj):
            require(torch.equal(real_adj(**a), read_back[j]),
                    f"safa train shifted adjoint {j}: every offset gives the read-back's values")
            every_ms.append(time_ms(lambda: real_adj(**a), 3))
        del read_back
        every_step_ms = timed_steps(kw, step, batch, SAFA_TRAIN_STEPS)[0]
    finally:
        core_warp._shift_reach = real_reach
    again_ms = timed_steps(kw, step, batch, SAFA_TRAIN_STEPS)[0]
    print(f"safa train shifted adjoint, offsets from the read-back range against every offset "
          f"(no read-back): per call {', '.join(f'{x:.3f}' for x in adj_ms)} against "
          f"{', '.join(f'{x:.3f}' for x in every_ms)} ms; per step {sum(adj_ms):.3f} against "
          f"{sum(every_ms):.3f} ms; ms/step read-back {ms:.3f}, every offset "
          f"{sum(every_step_ms) / len(every_step_ms):.3f}, read-back again "
          f"{sum(again_ms) / len(again_ms):.3f}")

    # where a step's time goes: each conv shape forward and backward, with
    # cuDNN and without (the path's forward choice printed)
    fixed = batch()
    with torch.no_grad():
        calls = conv_calls(module, lambda: module(fixed["img0"], fixed["img1"], fixed["t"]))
    flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
    print(f"train safa forward: {len(calls)} convs, {flop / 1e12:.4f} TFLOP (f32 bound "
          f"{flop / F32_FLOP_PER_S * 1e3:.3f} ms); a step with remat runs them twice and their "
          f"backward: about {4 * flop / 1e12:.4f} TFLOP, f32 bound "
          f"{4 * flop / F32_FLOP_PER_S * 1e3:.3f} ms")
    time_convs("train safa", calls, backward=True)
    t0 = _phase("train_safa_breakdown", t0)

    tot2 = per_shape_totals(kw, "train safa K2", "step", rec2, time_grad_launch)
    tot1 = per_shape_totals(kw, "train safa K1", "step", rec1, time_launch)
    _phase("train_safa_timing", t0)
    return (path_numbers(k1_run, max_err1, tot1, SAFA_TRAIN_STEPS),
            path_numbers(k2_run, max_err2, tot2, SAFA_TRAIN_STEPS))


def train_span_phase(kw) -> None:
    """Step 14 of the module docstring."""
    from vfisr_tpu_torch.models.sota.span import SPANModel
    from vfisr_tpu_torch.train.__main__ import SR_SCALE, batch_maker
    from vfisr_tpu_torch.train.train import create_train_state, make_sr_train_step

    for name, scale in SR_SCALE.items():
        t0 = time.perf_counter()
        model = SPANModel(scale=scale, device="cuda")
        model.load(weights_path=str(ROOT / "weights" / f"span_x{scale}.npz"))  # strict
        module = model.trainable()
        state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                                   total_steps=SPAN_TRAIN_STEPS + 1)
        step = make_sr_train_step(module, state)
        gen = torch.Generator(device="cuda").manual_seed(0)
        batch = batch_maker(name, gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)
        b = batch()
        lr_hw = TRAIN_CROP // scale
        require(tuple(b["lr"].shape) == (TRAIN_BATCH, lr_hw, lr_hw, 3)
                and tuple(b["hr"].shape) == (TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3),
                f"{name} batch shapes")
        step_ms, losses, k1, k2, peak_mb = timed_steps(kw, step, batch, SPAN_TRAIN_STEPS)
        require(k1 == 0 and k2 == 0, f"{name} training launches no warp ({k1}, {k2})")
        ms = sum(step_ms) / len(step_ms)
        with torch.no_grad():
            calls = conv_calls(module, lambda: module(b["lr"]))
        flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
        print(f"train {name} (x{scale}), batch {TRAIN_BATCH}, crop {TRAIN_CROP} (lr {lr_hw}), no "
              f"remat: ms/step {ms:.3f} (data + step; steps: "
              f"{', '.join(f'{x:.3f}' for x in step_ms)}); samples/s "
              f"{TRAIN_BATCH * 1000.0 / ms:.2f}; max_memory_allocated {peak_mb:.1f} MB; forward "
              f"{flop / 1e12:.4f} TFLOP, a step about {3 * flop / 1e12:.4f} TFLOP (f32 bound "
              f"{3 * flop / F32_FLOP_PER_S * 1e3:.3f} ms); losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}")
        time_convs(f"train {name}", calls, backward=True)
        del model, module, state, step
        _phase(f"train_{name}", t0)


# the evaluation phase: the evaluation library (vfisr_tpu_torch/evaluation/)
# on EVAL_FRAMES frames of step 4's 1080p scene, the odd ones interpolated
EVAL_FRAMES = 5  # cut from 7 to make room for step 25
# Farneback at 1080p: 4 pyramid levels (3 halvings; the smallest side stays
# >= 16 px) x 3 warps per level (one per matrix update)
K1_PER_FLOW = 12
# flows of the phase's counted run: FloLPIPS one per ground-truth pair; the
# comprehensive benchmark two per predicted pair (temporal) and one per
# ground-truth pair (stratified)
FLOWS_PER_PAIR = 4
EVAL_TIMED = 5  # calls per timed metric, after one warm-up call


def evaluation_phase(kw) -> dict:
    """Step 17 of the module docstring. Returns K1's numbers over the
    phase's counted launches."""
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.evaluation import lpips as tl, metrics as tm, speed
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.ops import edges
    from vfisr_tpu_torch.ops.ssim import ms_ssim

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    files = {"rife_weights": ROOT / "weights" / "rife.npz",
             "vfimamba_weights": ROOT / "weights" / "vfimamba.npz",
             "gate_path": ROOT / "weights" / "router_gate.json"}
    model = get_model("adaptive", device="cuda", load=True, **{k: str(p) for k, p in files.items()})
    gt_dev = [game_frame(i, dev) for i in range(EVAL_FRAMES)]
    gt = [f.cpu().numpy() for f in gt_dev]
    pred = list(gt)
    for i in range(1, EVAL_FRAMES, 2):
        mid = model.interpolate_batch(gt_dev[i - 1].float()[None] / 255.0,
                                      gt_dev[i + 1].float()[None] / 255.0, (0.5,))
        pred[i] = to_uint8(mid[0, 0]).cpu().numpy()
    del model
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    qe = tm.QualityEvaluator("cuda")
    require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
            "QualityEvaluator turns TF32 off")
    require(qe.lpips_mode == "calibrated_heads", f"LPIPS mode {qe.lpips_mode}")
    t0 = _phase("evaluation_setup", t0)

    # the library on the card, counted, every K1 launch recorded
    recorded, real_warp = [], kw.warp_windowed
    kw.warp_windowed = _recording(kw, recorded)
    try:
        with origin_table_raises(kw):
            kw.launches = 0
            quality = qe.evaluate(pred, gt)
            flolpips = qe.evaluate_flolpips(pred, gt)
            temporal = qe.evaluate_temporal_consistency(pred)
            bench = tm.run_comprehensive_benchmark(pred, gt, verbose=False, device="cuda")
            ui = [tm.detect_ui_regions(f, "cuda") for f in (gt[0], pred[1])]
            launches = kw.launches
    finally:
        kw.warp_windowed = real_warp
    want = K1_PER_FLOW * FLOWS_PER_PAIR * (EVAL_FRAMES - 1)
    require(launches == len(recorded) == want, f"{launches} K1 launches in the evaluation "
                                               f"({want} expected)")
    require_whole_c(kw, "evaluation", recorded)
    t0 = _phase("evaluation_run", t0)
    res = bench.to_dict()
    print(f"evaluation quality (QualityEvaluator.evaluate, {EVAL_FRAMES} frames, {EVAL_FRAMES // 2} interpolated "
          f"by get_model('adaptive')): {quality.to_dict()}, psnr per frame "
          f"{quality.psnr_per_frame}, lpips per frame {quality.lpips_per_frame}")
    print(f"evaluation flolpips {flolpips}, temporal {temporal}")
    print(f"evaluation run_comprehensive_benchmark: {json.dumps(res)}")
    mids = quality.psnr_per_frame[1::2]
    require(all(math.isinf(p) for p in quality.psnr_per_frame[::2])
            and all(math.isfinite(p) and p > 20.0 for p in mids), "PSNR per frame")
    numbers = [quality.ssim, quality.lpips, quality.ms_ssim, flolpips, *temporal.values(),
               res["reconstruction"]["ssim"], *res["temporal"].values(), *res["gaming"].values()]
    require(all(math.isfinite(v) for v in numbers), "finite metrics")
    require(0.0 < quality.ssim <= 1.0 and 0.0 < quality.ms_ssim <= 1.0 and quality.lpips >= 0.0,
            "metrics in range")
    require(res["total_frames"] == EVAL_FRAMES and sum(res["stratified"]["frame_counts"].values())
            == EVAL_FRAMES - 1, "comprehensive benchmark frame counts")
    require(all(m.dtype == np.uint8 and m.shape == (H, W) and m[: H // 6, : W // 5].any()
                for m in ui), "the UI masks cover the HUD box")

    # each metric that takes no flow against the same function on the CPU
    for i in range(1, EVAL_FRAMES, 2):
        p, g = pred[i], gt[i]
        d_psnr = abs(tm.compute_psnr_simple(p, g, "cuda") - tm.compute_psnr_simple(p, g, "cpu"))
        d_ssim = abs(tm.compute_ssim_simple(p, g, "cuda") - tm.compute_ssim_simple(p, g, "cpu"))
        d_glob = abs(tm.calc_ssim(p, g, "cuda") - tm.calc_ssim(p, g, "cpu"))
        d_ms = abs(float(ms_ssim(tm._gray(p, "cuda"), tm._gray(g, "cuda")))
                   - float(ms_ssim(tm._gray(p, "cpu"), tm._gray(g, "cpu"))))
        l_card, l_cpu = float(qe._lpips(p, g)[0]), float(tl.default_lpips("cpu")(p, g)[0])
        d_lpips = abs(l_card - l_cpu) / abs(l_cpu)
        print(f"evaluation frame {i} card vs cpu: psnr {d_psnr:.3e} dB (tolerance 1e-3), ssim "
              f"{d_ssim:.3e}, ms_ssim {d_ms:.3e}, ssim_global {d_glob:.3e} (1e-4 each), lpips "
              f"{d_lpips:.3e} relative (1e-4)")
        require(d_psnr <= 1e-3 and max(d_ssim, d_ms, d_glob) <= 1e-4 and d_lpips <= 1e-4,
                f"evaluation frame {i}, card vs cpu")
    iters = {}
    for name, f in (("hud frame 0", gt[0]), ("interpolated frame 1", pred[1])):
        gray_card, gray_cpu = tm._gray(f, "cuda"), tm._gray(f, "cpu")
        for lo, hi in ((100, 200), (50, 150)):
            e_card, n_card = edges.canny_with_iterations(gray_card, lo, hi)
            e_cpu, n_cpu = edges.canny_with_iterations(gray_cpu, lo, hi)
            require(torch.equal(e_card.cpu(), e_cpu) and n_card == n_cpu,
                    f"canny({lo}, {hi}) of {name}, card vs cpu")
            iters[(name, lo, hi)] = n_card
            print(f"evaluation canny({lo}, {hi}) of {name}: {int(e_card.count_nonzero())} edge "
                  f"pixels, hysteresis {n_card} iterations (the card's equal the cpu's)")
        require(np.array_equal(tm.detect_ui_regions(f, "cuda"), tm.detect_ui_regions(f, "cpu")),
                f"UI mask of {name}, card vs cpu")
    t0 = _phase("evaluation_cpu_checks", t0)

    # K1 against its twin, and the kernels' origins, at every launch
    max_err = 0.0
    for j, a in enumerate(recorded):
        check_origins(kw, f"evaluation launch {j}", a)
        max_err = max(max_err, check_warp(kw, f"evaluation launch {j}", a))
    t0 = _phase("evaluation_kernel_checks", t0)

    # ms per 1080p frame (speed.measure: CUDA events around each call, after
    # a warm-up call; each call uploads its frames and reads its value back)
    p, g = pred[1], gt[1]
    flow = tm.compute_optical_flow(gt[0], gt[1], "cuda")
    mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    lp = qe._lpips
    timed = {
        "compute_psnr_simple": lambda: tm.compute_psnr_simple(p, g, "cuda"),
        "compute_ssim_simple": lambda: tm.compute_ssim_simple(p, g, "cuda"),
        "calc_ssim (ssim_global)": lambda: tm.calc_ssim(p, g, "cuda"),
        "ms_ssim (gray, 5 scales)": lambda: float(ms_ssim(tm._gray(p, "cuda"), tm._gray(g, "cuda"))),
        "lpips": lambda: lp(p, g),
        "lpips.flow_weighted (FloLPIPS, flow given)": lambda: lp.flow_weighted(p, g, mag),
        "compute_optical_flow (Farneback, full resolution)":
            lambda: tm.compute_optical_flow(gt[0], gt[1], "cuda"),
        "compute_flow_consistency (one pair of flows)":
            lambda: tm.compute_flow_consistency([flow], [flow], "cuda"),
        "canny(100, 200) (gray upload included)":
            lambda: edges.canny(tm._gray(gt[0], "cuda"), 100, 200).cpu(),
        "detect_ui_regions": lambda: tm.detect_ui_regions(gt[0], "cuda"),
        "QualityEvaluator.evaluate_pair": lambda: qe.evaluate_pair(p, g),
    }
    for name, fn in timed.items():
        s = speed.measure(fn, iterations=EVAL_TIMED, warmup=1, device="cuda")
        require(s.method == "cuda_events", f"speed.measure's method on the card: {s.method}")
        print(f"evaluation ms per {W}x{H} frame, {name}: p50 {s.p50_ms:.3f}, mean "
              f"{s.mean_ms:.3f}, min {s.min_ms:.3f}, max {s.max_ms:.3f} ({s.n_iterations} calls)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    start = time.perf_counter()
    qe.evaluate(pred, gt)
    evaluate_s = time.perf_counter() - start
    start = time.perf_counter()
    tm.run_comprehensive_benchmark(pred, gt, verbose=False, device="cuda")
    comprehensive_s = time.perf_counter() - start
    peak = (torch.cuda.max_memory_allocated() - resident) / 1e6
    print(f"evaluation whole sequence ({EVAL_FRAMES} frames {W}x{H}, host clock): "
          f"QualityEvaluator.evaluate {evaluate_s * 1e3:.3f} ms ({evaluate_s * 1e3 / EVAL_FRAMES:.3f}"
          f" per frame), run_comprehensive_benchmark {comprehensive_s * 1e3:.3f} ms "
          f"({comprehensive_s * 1e3 / EVAL_FRAMES:.3f} per frame); peak {peak:.1f} MB over "
          f"{resident / 1e6:.1f} MB resident")
    # the five AlexNet convs at the phase's shapes (a and b in one batch)
    time_convs("evaluation lpips", conv_calls(lp.net, lambda: lp(p, g)))
    t0 = _phase("evaluation_timing", t0)

    by_shape = shape_times(kw, recorded, time_launch)
    for key, v in by_shape.items():
        print(f"evaluation launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} "
              f"r={key[3]} {key[4]} x{v['n']}/phase: kernel {v['kernel']:.4f} ms, bound "
              f"{v['bound']:.4f} ms ({v['by']}), wrapper host {v['host']:.4f} ms, wrapper "
              f"{v['wrapper']:.4f} ms, plain {v['plain']:.4f} ms, grid_sample {v['library']:.4f} ms")
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    total = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    total["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    print(f"evaluation K1: {launches} launches ({K1_PER_FLOW} per flow), " + ", ".join(
        f"{f} {total[f]:.4f} ms" for f in fields) + f"; max_abs_err {max_err:.3e}")
    _phase("evaluation_k1_timing", t0)
    return path_numbers(launches, max_err, total, 1)


def _twin(kw, fn, *args):
    """A plain twin's call, with window_origins in place for it (the twins
    compute their windows with it; a run may hold the kernels' path to
    never reaching it: ``origin_table_raises``)."""
    held = kw.window_origins
    kw.window_origins = ORIGIN_TABLE
    try:
        return fn(*args)
    finally:
        kw.window_origins = held


def _checking(kw, checks: list):
    """K1's wrapper, holding each launch against its plain twin and its
    origins against window_origins as it goes (no copies kept): appends
    (error, tolerance, origins differ) as device tensors."""
    real = kw.warp_windowed

    def checking(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        out = real(img, flow, t, r, border, compute_dtype)
        ref = _twin(kw, kw.warp_windowed_plain, img, flow, t, r, border, compute_dtype)
        base = 2.0 / 255.0 if compute_dtype == torch.bfloat16 else 1e-5
        ry, rx = (r, r) if isinstance(r, int) else r
        t_arr = torch.as_tensor(t, dtype=torch.float32, device=flow.device)
        t_arr = t_arr.reshape(-1).expand(flow.shape[0]).contiguous()
        got = kw.kernel_origins(flow, t, r, compute_dtype)
        want = ORIGIN_TABLE(flow, t_arr, ry, rx, compute_dtype == torch.bfloat16)
        differ = (got != want).any() if got.shape == want.shape else torch.ones((), dtype=torch.bool)
        checks.append(((out.float() - ref.float()).abs().max(),
                       base * torch.clamp(ref.float().abs().max(), min=1.0), differ))
        return out

    return checking


BENCH_CHECK_PAIRS = 10  # pairs of the bench's checked run (its counted run keeps the bench's 50)


def bench_phase(kw, per_pair: dict) -> dict:
    """Step 18 of the module docstring. Returns K1's numbers over the
    bench's counted launches, timed per pair in step 7."""
    from vfisr_tpu_torch import bench

    t0 = time.perf_counter()
    pairs = bench.WARMUP + bench.PAIRS
    # the same run with every launch checked as it goes (its times include
    # the twins: not the bench's)
    checks, real_warp = [], kw.warp_windowed
    kw.warp_windowed = _checking(kw, checks)
    try:
        print(f"bench check run ({BENCH_CHECK_PAIRS} pairs after the warm-up; every K1 launch "
              "against its twin and its origins; its times include the twins):")
        bench.measure(pairs=BENCH_CHECK_PAIRS)
    finally:
        kw.warp_windowed = real_warp
    err, tol, differ = (torch.stack(v) for v in zip(*checks))
    max_err = err.max().item()
    require(len(checks) == LAUNCHES_PER_PAIR * (bench.WARMUP + BENCH_CHECK_PAIRS),
            f"{len(checks)} K1 launches checked")
    require(bool((err <= tol).all()) and not bool(differ.any()),
            f"bench: K1 vs twin and origins at every launch (max_abs_err {max_err:.3e})")
    print(f"bench check run: {len(checks)} K1 launches, each within its tolerance of the twin "
          f"(max_abs_err {max_err:.3e}) with its origins equal to window_origins")
    t0 = _phase("bench_check", t0)

    with origin_table_raises(kw):
        kw.launches = 0
        record = bench.measure()
        launches = kw.launches
    print("bench record: " + json.dumps(record))
    require(math.isfinite(record["value"]) and record["value"] > 0, f"bench value {record}")
    require(launches == LAUNCHES_PER_PAIR * pairs, f"{launches} K1 launches in {pairs} bench pairs")
    require(record["value"] == len(TS) * 1000.0 / record["ms_per_pair_p50"]
            and record["pairs"] == bench.PAIRS, "the record's value is 3000 / the median")
    _phase("bench_run", t0)
    return path_numbers(launches, max_err, per_pair, pairs)


# the sweep phase: run_experiment_sweep on an interval of SWEEP_PANS pairs of
# the adaptive phase's 1080p scene (plane waves under a static HUD), at the
# default quality (2560x1440, 90 fps). The pans (px per pair at 1080p) are
# chosen from weights/router_gate.json's 'sweep' bins: at the 480x270 motion
# (about a quarter of the 1080p pan) a static pair is blended by every
# adaptive tier, 2 px pans (motion ~0.5) go to RIFE in the quality-aware
# tier, 8 px (~2.0) to VFIMamba there, and 16 px (~3.8) past
# adaptive_default's threshold of 3 to RIFE (VFIMamba in the quality-aware
# tier).
SWEEP_PANS = (0, 2, 16, 2, 2, 0, 8, 2, 2, 2)
SWEEP_CLIP = "chip_smoke"
SWEEP_COMPARE_KF = 3  # keyframes of the batched vs per-frame comparison (cut from 5 for step 25)
# the reference's tolerances of its batched path against its per-frame loop
# (tests/test_device_sweep.py): (PSNR dB, SSIM)
SWEEP_COMPARE = {"control": (0.35, 0.01), "degraded": (0.35, 0.01),
                 "lanczos_blend": (0.35, 0.01), "lanczos_blend_edge": (0.35, 0.01),
                 "optical_flow_basic": (1.0, None), "uafi_default": (1.5, 0.02),
                 "ughi_default": (1.5, 0.02), "mcar_default": (1.5, 0.02)}
# methods without K1 in the batched path (no flow, no RIFE)
SWEEP_NO_K1 = ("none", "frame_dup", "linear_blend")


def _shape_counter(kw, firsts: dict, counts: dict, tag: dict):
    """K1's wrapper counting each launch by (tag["name"], shape) and keeping
    a clone of the first launch of each shape (for the per-shape timing)."""
    real = kw.warp_windowed

    def counting(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        a = dict(img=img, flow=flow, t=t, r=r, border=border, compute_dtype=compute_dtype)
        key = shape_key(a)
        if key not in firsts:
            firsts[key] = dict(a, img=img.clone(), flow=flow.clone(),
                               t=t.clone() if torch.is_tensor(t) else t)
        counts[(tag["name"], key)] = counts.get((tag["name"], key), 0) + 1
        return real(img, flow, t, r, border, compute_dtype)

    return counting


def _require_checks(checks: list, label: str) -> float:
    """Every launch of a _checking run within its tolerance of the twin,
    with its origins equal to window_origins; returns the largest error."""
    require(len(checks) > 0, f"{label}: K1 launches checked")
    err, tol, differ = (torch.stack(v) for v in zip(*checks))
    max_err = err.max().item()
    require(bool((err <= tol).all()) and not bool(differ.any()),
            f"{label}: K1 vs twin and origins at every launch (max_abs_err {max_err:.3e})")
    print(f"{label}: {len(checks)} K1 launches, each within its tolerance of the twin "
          f"(max_abs_err {max_err:.3e}) with its origins equal to window_origins")
    return max_err


def _kernel_by_shape(kw, label: str, unit: str, firsts: dict, counts: dict,
                     grad: bool = False) -> dict:
    """K1's (grad: K2's) per-shape lines of a counted run, and the run's
    totals."""
    timer = time_grad_launch if grad else time_launch
    by_shape = {}
    for (_, key), n in counts.items():
        if key not in by_shape:
            by_shape[key] = dict(n=0, **timer(kw, firsts[key]))
        by_shape[key]["n"] += n
    name = "K2" if grad else "K1"
    for key, v in by_shape.items():
        print(f"{label} {name} launch shape {key[0]} {str(key[1])[6:]} window "
              f"{str(key[2])[6:]} r={key[3]} {key[4]} x{v['n']}/{unit}: kernel "
              f"{v['kernel']:.4f} ms, bound {v['bound']:.4f} ms ({v['by']}), wrapper host "
              f"{v['host']:.4f} ms, wrapper {v['wrapper']:.4f} ms, plain {v['plain']:.4f} ms, "
              f"grid_sample{' grad' if grad else ''} {v['library']:.4f} ms")
        print_grouped(kw, label, unit, key, firsts[key], v, grad=grad)
    fields = ("kernel", "bound", "host", "wrapper", "plain", "library")
    total = {f: sum(v["n"] * v[f] for v in by_shape.values()) for f in fields}
    total["by"] = "bytes" if {v["by"] for v in by_shape.values()} == {"bytes"} else "operations"
    print(f"{label} {name}: {sum(v['n'] for v in by_shape.values())} launches in "
          f"{len(by_shape)} shapes, " + ", ".join(f"{f} {total[f]:.4f} ms" for f in fields))
    return total


def sweep_phase(kw, card: str) -> dict:
    """Step 19 of the module docstring. Returns K1's numbers over the
    counted sweep's launches."""
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.data.extract_intervals import load_interval
    from vfisr_tpu_torch.data.png import write_png
    from vfisr_tpu_torch.data.video_io import VideoReader
    from vfisr_tpu_torch.harness import device_sweep as ds, experiments as ex
    from vfisr_tpu_torch.methods.inline import edge_enhance_core
    from vfisr_tpu_torch.utils.router_gate import bin_winner, blend_crossover_px, expert_bins

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    xs = [0.0]
    for p in SWEEP_PANS:
        xs.append(xs[-1] + p)
    n_pairs = len(SWEEP_PANS)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_")
    root = Path(tmp.name)
    try:
        # the interval, made on the card and written as PNG
        kf_dev = [scene_frame(x, dev) for x in xs]
        mid_dev = [scene_frame((a + b) / 2, dev) for a, b in zip(xs[:-1], xs[1:])]
        kfs = [f.cpu().numpy() for f in kf_dev]
        mids = [f.cpu().numpy() for f in mid_dev]
        idir = root / "data" / "clips" / SWEEP_CLIP / "intervals" / "interval_0000"
        for sub, frames, stem in (("keyframes", kfs, "kf"), ("midpoints", mids, "gt")):
            (idir / sub).mkdir(parents=True)
            for i, f in enumerate(frames):
                write_png(idir / sub / f"{stem}_{i:04d}.png", f)
        (idir / "meta.json").write_text(json.dumps({
            "interval_id": "interval_0000", "clip_id": SWEEP_CLIP, "keyframe_count": len(kfs),
            "midpoint_count": len(mids), "resolution": f"{W}x{H}", "difficulty": "EASY"}))
        rk, rm, meta = load_interval(SWEEP_CLIP, 0, root / "data")
        require(len(rk) == len(kfs) and len(rm) == len(mids)
                and all(np.array_equal(a, b) for a, b in zip(rk + rm, kfs + mids))
                and meta["clip_id"] == SWEEP_CLIP, "load_interval reads the PNGs back bit-equal")
        t0 = _phase("sweep_interval", t0)

        exps = ex.EXPERIMENTS
        out_w, out_h = ex.QUALITY_LEVELS[ex.DEFAULT_QUALITY]["resolution"]
        out_hw = (out_h, out_w)
        kwargs = dict(data_dir=root / "data", use_lpips=True, device="cuda")
        tag = {"name": None}
        real_batched = ds.run_experiment_batched

        def tagged(interval, experiment, **kw_):
            tag["name"] = experiment["name"]
            return real_batched(interval, experiment, **kw_)

        # 1. the sweep with every K1 launch checked as it goes (its times
        # include the twins: not the sweep's)
        checks, real_warp = [], kw.warp_windowed
        kw.warp_windowed = _checking(kw, checks)
        try:
            print("sweep check run (every K1 launch against its twin and its origins):")
            res = ex.run_experiment_sweep(SWEEP_CLIP, [0], exps, output_dir=root / "check",
                                          **kwargs)
        finally:
            kw.warp_windowed = real_warp
        require(len(res["experiments"]) == len(exps), "the check run's rows")
        max_err = _require_checks(checks, "sweep check run")
        del checks
        t0 = _phase("sweep_check_run", t0)

        # 2. the sweep, counted (window_origins raising), timed: the main path
        firsts, counts = {}, {}
        kw.warp_windowed = _shape_counter(kw, firsts, counts, tag)
        ds.run_experiment_batched = tagged
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                start = time.perf_counter()
                res = ex.run_experiment_sweep(SWEEP_CLIP, [0], exps, output_dir=root / "out",
                                              **kwargs)
                torch.cuda.synchronize()
                sweep_s = time.perf_counter() - start
                launches = kw.launches
        finally:
            kw.warp_windowed = real_warp
            ds.run_experiment_batched = real_batched
        peak = torch.cuda.max_memory_allocated() / 1e6
        rows = res["experiments"]
        log = (root / "out" / "experiment_log.txt").read_text()
        require("FAILED" not in log and len(rows) == len(exps)
                and [r["name"] for r in rows] == [e["name"] for e in exps],
                f"{len(rows)} sweep rows of {len(exps)}, none FAILED")
        require(launches == sum(counts.values()), f"{launches} K1 launches counted")
        for r in rows:
            vfi_eval = r["vfi_method"] != "none" and r["name"] != "control"
            require(r["frames"] == 4 * n_pairs + 1 and r["device_batched"]
                    and r["target_resolution"] == f"{out_w}x{out_h}"
                    and r["vfi_frames_evaluated"] == (n_pairs if vfi_eval else 0)
                    and r["lpips_frames_sampled"] == (1 if vfi_eval else 0)
                    and (r["vfi_lpips"] is not None) == vfi_eval, f"sweep row {r['name']}")
            n = sum(v for (name, _), v in counts.items() if name == r["name"])
            require((n == 0) == (r["vfi_method"] in SWEEP_NO_K1),
                    f"{r['name']}: {n} K1 launches")
            print(f"sweep {r['name']}: time_s {r['time_s']}, fps_achieved {r['fps_achieved']}, "
                  f"realtime_x {r['realtime_x']}, keyframe_psnr_db {r['keyframe_psnr_db']}, "
                  f"keyframe_ssim {r['keyframe_ssim']}, vfi_psnr_db {r['vfi_psnr_db']}, "
                  f"vfi_ssim {r['vfi_ssim']}, vfi_lpips {r['vfi_lpips']} ({r['lpips_mode']}), "
                  f"overall_psnr_db {r['overall_psnr_db']}, rife_frames_pct "
                  f"{r['rife_frames_pct']}, expert_mix {r['expert_mix']}; K1 launches {n}")
        print(f"sweep: {len(rows)} experiments x {4 * n_pairs + 1} frames at {out_w}x{out_h} in "
              f"{sweep_s:.3f} s (host clock, LPIPS and PNG loading included); peak "
              f"{peak:.1f} MB over {resident / 1e6:.1f} MB resident; {card}")
        by_exp = {}
        for (name, key), n in counts.items():
            by_exp.setdefault(name, []).append(f"{key[0]} r={key[3]} {key[4]} x{n}")
        for name, items in by_exp.items():
            print(f"sweep K1 {name}: " + "; ".join(items))
        t0 = _phase("sweep_run", t0)

        # routes: each adaptive pair's motion recomputed as the sweep takes it
        by_name = {r["name"]: r for r in rows}
        src = torch.stack(kf_dev).float()
        deg = ds._qu8(resize(src, (ds.INPUT_H, ds.INPUT_W), "area"))
        out_m = ds._qu8(resize(deg, out_hw, "lanczos4"))
        edged = ds._qu8(edge_enhance_core(out_m, 1.3))
        upq = ds._qu8(edge_enhance_core(resize(resize(src, (ds.INPUT_H, ds.INPUT_W), "area"),
                                               out_hw, "lanczos4"), 1.3))
        motion, motion_q = [], []
        for c in range(0, n_pairs, 2):  # the sweep's chunks of 2 pairs where RIFE runs
            motion += ds._motion_chunk(edged[c:c + 2], edged[c + 1:c + 3]).tolist()
            motion_q += ds._motion_chunk(upq[c:c + 2], upq[c + 1:c + 3]).tolist()
        del src, deg, out_m, edged, upq
        print(f"sweep motion per pair (480x270 fast Farneback): "
              f"{', '.join(f'{m:.4f}' for m in motion)}")
        gate_experts = ("rife", "rife_fast", "vfimamba")
        can_give = {bin_winner("sweep", (b["motion_lo"] + min(b["motion_hi"], 10.0)) / 2,
                               experts=gate_experts) for b in expert_bins("sweep")}
        for e in exps:
            if e["vfi"] != "adaptive":
                continue
            thresh = e["motion_thresh"]
            if e.get("quality_aware"):
                thresh = min(thresh, blend_crossover_px())
            want = {"blend": 0, "rife": 0, "rife_fast": 0, "vfimamba": 0}
            for m, mq in zip(motion, motion_q):
                if m <= thresh:
                    want["blend"] += 1
                elif e.get("quality_aware"):
                    want[bin_winner("sweep", mq, experts=gate_experts)] += 1
                else:
                    want["rife"] += 1
            got = by_name[e["name"]]
            require(got["expert_mix"] == want and got["rife_frames_pct"] == round(
                100.0 * (n_pairs - want["blend"]) / n_pairs, 1),
                f"{e['name']} routes {got['expert_mix']} (the rule gives {want})")
            print(f"sweep routes {e['name']} (blend at motion <= {thresh:.4f}): {want}")
        default, aggressive = by_name["adaptive_default"], by_name["adaptive_aggressive"]
        require(default["expert_mix"]["blend"] > 0 and default["expert_mix"]["rife"] > 0,
                "adaptive_default takes both blend and RIFE")
        require(all(aggressive["expert_mix"][x] > 0 for x in can_give),
                f"adaptive_aggressive takes every expert the gate can give ({sorted(can_give)})")
        t0 = _phase("sweep_routes", t0)

        # the batched path against the per-frame loop, on the card
        checks = []
        kw.warp_windowed = _checking(kw, checks)
        try:
            k5, m5 = kfs[:SWEEP_COMPARE_KF], mids[:SWEEP_COMPARE_KF - 1]
            interval5 = ds.DeviceInterval(k5, m5, device="cuda")
            for name, (tol_db, tol_ssim) in SWEEP_COMPARE.items():
                e = next(x for x in exps if x["name"] == name)
                b = ds.run_experiment_batched(interval5, e)
                h = ex.run_experiment(k5, m5, e, verbose=False, device="cuda")
                d_db = abs(b["vfi_psnr_db"] - h["vfi_psnr_db"]) if h["vfi_frames_evaluated"] else 0.0
                d_kf = (0.0 if b["keyframe_psnr_db"] == h["keyframe_psnr_db"]
                        else abs(b["keyframe_psnr_db"] - h["keyframe_psnr_db"]))
                d_ssim = abs(b["vfi_ssim"] - h["vfi_ssim"])
                ok = (b["frames"] == h["frames"] and b["vfi_frames_evaluated"]
                      == h["vfi_frames_evaluated"] and d_db <= tol_db and d_kf <= tol_db
                      and (tol_ssim is None or d_ssim <= tol_ssim))
                print(f"sweep batched vs per-frame {name}: vfi_psnr {b['vfi_psnr_db']} vs "
                      f"{h['vfi_psnr_db']} dB, keyframe {b['keyframe_psnr_db']} vs "
                      f"{h['keyframe_psnr_db']}, vfi_ssim {b['vfi_ssim']} vs {h['vfi_ssim']} "
                      f"(tolerance {tol_db} dB, {tol_ssim}); time_s {b['time_s']} vs "
                      f"{h['time_s']} {'ok' if ok else 'FAIL'}")
                require(ok, f"sweep batched vs per-frame {name}")
            del interval5
        finally:
            kw.warp_windowed = real_warp
        max_err = max(max_err, _require_checks(checks, "sweep comparisons"))
        del checks
        t0 = _phase("sweep_compare", t0)

        # a video of a light experiment
        light = [next(x for x in exps if x["name"] == "lanczos_blend_edge")]
        res = ex.run_experiment_sweep(SWEEP_CLIP, [0], light, output_dir=root / "video",
                                      write_videos=True, **kwargs)
        video = root / "video" / "videos" / "lanczos_blend_edge_i0.y4m"
        require(res["experiments"][0]["output_video"] == str(video), "the video's path")
        with VideoReader(str(video)) as reader:
            n_frames, shapes = 0, set()
            for f in reader:
                n_frames += 1
                shapes.add(f.shape)
        require(n_frames == 4 * n_pairs + 1 and shapes == {(out_h, out_w, 3)},
                f"the sweep's Y4M holds {n_frames} frames of {shapes}")
        print(f"sweep video {video.name}: {n_frames} frames at {out_w}x{out_h}, "
              f"{video.stat().st_size / 1e6:.1f} MB, time_s {res['experiments'][0]['time_s']} "
              f"(the writer's RGB -> I420 on the host included)")
        t0 = _phase("sweep_video", t0)

        # the CLI, as a user runs it (on the card by default)
        cmd = [sys.executable, "-m", "vfisr_tpu_torch.run_experiments", "--clip", SWEEP_CLIP,
               "--data-dir", str(root / "data"), "--output-dir", str(root / "cli"),
               "--experiment", "lanczos_blend_edge,rife_fast", "--max-frames", "3"]
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        require(res.returncode == 0, f"run_experiments CLI: {res.stdout[-2000:]}{res.stderr[-2000:]}")
        cli_rows = json.loads((root / "cli" / "experiment_results.json").read_text())["experiments"]
        require([r["name"] for r in cli_rows] == ["lanczos_blend_edge", "rife_fast"]
                and all(r["frames"] == 9 and r["target_resolution"] == f"{out_w}x{out_h}"
                        for r in cli_rows), "the run_experiments CLI's rows")
        print(f"sweep CLI: python -m vfisr_tpu_torch.run_experiments --experiment "
              f"lanczos_blend_edge,rife_fast --max-frames 3: rows {[r['name'] for r in cli_rows]}, "
              f"{cli_rows[0]['frames']} frames each at {out_w}x{out_h}")
        t0 = _phase("sweep_cli", t0)

        # one _chunk_program per method (CUDA events), RIFE per chunk
        interval = ds.DeviceInterval(kfs, mids, device="cuda")
        ex._RIFESingleton.get("cuda")
        up = resize(resize(interval.kf[:3].float(), (ds.INPUT_H, ds.INPUT_W), "area"), out_hw,
                    "lanczos4")
        for scale, native in ((0.5, 1.0), (0.25, 0.5)):
            ms = time_ms(lambda: ds._rife_chunk(up[:-1], up[1:], scale), 3, warmup=1)
            print(f"sweep RIFE chunk (2 pairs x 3 timesteps, batch 6 at {out_w}x{out_h}, f32), "
                  f"native scale {native}: {ms:.3f} ms; {card}")
        del up
        for vfi, k in (("none", 8), ("frame_dup", 8), ("linear_blend", 8), ("optical_flow", 8),
                       ("ui_aware", 4), ("ughi", 4), ("mcar", 2), ("rife", 2), ("adaptive", 2)):
            args = (interval.kf[:k + 1], interval.kf[:k + 1], interval.mid[:k],
                    torch.zeros((k, 3, *out_hw, 3), device=dev))
            opts = dict(vfi=vfi, interp="lanczos4", edge=1.3, out_hw=out_hw,
                        is_control=vfi == "none", motion_thresh=3.0, mcar_low=0.25,
                        mcar_high=0.6, want_frames=False)
            ms = time_ms(lambda: ds._chunk_program(*args, **opts), 2, warmup=1)
            print(f"sweep _chunk_program {vfi}, {k} pairs at {out_w}x{out_h}: {ms:.3f} ms "
                  f"({ms / k:.3f} per pair); {card}")
            del args
        del interval
        t0 = _phase("sweep_timing", t0)

        total = _kernel_by_shape(kw, "sweep", "sweep", firsts, counts)
        del firsts
        _phase("sweep_k1_timing", t0)
        return path_numbers(launches, max_err, total, 1)
    finally:
        tmp.cleanup()


# the triplet phase: run_benchmarks on a processed clip of TRIPLET_FRAMES
# 1080p frames of the adaptive phase's scene panning TRIPLET_PAN px per frame,
# its ground truth rendered at 2560x1440 (the clip's 1.3333 scale) at t =
# 0.25/0.5/0.75
TRIPLET_FRAMES, TRIPLET_PAN, TRIPLET_SCALE = 3, 4.0, 1.3333  # frames cut from 5 for step 25
TRIPLET_GT_HW = (1440, 2560)  # the models give 1439x2559 at 1.3333; the evaluator resizes
TRIPLET_MODELS = "lanczos,rife,adaptive,safa"


def triplet_phase(kw, card: str) -> dict:
    """Step 20 of the module docstring. Returns K1's numbers over the
    counted run's launches."""
    from vfisr_tpu_torch.data.png import write_png
    from vfisr_tpu_torch.harness import triplet as tr

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_triplet_")
    root = Path(tmp.name)
    try:
        clip = root / "data" / "clip_chip"
        inp, gtd = clip / "input_1080p30" / "frames", clip / "ground_truth" / "frames"
        inp.mkdir(parents=True)
        gtd.mkdir(parents=True)
        gh, gw = TRIPLET_GT_HW
        for i in range(TRIPLET_FRAMES):
            write_png(inp / f"frame_{i:04d}.png", scene_frame(TRIPLET_PAN * i, dev).cpu().numpy())
        triplets = []
        for i in range(TRIPLET_FRAMES - 1):
            names = [f"gt_{i:04d}_{k}.png" for k in range(3)]
            for name, t in zip(names, TS):
                write_png(gtd / name, scene_frame(TRIPLET_PAN * (i + t), dev, gh, gw,
                                                  scale=gw / W).cpu().numpy())
            triplets.append({"triplet_id": i, "input_frame_0": f"frame_{i:04d}.png",
                             "input_frame_1": f"frame_{i + 1:04d}.png",
                             "gt_intermediate": names, "num_intermediate": 3})
        (clip / "metadata.json").write_text(json.dumps({"spatial_scale": TRIPLET_SCALE,
                                                        "fps": 30}))
        (clip / "triplets.json").write_text(json.dumps(triplets))
        t0 = _phase("triplet_clip", t0)

        # every K1 launch checked as it goes
        checks, real_warp = [], kw.warp_windowed
        kw.warp_windowed = _checking(kw, checks)
        try:
            print("triplet check run (every K1 launch against its twin and its origins):")
            out = tr.run_benchmarks(root / "data", root / "check", models=TRIPLET_MODELS,
                                    warmup=1, device="cuda")
        finally:
            kw.warp_windowed = real_warp
        require(all("error" not in r for r in out["results"]["clip_chip"].values()),
                "the check run's rows")
        max_err = _require_checks(checks, "triplet check run")
        del checks
        t0 = _phase("triplet_check_run", t0)

        # counted (window_origins raising), timed
        firsts, counts, tag = {}, {}, {"name": "triplet"}
        kw.warp_windowed = _shape_counter(kw, firsts, counts, tag)
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                out = tr.run_benchmarks(root / "data", root / "out", models=TRIPLET_MODELS,
                                        warmup=1, device="cuda")
                launches = kw.launches
        finally:
            kw.warp_windowed = real_warp
        rows = out["results"]["clip_chip"]
        require(list(rows) == TRIPLET_MODELS.split(","), f"triplet rows {list(rows)}")
        for name, r in rows.items():
            require("error" not in r, f"triplet {name}: {r.get('error')}")
            require(r["num_triplets"] == TRIPLET_FRAMES - 1, f"triplet {name} count")
            q, sp = r["quality_summary"], r["speed_summary"]
            require(all(math.isfinite(q[m]["mean"]) for m in ("psnr", "ssim", "lpips")),
                    f"triplet {name} quality finite")
            print(f"triplet {name} ({r['model']}): psnr {q['psnr']['mean']:.4f} dB, ssim "
                  f"{q['ssim']['mean']:.4f}, lpips {q['lpips']['mean']:.4f} ({out['lpips_mode']}); "
                  f"time_ms mean {sp['time_ms']['mean']:.3f}, p50 {sp['time_ms']['p50']:.3f}; "
                  f"throughput_fps {sp['throughput_fps']:.3f}; vram_mb max "
                  f"{sp['vram_mb']['max']:.1f}; {card}")
        require(launches == sum(counts.values()) and launches > 0,
                f"{launches} K1 launches in the triplet run")
        t0 = _phase("triplet_run", t0)

        # the CLI, as a user runs it, and a --merge run that keeps its row
        base = [sys.executable, "-m", "vfisr_tpu_torch.benchmark", "-d", str(root / "data"),
                "-o", str(root / "cli"), "--warmup", "1"]
        for extra in (["-m", "lanczos", "--max-triplets", "2"],
                      ["-m", "bicubic", "--max-triplets", "1", "--merge"]):
            res = subprocess.run(base + extra, cwd=ROOT, capture_output=True, text=True,
                                 timeout=300)
            require(res.returncode == 0, f"benchmark CLI {extra}: {res.stdout[-2000:]}"
                                         f"{res.stderr[-2000:]}")
        merged = json.loads((root / "cli" / "benchmark_results.json").read_text())
        require(set(merged["results"]["clip_chip"]) == {"lanczos", "bicubic"}
                and merged["results"]["clip_chip"]["lanczos"]["num_triplets"] == 2
                and merged["merged_models"] == ["bicubic"],
                "the benchmark CLI's file, merged")
        print("triplet CLI: python -m vfisr_tpu_torch.benchmark -m lanczos --max-triplets 2, "
              "then -m bicubic --merge: both rows in benchmark_results.json")
        t0 = _phase("triplet_cli", t0)

        total = _kernel_by_shape(kw, "triplet", "run", firsts, counts)
        _phase("triplet_k1_timing", t0)
        return path_numbers(launches, max_err, total, 1)
    finally:
        tmp.cleanup()


# the ingest phase: the dataset pipeline (data/, its CLIs, analysis/) on a
# source clip the card renders: INGEST_FRAMES frames of the adaptive phase's
# scene (plane waves under a static HUD box) at INGEST_HW, a INGEST_FPS fps
# Y4M, panning INGEST_PANS px per source frame over the INGEST_COUNT
# intervals of INGEST_DURATION s that extract_intervals places
INGEST_HW, INGEST_FRAMES, INGEST_FPS = (1440, 2560), 40, 120
INGEST_PANS = (0, 2, 8)
INGEST_COUNT, INGEST_DURATION = 3, 0.1
INGEST_OUT = (1920, 1080)  # the intervals' frames and the triplets' input (w, h)
INGEST_IN_FPS = 30
INGEST_CLIP = "chip_ingest"
INGEST_MODELS = "lanczos,rife"
INGEST_STAGE_FRAMES = 4  # frames per stage timing (cut from 8 for step 25)
INGEST_FULL_KEYFRAMES = 3  # run_full_benchmark --max-frames (all 6, cut for step 25)


def ingest_layout(xi) -> tuple:
    """Each source frame's pan offset (px at INGEST_HW) and the intervals'
    (first, end) source frames, from the port's placement code (the
    extractor's own): the floor of int(start_s * fps) moves the starts, so
    the pan changes where the extractor will cut, not where a hand puts it."""
    _, starts = xi.interval_starts(INGEST_FRAMES / INGEST_FPS, INGEST_COUNT, INGEST_DURATION)
    spans = [xi.interval_frames(s, INGEST_DURATION, INGEST_FPS, INGEST_FRAMES) for s in starts]
    x, xs = 0.0, []
    for f in range(INGEST_FRAMES):
        xs.append(x)
        x += INGEST_PANS[max(sum(f >= a for a, _ in spans) - 1, 0)]
    return xs, spans


def run_cli(args: list, label: str, timeout: int = 300) -> tuple:
    """``python -m <args>`` as a user runs it, from the repository's root:
    (stdout, seconds with the process's start). Fails on a nonzero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", *map(str, args)], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    require(res.returncode == 0, f"{label}: exit {res.returncode}: {res.stdout[-2000:]}"
                                 f"{res.stderr[-2000:]}")
    return res.stdout, time.perf_counter() - t0


def want_triplets(n_in: int, n_gt: int, scale: float) -> list:
    """The triplet index the reference's formula gives (preprocess_video.py:
    gt_start = round(i * scale), gt_end = round((i + 1) * scale), the frames
    strictly between them, positions (k - gt_start) / (gt_end - gt_start))."""
    out = []
    for i in range(n_in - 1):
        s, e = int(round(i * scale)), int(round((i + 1) * scale))
        mid = list(range(s + 1, e))
        if not mid or e >= n_gt:
            continue
        out.append({"triplet_id": len(out), "input_frame_0": f"frame_{i:05d}.png",
                    "input_frame_1": f"frame_{i + 1:05d}.png", "input_idx_0": i,
                    "input_idx_1": i + 1, "gt_frame_start": f"frame_{s:05d}.png",
                    "gt_frame_end": f"frame_{e:05d}.png", "gt_start_idx": s, "gt_end_idx": e,
                    "gt_intermediate": [f"frame_{k:05d}.png" for k in mid],
                    "gt_intermediate_indices": mid,
                    "temporal_positions": [(k - s) / (e - s) for k in mid],
                    "num_intermediate": len(mid)})
    return out


def ingest_phase(kw, card: str) -> tuple:
    """Step 21 of the module docstring. Returns K1's numbers over the
    counted extraction's launches, and the temporary directory that holds
    the processed clip (``processed/``) for step 22: the caller cleans it
    up."""
    import contextlib as cl
    import io
    import shutil
    import zlib

    from vfisr_tpu_torch import list_intervals
    from vfisr_tpu_torch.analysis import final_analysis, normalize_data, statistical_analysis
    from vfisr_tpu_torch.core.color import i420_to_rgb, rgb_to_gray
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.data import extract_intervals as xi
    from vfisr_tpu_torch.data.png import read_png, write_png
    from vfisr_tpu_torch.data.registry import ClipRegistry
    from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter
    from vfisr_tpu_torch.harness import triplet as tr
    from vfisr_tpu_torch.ops.flow import farneback_flow
    from vfisr_tpu_torch.pipeline.streaming import pack_i420

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sh, sw = INGEST_HW
    ow, oh = INGEST_OUT
    xs, spans = ingest_layout(xi)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ingest_")
    root = Path(tmp.name)
    data = root / "data"
    y4m = data / "raw" / "ingest.y4m"
    try:
        # 1. the source clip, rendered on the card and packed to I420 there
        scale = sw / W
        with VideoWriter(str(y4m), sw, sh, INGEST_FPS) as wr:
            for x in xs:
                wr.write_i420(pack_i420(scene_frame(x / scale, dev, sh, sw, scale=scale)[None])[0]
                              .cpu().numpy())
        print(f"ingest source: {y4m.name}, {INGEST_FRAMES} frames at {sw}x{sh}, {INGEST_FPS} fps, "
              f"{y4m.stat().st_size / 1e6:.1f} MB; intervals (source frames) {spans}, pans "
              f"{INGEST_PANS} px per frame")
        t0 = _phase("ingest_source", t0)

        # 2. register, through the CLI
        _, reg_s = run_cli(["vfisr_tpu_torch.register_clip", y4m, "--clip-id", INGEST_CLIP,
                            "--data-dir", data], "register_clip")
        entry = ClipRegistry(data).get_clip(INGEST_CLIP)
        require(entry is not None and (entry["width"], entry["height"], entry["fps"],
                                       entry["frame_count"]) == (sw, sh, float(INGEST_FPS),
                                                                 INGEST_FRAMES)
                and entry["duration_s"] == INGEST_FRAMES / INGEST_FPS,
                f"the registry entry {entry}")
        print(f"ingest register (python -m vfisr_tpu_torch.register_clip): {reg_s:.3f} s; "
              f"{entry['width']}x{entry['height']}@{entry['fps']} fps, {entry['frame_count']} "
              f"frames, {entry['duration_s']:.4f} s, codec {entry['codec']}")
        t0 = _phase("ingest_register", t0)

        # 3a. the extraction with every K1 launch checked as it goes, into a
        # copy of the registry (its times include the twins)
        check = root / "check"
        (check / "clips" / INGEST_CLIP).mkdir(parents=True)
        shutil.copy(data / "clips_registry.json", check)
        shutil.copy(data / "clips" / INGEST_CLIP / "clip_meta.json", check / "clips" / INGEST_CLIP)
        checks, real_warp = [], kw.warp_windowed
        kw.warp_windowed = _checking(kw, checks)
        try:
            xi.IntervalExtractor(check, device="cuda").extract_intervals(
                INGEST_CLIP, INGEST_COUNT, INGEST_DURATION, output_resolution=INGEST_OUT,
                verbose=False)
        finally:
            kw.warp_windowed = real_warp
        max_err = _require_checks(checks, "ingest check run")
        del checks
        t0 = _phase("ingest_check_run", t0)

        # 3b. the extraction, counted (window_origins raising) and timed: the
        # main path of this step
        firsts, counts, tag = {}, {}, {"name": "ingest"}
        kw.warp_windowed = _shape_counter(kw, firsts, counts, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                start = time.perf_counter()
                metas = xi.IntervalExtractor(data, device="cuda").extract_intervals(
                    INGEST_CLIP, INGEST_COUNT, INGEST_DURATION, output_resolution=INGEST_OUT,
                    verbose=False)
                torch.cuda.synchronize()
                extract_s = time.perf_counter() - start
                launches = kw.launches
        finally:
            kw.warp_windowed = real_warp
        peak = torch.cuda.max_memory_allocated() / 1e6
        n_read = sum(m["end_frame"] - m["start_frame"] for m in metas)
        n_pairs = sum(m["keyframe_count"] - 1 for m in metas)
        require(launches == sum(counts.values()) and launches > 0 and launches % n_pairs == 0,
                f"{launches} K1 launches over {n_pairs} keyframe pairs")
        require([(m["start_frame"], m["end_frame"], m["keyframe_count"], m["midpoint_count"])
                 for m in metas] == [(a, e, (e - a + 1) // 2, (e - a) // 2) for a, e in spans],
                f"the intervals' frames and counts {[(m['start_frame'], m['end_frame']) for m in metas]}")
        flows = []
        for m, pan in zip(metas, INGEST_PANS):
            idir = data / "clips" / INGEST_CLIP / "intervals" / m["interval_id"]
            meta = json.loads((idir / "meta.json").read_text())
            mf = meta["motion_stats"]["mean_flow"]
            require(meta["difficulty"] == xi.classify_difficulty(mf), f"{m['interval_id']} difficulty")
            flows.append(mf)
            print(f"ingest {m['interval_id']}: source frames [{m['start_frame']}, {m['end_frame']}), "
                  f"{m['keyframe_count']} keyframes / {m['midpoint_count']} midpoints, mean_flow "
                  f"{mf:.4f} px against a known {2 * pan * ow / sw:.4f} px per keyframe pair at "
                  f"{ow}x{oh} (the HUD box static), max_flow {meta['motion_stats']['max_flow']:.4f}, "
                  f"{meta['difficulty']}")
        require(metas[0]["difficulty"] == "STATIC" and flows == sorted(set(flows)),
                f"the static interval is STATIC and mean_flow rises with the pan: {flows}")
        print(f"ingest extraction: {n_read} source frames ({INGEST_COUNT} intervals, {n_pairs} "
              f"pairs) in {extract_s:.3f} s = {n_read / extract_s:.2f} fps (host clock; decode, "
              f"PNG and Farneback included); K1 {launches} launches ({launches // n_pairs} per "
              f"pair); peak {peak:.1f} MB over {resident / 1e6:.1f} MB resident; {card}")
        t0 = _phase("ingest_extract", t0)

        # the card against the CPU path: interval 1's first two keyframes
        # from the host's decode, and its first pair's statistics
        a1 = spans[1][0]
        idir1 = data / "clips" / INGEST_CLIP / "intervals" / metas[1]["interval_id"]
        with VideoReader(str(y4m), a1) as rd:
            src = [rd.read() for _ in range(3)]
        kf = [read_png(idir1 / "keyframes" / f"kf_{k:04d}.png") for k in (0, 1)]
        for k, f in ((0, src[0]), (1, src[2])):
            cpu = xi.fit_frame(torch.from_numpy(f), INGEST_OUT).numpy()
            d = np.abs(cpu.astype(int) - kf[k].astype(int))
            print(f"ingest keyframe {k} of {metas[1]['interval_id']} against the CPU's crop and "
                  f"Lanczos4 of the host-decoded frame: max {d.max()} LSB, mean {d.mean():.6f}")
            require(d.max() <= 1, f"keyframe {k} against the CPU path")
        pair = json.loads((idir1 / "motion" / "complexity.json").read_text())[0]
        cpu_stats = xi.compute_motion_stats(kf[0][..., ::-1], kf[1][..., ::-1], device="cpu")
        rel = {k: abs(pair[k] - v) / max(abs(v), 1e-12) for k, v in cpu_stats.items()}
        print(f"ingest pair 0 of {metas[1]['interval_id']}, card against CPU: "
              + ", ".join(f"{k} {pair[k]:.6f} / {cpu_stats[k]:.6f} (rel {rel[k]:.2e})"
                          for k in cpu_stats))
        require(max(rel.values()) <= 1e-3, "the pair's motion stats, card against CPU")
        t0 = _phase("ingest_cpu_checks", t0)

        # the CLIs over what was extracted
        out, val_s = run_cli(["vfisr_tpu_torch.validate_intervals", "--clip", INGEST_CLIP,
                              "--interval", ",".join(str(i) for i in range(len(metas))),
                              "--data-dir", data, "--sample", "3"], "validate_intervals")
        require("VALID" in out and "MISMATCH" not in out, f"validate_intervals: {out}")
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            list_intervals.main(["--data-dir", str(data)])
        require(all(f"{m['interval_id']}: " in buf.getvalue() for m in metas),
                f"list_intervals: {buf.getvalue()}")
        print(f"ingest validate_intervals (python -m, all {len(metas)} intervals, 3 keyframes "
              f"each re-extracted on the card): VALID, {val_s:.3f} s; list_intervals:\n"
              + buf.getvalue().rstrip())
        t0 = _phase("ingest_validate", t0)

        # where an extracted frame's time goes: each stage alone, on the
        # second interval's frames
        with VideoReader(str(y4m), a1) as rd:
            start = time.perf_counter()
            bufs = [rd.read_i420() for _ in range(INGEST_STAGE_FRAMES)]
            decode_ms = (time.perf_counter() - start) * 1e3 / INGEST_STAGE_FRAMES
        upload_ms = time_ms(lambda: torch.from_numpy(bufs[0]).to(dev), 10)
        planes = torch.from_numpy(bufs[0]).to(dev)
        convert_ms = time_ms(lambda: i420_to_rgb(planes, sh, sw), 10)
        rgb = i420_to_rgb(planes, sh, sw)
        fit_ms = time_ms(lambda: xi.fit_frame(rgb, INGEST_OUT), 10)
        fitted = xi.fit_frame(rgb, INGEST_OUT)
        readback_ms = time_ms(lambda: fitted.cpu(), 10)
        host = fitted.cpu().numpy()
        start = time.perf_counter()
        for i in range(INGEST_STAGE_FRAMES):
            write_png(root / f"stage_{i}.png", host)
        encode_ms = (time.perf_counter() - start) * 1e3 / INGEST_STAGE_FRAMES
        # the earlier writer's encode (unfiltered rows, zlib's default
        # strategy at level 1), on the same frame, for the comparison
        rows0 = np.zeros((oh, 1 + host[0].size), np.uint8)
        rows0[:, 1:] = host.reshape(oh, -1)
        start = time.perf_counter()
        for _ in range(INGEST_STAGE_FRAMES):
            zlib.compress(rows0.tobytes(), 1)
        encode0_ms = (time.perf_counter() - start) * 1e3 / INGEST_STAGE_FRAMES
        gray = torch.stack([rgb_to_gray(xi.fit_frame(i420_to_rgb(torch.from_numpy(b).to(dev),
                                                                   sh, sw), INGEST_OUT))
                            for b in bufs[:3:2]])
        small = resize(gray[..., None], (oh // 2, ow // 2), "linear")[..., 0].float()
        flow_ms = time_ms(lambda: farneback_flow(small[:1], small[1:]), 5)
        xi.motion_stats(gray)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(5):
            xi.motion_stats(gray)
        stats_ms = (time.perf_counter() - start) * 1e3 / 5
        per_frame = decode_ms + upload_ms + convert_ms + fit_ms + readback_ms + encode_ms
        print(f"ingest stages per {sw}x{sh} source frame ({card}): decode (read_i420, host) "
              f"{decode_ms:.3f} ms, upload {upload_ms:.3f}, I420 -> RGB {convert_ms:.3f}, crop + "
              f"Lanczos4 to {ow}x{oh} {fit_ms:.3f}, read-back {readback_ms:.3f}, PNG encode "
              f"(host: Sub rows, zlib level 1, Z_RLE) {encode_ms:.3f} (unfiltered rows, the "
              f"default strategy: {encode0_ms:.3f}); Farneback per pair at {ow // 2}x{oh // 2} "
              f"(CUDA events) {flow_ms:.3f} ms, motion_stats per pair (host clock: gray resize, "
              f"Farneback, read-back, numpy statistics) {stats_ms:.3f} ms")
        print(f"ingest model of the extraction: {n_read} frames x {per_frame:.3f} ms + {n_pairs} "
              f"pairs x {stats_ms:.3f} ms = {(n_read * per_frame + n_pairs * stats_ms) / 1e3:.3f} s "
              f"(PNG encode {n_read * encode_ms / 1e3:.3f} s, motion {n_pairs * stats_ms / 1e3:.3f} "
              f"s) against {extract_s:.3f} s measured")
        del bufs, planes, rgb, fitted, gray, small
        t0 = _phase("ingest_stages", t0)

        # 4. preprocess, through the CLI (it prints the processing's seconds)
        n_in = -(-INGEST_FRAMES * INGEST_IN_FPS // INGEST_FPS)
        out, cli_s = run_cli(["vfisr_tpu_torch.preprocess_video", y4m, "--clip-name",
                              INGEST_CLIP, "--output-dir", root / "processed",
                              "--input-resolution", f"{ow}x{oh}", "--input-fps", INGEST_IN_FPS,
                              "--target-resolution", f"{sw}x{sh}", "--target-fps", INGEST_FPS],
                             "preprocess_video")
        pre_s = float(out.rsplit(" in ", 1)[1].split()[0])
        clip = root / "processed" / INGEST_CLIP
        md = json.loads((clip / "metadata.json").read_text())
        triplets = json.loads((clip / "triplets.json").read_text())
        want = want_triplets(n_in, INGEST_FRAMES, INGEST_FPS / INGEST_IN_FPS)
        require((md["num_input_frames"], md["num_gt_frames"], md["num_triplets"])
                == (n_in, INGEST_FRAMES, len(want)), f"processed counts {md}")
        require(triplets == want and triplets[0]["temporal_positions"] == [0.25, 0.5, 0.75],
                "triplets.json equals the formula")
        with VideoReader(str(y4m)) as rd:
            for k in range(INGEST_FRAMES):
                require(np.array_equal(read_png(clip / "ground_truth" / "frames"
                                                / f"frame_{k:05d}.png"), rd.read()),
                        f"GT frame {k} equals its decoded source frame")
        print(f"ingest preprocess (python -m vfisr_tpu_torch.preprocess_video, {sw}x{sh}@"
              f"{INGEST_FPS} -> input {ow}x{oh}@{INGEST_IN_FPS}, GT {sw}x{sh}@{INGEST_FPS}): "
              f"{n_in} input frames, {INGEST_FRAMES} GT frames (each equal to its decoded source "
              f"frame), {len(want)} triplets equal to the formula; processing {pre_s:.3f} s = "
              f"{INGEST_FRAMES / pre_s:.2f} source fps ({cli_s:.3f} s with the process's start); "
              f"{card}")
        t0 = _phase("ingest_preprocess", t0)

        # 5. the triplet benchmark on the processed clip, every K1 launch
        # checked as it goes
        checks = []
        kw.warp_windowed = _checking(kw, checks)
        try:
            start = time.perf_counter()
            out = tr.run_benchmarks(root / "processed", root / "triplet", models=INGEST_MODELS,
                                    warmup=1, device="cuda")
            triplet_s = time.perf_counter() - start
        finally:
            kw.warp_windowed = real_warp
        max_err = max(max_err, _require_checks(checks, "ingest triplet run"))
        del checks
        rows = out["results"][INGEST_CLIP]
        require(list(rows) == INGEST_MODELS.split(","), f"triplet rows {list(rows)}")
        for name, r in rows.items():
            require("error" not in r and r["num_triplets"] == len(want),
                    f"ingest triplet {name}: {r.get('error', r.get('num_triplets'))}")
            q, sp = r["quality_summary"], r["speed_summary"]
            require(all(math.isfinite(q[m]["mean"]) for m in ("psnr", "ssim", "lpips")),
                    f"ingest triplet {name} quality finite")
            print(f"ingest triplet {name}: {r['num_triplets']} triplets, psnr "
                  f"{q['psnr']['mean']:.4f} dB, ssim {q['ssim']['mean']:.4f}, lpips "
                  f"{q['lpips']['mean']:.4f}; time_ms mean {sp['time_ms']['mean']:.3f}, p50 "
                  f"{sp['time_ms']['p50']:.3f} (its launches checked against the twins); {card}")
        print(f"ingest triplet run: {triplet_s:.3f} s (host clock, twins included)")
        t0 = _phase("ingest_triplet", t0)

        # 6. the full benchmark over the registered clip, then the analyses
        full = root / "full"
        _, full_s = run_cli(["vfisr_tpu_torch.run_full_benchmark", "--data-dir", data,
                             "--output-dir", full, "--max-frames", str(INGEST_FULL_KEYFRAMES)],
                            "run_full_benchmark", timeout=600)
        results = json.loads((full / "experiment_results.json").read_text())
        log = (full / "experiment_log.txt").read_text()
        per = {}
        for r in results["experiments"]:
            per.setdefault(r["interval_idx"], []).append(r)
        require("FAILED" not in log and sorted(per) == list(range(len(metas)))
                and all(len(v) == 12 for v in per.values()),
                f"run_full_benchmark rows per interval {[len(v) for v in per.values()]}")
        for i, v in sorted(per.items()):
            by = {r["name"]: r for r in v}
            print(f"ingest full benchmark interval {i}: {len(v)} rows; vfi_psnr_db degraded "
                  f"{by['degraded']['vfi_psnr_db']}, lanczos_blend {by['lanczos_blend']['vfi_psnr_db']}, "
                  f"optical_flow_basic {by['optical_flow_basic']['vfi_psnr_db']}, uafi_default "
                  f"{by['uafi_default']['vfi_psnr_db']}, ughi_default "
                  f"{by['ughi_default']['vfi_psnr_db']}; time_s sum "
                  f"{sum(r['time_s'] for r in v):.3f}")
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            from vfisr_tpu_torch import analyze_statistics

            analyze_statistics.main(["--results", str(full / "experiment_results.json"),
                                     "--output-dir", str(full)])
        report = json.loads((full / "statistical_analysis.json").read_text())
        norm = normalize_data.run(full / "experiment_results.json", full)
        final = final_analysis.run(full / "experiment_results.json", full)
        for m in ("uafi_default", "ughi_default"):
            v, t = report["novel_verdicts"][m], report["methods"][m]["paired_t"]
            require(t["n"] == len(metas) and v["mean_gain_db"] is not None
                    and v["confidence"] in ("significant", "not significant"),
                    f"statistics of {m}: {v}, {t}")
            print(f"ingest statistics {m}: gain {v['mean_gain_db']:+.4f} dB over degraded, "
                  f"n {t['n']}, p {v['p_value']}, {v['confidence']}; normalized gain "
                  f"{norm['methods'][m]['mean_gain_db']:+.4f} dB, time_ratio "
                  f"{norm['methods'][m]['time_ratio']:.4f}")
        require(set(statistical_analysis.NOVEL_METHODS) & set(final["novel_methods"])
                == {"uafi_default", "ughi_default"}, "final_analysis's novel methods")
        print(f"ingest full benchmark (python -m vfisr_tpu_torch.run_full_benchmark, light "
              f"experiments, {len(metas)} intervals at the default quality): {full_s:.3f} s with "
              f"both processes' start; analyze_statistics, normalize_data and final_analysis "
              f"written; {card}")
        t0 = _phase("ingest_full_benchmark", t0)

        # 7. the quality CLI on an interval's keyframes against its midpoints
        _, q_s = run_cli(["vfisr_tpu_torch.evaluate_quality", "--pred-dir", idir1 / "keyframes",
                          "--gt-dir", idir1 / "midpoints", "--comprehensive", "--output",
                          root / "quality.json"], "evaluate_quality")
        q = json.loads((root / "quality.json").read_text())
        require(q["frames"] == metas[1]["midpoint_count"] and "comprehensive" in q
                and math.isfinite(q["psnr"]), f"evaluate_quality's JSON {sorted(q)}")
        print(f"ingest evaluate_quality --comprehensive ({q['frames']} frames): psnr "
              f"{q['psnr']:.4f} dB, ssim {q['ssim']:.4f}, lpips {q['lpips']:.4f}; {q_s:.3f} s "
              f"with the process's start")
        t0 = _phase("ingest_quality", t0)

        total = _kernel_by_shape(kw, "ingest", "run", firsts, counts)
        del firsts
        _phase("ingest_k1_timing", t0)
        return path_numbers(launches, max_err, total, 1), tmp
    except BaseException:
        tmp.cleanup()
        raise


# the training-data phase: step 21's processed clip (9 triplets, 27 entries,
# 1920x1080 inputs, 2560x1440 ground truth) through TripletCropDataset and
# the trainer's --data, the host scene generators through --data-source
# host, then the held-out evaluation and gate CLIs, all in this process
DATA_BATCH, DATA_CROP, DATA_SEED = 16, 192, 0
DATA_STEPS = 2  # --data steps of full-width RIFE (cut from 3 for step 25)
HOST_STEPS = (("rife", 4), ("span_x4", 2), ("safa", 2))  # --data-source host
DATA_ENTRIES = 27
K1_PER_DATA_STEP = {"rife": K1_PER_STEP - 2, "safa": K1_PER_SAFA_STEP - 2}  # no data warps
K2_PER_DATA_STEP = {"rife": K2_PER_STEP, "safa": K2_PER_SAFA_STEP}
GATE_SAMPLES = 8
EVAL_CLI_SAMPLES = 8  # the eval CLIs' samples (their defaults 16 and 12, cut for step 25)


def _checking_grad(kw, checks: list, firsts: dict, counts: dict, tag: dict):
    """K2's wrapper, holding each launch against its plain twin as it goes
    (error, tolerance, largest |cg|: device tensors in checks), counting it
    by (tag["name"], shape) and keeping a clone of each shape's first launch
    for the per-shape timing."""
    real = kw.warp_windowed_grad

    def checking(img, flow, t, ct, r=8, border="replicate", compute_dtype=torch.float32):
        gflow, cg = real(img, flow, t, ct, r, border, compute_dtype)
        ref_gflow, ref_cg = _twin(kw, kw.warp_windowed_grad_plain, img, flow, t, ct, r, border,
                                  compute_dtype)
        base = 2.0 / 255.0 if compute_dtype == torch.bfloat16 else 1e-5
        scale = ref_cg.abs().max()
        checks.append((torch.maximum((gflow.float() - ref_gflow.float()).abs().max(),
                                     (cg - ref_cg).abs().max()), base * scale, scale))
        a = dict(img=img, flow=flow, t=t, r=r, border=border, compute_dtype=compute_dtype)
        key = shape_key(a)
        if key not in firsts:
            firsts[key] = dict(a, img=img.clone(), flow=flow.clone(), ct=ct.contiguous().clone(),
                               t=t.clone() if torch.is_tensor(t) else t)
        counts[(tag["name"], key)] = counts.get((tag["name"], key), 0) + 1
        return gflow, cg

    return checking


def _counted_run(kw, checks1: list, checks2: list, firsts1: dict, counts1: dict,
                 firsts2: dict, counts2: dict, tag: dict, label: str, fn):
    """fn() with K1 and K2 held against their twins (and K1's origins against
    window_origins) as they go, counted by shape under label and in all,
    with window_origins raising: (fn's result, K1 launches, K2 launches)."""
    tag["name"] = label
    real_warp, real_grad = kw.warp_windowed, kw.warp_windowed_grad
    kw.warp_windowed = _checking(kw, checks1)
    kw.warp_windowed = _shape_counter(kw, firsts1, counts1, tag)
    kw.warp_windowed_grad = _checking_grad(kw, checks2, firsts2, counts2, tag)
    n1, n2 = len(checks1), len(checks2)
    try:
        with origin_table_raises(kw):
            kw.launches = kw.grad_launches = 0
            out = fn()
            torch.cuda.synchronize()
            k1, k2 = kw.launches, kw.grad_launches
    finally:
        kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
    require(k1 == len(checks1) - n1 and k2 == len(checks2) - n2,
            f"{label}: {k1} K1 and {k2} K2 launches, each checked")
    return out, k1, k2


def _require_grad_checks(checks: list, label: str, zero_ct: bool = False) -> float:
    """Every K2 launch of a checked run within its tolerance of the twin
    (relative to its largest |cg|, which must not be 0; with zero_ct, a
    launch whose twin's cg is 0 everywhere must give exactly 0, and at least
    one launch must have a gradient); returns the largest error."""
    err, tol, scale = (torch.stack(v) for v in zip(*checks))
    max_err = err.max().item()
    live = bool((scale > 0).any()) if zero_ct else bool((scale > 0).all())
    require(live and bool((err <= tol).all()),
            f"{label}: K2 vs twin at every launch (max_abs_err {max_err:.3e})")
    print(f"{label}: {len(checks)} K2 launches, each within its tolerance of the twin "
          f"(max_abs_err {max_err:.3e})")
    return max_err


def _weights_state() -> dict:
    """Each file under weights/ with its size and modification time."""
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted((ROOT / "weights").iterdir()) if p.is_file()}


def data_phase(kw, card: str, processed: Path) -> tuple:
    """Step 22 of the module docstring. Returns K1's and K2's numbers over
    the phase's counted launches."""
    import contextlib as cl
    import hashlib
    import io
    import random
    import shutil

    from vfisr_tpu_torch import eval_sr_quality, eval_vfi_quality
    from vfisr_tpu_torch import gate_checkpoint as gate
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.data.png import read_png
    from vfisr_tpu_torch.train import __main__ as train_cli
    from vfisr_tpu_torch.train.data import (TripletCropDataset, augment_vfi_batch,
                                            synthetic_batch)

    t0 = time.perf_counter()
    weights_before = _weights_state()
    c = DATA_CROP

    # 1. the dataset's first batch, on the card, against a replay of its
    # draws on the CPU
    ds = TripletCropDataset(processed, crop=c, seed=DATA_SEED, device="cuda")
    require(len(ds) == DATA_ENTRIES, f"{len(ds)} triplet entries")
    start = time.perf_counter()
    batch = next(ds.batches(DATA_BATCH, 1))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - start
    rng = random.Random(DATA_SEED)
    read_ms = {}
    for i in range(DATA_BATCH):
        e = rng.choice(ds.entries)
        frames = []
        for k in ("f0", "f1", "gt"):
            start = time.perf_counter()
            f = read_png(e[k])
            read_ms.setdefault(f.shape[:2], []).append((time.perf_counter() - start) * 1e3)
            frames.append(torch.from_numpy(f))
        h, w = frames[0].shape[:2]
        frames[2] = resize(frames[2], (h, w), "area")
        y, x = rng.randint(0, max(h - c, 0)), rng.randint(0, max(w - c, 0))
        for k, f in zip(("img0", "img1", "gt"), frames):
            # as bytes: the card divides by 255 as a product with its
            # reciprocal, which can leave the last bit of the float apart
            got = torch.round(batch[k][i].cpu() * 255.0).to(torch.uint8)
            require(torch.equal(got, f[y:y + c, x:x + c]),
                    f"dataset sample {i} {k}: the CPU's read, area resize and crop at the "
                    f"replayed draw ({y}, {x})")
        require(batch["t"][i].item() == e["t"], f"dataset sample {i} t")
    require(ds.rng.getstate() == rng.getstate(), "the dataset's draws equal the replay's")
    per = {hw: sum(v) / len(v) for hw, v in read_ms.items()}
    print(f"data TripletCropDataset first batch ({DATA_BATCH} x {c}^2, t "
          f"{sorted(set(batch['t'].tolist()))}): {batch_s:.3f} s (host clock: 3 PNG reads, the "
          f"GT's area resize on the card and the crops per sample); each crop's bytes, GT and t "
          f"equal to the CPU's read, area resize and crop at a fresh random.Random({DATA_SEED}) "
          "replay; "
          "read_png per frame (host) " + ", ".join(
              f"{w}x{h} {v:.3f} ms (n {len(read_ms[(h, w)])})" for (h, w), v in sorted(per.items()))
          + f"; {card}")
    del batch
    t0 = _phase("data_dataset", t0)

    # 2. the trainer, in process, at full width: K1 and K2 held against their
    # twins at every launch as it goes, counted with window_origins raising
    checks1, checks2, firsts1, counts1, firsts2, counts2 = [], [], {}, {}, {}, {}
    tag = {}

    def counted(label: str, fn):
        return _counted_run(kw, checks1, checks2, firsts1, counts1, firsts2, counts2, tag,
                            label, fn)

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_data_")
    root = Path(tmp.name)
    try:
        common = ["--batch", str(DATA_BATCH), "--crop", str(c), "--seed", str(DATA_SEED),
                  "--log-every", "1"]
        runs = [("rife", DATA_STEPS, ["--data", str(processed)], "triplets")]
        runs += [(m, n, ["--data-source", "host"], "host scenes") for m, n in HOST_STEPS]
        data_out = None
        for model, steps, source, what in runs:
            out = root / f"{model}_{what.split()[0]}.npz"
            buf = io.StringIO()
            with cl.redirect_stdout(buf):
                res, k1, k2 = counted(f"train {model} {what}", lambda: train_cli.run(
                    ["--model", model, "--steps", str(steps), "--out", str(out), *source,
                     *common]))
            losses = [float(ln.split("loss ")[1].split()[0]) for ln in buf.getvalue().splitlines()
                      if ln.startswith("step ")]
            require(out.is_file() and len(losses) == steps
                    and all(math.isfinite(v) for v in losses), f"{model} on {what}: {losses}")
            want1 = K1_PER_DATA_STEP.get(model, 0) * steps
            want2 = K2_PER_DATA_STEP.get(model, 0) * steps
            require(k1 == want1 and k2 == want2,
                    f"{model} on {what}: {k1} K1 and {k2} K2 launches, {want1} and {want2} wanted")
            step_ms = [v * 1e3 for v in res["step_s"]]
            wait_ms = [v * 1e3 for v in res["wait_s"]]
            print(f"data train {model} on {what} (python -m vfisr_tpu_torch.train {' '.join(source)}"
                  f", batch {DATA_BATCH}, crop {c}, in process): {steps} steps, losses "
                  f"{', '.join(f'{v:.5f}' for v in losses)}; ms per step (host clock, K1 and K2 "
                  f"checked against their twins as they go) first {step_ms[0]:.3f}, then "
                  f"{', '.join(f'{v:.3f}' for v in step_ms[1:])}; the step loop's wait on the "
                  f"queue per step first {wait_ms[0]:.3f} ms, then "
                  f"{', '.join(f'{v:.3f}' for v in wait_ms[1:])}; K1 {k1}, K2 {k2} launches; "
                  f"{card}")
            if what == "triplets":
                data_out = out
            t0 = _phase(f"data_train_{model}_{what.split()[0]}", t0)

        # the host generators alone, at the trainer's batch and crop
        gen = np.random.default_rng(DATA_SEED)
        start = time.perf_counter()
        scenes = synthetic_batch(gen, DATA_BATCH, c)
        scene_ms = (time.perf_counter() - start) * 1e3
        start = time.perf_counter()
        for _ in range(10):
            augment_vfi_batch(gen, scenes)
        augment_ms = (time.perf_counter() - start) * 1e2
        print(f"data host generators (batch {DATA_BATCH}, crop {c}, host clock): synthetic_batch "
              f"{scene_ms:.3f} ms ({scene_ms / DATA_BATCH:.3f} ms per scene), augment_vfi_batch "
              f"{augment_ms:.3f} ms; {card}")
        t0 = _phase("data_generators", t0)

        # 3. the held-out evaluations at their defaults, on the card
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            vfi_rows, k1, _ = counted("eval_vfi_quality", lambda: eval_vfi_quality.main(
                ["--samples", str(EVAL_CLI_SAMPLES)]))
            sr_rows, k1_sr, k2_sr = counted("eval_sr_quality", lambda: {
                scene: eval_sr_quality.main(["--scene", scene, "--samples", str(EVAL_CLI_SAMPLES)])
                for scene in ("smooth", "detail")})
        print(buf.getvalue().rstrip())
        rows = [*vfi_rows.values(), *(v for r in sr_rows.values() for v in r.values())]
        require(set(vfi_rows) == {"rife", "lanczos", "optical_flow"} and k1 > 0
                and all(len(r) == 4 for r in sr_rows.values()) and k1_sr == k2_sr == 0
                and all(math.isfinite(v) for row in rows for v in row),
                f"held-out PSNR and SSIM finite: {vfi_rows} {sr_rows}")
        print(f"data eval_vfi_quality ({EVAL_CLI_SAMPLES} samples at 256^2; K1 {k1} launches, checked) "
              f"and eval_sr_quality (defaults, smooth and detail scenes): every PSNR and SSIM "
              f"finite; {card}")
        t0 = _phase("data_eval", t0)

        # 4. the gate, on copies: the --data checkpoint against the shipped
        # weights/rife.npz
        cand, inc = root / "gate" / "rife.npz", root / "gate" / "rife_shipped.npz"
        cand.parent.mkdir()
        shutil.copyfile(data_out, cand)
        shutil.copyfile(ROOT / "weights" / "rife.npz", inc)
        digest = {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in (cand, inc)}
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            record, k1, _ = counted("gate_checkpoint", lambda: gate.main(
                ["--candidate", "rife", "--incumbent", "rife", "--incumbent-weights", str(inc),
                 "--weights", str(cand), "--demote-to", str(root / "gate" / "rife_aside.npz"),
                 "--samples", str(GATE_SAMPLES), "--record", str(root / "gate" / "rec.json")]))
        kept = record["decision"].startswith("kept")
        better = cand if kept else inc
        cand_db, inc_db = record["candidate_psnr_db"], record["incumbent_psnr_db"]
        require(json.loads((root / "gate" / "rec.json").read_text()) == record
                and (cand_db >= inc_db if kept else cand_db <= inc_db) and k1 > 0
                and hashlib.sha256(cand.read_bytes()).hexdigest() == digest[better],
                f"the gate's record and the file at --weights: {record}")
        print(f"data gate_checkpoint (--samples {GATE_SAMPLES}, the {DATA_STEPS}-step --data "
              f"checkpoint against a copy of weights/rife.npz; K1 {k1} launches, checked): "
              f"{json.dumps(record)}; --weights now holds the "
              f"{'candidate' if kept else 'incumbent'}'s bytes, the better score")
        t0 = _phase("data_gate", t0)
    finally:
        tmp.cleanup()
    require(_weights_state() == weights_before, "no file under weights/ written or moved")

    err1 = _require_checks(checks1, "data phase")
    err2 = _require_grad_checks(checks2, "data phase")
    del checks1, checks2
    total1 = _kernel_by_shape(kw, "data", "phase", firsts1, counts1)
    total2 = _kernel_by_shape(kw, "data", "phase", firsts2, counts2, grad=True)
    _phase("data_kernel_timing", t0)
    return (path_numbers(sum(counts1.values()), err1, total1, 1),
            path_numbers(sum(counts2.values()), err2, total2, 1))


# the calibration phase: the clip renderer and the router and LPIPS
# calibrations (make_synthetic_clip, calibrate_router, calibrate_lpips) on
# the card, at full width, cut in counts only: two 1 s clips at 1920x1080,
# 60 fps (the hard and routing presets at held-out seeds); the router's rows
# at the default quality 2560x1440 with full-width RIFE and VFIMamba; LPIPS
# at its defaults
CALIB_SECONDS = 1.0  # cut from 2 s for step 25
CALIB_CLIPS = (("hard", 431), ("routing", 432))
CALIB_ROUTER_ARGS = ["--pairs", "4", "--stride", "4", "--native-pairs", "4", "--samples", "4",
                     "--scene-worlds", "2", "--scene-seconds", "1"]
CALIB_HUD = (slice(42, 198), slice(42, 298))  # inside the minimap box, on whole chroma blocks
# the JAX package's pins for a calibration (tests/test_lpips_calibration.py):
# held-out 2AFC accuracy, the mean and the least within-family Spearman
LPIPS_PINS = (0.85, 0.9, 0.6)


def calibration_phase(kw, card: str) -> dict:
    """Step 23 of the module docstring. Returns K1's numbers over the
    phase's counted launches."""
    import contextlib as cl
    import io

    from vfisr_tpu_torch import calibrate_lpips, calibrate_router, make_synthetic_clip
    from vfisr_tpu_torch.core.resize import scale_size
    from vfisr_tpu_torch.data.video_io import VideoReader
    from vfisr_tpu_torch.evaluation import lpips_calibrate as lc
    from vfisr_tpu_torch.models.registry import get_model
    from vfisr_tpu_torch.pipeline.flagship import FlagshipVFI
    from vfisr_tpu_torch.utils import router_gate

    t0 = time.perf_counter()
    weights_before = _weights_state()
    checks, firsts, counts, tag = [], {}, {}, {}
    real_warp = kw.warp_windowed

    def counted(label: str, fn):
        """fn() with every K1 launch held against its twin as it goes,
        counted by shape with window_origins raising."""
        tag["name"] = label
        kw.warp_windowed = _checking(kw, checks)
        kw.warp_windowed = _shape_counter(kw, firsts, counts, tag)
        n = len(checks)
        try:
            with origin_table_raises(kw):
                kw.launches = 0
                out = fn()
                torch.cuda.synchronize()
                k1 = kw.launches
        finally:
            kw.warp_windowed = real_warp
        require(k1 == len(checks) - n, f"{label}: {k1} K1 launches, each checked")
        return out, k1

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_calib_")
    root = Path(tmp.name)
    try:
        # 1. the two calibration clips, rendered on the card
        clips, frames_hard = [], None
        for preset, seed in CALIB_CLIPS:
            path = root / f"calib_{preset}.y4m"
            buf = io.StringIO()
            with cl.redirect_stdout(buf):
                res = make_synthetic_clip.main([str(path), "--preset", preset, "--seconds",
                                                str(CALIB_SECONDS), "--seed", str(seed)])
            with VideoReader(str(path)) as r:
                frames = list(iter(lambda: r.read_to("cuda"), None))
            n = int(CALIB_SECONDS * 60)
            require(res["frames"] == len(frames) == n
                    and all(tuple(f.shape) == (H, W, 3) for f in frames),
                    f"{preset}: {len(frames)} frames of {tuple(frames[0].shape)}")
            if preset == "hard":
                hud = torch.stack([f[CALIB_HUD] for f in frames])
                require(bool((hud == hud[:1]).all()), "hard: the HUD box the same in every frame")
                frames_hard = frames[:2]
            else:
                require(all(not torch.equal(a, b) for a, b in zip(frames, frames[1:])),
                        "routing: no two consecutive frames identical")
            print(f"calibration render {preset} (python -m vfisr_tpu_torch.make_synthetic_clip "
                  f"--preset {preset} --seconds {CALIB_SECONDS} --seed {seed}, 1920x1080, 60 fps, "
                  f"on the card; host clock): {n} frames, textures {res['textures'] * 1e3:.3f} ms "
                  f"({res['textures'] * 1e3 / n:.3f} ms per frame of the clip), composite "
                  f"{res['composite'] * 1e3 / n:.3f} ms/frame, Y4M write "
                  f"{res['write'] * 1e3 / n:.3f} ms/frame; "
                  + ("the HUD box equal in every frame" if preset == "hard"
                     else "no two consecutive frames equal") + f"; {card}")
            clips.append(str(path))
            del frames
        t0 = _phase("calibration_render", t0)

        # 2. the router's calibration on those clips, every K1 launch checked
        gate_out = root / "router_gate.json"
        buf = io.StringIO()
        clip_list = ",".join(clips)
        start = time.perf_counter()
        with cl.redirect_stdout(buf):
            record, k1 = counted("calibrate_router", lambda: calibrate_router.main(
                ["--clip", clip_list, "--native-clips", clip_list, *CALIB_ROUTER_ARGS,
                 "--out", str(gate_out)]))
        router_s = time.perf_counter() - start
        print(buf.getvalue().rstrip())
        shipped = json.loads((ROOT / "weights" / "router_gate.json").read_text())
        require(json.loads(gate_out.read_text()) == json.loads(json.dumps(record))
                and set(shipped) <= set(record) and k1 > 0
                and set(record["experts"]) == {"rife", "vfimamba"},
                f"the gate file's sections: {sorted(record)}")
        sg, ssg = record["scene_gate"], shipped["scene_gate"]

        def bins(rec, regime):
            return [{k: v for k, v in b.items() if k != "count"} | {"n": b["count"]}
                    for b in rec["expert_bins"][regime]]

        print(f"calibration router_gate ({' '.join(CALIB_ROUTER_ARGS)}, quality 2560x1440, "
              f"{record['pairs_measured']} sweep rows, {len(record['native_rows'])} native rows; "
              f"measurements, not gates; calibrated / shipped): experts {record['experts']} / "
              f"{shipped['experts']}; blend_vs_rife_crossover_px "
              f"{record['blend_vs_rife_crossover_px']} / {shipped['blend_vs_rife_crossover_px']} "
              f"({record['blend_win_pairs']}/{record['pairs_measured']} blend wins); "
              f"warped_ssim_threshold {sg['warped_ssim_threshold']} / "
              f"{ssg['warped_ssim_threshold']} (cuts {sg['cut_pairs']}, non-cuts "
              f"{sg['noncut_pairs']}, false holds {sg['false_holds']}, missed "
              f"{sg['missed_cuts']}); native bins {bins(record, 'native')} / "
              f"{bins(shipped, 'native')}; sweep bins {bins(record, 'sweep')} / "
              f"{bins(shipped, 'sweep')}; {router_s:.3f} s, K1 {k1} launches; {card}")
        t0 = _phase("calibration_router", t0)

        # 3. the gate it wrote, loaded by the flagship and the adaptive model,
        # one 1080p pair of the hard clip through each
        router_gate.clear_cache()
        rife_npz = ROOT / "weights" / "rife.npz"
        vfi = FlagshipVFI(device="cuda")
        vfi.load(weights_path=str(rife_npz), gate_path=str(gate_out))
        require(vfi.base_config.scene_warp_ssim_threshold == sg["warped_ssim_threshold"],
                "the flagship's scene gate is the calibrated one")
        up, k1_flagship = counted("flagship on the calibrated gate", lambda: vfi.fused_stream_step(
            frames_hard[0], frames_hard[1], SCALE, TS))
        require(up.dtype == torch.uint8
                and tuple(up.shape) == (1 + len(TS), *scale_size(H, W, SCALE), 3),
                f"flagship pair on the calibrated gate: {tuple(up.shape)}")
        model = get_model("adaptive", device="cuda", load=True, rife_weights=str(rife_npz),
                          vfimamba_weights=str(ROOT / "weights" / "vfimamba.npz"),
                          gate_path=str(gate_out))
        require(model.router.scene_warp_ssim_threshold == sg["warped_ssim_threshold"]
                and model.router.gate_path == str(gate_out),
                "the adaptive model's scene gate and bins are the calibrated file's")
        x0, x1 = (f.float()[None] / 255.0 for f in frames_hard)
        mid, k1_adaptive = counted("adaptive on the calibrated gate",
                                   lambda: model.interpolate_batch(x0, x1, TS))
        require(tuple(mid.shape[-3:]) == (H, W, 3) and bool(torch.isfinite(mid.float()).all()),
                f"adaptive pair on the calibrated gate: {tuple(mid.shape)}")
        print(f"calibration gate loads: FlagshipVFI.load(gate_path=...) scene gate "
              f"{vfi.base_config.scene_warp_ssim_threshold}, a 1080p pair to "
              f"{tuple(up.shape)} (K1 {k1_flagship}); get_model('adaptive', gate_path=...) "
              f"scene gate {model.router.scene_warp_ssim_threshold}, VFIMamba "
              f"{'enabled' if model.enable_vfimamba else 'disabled'}, a 1080p pair to "
              f"{tuple(mid.shape)} (K1 {k1_adaptive}); {card}")
        del vfi, model, up, mid, x0, x1, frames_hard
        torch.cuda.empty_cache()
        t0 = _phase("calibration_gate_loads", t0)

        # 4. LPIPS heads at calibrate_lpips's defaults, held to the JAX
        # package's pins on its own pinned sets
        heads_out = root / "lpips_heads.npz"
        buf = io.StringIO()
        start = time.perf_counter()
        with cl.redirect_stdout(buf):
            report = calibrate_lpips.main(["--out", str(heads_out)])
        lpips_s = time.perf_counter() - start
        heads = {k: v for k, v in np.load(heads_out).items()}
        shipped_heads = {k: v for k, v in np.load(ROOT / "weights" / "lpips_heads.npz").items()}
        pairs = lc.build_pairs(np.random.default_rng(99), n_patches=4, cross_per_patch=6,
                               device="cuda")
        pins = {}
        for name, h in (("calibrated", heads), ("shipped", shipped_heads)):
            rho = lc.severity_spearman(h, np.random.default_rng(7), n_patches=2, device="cuda")
            pins[name] = (lc.evaluate_heads(h, *pairs, device="cuda")["accuracy_2afc"],
                          float(np.mean(list(rho.values()))), min(rho.values()), rho)
        acc, mean_rho, min_rho, rho = pins["calibrated"]
        require(acc >= LPIPS_PINS[0] and mean_rho >= LPIPS_PINS[1] and min_rho >= LPIPS_PINS[2],
                f"LPIPS pins: 2AFC {acc:.4f} >= {LPIPS_PINS[0]}, mean Spearman {mean_rho:.4f} >= "
                f"{LPIPS_PINS[1]}, each family >= {LPIPS_PINS[2]}: {rho}")
        require((root / "LPIPS_CALIBRATION.md").is_file(), "LPIPS_CALIBRATION.md beside --out")
        sacc, smean, smin, _ = pins["shipped"]
        print(f"calibration calibrate_lpips (defaults: 48 patches, 600 steps; {lpips_s:.3f} s): "
              f"{report['train']['n_pairs']} train / {report['holdout']['n_pairs']} held-out pairs, "
              f"final loss {report['final_loss']:.5f}, held-out 2AFC "
              f"{report['holdout']['accuracy_2afc']:.4f} (uniform heads "
              f"{report['holdout_uniform']['accuracy_2afc']:.4f}); the pins (build_pairs "
              f"default_rng(99) 4 patches, severity_spearman default_rng(7) 2 patches): 2AFC "
              f"{acc:.4f}, mean Spearman {mean_rho:.4f}, least {min_rho:.4f} {rho}; the shipped "
              f"heads on the same sets: {sacc:.4f}, {smean:.4f}, {smin:.4f}; {card}")
        t0 = _phase("calibration_lpips", t0)
    finally:
        tmp.cleanup()
    require(_weights_state() == weights_before, "no file under weights/ written or moved")
    err = _require_checks(checks, "calibration phase")
    total = _kernel_by_shape(kw, "calibration", "phase", firsts, counts)
    _phase("calibration_kernel_timing", t0)
    return path_numbers(sum(counts.values()), err, total, 1)



# step 24: VFIMamba training at the trainer's defaults (batch 16, crop 192,
# scenes made on the card, per-block remat and no whole-forward remat), then
# the fixed-shape export of utils/aot.py: python -m
# vfisr_tpu_torch.compile_aot --model rife --precision bf16 at 1080p, one
# pair, the flagship's timesteps
MAMBA_MODELS = ("vfimamba", "vfimamba_s")
MAMBA_TRAIN_STEPS = 2  # timed, after 1 warm-up step (cut from 3 for step 25)
# K1 per VFIMamba train step: 2 for the data (device_synthetic_batch), then
# 6 in the forward, two per refinement level (1/4, 1/2) and two at full
# resolution (per-block remat recomputes the BiMambaBlocks, not the warps);
# K2: one per warp whose flow has a gradient, all 6 of the forward's
K1_PER_MAMBA_STEP, K2_PER_MAMBA_STEP = 8, 6
MAMBA_SCAN_ROWS = 8  # rows of block 0's first scan held against the unrolled loop
# K1 per run of the exported RIFE (bf16, batch 3 = 1 pair x 3 timesteps):
# the level warps at 1/4, 1/2 and 1/2 resolution and the final warp
K1_PER_EXPORT_RUN = 4
EXPORT_RUNS = 5  # timed runs of the exported program and of the eager call, after one
EXPORT_TOL = 1e-5  # max abs difference of the exported program's frames from the eager call's


def unrolled_scan(dt, A, u, B, C) -> torch.Tensor:
    """selective_scan as plain autograd sees it: one step at a time, no
    out=, no chunks, y_t = sum_S h_t C_t."""
    h = torch.zeros((u.shape[0], u.shape[2], A.shape[1]), dtype=u.dtype, device=u.device)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1)


def check_scan_grad(label: str, scan, inputs: tuple) -> None:
    """The scan Function's output and gradients against autograd through
    ``unrolled_scan`` on the same inputs and a random cotangent: within
    1e-4 of each tensor's largest (f32 sums in other orders)."""
    ins = [v.detach().requires_grad_(True) for v in inputs]
    gen = torch.Generator(device=ins[2].device).manual_seed(4)
    gy = torch.randn(ins[2].shape, generator=gen, device=ins[2].device)
    y = scan(*ins)
    got = torch.autograd.grad(y, ins, gy)
    y_ref = unrolled_scan(*ins)
    want = torch.autograd.grad(y_ref, ins, gy)
    errs = [(a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            for a, b in zip((y, *got), (y_ref, *want))]
    names = ("y", "dt", "A", "u", "B", "C")
    print(f"{label}: selective_scan's Function against autograd through the unrolled loop, "
          f"{tuple(ins[2].shape)} (L spans {-(-ins[2].shape[1] // 32)} chunks): "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
          + " of each tensor's largest (tolerance 1e-4)")
    require(all(e <= 1e-4 for e in errs), f"{label}: scan gradient")


def check_mamba_grad(kw, label: str, a: dict) -> float:
    """K2 against its twin at a recorded launch. A refinement level whose
    head is still at its zero init (a v1 checkpoint, a seeded init) passes
    its warps a zero cotangent: there K2's outputs must be exactly 0, and
    the kernel is held against its twin at a random cotangent on the same
    image and flow."""
    if a["ct"].abs().max().item() == 0:
        gflow, cg = kw.warp_windowed_grad(a["img"], a["flow"], a["t"], a["ct"], a["r"],
                                          a["border"], a["compute_dtype"])
        require(not gflow.any() and not cg.any(), f"{label}: zero cotangent, zero gradient")
        gen = torch.Generator(device="cpu").manual_seed(3)
        a = dict(a, ct=torch.randn(a["ct"].shape, generator=gen).to(a["ct"]))
        label += " (its cotangent is 0: held at a random one)"
    return check_warp_grad(kw, label, a)


def mamba_train_phase(kw, card: str) -> tuple:
    """Step 24's training half (module docstring). Returns K1's and K2's
    numbers over the counted train steps (the timed steps and the
    trainer's runs)."""
    import contextlib as cl
    import io

    from vfisr_tpu_torch.models.sota import vfimamba as tvm
    from vfisr_tpu_torch.train import __main__ as train_cli
    from vfisr_tpu_torch.train.train import create_train_state, make_train_step
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_to_jax

    def step_maker(module, state):
        return make_train_step(module, state, use_remat=False)

    weights_before = _weights_state()
    checks1, checks2, firsts1, counts1, firsts2, counts2, tag = [], [], {}, {}, {}, {}, {}
    k1_timed = k2_timed = 0
    tot1 = dict(kernel=0.0, bound=0.0, plain=0.0, library=0.0)
    tot2 = dict(tot1)
    max_err1 = max_err2 = 0.0
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_mamba_")
    try:
        for name in MAMBA_MODELS:
            t0 = time.perf_counter()
            npz = ROOT / "weights" / f"{name}.npz"
            args = train_cli.parse_args(["--model", name])
            require((args.batch, args.crop, args.data_source) == (TRAIN_BATCH, TRAIN_CROP, "auto"),
                    "the trainer's defaults: batch 16, crop 192, scenes on the device")
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            model = train_cli._model(name, torch.device("cuda"), args)
            # the full model from its shipped file; VFIMamba-S's file is not in
            # the chip copy, so it starts from the seeded init
            model.load(weights_path=str(npz) if npz.is_file() else None)
            require(not (torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32),
                    f"TF32 off after {name}'s load")
            module = model.trainable()
            cfg = module.cfg
            want_width = (256, 12) if name == "vfimamba" else (192, 10)
            require(cfg.remat and (cfg.d_model, cfg.layers) == want_width and module.training
                    and all(p.requires_grad for p in module.parameters()),
                    f"full-width {name} with per-block remat, trainable")
            state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                                       total_steps=MAMBA_TRAIN_STEPS + 1)
            step = step_maker(module, state)
            gen = torch.Generator(device="cuda").manual_seed(0)
            batch = train_cli.batch_maker(name, gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)
            fixed = batch()
            n_par = sum(p.numel() for p in module.parameters())
            print(f"train {name}: {n_par} parameters (d_model {cfg.d_model}, {cfg.layers} blocks, "
                  f"d_state {cfg.d_state}), {'weights/' + npz.name if npz.is_file() else 'seeded init'}"
                  f", batch {TRAIN_BATCH}, crop {TRAIN_CROP}, per-block remat")
            t0 = _phase(f"train_{name}_load", t0)

            # the conv shapes of a step, forward and backward, cuDNN's plan
            # against cuDNN off, before any timed step
            with torch.no_grad():
                calls = conv_calls(module, lambda: module(fixed["img0"], fixed["img1"],
                                                          fixed["t"]))
            flop = sum(conv_flop(c, shp) for _, c, shp, _ in calls)
            print(f"train {name} forward: {len(calls)} convs, {flop / 1e12:.4f} TFLOP (f32 bound "
                  f"{flop / F32_FLOP_PER_S * 1e3:.3f} ms); {card}")
            time_convs(f"train {name}", calls, backward=True)
            t0 = _phase(f"train_{name}_convs", t0)

            # one step, every launch of both kernels recorded and counted, and
            # block 0's first scan's inputs kept
            real_warp, real_grad, real_scan = kw.warp_windowed, kw.warp_windowed_grad, \
                tvm.selective_scan
            rec1, rec2, scans = [], [], []

            def recording_scan(dt, A, u, B, C):
                if not scans:
                    scans.append(tuple(v.detach().clone() for v in (dt, A, u, B, C)))
                return real_scan(dt, A, u, B, C)

            kw.warp_windowed, kw.warp_windowed_grad = _recording(kw, rec1), _recording_grad(kw, rec2)
            tvm.selective_scan = recording_scan
            try:
                with origin_table_raises(kw):
                    kw.launches = kw.grad_launches = 0
                    loss = step(batch()).item()
                    k1, k2 = kw.launches, kw.grad_launches
            finally:
                kw.warp_windowed, kw.warp_windowed_grad = real_warp, real_grad
                tvm.selective_scan = real_scan
            print(f"one {name} train step: K1 {k1} launches, K2 {k2}, loss {loss:.6f}")
            require(k1 == K1_PER_MAMBA_STEP and len(rec1) == k1,
                    f"{k1} K1 launches in a {name} train step")
            require(k2 == K2_PER_MAMBA_STEP and len(rec2) == k2,
                    f"{k2} K2 launches in a {name} train step")
            require(math.isfinite(loss), "finite loss")
            require_whole_c(kw, f"train {name}", rec1)
            require_whole_c(kw, f"train {name}", rec2, grad=True)
            for j, a in enumerate(rec1 + rec2):
                check_origins(kw, f"{name} train launch {j}", a)
            for j, a in enumerate(rec1):
                max_err1 = max(max_err1, check_warp(kw, f"{name} train launch {j}", a))
            for j, a in enumerate(rec2):
                max_err2 = max(max_err2, check_mamba_grad(kw, f"{name} train launch {j}", a))
            for a in grad_cases(rec2):
                max_err2 = max(max_err2, check_warp_grad(kw, f"{name} train {a['name']}", a))
            compare_step_with_twins(kw, module, fixed, step_maker, f"{name} train step")
            dt, A, u, B, C = scans[0]
            rows = slice(0, MAMBA_SCAN_ROWS)
            check_scan_grad(f"{name} block 0 scan, rows 0-{MAMBA_SCAN_ROWS - 1} of "
                            f"{u.shape[0]}", real_scan, (dt[rows], A, u[rows], B[rows], C[rows]))
            t0 = _phase(f"train_{name}_checks", t0)

            # where a step's scan time goes: block 0's first scan alone (every
            # scan of a step at crop 192 has its [rows, L, Di] shape), the
            # Function's forward and forward + backward; a step runs the
            # forward twice (the blocks' remat) and the backward once, in
            # each of its 2 x layers scans
            ins = [v.requires_grad_(True) for v in (dt, A, u, B, C)]
            gy = torch.randn_like(u)
            scan_fwd = time_ms(lambda: real_scan(*ins), 3)
            scan_fb = time_ms(lambda: torch.autograd.grad(real_scan(*ins), ins, gy), 3)
            per_step = 2 * cfg.layers * (scan_fwd + scan_fb)
            del scans, ins, gy

            # the steps, counted and timed (CUDA events)
            step_ms, losses, k1_run, k2_run, peak_mb = timed_steps(kw, step, batch,
                                                                   MAMBA_TRAIN_STEPS)
            require(k1_run == K1_PER_MAMBA_STEP * MAMBA_TRAIN_STEPS
                    and k2_run == K2_PER_MAMBA_STEP * MAMBA_TRAIN_STEPS,
                    f"{k1_run} K1 and {k2_run} K2 launches in {MAMBA_TRAIN_STEPS} {name} steps")
            k1_timed += k1_run
            k2_timed += k2_run
            ms = sum(step_ms) / len(step_ms)
            print(f"train {name}, batch {TRAIN_BATCH}, crop {TRAIN_CROP}, per-block remat: ms/step "
                  f"{ms:.3f} (data + step; steps: {', '.join(f'{x:.3f}' for x in step_ms)}); "
                  f"samples/s {TRAIN_BATCH * 1000.0 / ms:.2f}; max_memory_allocated "
                  f"{peak_mb:.1f} MB; {k1_run} K1 and {k2_run} K2 launches; losses "
                  f"{', '.join(f'{v:.5f}' for v in losses)}; {card}")
            print(f"train {name} scan {tuple(u.shape)} x {2 * cfg.layers} per step: forward "
                  f"{scan_fwd:.3f} ms, forward + backward {scan_fb:.3f} ms (CUDA events); a step's "
                  f"scans about {per_step:.3f} ms ({100.0 * per_step / ms:.1f}% of {ms:.3f})")
            s1 = per_shape_totals(kw, f"train {name} K1", "step", rec1, time_launch)
            s2 = per_shape_totals(kw, f"train {name} K2", "step", rec2, time_grad_launch)
            for tot, s in ((tot1, s1), (tot2, s2)):
                for f in tot:
                    tot[f] += s[f] * MAMBA_TRAIN_STEPS
            del model, module, state, step, fixed, rec1, rec2
            torch.cuda.empty_cache()
            t0 = _phase(f"train_{name}_main", t0)

            # the trainer's entry point, in process: one warm-up and the timed
            # steps, --out in a temporary directory, every launch checked
            out = Path(tmp.name) / f"{name}.npz"
            buf = io.StringIO()
            torch.cuda.reset_peak_memory_stats()
            with cl.redirect_stdout(buf):
                res, k1, k2 = _counted_run(
                    kw, checks1, checks2, firsts1, counts1, firsts2, counts2, tag,
                    f"python -m vfisr_tpu_torch.train --model {name}",
                    lambda: train_cli.run(["--model", name, "--steps", str(1 + MAMBA_TRAIN_STEPS),
                                           "--out", str(out), "--log-every", "1"]))
            peak_mb = torch.cuda.max_memory_allocated() / 1e6
            steps = 1 + MAMBA_TRAIN_STEPS
            losses = [float(ln.split("loss ")[1].split()[0]) for ln in buf.getvalue().splitlines()
                      if ln.startswith("step ")]
            require(out.is_file() and len(losses) == steps
                    and all(math.isfinite(v) for v in losses), f"{name} trainer: {losses}")
            require(k1 == K1_PER_MAMBA_STEP * steps and k2 == K2_PER_MAMBA_STEP * steps,
                    f"{name} trainer: {k1} K1 and {k2} K2 launches in {steps} steps")
            # the JAX-layout checkpoint read back by the port's load
            back = tvm.VFIMambaModel(variant=train_cli.MAMBA[name], device="cuda")
            back.load(weights_path=str(out))
            flat = load_npz(str(out))
            mine = params_to_jax(back.module.state_dict())
            require(set(flat) == set(mine) and all(
                np.array_equal(flat[k], mine[k]) for k in flat),
                f"{out.name}: every parameter in the JAX layout, loaded by VFIMambaModel.load")
            step_ms = [v * 1e3 for v in res["step_s"]]
            print(f"train {name} through the trainer (python -m vfisr_tpu_torch.train --model "
                  f"{name} --steps {steps} --out <tmp>, in process; K1 and K2 checked against "
                  f"their twins as they go): losses {', '.join(f'{v:.5f}' for v in losses)}; ms "
                  f"per step (host clock, with the checks) first {step_ms[0]:.3f}, then "
                  f"{', '.join(f'{v:.3f}' for v in step_ms[1:])}; K1 {k1}, K2 {k2}; "
                  f"max_memory_allocated {peak_mb:.1f} MB; {len(flat)} arrays read back; {card}")
            del back
            torch.cuda.empty_cache()
            _phase(f"train_{name}_trainer", t0)
    finally:
        tmp.cleanup()
    require(_weights_state() == weights_before, "no file under weights/ written or moved")
    err1 = max(max_err1, _require_checks(checks1, "vfimamba trainer runs"))
    # VFIMamba-S's refinement heads start at their zero init: until the
    # second step's update moves them, its level warps' cotangents are 0
    err2 = max(max_err2, _require_grad_checks(checks2, "vfimamba trainer runs", zero_ct=True))
    zero = sum(1 for c in (chk[2] for chk in checks2) if c.item() == 0)
    print(f"vfimamba trainer runs: {zero} of {len(checks2)} K2 launches had a zero cotangent "
          "(a refinement level at its zero init), each giving exactly 0")
    del checks1, checks2
    t0 = time.perf_counter()
    run1 = _kernel_by_shape(kw, "train vfimamba trainer", "phase", firsts1, counts1)
    run2 = _kernel_by_shape(kw, "train vfimamba trainer", "phase", firsts2, counts2, grad=True)
    _phase("train_vfimamba_kernel_timing", t0)
    by1, by2 = run1.pop("by"), run2.pop("by")
    n1, n2 = sum(counts1.values()), sum(counts2.values())
    return (dict(launches=k1_timed + n1, err=err1, by=by1,
                 **{f: tot1[f] + run1[f] for f in tot1}),
            dict(launches=k2_timed + n2, err=err2, by=by2,
                 **{f: tot2[f] + run2[f] for f in tot2}))


def export_phase(kw, card: str, rife_npz: Path) -> dict:
    """Step 24's export half (module docstring). Returns K1's numbers over
    the exported program's counted runs."""
    from vfisr_tpu_torch import compile_aot
    from vfisr_tpu_torch.utils import aot

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_export_")
    try:
        path = Path(tmp.name) / "rife_1080p.pt2"
        argv = ["--model", "rife", "--precision", "bf16", "--height", str(H), "--width", str(W),
                "--pairs", "1", "--timesteps", ",".join(str(t) for t in TS),
                "--weights", str(rife_npz), "--output", str(path)]
        start = time.perf_counter()
        record = compile_aot.main(argv)
        export_s = time.perf_counter() - start
        require(path.is_file() and record["bytes"] == path.stat().st_size > 0,
                f"compile_aot wrote its artifact: {record}")
        blob = path.read_bytes()
        start = time.perf_counter()
        exported = aot.load_exported(blob)
        load_s = time.perf_counter() - start
        fn, model = aot.build_interpolate_fn("rife", TS, "bf16", str(rife_npz), "cuda")
        require(model.CONFIG.dtype == torch.bfloat16
                and model.module.config.channels == (256, 160, 112, 80)
                and next(model.module.parameters()).dtype == torch.bfloat16,
                "full-width RIFE in bf16 for the eager call")
        t0 = _phase("export_compile_aot", t0)

        x0, x1 = (game_frame(i, dev, H, W).float()[None] / 255.0 for i in (0, 1))
        # the exported program's first run: each K1 launch (the op's CUDA
        # kernel) recorded and counted, window_origins raising
        recs, real_launch = [], kw.launch

        def recording_launch(img, flow, t, out, r, border, compute_dtype):
            recs.append(dict(img=img.clone(), flow=flow.clone(),
                             t=t.clone() if torch.is_tensor(t) else t, r=r, border=border,
                             compute_dtype=compute_dtype))
            return real_launch(img, flow, t, out, r, border, compute_dtype)

        kw.launch = recording_launch
        try:
            with origin_table_raises(kw), torch.no_grad():
                kw.launches = 0
                start = time.perf_counter()
                got = exported(x0, x1)
                torch.cuda.synchronize()
                first_s = time.perf_counter() - start
                k1 = kw.launches
        finally:
            kw.launch = real_launch
        with torch.no_grad():
            want = fn(x0, x1)
        diff = (got.float() - want.float()).abs().max().item()
        print(f"export rife bf16 {H}x{W}, 1 pair, t {TS}: compile_aot {export_s:.3f} s "
              f"({record['bytes']} bytes), torch.export.load {load_s:.3f} s, first run "
              f"{first_s:.3f} s; exported program against eager interpolate_batch on the same "
              f"frames: max abs diff {diff:.3e} (tolerance {EXPORT_TOL:g}); K1 {k1} launches "
              f"through the custom op; {card}")
        require(tuple(got.shape) == (1, len(TS), H, W, 3) and got.dtype == torch.float32,
                f"exported output {tuple(got.shape)} {got.dtype}")
        require(bool(torch.isfinite(got).all()) and diff <= EXPORT_TOL, "exported against eager")
        require(k1 == K1_PER_EXPORT_RUN == len(recs),
                f"{k1} K1 launches in the exported program's run")
        max_err = 0.0
        for j, a in enumerate(recs):
            check_origins(kw, f"export launch {j}", a)
            max_err = max(max_err, check_warp(kw, f"export launch {j}", a))
        t0 = _phase("export_checks", t0)

        # counted and timed: the exported program against the eager call
        with origin_table_raises(kw), torch.no_grad():
            kw.launches = 0
            run_ms = time_ms(lambda: exported(x0, x1), EXPORT_RUNS, warmup=1)
            runs = EXPORT_RUNS + 1
            k1_run = kw.launches
            eager_ms = time_ms(lambda: fn(x0, x1), EXPORT_RUNS, warmup=1)
        require(k1_run == K1_PER_EXPORT_RUN * runs, f"{k1_run} K1 launches in {runs} runs")
        stats = aot.compile_stats(fn, x0, x1)
        print(f"export compile_stats (rife bf16, 1080p pair): {json.dumps(stats)}")
        require(stats["lower_s"] > 0 and stats["compile_s"] > 0 and stats["flops"] > 0
                and stats["peak_bytes"] > 0, "compile_stats")
        loaded = compile_aot.main(["--load", str(path), "--height", str(H), "--width", str(W)])
        require(loaded["output_shape"] == [1, len(TS), H, W, 3], f"compile_aot --load: {loaded}")
        print(f"export run ms per pair: exported program {run_ms:.3f}, eager interpolate_batch "
              f"{eager_ms:.3f} (CUDA events, {EXPORT_RUNS} runs after one); {card}")
        t0 = _phase("export_run", t0)
    finally:
        tmp.cleanup()
    tot = per_shape_totals(kw, "export K1", "run", recs, time_launch)
    # the op's dispatch on the host: the wrapper (checks, then the op, whose
    # CUDA kernel allocates and launches) against launch alone
    a = recs[-1]
    args = (a["img"], a["flow"], a["t"], a["r"], a["border"], a["compute_dtype"])
    out = torch.empty_like(a["img"])
    via_op = host_ms(lambda: kw.warp_windowed(*args), 200)
    direct = host_ms(lambda: kw.launch(a["img"], a["flow"], a["t"], out, a["r"], a["border"],
                                       a["compute_dtype"]), 200)
    print(f"export K1 host ms per call at {_label(a)}: through the op (warp_windowed) "
          f"{via_op:.4f}, launch alone {direct:.4f} (the op's dispatch and checks "
          f"{via_op - direct:.4f}); {card}")
    _phase("export_k1_timing", t0)
    return path_numbers(k1_run, max_err, tot, runs)


# step 25: scale-out and the blind study. (a) the data-parallel RIFE step at
# the trainer's defaults (full width, weights/rife.npz, batch 16, crop 192,
# f32 with TF32 off, deterministic cuDNN) over NCCL on every visible card
# (world 1 on a one-card machine: this process) and over a gloo group of
# DP_GLOO_RANKS spawned ranks on one card, each held against the one-process
# step on the whole batch; (b) H-sharded SPAN x2 (weights/span_x2.npz) on a
# 1920x1080 frame over the gloo group against the unsharded call; (c) the
# blind study's CLIs in process on step 21's clip
DP_STEPS = 2  # compared steps: the first at lr 0 (warmup), the second at TRAIN_LR
DP_TIMED = 5  # timed steps after the compared ones
DP_GLOO_RANKS = 2
DP_TOL = 1e-5  # loss, the first step's averaged gradients and every parameter, relative
SHARD_TOL = 1e-5  # H-sharded SPAN against the unsharded call, max abs
SCALEOUT_TIMEOUT = 300.0  # seconds for a spawned group
STUDY_INTERVAL = 2  # step 21's 8 px pan interval
STUDY_KEYFRAMES = 3  # benchmark_proper/generate_clips --max-frames
STUDY_FRAMES = STUDY_KEYFRAMES + 3 * (STUDY_KEYFRAMES - 1)  # 3 between each keyframe pair
STUDY_METHODS = ("control", "degraded", "lanczos", "rife_lanczos", "adaptive_vfi")
# the metadata's keyframe PSNR (dB; float64 MSE) and SSIM (f32 sums) against the same
# frames scored on the CPU
STUDY_PSNR_TOL, STUDY_SSIM_TOL = 1e-6, 1e-5


def _counting_acc() -> dict:
    return dict(checks1=[], checks2=[], firsts1={}, counts1={}, firsts2={}, counts2={}, tag={})


def _acc_run(kw, acc: dict, label: str, fn):
    """fn() through ``_counted_run``: every K1 and K2 launch held against its
    twin as it goes, counted by shape into acc."""
    return _counted_run(kw, acc["checks1"], acc["checks2"], acc["firsts1"], acc["counts1"],
                        acc["firsts2"], acc["counts2"], acc["tag"], label, fn)


def _blockwise_step(module, state, blocks: int):
    """The data-parallel step's arithmetic in one process: the whole batch
    in ``blocks`` equal blocks, as that many ranks hold it; each block's
    loss and gradients (remat, as ``make_train_step``) summed in block
    order and divided by ``blocks``, as the ranks' all-reduce averages
    them; then the clip and AdamW."""
    from torch.utils.checkpoint import checkpoint

    from vfisr_tpu_torch.train.train import apply_gradients, vfi_loss

    params = [p for p in module.parameters() if p.requires_grad]

    def forward(img0, img1, t, gt):
        return vfi_loss(module(img0, img1, t)[0], gt)

    def step(batch: dict) -> torch.Tensor:
        for p in params:
            p.grad = None
        total = 0.0
        for k in range(blocks):
            b = {key: v.chunk(blocks)[k] for key, v in batch.items()}
            loss = checkpoint(forward, b["img0"], b["img1"], b["t"], b["gt"], use_reentrant=False)
            loss.backward()
            total = total + loss.detach()
        for p in params:
            if p.grad is not None:
                p.grad.div_(blocks)
        apply_gradients(state, params)
        return total / blocks

    return step


def _dp_run(kw, batch: dict, mesh, label: str, acc: dict, blocks: int = 1) -> dict:
    """Full-width RIFE from weights/rife.npz through DP_STEPS compared steps,
    its launches checked and counted into acc: the steps' losses, the first
    step's gradients (averaged over the mesh and clipped), the parameters
    after them (CPU) and ``time``, which times DP_TIMED more steps (CUDA
    events, after one) and returns ms per step. Without a mesh, the
    one-process step on the whole batch (with blocks > 1,
    ``_blockwise_step``'s)."""
    from vfisr_tpu_torch.models.sota.rife import RIFEModel
    from vfisr_tpu_torch.parallel.mesh import shard_batch
    from vfisr_tpu_torch.train.train import create_train_state, make_train_step

    model = RIFEModel(device="cuda")
    model.load(weights_path=str(ROOT / "weights" / "rife.npz"))
    module = model.trainable()
    state = create_train_state(module.parameters(), learning_rate=TRAIN_LR,
                               total_steps=DP_STEPS + 1)
    if blocks > 1:
        step = _blockwise_step(module, state, blocks)
    else:
        step = make_train_step(module, state, mesh=mesh)  # remat on, as the trainer
    block = batch if mesh is None else shard_batch(mesh, batch)

    def compared():
        losses, grads = [], None
        for _ in range(DP_STEPS):
            losses.append(step(block).item())
            if grads is None:
                grads = {n: p.grad.detach().cpu() for n, p in module.named_parameters()}
        return losses, grads

    def time_steps() -> list:
        step(block)
        torch.cuda.synchronize()
        ms = []
        for _ in range(DP_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(block)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        return ms

    (losses, grads), k1, k2 = _acc_run(kw, acc, label, compared)
    params = {n: p.detach().cpu() for n, p in module.named_parameters()}
    return dict(losses=losses, grads=grads, params=params, k1=k1, k2=k2,
                batch=block["img0"].shape[0], time=time_steps)


def _span_sharded(mesh) -> dict:
    """SPAN x2 on step 4's first 1080p frame over the mesh's 'spatial' axis
    and unsharded (CUDA events, 3 runs after one; the unsharded call timed
    on rank 0 alone, the other ranks waiting, as they share its card)."""
    import torch.distributed as dist

    from vfisr_tpu_torch.models.sota.span import SPANModel
    from vfisr_tpu_torch.parallel.mesh import receptive_radius, shard_batch, spatial_apply

    span = SPANModel(scale=2, device="cuda")
    span.load(weights_path=str(ROOT / "weights" / "span_x2.npz"))
    x = game_frame(0, torch.device("cuda")).float()[None] / 255.0
    rows = shard_batch(mesh, {"x": x}, h_sharded=True)["x"]
    with torch.no_grad():
        sharded = spatial_apply(span.module, rows, mesh)
        sharded_ms = time_ms(lambda: spatial_apply(span.module, rows, mesh), 3, warmup=0)
        unsharded = span.module(x)
        dist.barrier()
        unsharded_ms = time_ms(lambda: span.module(x), 3, warmup=0) if dist.get_rank() == 0 \
            else None
        dist.barrier()
    return dict(err=(sharded - unsharded).abs().max().item(), shape=tuple(sharded.shape),
                rows=tuple(rows.shape), halo=receptive_radius(span.module), sharded_ms=sharded_ms,
                unsharded_ms=unsharded_ms)


def _to(tree, device):
    return {k: (v.to(device) if torch.is_tensor(v) else v) for k, v in tree.items()}


def _scaleout_rank(rank: int, world: int, batch_path: str, span: bool) -> dict:
    """One spawned rank of step 25: the data-parallel steps over all ranks,
    and with ``span`` SPAN over a data 1 x spatial world mesh. Returns CPU
    data: the steps' numbers, the launches' errors (each within its
    tolerance), counts and each launch shape's first inputs."""
    global ORIGIN_TABLE
    from vfisr_tpu_torch.ops.cuda import warp as kw
    from vfisr_tpu_torch.parallel.mesh import make_mesh

    kw.build()
    ORIGIN_TABLE = kw.window_origins
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    batch = {k: v.cuda() for k, v in torch.load(batch_path).items()}
    acc = _counting_acc()
    backend = torch.distributed.get_backend()
    out = _dp_run(kw, batch, make_mesh(world), f"dp {backend} rank {rank}/{world}", acc)
    del out["time"]
    if span:
        out["span"] = _span_sharded(make_mesh(world, spatial=world))
    out["err1"] = _require_checks(acc["checks1"], f"dp {backend} rank {rank}")
    out["err2"] = _require_grad_checks(acc["checks2"], f"dp {backend} rank {rank}")
    for f in ("firsts1", "firsts2"):
        out[f] = {k: _to(a, "cpu") for k, a in acc[f].items()}
    out["counts1"], out["counts2"] = acc["counts1"], acc["counts2"]
    return out


def _params_err(got: dict, ref: dict) -> float:
    """The largest |got - ref| of any tensor over max(1, its largest |ref|)."""
    return max((got[n] - p).abs().max().item() / max(1.0, p.abs().max().item())
               for n, p in ref.items())


def _grads_err(got: dict, ref: dict) -> float:
    """The largest |got - ref| of any tensor over its largest |ref|."""
    return max((got[n] - g).abs().max().item() / max(g.abs().max().item(), 1e-30)
               for n, g in ref.items())


def scaleout_phase(kw, card: str) -> tuple:
    """Step 25 (a) and (b) of the module docstring. Returns K1's and K2's
    numbers over every compared step's launches."""
    import torch.distributed as dist

    from vfisr_tpu_torch.parallel.launch import run
    from vfisr_tpu_torch.parallel.mesh import make_mesh
    from vfisr_tpu_torch.train.device_data import device_synthetic_batch

    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    acc = _counting_acc()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_scaleout_")
    try:
        gen = torch.Generator(device="cuda").manual_seed(25)
        batch = device_synthetic_batch(gen, TRAIN_BATCH, TRAIN_CROP, TRAIN_DETAIL)
        batch_path = str(Path(tmp.name) / "batch.pt")
        torch.save({k: v.cpu() for k, v in batch.items()}, batch_path)
        # the gloo ranks start (seconds of imports and set-up each) while this
        # process runs its compared steps; every timing waits for them
        gloo, failed = [], []

        def gloo_group():
            try:
                gloo.extend(run(_scaleout_rank, DP_GLOO_RANKS, batch_path, True, backend="gloo",
                                device="cuda", timeout=SCALEOUT_TIMEOUT, store_dir=tmp.name))
            except Exception as e:  # raised again below, in this thread
                failed.append(e)

        thread = threading.Thread(target=gloo_group)
        thread.start()
        try:
            one = _dp_run(kw, batch, None, "dp one process", acc)
            blockwise = _dp_run(kw, batch, None, "dp one process, blockwise", acc,
                                blocks=DP_GLOO_RANKS)
            world = torch.cuda.device_count()
            if world == 1:  # this process is the one rank
                dist.init_process_group("nccl", init_method=f"file://{tmp.name}/nccl_store",
                                        rank=0, world_size=1)
                nccl_acc = _counting_acc()
                nccl = [_dp_run(kw, batch, make_mesh(1), "dp nccl rank 0/1", nccl_acc)]
                nccl[0]["err1"] = _require_checks(nccl_acc["checks1"], "dp nccl rank 0")
                nccl[0]["err2"] = _require_grad_checks(nccl_acc["checks2"], "dp nccl rank 0")
                for f in ("firsts1", "firsts2", "counts1", "counts2"):
                    nccl[0][f] = nccl_acc[f]
            else:
                nccl = run(_scaleout_rank, world, batch_path, False, backend="nccl",
                           device="cuda", timeout=SCALEOUT_TIMEOUT, store_dir=tmp.name)
        finally:
            thread.join()
        if failed:
            raise failed[0]
        t0 = _phase("scaleout_runs", t0)
        try:
            one["ms"] = one["time"]()
            nccl[0]["ms"] = nccl[0]["time"]() if world == 1 else None
        finally:
            if world == 1:
                dist.destroy_process_group()
        t0 = _phase("scaleout_timing", t0)
    finally:
        tmp.cleanup()
        torch.backends.cudnn.deterministic = False

    # each group against the one-process step on the whole batch: NCCL's
    # ranks hold whole-batch blocks (world 1), gloo's half-batch ones, whose
    # f32 convs take other algorithms than at batch 16 and whose bf16 warp
    # windows round those last-bit differences to bf16 steps: gloo's ranks
    # are held to the blockwise step (the same blocks in one process), and
    # their distance from the whole-batch step is printed beside it
    def errors(res, ref):
        return (max(abs(a - b) / abs(b) for a, b in zip(res["losses"], ref["losses"])),
                _grads_err(res["grads"], ref["grads"]), _params_err(res["params"], ref["params"]))

    print(f"scaleout dp blockwise ({DP_GLOO_RANKS} blocks) against the whole-batch step: loss, "
          f"first step's gradients, parameters after {DP_STEPS} steps "
          + ", ".join(f"{e:.3e}" for e in errors(blockwise, one)))
    for name, group, ref, what in ((f"NCCL world {world}", nccl, one, "whole-batch"),
                                   (f"gloo {DP_GLOO_RANKS} ranks", gloo, blockwise, "blockwise")):
        for r, res in enumerate(group):
            loss_err, grad_err, par_err = errors(res, ref)
            print(f"scaleout dp {name} rank {r} (batch {res['batch']} of {TRAIN_BATCH}) against "
                  f"the one-process {what} step: losses "
                  f"{', '.join(f'{v:.9f}' for v in res['losses'])} vs "
                  f"{', '.join(f'{v:.9f}' for v in ref['losses'])} (max rel {loss_err:.3e}), "
                  f"first step's gradients {grad_err:.3e}, parameters after {DP_STEPS} steps "
                  f"{par_err:.3e} (tolerance {DP_TOL}); against the whole-batch step "
                  + ", ".join(f"{e:.3e}" for e in errors(res, one))
                  + f"; K1 {res['k1']}, K2 {res['k2']} launches, each checked (max_abs_err "
                  f"{res['err1']:.3e} / {res['err2']:.3e})")
            require(loss_err <= DP_TOL and grad_err <= DP_TOL and par_err <= DP_TOL,
                    f"dp {name} rank {r} against the one-process {what} step")
            require(all(torch.equal(res["params"][n], group[0]["params"][n]) for n in one["params"]),
                    f"dp {name}: rank {r}'s parameters equal rank 0's")
    base = sum(one["ms"]) / len(one["ms"])
    for name, v in (("one process", one["ms"]), (f"NCCL world {world}", nccl[0]["ms"])):
        if v is None:
            print(f"scaleout dp ms/step {name}: not measured (spawned ranks)")
            continue
        mean = sum(v) / len(v)
        print(f"scaleout dp ms/step {name}: {mean:.3f} ({', '.join(f'{x:.3f}' for x in v)}; "
              f"{mean - base:+.3f} against one process); {card}")
    s = gloo[0]["span"]
    require(all(g["span"]["err"] <= SHARD_TOL for g in gloo),
            f"H-sharded SPAN against unsharded: {[g['span']['err'] for g in gloo]}")
    print(f"scaleout H-sharded SPAN x2 1920x1080 -> {s['shape'][1:3]} over {DP_GLOO_RANKS} gloo "
          f"ranks ({s['rows']} rows each + a {s['halo']}-row halo): max abs diff "
          f"{max(g['span']['err'] for g in gloo):.3e} against the unsharded call (tolerance "
          f"{SHARD_TOL}); ms sharded {s['sharded_ms']:.3f}, unsharded {s['unsharded_ms']:.3f}; "
          f"{card}")

    # every compared step's launches: their errors and, per shape, the kernels alone
    for res in [*nccl, *gloo]:
        for g in ("1", "2"):
            acc[f"firsts{g}"].update({k: _to(a, "cuda") for k, a in res[f"firsts{g}"].items()
                                      if k not in acc[f"firsts{g}"]})
            for k, n in res[f"counts{g}"].items():
                acc[f"counts{g}"][k] = acc[f"counts{g}"].get(k, 0) + n
    err1 = max(_require_checks(acc["checks1"], "dp one process"), *(r["err1"] for r in nccl + gloo))
    err2 = max(_require_grad_checks(acc["checks2"], "dp one process"),
               *(r["err2"] for r in nccl + gloo))
    total1 = _kernel_by_shape(kw, "scaleout", "phase", acc["firsts1"], acc["counts1"])
    total2 = _kernel_by_shape(kw, "scaleout", "phase", acc["firsts2"], acc["counts2"], grad=True)
    _phase("scaleout_kernel_timing", t0)
    return (path_numbers(sum(acc["counts1"].values()), err1, total1, 1),
            path_numbers(sum(acc["counts2"].values()), err2, total2, 1))


def blind_study_phase(kw, card: str, data_dir: Path) -> tuple:
    """Step 25 (c) of the module docstring. Returns K1's numbers over the
    CLIs' launches, and the temporary directory of the study's videos
    (``bench/``) for step 26: the caller cleans it up."""
    import contextlib as cl
    import io

    from vfisr_tpu_torch import prepare_blind_study as pbs
    from vfisr_tpu_torch.core.color import rgb_to_gray
    from vfisr_tpu_torch.data import video_io
    from vfisr_tpu_torch.data.extract_intervals import load_interval
    from vfisr_tpu_torch.evaluation.metrics import calc_psnr, calc_ssim
    from vfisr_tpu_torch.gui import benchmark_proper as bp, generate_clips as gc

    t0 = time.perf_counter()
    acc = _counting_acc()
    per = {}

    def timed(fn):
        def wrapper(method, *args, **kw_):
            torch.cuda.synchronize()
            k1, start = kw.launches, time.perf_counter()
            res = fn(method, *args, **kw_)
            torch.cuda.synchronize()
            per[(fn.__module__.rsplit(".", 1)[1], method)] = (
                (time.perf_counter() - start) * 1e3, kw.launches - k1)
            return res
        return wrapper

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_study_")
    root = Path(tmp.name)
    real = bp.run_method, gc.generate_method
    bp.run_method, gc.generate_method = timed(bp.run_method), timed(gc.generate_method)
    try:
        common = ["--clip", INGEST_CLIP, "--interval", str(STUDY_INTERVAL), "--data-dir",
                  str(data_dir), "--max-frames", str(STUDY_KEYFRAMES)]
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            _acc_run(kw, acc, "benchmark_proper", lambda: bp.main(
                [*common, "--output-dir", str(root / "bench")]))
            _acc_run(kw, acc, "generate_clips", lambda: gc.main(
                [*common, "--preset", "sota", "--output-dir", str(root / "sota")]))
            _acc_run(kw, acc, "prepare_blind_study", lambda: pbs.main(
                ["--benchmark-dir", str(root / "bench"), "--output-dir", str(root / "study"),
                 "--seed", "0"]))
        t0 = _phase("study_clis", t0)

        # every video written, with the keyframes and 3 frames between each pair
        suffix = video_io.writable_suffix()
        meta = json.loads((root / "bench" / "clips_metadata.json").read_text())["clips"][INGEST_CLIP]
        videos = {m: Path(p) for m, p in meta["videos"].items()}
        require(list(videos) == list(STUDY_METHODS) and all(
            p == root / "bench" / f"{m}{suffix}" for m, p in videos.items()),
            f"clips_metadata.json's videos: {meta['videos']}")
        videos["sota rife_lanczos"] = root / "sota" / f"rife_lanczos{suffix}"
        for name, p in videos.items():
            n = video_io.probe_video(str(p)).frame_count
            require(n == STUDY_FRAMES, f"{name}: {n} frames, not {STUDY_FRAMES}")
        key = json.loads((root / "study" / "answer_key.json").read_text())
        require(sorted(key) == [f"pair_{i:02d}{suffix}" for i in range(len(STUDY_METHODS) - 1)]
                and all(v["frames"] == STUDY_FRAMES for v in key.values()),
                f"answer key: {key}")
        pair = video_io.probe_video(str(root / "study" / f"pair_00{suffix}"))
        require((pair.frame_count, pair.width, pair.height) == (STUDY_FRAMES, 2 * 2560, 1440),
                f"pair_00's frames and size: {pair}")
        print(f"study videos: {', '.join(f'{p.name}' for p in videos.values())} and "
              f"{len(key)} pairs ({pair.width}x{pair.height}), {STUDY_FRAMES} frames each "
              f"({STUDY_KEYFRAMES} keyframes, 3 between each pair), written as {suffix} "
              f"(ffmpeg on PATH: {video_io.FFMPEG})")

        # the metadata's PSNR and SSIM against the same frames scored on the CPU
        kfs = load_interval(INGEST_CLIP, STUDY_INTERVAL, str(data_dir),
                            max_frames=STUDY_KEYFRAMES)[0]
        for method, interp in (("degraded", "cubic"), ("lanczos", "lanczos4")):
            psnrs, ssims = [], []
            for f in kfs:
                src = torch.from_numpy(f).cuda()
                out = bp.resize_u8(bp.resize_u8(src, bp.DEGRADE, "area"), (2560, 1440), interp).cpu()
                ref = bp.resize_u8(src, (2560, 1440), "lanczos4").cpu()
                psnrs.append(calc_psnr(out, ref, "cpu"))
                ssims.append(calc_ssim(rgb_to_gray(out), rgb_to_gray(ref), "cpu"))
            m = meta["metrics"][method]
            require(abs(m["psnr"] - float(np.mean(psnrs))) <= STUDY_PSNR_TOL
                    and abs(m["ssim"] - float(np.mean(ssims))) <= STUDY_SSIM_TOL,
                    f"{method}: card psnr/ssim {m['psnr']}/{m['ssim']} vs CPU "
                    f"{np.mean(psnrs)}/{np.mean(ssims)}")
            print(f"study {method}: psnr {m['psnr']:.6f} dB, ssim {m['ssim']:.6f} (the same "
                  f"frames scored on the CPU: {np.mean(psnrs):.6f}, {np.mean(ssims):.6f})")

        # extract_clip's cut of a Y4M against the source's frames (a Y4M
        # lanczos video: run_method writes the container its path names)
        y4m, cut = root / "lanczos.y4m", root / "cut.y4m"
        fps = 120.0
        _acc_run(kw, acc, "run_method y4m", lambda: bp.run_method(
            "lanczos", kfs, str(y4m), 2560, 1440, fps))
        require(bp.extract_clip(y4m, None, 2 / fps, 4 / fps, cut), "extract_clip")
        with video_io.VideoReader(str(y4m)) as a, video_io.VideoReader(str(cut)) as b:
            src = [a.read_i420() for _ in range(6)]
            require(b.frame_count == 4 and all(np.array_equal(b.read_i420(), src[2 + i])
                                               for i in range(4)), "the Y4M cut's frames")
        print(f"study extract_clip: frames 2-5 of lanczos.y4m cut by copying, equal to the "
              f"source's; get_full_video_duration {bp.get_full_video_duration(cut):.6f} s")
    except BaseException:
        tmp.cleanup()
        raise
    finally:
        bp.run_method, gc.generate_method = real
    for (cli, method), (ms, k1) in per.items():
        print(f"study {cli} {method} at 2560x1440 ({STUDY_KEYFRAMES} keyframes, {STUDY_FRAMES} "
              f"frames): {ms:.3f} ms (host clock, synchronized), K1 {k1} launches; {card}")
    err1 = _require_checks(acc["checks1"], "blind study")
    require(not acc["checks2"], "no K2 launch in the blind study")
    total1 = _kernel_by_shape(kw, "study", "run", acc["firsts1"], acc["counts1"])
    _phase("study_kernel_timing", t0)
    return path_numbers(sum(acc["counts1"].values()), err1, total1, 1), tmp


# step 26: the last modules of the port. (a) RIFE's RefineNet on full-width
# RIFE (weights/rife.npz, bf16 deploy config) with seeded non-zero RefineNet
# parameters; (b) the per-timestep flagship step (FlagshipConfig
# (shared_flow=False)); (c) the JPEG codec (data/jpeg.py) on a 1080p frame;
# (d) the image-pair study server (gui/web_app.py) on step 21's processed
# clip over HTTP; (e) the video study server (gui/video_blind_study.py) on
# step 25's study videos; (f) lpips_ordering_study and check_expert_downscale
# on clips the card renders; (g) the two report scripts on step 21's
# experiment_results.json
REFINE_SEED, REFINE_SCALE = 26, 0.05  # the RefineNet's seeded normal parameters
EXACT_T_PAIRS = 2  # timed pairs of the per-timestep step
# K1 per 1080p pair: the shared step 18 (analysis 13, the IFNet's 4, the fused
# fusion warp); the per-timestep step 17 (the analysis and 4 IFNet warps at batch 3)
EXACT_T_LAUNCHES = 17
REFINE_LAUNCHES = 5  # shared_flow_apply alone: the IFNet's 4 and the fused warp
JPEG_QUALITIES = (92, 28)
STUDY_SEED, STUDY_PAIRS = 0, 2
STUDY_SERVER_METHODS = "rife_default,optical_flow_basic"  # every pair renders RIFE and the flow model
SCRIPT_SECONDS = 0.2  # rendered clips: 12 frames at 60 fps, 6 keyframe pairs
SCRIPT_PAIRS = 2
FULL_VIDEO = (640, 360, 10, 30)  # the video study's full videos: w, h, fps, frames (3 s)


def _plain(kw):
    """K1's wrapper replaced by its plain twin (window_origins in place)."""
    def plain(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        return _twin(kw, kw.warp_windowed_plain, img, flow, t, r, border, compute_dtype)
    return plain


def _with_twin(kw, fn):
    real = kw.warp_windowed
    kw.warp_windowed = _plain(kw)
    try:
        return fn()
    finally:
        kw.warp_windowed = real


def _u8_close(label: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """uint8 frames of a run with the kernels against the same run with the
    plain twins: the main path's tolerance (max 2 LSB, mean 0.05 LSB)."""
    d = (a.int() - b.int()).abs()
    print(f"{label} with kernel vs with plain twin: max {d.max().item()} LSB, mean "
          f"{d.float().mean().item():.6f} LSB (tolerance max 2, mean 0.05)")
    require(d.max().item() <= 2 and d.float().mean().item() <= 0.05, f"{label}: kernel vs twin")


def _refine_module(rife_npz: Path):
    """Full-width RIFE, bf16 deploy config, refine on: the IFNet from
    rife.npz, the RefineNet (which no checkpoint holds) seeded normal."""
    from vfisr_tpu_torch.models.sota.rife import IFNet, RIFEConfig
    from vfisr_tpu_torch.utils.checkpoint import load_npz, params_from_jax

    cfg = RIFEConfig(dtype=torch.bfloat16, level_warp_radius=(2, 2), final_warp_radius=(3, 4),
                     refine=True)
    module = IFNet(cfg)
    missing, unexpected = module.load_state_dict(params_from_jax(load_npz(str(rife_npz))),
                                                 strict=False)
    require(not unexpected and missing and all(k.startswith("refine.") for k in missing),
            f"rife.npz into the refine config: missing {missing}, unexpected {unexpected}")
    gen = torch.Generator().manual_seed(REFINE_SEED)
    with torch.no_grad():
        for p in module.refine.parameters():
            p.copy_(REFINE_SCALE * torch.randn(p.shape, generator=gen))
    return module.to(device="cuda", dtype=torch.bfloat16).eval().requires_grad_(False)


def study_slice_phase(kw, card: str, vfi, rife_npz: Path, gate_json: Path, ingest_root: Path,
                      study_root: Path) -> dict:
    """Step 26 of the module docstring. Returns K1's numbers over the
    phase's counted launches."""
    import contextlib as cl
    import io
    import random
    import urllib.request
    from http.server import ThreadingHTTPServer

    from vfisr_tpu_torch import (check_expert_downscale, generate_comprehensive_report,
                                 generate_report_figures, lpips_ordering_study,
                                 make_synthetic_clip)
    from vfisr_tpu_torch.core.frames import pad_to_multiple, to_uint8, unpad
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.data import jpeg
    from vfisr_tpu_torch.data.video_io import VideoReader, VideoWriter
    from vfisr_tpu_torch.gui import video_blind_study as vbs, web_app
    from vfisr_tpu_torch.models.sota.rife import shared_flow_apply
    from vfisr_tpu_torch.pipeline.flagship import FlagshipConfig, FlagshipVFI

    t0 = time.perf_counter()
    acc = _counting_acc()
    dev = torch.device("cuda")
    out_hw = (1440, 2560)
    frames = [game_frame(i, dev) for i in range(EXACT_T_PAIRS + 1)]
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_step26_")
    root = Path(tmp.name)
    try:
        # (a) RefineNet: one 1080p pair through shared_flow_apply (the anchor
        # timestep through the RefineNet), counted and checked
        refine = _refine_module(rife_npz)
        x0, x1 = (pad_to_multiple(f.float()[None] / 255.0, 32)[0] for f in frames[:2])

        def mids(module):
            with torch.no_grad():
                return to_uint8(unpad(shared_flow_apply(module, x0, x1, TS), H, W))

        mids(refine)  # warm-up
        got, k1, _ = _acc_run(kw, acc, "refine", lambda: mids(refine))
        require(k1 == REFINE_LAUNCHES, f"refine: {k1} K1 launches, not {REFINE_LAUNCHES}")
        _u8_close("refine pair", got, _with_twin(kw, lambda: mids(refine)))
        plain_mids = mids(vfi._module)
        d = (got.int() - plain_mids.int()).abs()
        require(d.max().item() > 0 and (got[1].int() - plain_mids[1].int()).abs().max() > 0,
                "the seeded RefineNet changes the anchor timestep")
        require(torch.equal(got[0], plain_mids[0]) and torch.equal(got[2], plain_mids[2]),
                "the derived timesteps do not go through the RefineNet")
        # in turns: without, with, with, without (10 pairs each, CUDA events)
        turns = [("without", vfi._module), ("with", refine), ("with", refine),
                 ("without", vfi._module)]
        ms = {"with": [], "without": []}
        for name, module in turns:
            ms[name].append(time_ms(lambda: mids(module), 10))
        print(f"refine: full-width RIFE bf16, seeded RefineNet (seed {REFINE_SEED}, scale "
              f"{REFINE_SCALE}), one 1080p pair, {len(TS)} timesteps through shared_flow_apply: "
              f"ms/pair with refine {', '.join(f'{x:.3f}' for x in ms['with'])}, without "
              f"{', '.join(f'{x:.3f}' for x in ms['without'])} (CUDA events over 10 pairs, "
              f"in turns without/with/with/without); K1 {k1} launches; anchor t=0.5 differs by "
              f"max {d.max().item()} LSB, t=0.25/0.75 equal; {card}")
        del refine
        t0 = _phase("step26_refine", t0)

        # (b) the per-timestep flagship step against the shared step
        exact = FlagshipVFI(device="cuda", config=FlagshipConfig(shared_flow=False))
        exact.load(weights_path=str(rife_npz), gate_path=str(gate_json))
        require(exact.base_config.shared_flow is False, "shared_flow=False kept by load")

        def stream(model):
            model.reset_history()
            return [model.fused_stream_step(frames[i], frames[i + 1], SCALE, TS)
                    for i in range(EXACT_T_PAIRS)]

        stream(exact)  # warm-up
        ups, k1, _ = _acc_run(kw, acc, "exact_t", lambda: stream(exact))
        require(k1 == EXACT_T_LAUNCHES * EXACT_T_PAIRS,
                f"exact_t: {k1} K1 launches in {EXACT_T_PAIRS} pairs")
        exact.reset_history()
        twin = _with_twin(kw, lambda: exact.fused_stream_step(frames[0], frames[1], SCALE, TS))
        _u8_close("per-timestep pair", ups[0], twin)
        shared = stream(vfi)
        # in turns: per-timestep, shared, shared, per-timestep, each over the pairs
        times = {"per-timestep": [], "shared": []}
        for name in ("per-timestep", "shared", "shared", "per-timestep"):
            model = exact if name == "per-timestep" else vfi
            model.reset_history()
            for i in range(EXACT_T_PAIRS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                model.fused_stream_step(frames[i], frames[i + 1], SCALE, TS)
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
        quality = {}
        for name, outs in (("per-timestep", ups), ("shared", shared)):
            vals = []
            for i, up in enumerate(outs):
                require(up.dtype == torch.uint8 and tuple(up.shape) == (1 + len(TS), *out_hw, 3),
                        f"{name} output {tuple(up.shape)}")
                for k, t in enumerate(TS):
                    truth = to_uint8(resize(game_frame(i + t, dev).float()[None] / 255.0, out_hw,
                                            "lanczos4"))[0]
                    vals.append(psnr(up[1 + k], truth))
            quality[name] = sum(vals) / len(vals)
        for name in times:
            print(f"flagship {name} step 1080p->1440p: ms/pair "
                  f"{', '.join(f'{x:.3f}' for x in times[name])} (CUDA events, after warm-up, "
                  f"the two steps in turns); "
                  f"midpoint PSNR against the scene's true in-between frames {quality[name]:.4f} dB "
                  f"(a result, not a gate); {card}")
        print(f"exact_t: {EXACT_T_LAUNCHES} K1 launches per pair (analysis 13 + IFNet 4 at batch "
              f"3), against {LAUNCHES_PER_PAIR} in the shared step")
        del exact
        torch.cuda.empty_cache()
        t0 = _phase("step26_exact_t", t0)

        # (c) JPEG on a 1080p frame: the card against the CPU, ms per frame
        frame = game_frame(0, dev)
        for q in JPEG_QUALITIES:
            jpeg.decode(jpeg.encode(frame, q, "cuda"), "cuda")  # warm-up
            torch.cuda.synchronize()
            start = time.perf_counter()
            data = jpeg.encode(frame, q, "cuda")
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - start) * 1e3
            start = time.perf_counter()
            dec = jpeg.decode(data, "cuda")
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - start) * 1e3
            fwd_ms = time_ms(lambda: jpeg.forward_blocks(frame, q), 5)
            info = jpeg.parse(data)
            coefs = torch.from_numpy(jpeg.entropy_decode(info)).cuda()
            inv_ms = time_ms(lambda: jpeg.inverse_blocks(coefs, jpeg.layout(info), info["q"]), 5)
            cpu_data = jpeg.encode(frame.cpu(), q, "cpu")
            cpu_dec = jpeg.decode(cpu_data, "cpu")
            require(data == cpu_data and torch.equal(dec.cpu(), cpu_dec),
                    f"JPEG q{q}: the card's bytes and pixels equal the CPU run's (tolerance 0)")
            print(f"jpeg q{q} 1920x1080: {len(data)} bytes, equal to the CPU run's, decoded equal; "
                  f"PSNR {psnr(dec, frame):.4f} dB; encode {enc_ms:.3f} ms (card {fwd_ms:.3f} ms, "
                  f"host {enc_ms - fwd_ms:.3f} ms), decode {dec_ms:.3f} ms (card {inv_ms:.3f} ms, "
                  f"host {dec_ms - inv_ms:.3f} ms); host clock, card shares by CUDA events; {card}")
        t0 = _phase("step26_jpeg", t0)

        # (d) the image-pair study server on step 21's processed clip, over HTTP
        processed = ingest_root / "processed"
        state = web_app.StudyState(processed, root / "web", methods=STUDY_SERVER_METHODS.split(","),
                                   num_pairs=STUDY_PAIRS, seed=STUDY_SEED, device="cuda")
        render_ms = []
        real_render = state._render_method

        def timed_render(method, f0, f1, gt):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = real_render(method, f0, f1, gt)
            torch.cuda.synchronize()
            render_ms.append((method, (time.perf_counter() - start) * 1e3))
            return out

        state._render_method = timed_render
        server = ThreadingHTTPServer(("127.0.0.1", 0), web_app.make_handler(state))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"

        def call(path, body=None, headers=None):
            req = urllib.request.Request(base + path, headers=headers or {},
                                         data=None if body is None else json.dumps(body).encode(),
                                         method="GET" if body is None else "POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, dict(r.headers), r.read()

        try:
            def walk():
                clips = json.loads(call("/api/clips")[2])["clips"]
                require(INGEST_CLIP in clips, f"web_app clips {clips}")
                call("/api/clip", {"clip": INGEST_CLIP})
                pairs = json.loads(call("/api/pairs")[2])["pairs"]
                served = {}
                for p in pairs:
                    for pos in ("left", "right", "gt"):
                        code, hdr, data = call(f"/api/frame/{p['idx']}/{pos}")
                        require(code == 200 and hdr["Content-Type"] == "image/jpeg",
                                f"web_app frame {p['idx']}/{pos}: {code}")
                        served[(p["idx"], pos)] = data
                r = json.loads(call("/api/guess", {"pair_idx": pairs[0]["idx"],
                                                   "choice": "left"})[2])
                res = json.loads(call("/api/results")[2])
                saved = json.loads(call("/api/save", {})[2])
                return pairs, served, r, res, saved

            start = time.perf_counter()
            (pairs, served, r, res, saved), k1, _ = _acc_run(kw, acc, "web_app", walk)
            walk_s = time.perf_counter() - start
        finally:
            server.shutdown()
            server.server_close()
        require(len(pairs) == STUDY_PAIRS and r["total"] == res["total"] == 1
                and Path(saved["path"]).is_file(), f"web_app session {res}")
        for (idx, pos), data in served.items():
            img = jpeg.decode(data, "cuda")
            require(tuple(img.shape) == (540, 960, 3), f"web_app {idx}/{pos}: {tuple(img.shape)}")
        gt_name = state.pairs[0]["triplet"]["gt_intermediate"]
        from vfisr_tpu_torch.data.png import read_png

        gt = read_png(processed / INGEST_CLIP / "ground_truth" / "frames"
                      / gt_name[len(gt_name) // 2])
        gt_small = resize(torch.from_numpy(gt).cuda(), (540, 960), "area")
        control = served[(state.pairs[0]["idx"], "gt")]
        require(control == jpeg.encode(gt_small, web_app.JPEG_QUALITY, "cuda"),
                "web_app's control: the JPEG of its ground-truth frame at 540 rows")
        p_gt = psnr(jpeg.decode(control, "cuda"), gt_small)
        print(f"web_app on step 21's clip at 540 rows, methods {STUDY_SERVER_METHODS}, seed "
              f"{STUDY_SEED}: {len(pairs)} pairs, {len(served)} JPEGs served (q{web_app.JPEG_QUALITY}"
              f", each 960x540), the control the JPEG of its ground truth ({p_gt:.4f} dB from "
              f"it); walk {walk_s:.3f} s "
              f"(host clock: clips -> clip -> pairs -> frames -> guess -> results -> save); K1 "
              f"{k1} launches; renders ms (a method's first includes its model's load) "
              + ", ".join(f"{m} {ms:.3f}" for m, ms in render_ms) + f"; {card}")
        t0 = _phase("step26_web_app", t0)

        # (e) the video study server on step 25's study videos
        full = root / "full"
        fw, fh, ffps, fn = FULL_VIDEO
        for name in ("control", "lanczos"):
            with VideoWriter(str(full / f"{name}.y4m"), fw, fh, ffps) as w:
                for i in range(fn):
                    w.write(game_frame(i + (name == "lanczos"), "cpu", h=fh, w=fw, step=2).numpy())
        app = vbs.AppState(str(study_root / "bench"), str(ingest_root / "full" /
                                                           "experiment_results.json"),
                           full_dir=str(full), duration=0.5, out_dir=str(root / "video"),
                           device="cuda")
        app.rng = random.Random(STUDY_SEED)
        server = ThreadingHTTPServer(("127.0.0.1", 0), vbs.make_handler(app))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            models = app.models()
            require(models == sorted(STUDY_METHODS), f"video study models {models}")
            video = app.video_path("lanczos")
            size = video.stat().st_size
            code, hdr, body = call("/api/video/lanczos", headers={"Range": "bytes=1000-1999"})
            require(code == 206 and hdr["Content-Range"] == f"bytes 1000-1999/{size}"
                    and body == video.read_bytes()[1000:2000], f"video Range: {code} {hdr}")
            token = json.loads(call("/api/quiz/start", {})[2])["token"]
            answer = app.quiz[token]
            code, _, body = call(f"/api/quiz/video?t={token}", headers={"Range": "bytes=0-9"})
            require(code == 206 and len(body) == 10, f"quiz video {code}")
            g = json.loads(call("/api/quiz/guess", {"token": token, "guess": answer})[2])
            require(g["correct"] and g["total"] == 1, f"quiz guess {g}")
            code, _, body = call("/api/new-interval", {})
            cut = json.loads(body)
            require(code == 200 and cut["status"] == "done", f"new_interval {code} {cut}")
            meta = app.metadata()["clips"]["full"]["videos"]
            start_f = int(round(cut["start_time"] * ffps))
            with VideoReader(meta["lanczos"]) as c, VideoReader(str(full / "lanczos.y4m")) as src:
                got = [c.read_i420() for _ in range(c.frame_count)]
                want = [src.read_i420() for _ in range(fn)]
            require(len(got) == int(round(0.5 * ffps)) and any(
                all(np.array_equal(a, want[s + i]) for i, a in enumerate(got))
                for s in (start_f - 1, start_f, start_f + 1)), "new_interval's cut frames")
            res = json.loads(call("/api/experiment-results")[2])["experiments"]
            require(res and all("base_name" in e for e in res), "experiment results served")
        finally:
            server.shutdown()
            server.server_close()
        print(f"video study on step 25's videos ({', '.join(models)}, {video.suffix}): a 206 of "
              f"bytes 1000-1999 of {size}, a quiz round ({answer}, correct), new_interval cut "
              f"{len(got)} frames at {cut['start_time']} s of the {fn / ffps:.1f} s full videos, "
              f"{len(res)} experiment rows served")
        t0 = _phase("step26_video_study", t0)

        # (f) the two study scripts on clips the card renders
        clips = {}
        for preset, seed in (("hard", 431), ("smooth", 1)):
            clips[preset] = root / f"{preset}.y4m"
            with cl.redirect_stdout(io.StringIO()):
                make_synthetic_clip.main([str(clips[preset]), "--preset", preset, "--seconds",
                                          str(SCRIPT_SECONDS), "--seed", str(seed)])
        t0 = _phase("step26_render", t0)
        buf = io.StringIO()
        start = time.perf_counter()
        with cl.redirect_stdout(buf):
            _, k1_los, _ = _acc_run(kw, acc, "lpips_ordering_study", lambda: lpips_ordering_study.main(
                ["--pairs", str(SCRIPT_PAIRS), "--stride", "1", "--hard-clip", str(clips["hard"]),
                 "--smooth-clip", str(clips["smooth"]), "--out", str(root / "lpips.json")]))
        los_s = time.perf_counter() - start
        los = json.loads((root / "lpips.json").read_text())
        for name, fam in los["families"].items():
            require(fam["pairs"] == SCRIPT_PAIRS and all(
                math.isfinite(fam[k]) for k in ("lpips_blend_mean", "lpips_rife_mean",
                                                 "psnr_blend_mean", "psnr_rife_mean")),
                f"lpips_ordering_study {name}: {fam}")
            print(f"lpips_ordering_study {name}: " + json.dumps(
                {k: v for k, v in fam.items() if k not in ("rows", "clip")}))
        print(f"lpips_ordering_study: {los_s:.3f} s (host clock; mode {los['lpips_mode']}), K1 "
              f"{k1_los} launches")
        t0 = _phase("step26_lpips_ordering_study", t0)
        buf = io.StringIO()
        start = time.perf_counter()
        with cl.redirect_stdout(buf):
            rc, k1_ced, _ = _acc_run(kw, acc, "check_expert_downscale", lambda: check_expert_downscale.main(
                ["--clips", str(clips["hard"]), "--pairs", str(SCRIPT_PAIRS), "--stride", "1",
                 "--out", str(root / "expert.json")]))
        ced_s = time.perf_counter() - start
        require(rc == 0, f"check_expert_downscale exit {rc}: {buf.getvalue()[-500:]}")
        ced = json.loads((root / "expert.json").read_text())
        require(ced["pairs"] == SCRIPT_PAIRS and ced["native_over_resident_mb"] > 0,
                f"expert check {ced}")
        print("check_expert_downscale: " + json.dumps({k: v for k, v in ced.items()
                                                       if k not in ("rows", "created")}))
        print(f"check_expert_downscale: {ced_s:.3f} s (host clock), K1 {k1_ced} launches; VFIMamba's "
              f"native trunk at 2560x1440 peaked at {ced['native_peak_mb']} MB "
              f"(torch.cuda.max_memory_allocated), {ced['native_over_resident_mb']} MB over what "
              f"was resident before it, on {ced['card']}")
        torch.cuda.empty_cache()
        t0 = _phase("step26_check_expert_downscale", t0)

        # (g) the report scripts on step 21's experiment_results.json
        results = ingest_root / "full" / "experiment_results.json"
        start = time.perf_counter()
        with cl.redirect_stdout(io.StringIO()):
            generate_comprehensive_report.main(["--results", str(results), "--output-dir",
                                                str(root / "report")])
        report = (root / "report" / "COMPREHENSIVE_REPORT.md").read_text()
        require(f"**Hardware:** {torch.cuda.get_device_name(0)}" in report
                and (root / "report" / "METHODS_REFERENCE.md").is_file(), "the report's files")
        try:
            import matplotlib  # noqa: F401
            figures = True
        except ImportError:
            figures = False
        if figures:
            with cl.redirect_stdout(io.StringIO()):
                generate_report_figures.main(["--results", str(results), "--output-dir",
                                              str(root / "figures")])
            table = (root / "figures" / "table1_results.tex").read_text()
        else:
            try:
                generate_report_figures.main(["--results", str(results), "--output-dir",
                                              str(root / "figures")])
                require(False, "generate_report_figures without matplotlib")
            except ImportError as e:
                require("matplotlib" in str(e), f"generate_report_figures: {e}")
            from vfisr_tpu_torch.analysis.data_analysis import load_results, rankings

            table = generate_report_figures.results_table(rankings(load_results(results))["by_vfi_psnr"])
        require(table.count("\\\\\n") >= 2, "the results table's rows")
        print(f"reports on step 21's results: COMPREHENSIVE_REPORT.md {len(report.splitlines())} "
              f"lines, METHODS_REFERENCE.md, table1_results.tex {table.count(chr(10))} lines; "
              + ("figures drawn" if figures else "figures not drawn: matplotlib is not installed "
                 "here, and generate_report_figures says so by name")
              + f"; {time.perf_counter() - start:.3f} s")
        t0 = _phase("step26_reports", t0)
    finally:
        tmp.cleanup()
    err1 = _require_checks(acc["checks1"], "step 26")
    require(not acc["checks2"], "no K2 launch in step 26")
    total1 = _kernel_by_shape(kw, "step26", "phase", acc["firsts1"], acc["counts1"])
    _phase("step26_kernel_timing", t0)
    return path_numbers(sum(acc["counts1"].values()), err1, total1, 1)


# step 27: the last slice of the port. (a) csrc/warp_tiled.cu (K1 and K2 at
# any output tile) against its plain twin at every tile and shape the
# profile tools launch, K2 at the reference's test tile, a constant border,
# a flow past the window, 176 channels, a t per image, and at 32x256 against
# the tile kernels; (b) the eight profile tools in process at their full
# case lists, TILE_REPS timed calls after TILE_WARMUP; (c) verify_setup,
# probe_system, graft_entry (entry() and the sharded flagship check over a
# gloo pair on the one card), generate_figures on step 21's results and
# evaluate_quality on JPEG frames written by data/jpeg.py
TILE_REPS, TILE_WARMUP = 2, 1  # the tools' timed calls per case (20 and 3 by default)
PROFILE_TOOLS = ("profile_flagship", "profile_pairs", "profile_components", "profile_adaptive",
                 "profile_conv", "profile_resize", "profile_radius", "profile_warp_tiles")
# the tools' K1 at tiles other than 32x256: profile_components' three 16x256
# cases and profile_warp_tiles' eight
TILED_LAUNCH_CASES = 3 + 8
TILED_GRAD_TILE, TILED_GRAD_R = (8, 128), 6  # tests/test_pallas_warp.py:101-103
STEP27_GRAPH = 5  # launches per captured graph of step 27's per-shape timing


def _tile_key(a: dict) -> tuple:
    return shape_key(a) + (tuple(a["tile"]),)


def check_tiled(kw, label: str, a: dict) -> float:
    """warp_tiled.cu's K1 (through the wrapper at a's tile) against the
    plain twin at that tile, bit for bit (max abs error 0), and its origins
    against window_origins; returns the error."""
    tile = a["tile"]
    args = (a["img"], a["flow"], a["t"], a["r"], a["border"], a["compute_dtype"])
    before = kw.tiled_launches
    out = kw.warp_windowed(*args, tile=tile)
    ref = kw.warp_windowed_plain(*args, tile=tile)
    torch.cuda.synchronize()
    require(kw.tiled_launches == before + (tuple(tile) != kw.TILE), f"{label}: the tiled kernel ran")
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref, a["compute_dtype"])
    ry, rx = (a["r"], a["r"]) if isinstance(a["r"], int) else a["r"]
    t_arr = torch.as_tensor(a["t"], dtype=torch.float32, device=a["flow"].device)
    t_arr = t_arr.reshape(-1).expand(a["flow"].shape[0]).contiguous()
    got = kw.kernel_origins(a["flow"], a["t"], a["r"], a["compute_dtype"], tile)
    want = ORIGIN_TABLE(a["flow"], t_arr, ry, rx, a["compute_dtype"] == torch.bfloat16, tile)
    same = got.shape == want.shape and torch.equal(got, want)
    print(f"tiled kernel vs plain {label}: {_label(a)} tile {tuple(tile)}: max_abs_err {err:.3e} "
          f"(required 0; the twin's tolerance {tol:.3e}), origins {'equal' if same else 'DIFFER'}; "
          f"plan {_plan_text(kw, a)}")
    require(err == 0.0 and same, f"tiled kernel vs plain {label}")
    return err


def _plan_text(kw, a: dict, grad: bool = False) -> str:
    """warp_tiled.cu's plan of a's launch on the card, in one line."""
    pl = kw.card_tiled_plan(a["img"], a["r"], a["compute_dtype"], tuple(a["tile"]), grad)
    if pl is None:
        return "refused"
    return (f"{pl['rows']}x{pl['cols']} px slabs, {pl['bands']} bands x {pl['segments']} "
            f"segments per tile, {pl['slabs']} slabs, "
            + (f"chunks of {pl['chunk']} channels x{pl['chunks']}, " if pl["chunked"] else "")
            + f"{pl['ring_rows']} ring rows, {pl['smem']} B shared, {pl['ctas']} CTAs, "
            f"{pl['ctas_per_sm']} per SM, origins {'fused' if pl['fused'] else 'pass'}")


def check_tiled_grad(kw, label: str, a: dict) -> float:
    """warp_tiled.cu's K2 at a's tile against the plain twin (grad_flow and
    cg), within 1e-5 (f32 windows) or 2/255 (bf16) of the largest |cg|."""
    tile = a["tile"]
    args = (a["img"], a["flow"], a["t"], a["ct"], a["r"], a["border"], a["compute_dtype"])
    before = kw.tiled_grad_launches
    gflow, cg = kw.warp_windowed_grad(*args, tile=tile)
    ref_gflow, ref_cg = kw.warp_windowed_grad_plain(*args, tile=tile)
    torch.cuda.synchronize()
    require(kw.tiled_grad_launches == before + 1, f"{label}: the tiled grad kernel ran")
    err = max((gflow.float() - ref_gflow.float()).abs().max().item(),
              (cg - ref_cg).abs().max().item())
    scale = ref_cg.abs().max().item()
    tol = (2.0 / 255.0 if a["compute_dtype"] == torch.bfloat16 else 1e-5) * scale
    require(scale > 0, f"{label} has a gradient to check")
    print(f"tiled grad kernel vs plain {label}: {_label(a)} tile {tuple(tile)}: max_abs_err "
          f"{err:.3e} tol {tol:.3e}; plan {_plan_text(kw, a, True)}")
    require(err <= tol, f"tiled grad kernel vs plain {label}")
    return err


def tiled_case_specs() -> list:
    """The tiled kernel's cases without their tensors: every (shape, r,
    window dtype, tile) the profile tools launch at a tile other than
    32x256 (their inputs' kind: random +-4 px flows, the smooth gaming
    flow), and the edges: a constant border, a flow past the window, 176
    channels, a t per image. Each: name, shape, compute_dtype, r, tile,
    flow (its kind), t, border, amp. tests/test_torch_tiles.py plans them."""
    bf, f32 = torch.bfloat16, torch.float32
    full, half = (6, 1088, 1920, 3), (6, 544, 960, 3)

    def spec(name, shape, cd, r, tile, flow="random", t=1.0, border="replicate", amp=4.0):
        return dict(name=name, shape=shape, compute_dtype=cd, r=r, tile=tile, flow=flow, t=t,
                    border=border, amp=amp)

    specs = [spec(f"components_r{r}_t16x256", full, f32, r, (16, 256)) for r in (6, 4, 2)]
    specs += [spec(f"warp_tiles_t{th}x{tw}", full, bf, (3, 4), (th, tw), flow="gaming")
              for th, tw in ((40, 256), (40, 640), (104, 640), (104, 256), (40, 1920), (8, 640))]
    specs += [spec(f"warp_tiles_half_t{th}x{tw}", half, bf, (2, 2), (th, tw), flow="gaming_half")
              for th, tw in ((40, 960), (104, 960))]
    specs += [
        spec("constant_border_bf16_t40x256", (2, 544, 960, 3), bf, (2, 2), (40, 256),
             flow="smooth12", border="constant"),
        spec("constant_border_f32_t8x640", (2, 544, 960, 3), f32, 8, (8, 640), flow="smooth12",
             border="constant"),
        spec("past_window_t40x256", (2, 544, 960, 3), bf, (2, 2), (40, 256), flow="smooth25"),
        spec("c176_t16x256", (3, 114, 144, 176), f32, 8, (16, 256), amp=6.0),
        spec("per_image_t_t40x256", (3, 270, 480, 3), f32, (3, 4), (40, 256),
             t=(0.25, 0.5, 0.75)),
    ]
    return specs


def tiled_cases(device) -> list:
    """``tiled_case_specs`` with their tensors on ``device``: a random f32
    image and cotangent, the flow of the spec's kind, t."""
    from vfisr_tpu_torch.profile_warp_tiles import gaming_flow

    gen = torch.Generator(device="cpu").manual_seed(27)
    g_full = torch.from_numpy(gaming_flow(1088, 1920))[None].expand(6, -1, -1, -1).contiguous()
    g_half = torch.from_numpy(gaming_flow(1088, 1920)[::2, ::2] / 2)[None]
    g_half = g_half.expand(6, -1, -1, -1).contiguous()
    yy, xx = torch.meshgrid(torch.arange(544.0), torch.arange(960.0), indexing="ij")
    smooth = torch.stack([torch.sin(xx / 17.0 + yy / 23.0), torch.cos(yy / 9.0)], -1)[None]
    cases = []
    for sp in tiled_case_specs():
        n, h, w, c = sp["shape"]
        img = torch.rand(sp["shape"], generator=gen).to(device)
        kind = sp["flow"]
        if kind == "random":
            flow = (torch.rand((n, h, w, 2), generator=gen) - 0.5) * (2 * sp["amp"])
        elif kind == "gaming":
            flow = g_full
        elif kind == "gaming_half":
            flow = g_half
        else:  # smooth12, smooth25: that many px of smooth motion plus noise
            amp, noise = (12.0, 0.5) if kind == "smooth12" else (25.0, 4.0)
            flow = amp * smooth + noise * torch.randn((n, h, w, 2), generator=gen)
        t = torch.tensor(sp["t"], device=device) if isinstance(sp["t"], tuple) else sp["t"]
        cases.append(dict(sp, img=img, flow=flow.to(device), t=t,
                          ct=torch.randn(sp["shape"], generator=gen).to(device)))
    return cases


def _tool_wrapper(kw, checks: list, firsts: dict, counts: dict, live):
    """K1's wrapper for the profile tools (which pass ``tile``): counts
    every launch by (shape, tile), keeps a clone of each key's first launch
    for the per-shape timing, and while ``live()`` (the tool's first case)
    holds the launch against its twin and its origins against
    window_origins."""
    real = kw.warp_windowed

    def wrapper(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32,
                tile=kw.TILE):
        out = real(img, flow, t, r, border, compute_dtype, tile)
        a = dict(img=img, flow=flow, t=t, r=r, border=border, compute_dtype=compute_dtype,
                 tile=tuple(tile))
        key = _tile_key(a)
        if key not in firsts:
            firsts[key] = dict(a, img=img.clone(), flow=flow.clone(),
                               t=t.clone() if torch.is_tensor(t) else t)
        counts[key] = counts.get(key, 0) + 1
        if live():
            ref = _twin(kw, kw.warp_windowed_plain, img, flow, t, r, border, compute_dtype,
                        "interp", tile)
            base = 2.0 / 255.0 if compute_dtype == torch.bfloat16 else 1e-5
            ry, rx = (r, r) if isinstance(r, int) else r
            t_arr = torch.as_tensor(t, dtype=torch.float32, device=flow.device)
            t_arr = t_arr.reshape(-1).expand(flow.shape[0]).contiguous()
            got = kw.kernel_origins(flow, t, r, compute_dtype, tile)
            want = ORIGIN_TABLE(flow, t_arr, ry, rx, compute_dtype == torch.bfloat16, tuple(tile))
            differ = ((got != want).any() if got.shape == want.shape
                      else torch.ones((), dtype=torch.bool, device=flow.device))
            checks.append(((out.float() - ref.float()).abs().max(),
                           base * torch.clamp(ref.float().abs().max(), min=1.0), differ,
                           tuple(tile) != kw.TILE))
        return out

    return wrapper


def time_step27_launch(kw, a: dict, grad: bool = False) -> dict:
    """One launch shape's times, lighter than ``time_launch`` (step 27 has
    ~100 shapes): the kernel alone by CUDA-graph replay of STEP27_GRAPH
    launches, the plain twin once and grid_sample (K2: its grid gradient)
    three times after a warm-up, and the bound."""
    img, flow, r, cd, tile = a["img"], a["flow"], a["r"], a["compute_dtype"], a["tile"]
    graph = torch.cuda.CUDAGraph()
    if grad:
        ct = a["ct"].contiguous()
        gflow = torch.empty_like(flow)
        cg = torch.empty(flow.shape, dtype=torch.float32, device=flow.device)
        kw.launch_grad(img, flow, a["t"], ct, gflow, cg, r, a["border"], cd, tile)  # warm-up
        with torch.cuda.graph(graph):
            for _ in range(STEP27_GRAPH):
                kw.launch_grad(img, flow, a["t"], ct, gflow, cg, r, a["border"], cd, tile)
        plain = lambda: _twin(kw, kw.warp_windowed_grad_plain, img, flow, a["t"], ct, r,  # noqa: E731
                              a["border"], cd, tile)
        bound, by = grad_launch_bound(a)
        library = grid_sample_grad_call(a)
    else:
        out = torch.empty_like(img)
        kw.launch(img, flow, a["t"], out, r, a["border"], cd, tile)  # warm-up
        with torch.cuda.graph(graph):
            for _ in range(STEP27_GRAPH):
                kw.launch(img, flow, a["t"], out, r, a["border"], cd, tile)
        plain = lambda: _twin(kw, kw.warp_windowed_plain, img, flow, a["t"], r,  # noqa: E731
                              a["border"], cd, "interp", tile)
        bound, by = launch_bound(a)
        library = grid_sample_call(a)
    return dict(kernel=time_ms(graph.replay, 3, warmup=1) / STEP27_GRAPH, bound=bound, by=by,
                plain=time_ms(plain, 1, warmup=0), library=time_ms(library, 3, warmup=1))


def step27_by_shape(kw, label: str, firsts: dict, counts: dict, grad: bool = False) -> dict:
    """Per-shape lines of step 27's counted launches and their totals."""
    total = dict(kernel=0.0, bound=0.0, plain=0.0, library=0.0)
    bys = set()
    for key, n in counts.items():
        v = time_step27_launch(kw, firsts[key], grad)
        bys.add(v["by"])
        for f in total:
            total[f] += n * v[f]
        plan = "" if key[5] == kw.TILE else f"; plan {_plan_text(kw, firsts[key], grad)}"
        print(f"{label} launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} "
              f"r={key[3]} {key[4]} tile {key[5]} x{n}: kernel {v['kernel']:.4f} ms, bound "
              f"{v['bound']:.4f} ms ({v['by']}), plain {v['plain']:.4f} ms, "
              f"grid_sample{' grad' if grad else ''} {v['library']:.4f} ms{plan}")
    total["by"] = "bytes" if bys <= {"bytes"} else "operations"
    print(f"{label}: {sum(counts.values())} launches in {len(counts)} shapes, "
          + ", ".join(f"{f} {total[f]:.4f} ms" for f in ("kernel", "bound", "plain", "library")))
    return total


class _LineCount(io.StringIO):
    """A tool's captured standard output; ``lines`` counts finished lines
    (its cases: one JSON line each)."""

    @property
    def lines(self) -> int:
        return self.getvalue().count("\n")


def _finite_numbers(obj) -> list:
    if isinstance(obj, dict):
        return [v for x in obj.values() for v in _finite_numbers(x)]
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return [obj] if math.isfinite(obj) else [float("nan")]
    return []


def last_slice_phase(kw, card: str, ingest_root: Path) -> tuple:
    """Step 27 of the module docstring. Returns (K1's numbers over the
    tools' launches at 32x256, the tiled K1's over theirs at other tiles,
    the tiled K2's over its counted run)."""
    from vfisr_tpu_torch import graft_entry

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    # (c)'s child processes start first (each takes seconds to reach the
    # card) and run beside (a) and (b): the three CLIs, and the sharded
    # flagship check's two gloo ranks from a thread of this process
    results = ingest_root / "full" / "experiment_results.json"
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_step27_")
    root = Path(tmp.name)
    clis = {name: subprocess.Popen([sys.executable, "-m", f"vfisr_tpu_torch.{name}", *args],
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                   cwd=ROOT)
            for name, args in (("verify_setup", ["--device", "cuda"]),
                               ("probe_system", ["--json"]),
                               ("generate_figures", ["--results", str(results), "--output-dir",
                                                     str(root / "figs")]))}
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(graft_entry.flagship_ranks, 2, "cuda", "gloo", SCALEOUT_TIMEOUT)
    try:
        return _last_slice_body(kw, card, dev, t0, root, clis, ranks)
    finally:
        pool.shutdown(wait=True)
        for p in clis.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        tmp.cleanup()


def _last_slice_body(kw, card: str, dev, t0: float, root: Path, clis: dict, ranks) -> tuple:
    """Step 27's parts (a)-(c) in this process, with (c)'s child processes
    already started (``last_slice_phase``)."""
    import contextlib as cl
    import importlib

    from vfisr_tpu_torch import evaluate_quality, graft_entry
    from vfisr_tpu_torch.data import jpeg
    from vfisr_tpu_torch.evaluation import QualityEvaluator

    # (a) the tiled kernel against its twin, and at 32x256 against the tile kernels
    errs1, errs2 = [], []
    cases = tiled_cases(dev)
    for a in cases:
        errs1.append(check_tiled(kw, a["name"], a))
        if a["name"] in ("constant_border_f32_t8x640", "c176_t16x256", "per_image_t_t40x256"):
            errs2.append(check_tiled_grad(kw, a["name"], a))
    gen = torch.Generator(device="cpu").manual_seed(28)
    grad_cases_ = []
    for border in ("replicate", "constant"):
        yy, xx = torch.meshgrid(torch.arange(1080.0), torch.arange(1920.0), indexing="ij")
        flow = torch.stack([4.0 * torch.sin(xx / 17.0 + yy / 23.0), 2.0 * torch.cos(yy / 9.0)], -1)
        flow = (flow[None] + torch.randn((1, 1080, 1920, 2), generator=gen)).to(dev)
        grad_cases_.append(dict(name=f"k2_t8x128_r6_1080p_{border}", border=border, flow=flow,
                                img=torch.rand((1, 1080, 1920, 3), generator=gen).to(dev),
                                ct=torch.randn((1, 1080, 1920, 3), generator=gen).to(dev),
                                t=0.7, r=TILED_GRAD_R, compute_dtype=torch.float32,
                                tile=TILED_GRAD_TILE))
    for a in grad_cases_:
        errs2.append(check_tiled_grad(kw, a["name"], a))
        errs1.append(check_tiled(kw, a["name"], a))
    for cd in (torch.float32, torch.bfloat16):
        a = cases[-3]  # the flow past the window, [2,544,960,3]
        img, flow = a["img"].to(cd), a["flow"]
        ct = a["ct"].to(cd)
        out, tiled = torch.empty_like(img), torch.empty_like(img)
        kw.launch(img, flow, 1.0, out, (2, 2), "replicate", cd)
        kw.launch_tiled(img, flow, 1.0, tiled, (2, 2), "replicate", cd, kw.TILE)
        g1, c1, g2, c2 = (torch.empty(flow.shape, dtype=torch.float32, device=dev)
                          for _ in range(4))
        kw.launch_grad(img, flow, 1.0, ct, g1, c1, (2, 2), "replicate", cd)
        kw.launch_grad_tiled(img, flow, 1.0, ct, g2, c2, (2, 2), "replicate", cd, kw.TILE)
        torch.cuda.synchronize()
        same = torch.equal(out, tiled) and torch.equal(c1, c2) and torch.equal(g1, g2)
        print(f"tiled kernel at 32x256 vs the tile kernels, {str(cd)[6:]} image: K1 "
              f"{'equal' if torch.equal(out, tiled) else 'DIFFER'}, K2 "
              f"{'equal' if torch.equal(c1, c2) and torch.equal(g1, g2) else 'DIFFER'}")
        require(same, f"tiled kernel at 32x256 equals the tile kernels ({cd})")
    t0 = _phase("step27_tiled_checks", t0)

    # the tiled K2's counted run: the reference's own K2 case (tile 8x128,
    # r = 6; tests/test_pallas_warp.py:101-103) on the 1080p frames above
    firsts2, counts2 = {}, {}
    with origin_table_raises(kw):
        kw.grad_launches = kw.tiled_grad_launches = 0
        for a in grad_cases_:
            kw.warp_windowed_grad(a["img"], a["flow"], a["t"], a["ct"], a["r"], a["border"],
                                  a["compute_dtype"], a["tile"])
            key = _tile_key(a)
            firsts2.setdefault(key, a)
            counts2[key] = counts2.get(key, 0) + 1
        torch.cuda.synchronize()
        k2_tiled = kw.tiled_grad_launches
    require(k2_tiled == len(grad_cases_) and kw.grad_launches == k2_tiled,
            f"{k2_tiled} tiled K2 launches")

    # (b) the eight profile tools in process
    checks, firsts, counts = [], {}, {}
    tool_k1 = tool_tiled = 0
    real = kw.warp_windowed
    for name in PROFILE_TOOLS:
        tool = importlib.import_module(f"vfisr_tpu_torch.{name}")
        buf = _LineCount()
        kw.warp_windowed = _tool_wrapper(kw, checks, firsts, counts, lambda: buf.lines == 0)
        start = time.perf_counter()
        n_checked = len(checks)
        try:
            with origin_table_raises(kw), cl.redirect_stdout(buf):
                kw.launches = kw.tiled_launches = 0
                rc = tool.main(["--reps", str(TILE_REPS), "--warmup", str(TILE_WARMUP)])
                torch.cuda.synchronize()
                k1, tiled = kw.launches, kw.tiled_launches
        finally:
            kw.warp_windowed = real
        lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
        nums = [v for ln in lines for v in _finite_numbers(
            {k: v for k, v in ln.items() if k not in ("launches",)})]
        require(rc == 0 and lines and all(_finite_numbers(ln) for ln in lines)
                and all(math.isfinite(v) for v in nums)
                and all(ln["device"] == torch.cuda.get_device_name(0) for ln in lines),
                f"{name}: a finite number in every case's JSON line")
        for ln in lines:
            print(f"{name}: {json.dumps(ln)}")
        print(f"{name}: {len(lines)} cases in {time.perf_counter() - start:.3f} s, K1 {k1} "
              f"launches ({tiled} in warp_tiled), {len(checks) - n_checked} of its first case's "
              f"held against the twin; {card}")
        require(k1 == 0 or len(checks) > n_checked, f"{name}: its first case's K1 checked")
        tool_k1 += k1 - tiled
        tool_tiled += tiled
    require(tool_tiled == TILED_LAUNCH_CASES * (TILE_REPS + TILE_WARMUP),
            f"{tool_tiled} tiled K1 launches in the tools")
    err, tol, differ, is_tiled = zip(*checks)
    err, tol, differ = torch.stack(err), torch.stack(tol), torch.stack(differ)
    require(bool((err <= tol).all()) and not bool(differ.any()),
            "step 27: every checked tool launch within its tolerance, origins equal")
    tiled_err = max([e.item() for e, t in zip(err, is_tiled) if t] + errs1)
    whole_err = max([e.item() for e, t in zip(err, is_tiled) if not t] or [0.0])
    print(f"step 27 tools: {len(checks)} K1 launches held against the twin ({sum(is_tiled)} "
          f"tiled), max_abs_err whole-C {whole_err:.3e}, tiled {tiled_err:.3e}")
    t0 = _phase("step27_profile_tools", t0)

    # (c) the environment and entry files
    start = time.perf_counter()
    fn, example = graft_entry.entry("cuda")
    kw.launches = 0
    with torch.no_grad():
        out = fn(*example)
        torch.cuda.synchronize()
        n_entry = kw.launches
        plain = _with_twin(kw, lambda: fn(*example))
    d = (out - plain).abs().max().item()
    print(f"graft_entry.entry(): exported, run on the card: {tuple(out.shape)}, {n_entry} K1 "
          f"launches, max abs diff from the plain twin's run {d:.3e} (tolerance 1e-3); "
          f"{time.perf_counter() - start:.3f} s")
    require(out.shape == (1, 256, 256, 3) and bool(torch.isfinite(out).all()) and d <= 1e-3,
            "graft_entry.entry() on the card")
    start = time.perf_counter()
    frames = {"pred": [game_frame(i + 0.5, dev, 270, 480) for i in range(2)],
              "gt": [game_frame(i + 0.4, dev, 270, 480) for i in range(2)]}
    for name, fs in frames.items():
        (root / name).mkdir()
        for i, f in enumerate(fs):
            (root / name / f"f_{i:04d}.jpg").write_bytes(jpeg.encode(f, 92, device="cuda"))
    with cl.redirect_stdout(_LineCount()):
        evaluate_quality.main(["--pred-dir", str(root / "pred"), "--gt-dir", str(root / "gt"),
                               "--output", str(root / "q.json")])
    got = json.loads((root / "q.json").read_text())
    decoded = {n: [jpeg.decode((root / n / f"f_{i:04d}.jpg").read_bytes(), "cuda").cpu().numpy()
                   for i in range(2)] for n in frames}
    want = QualityEvaluator("cuda").evaluate(decoded["pred"], decoded["gt"])
    print(f"evaluate_quality on data/jpeg.py's JPEGs: {got}; {time.perf_counter() - start:.3f} s")
    require(got["frames"] == 2 and got["psnr"] == want.psnr and got["ssim"] == want.ssim,
            "evaluate_quality on JPEG frames")
    # the sharded check: its ranks started with the step; the one-process
    # reference on the same pairs here
    ref = graft_entry.flagship_run(*(torch.from_numpy(x) for x in graft_entry.flagship_pairs(2)),
                                   "cuda")
    sharded = graft_entry.check_sharded(ref, ranks.result(), "gloo on cuda, one card")
    require(sharded["up_err"] <= 1, "the sharded flagship check")
    outs = {name: p.communicate(timeout=300) + (p.returncode,) for name, p in clis.items()}
    print(outs["verify_setup"][0].strip())
    require(outs["verify_setup"][2] == 0, "verify_setup --device cuda exits 0")
    report = json.loads(outs["probe_system"][0])
    acc_info = report["accelerator"]
    print(f"probe_system: {json.dumps(acc_info)}; score {report['compatibility_score']}")
    require(outs["probe_system"][2] == 0
            and acc_info["devices"][0]["kind"] == torch.cuda.get_device_name(0)
            and acc_info["power_limit"] == card, "probe_system names the card and its power limit")
    rc, err = outs["generate_figures"][2], outs["generate_figures"][1]
    try:
        import matplotlib  # noqa: F401
        has_mpl = True
    except ImportError:
        has_mpl = False
    if has_mpl:
        require(rc == 0 and any((root / "figs").iterdir()), f"generate_figures: rc {rc} {err[-300:]}")
    else:
        require(rc != 0 and "matplotlib" in err, f"generate_figures without matplotlib: rc {rc}")
    print(f"generate_figures on step 21's results: rc {rc}"
          + ("" if has_mpl else ", naming matplotlib, which is not installed here"))
    t0 = _phase("step27_entry_files", t0)

    # the per-shape device times, with no other process on the card
    whole = {k: v for k, v in counts.items() if k[5] == kw.TILE}
    tiled_counts = {k: v for k, v in counts.items() if k[5] != kw.TILE}
    total_whole = step27_by_shape(kw, "step27 K1", firsts, whole)
    total_tiled = step27_by_shape(kw, "step27 tiled K1", firsts, tiled_counts)
    total2 = step27_by_shape(kw, "step27 tiled K2", firsts2, counts2, grad=True)
    del firsts, cases
    torch.cuda.empty_cache()
    _phase("step27_kernel_timing", t0)
    k1 = dict(launches=tool_k1, err=whole_err, **total_whole)
    tiled1 = dict(launches=tool_tiled, err=tiled_err, **total_tiled)
    tiled2 = dict(launches=k2_tiled, err=max(errs2), **total2)
    return k1, tiled1, tiled2


def main() -> int:
    wall0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (ROOT / "vfisr_tpu_torch").is_dir():
        print(f"chip_smoke: no vfisr_tpu_torch/ beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from vfisr_tpu_torch.core.frames import to_uint8
    from vfisr_tpu_torch.core.resize import resize
    from vfisr_tpu_torch.ops.cuda import warp as kw
    from vfisr_tpu_torch.pipeline.flagship import (FlagshipVFI, analyze_small, init_history,
                                                   push_history)

    global ORIGIN_TABLE
    ORIGIN_TABLE = kw.window_origins

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # one nvcc per kernel source, started together
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        for build in [pool.submit(kw.build), pool.submit(kw.build_tiled)]:
            build.result()
    t0 = _phase("build", t0)

    rife_npz, gate_json = ROOT / "weights" / "rife.npz", ROOT / "weights" / "router_gate.json"
    require(rife_npz.is_file() and gate_json.is_file(), f"{rife_npz} and {gate_json} present")
    vfi = FlagshipVFI(device="cuda")
    # explicit paths make the loads strict: a missing or mismatched
    # checkpoint raises instead of leaving a fresh init
    vfi.load(weights_path=str(rife_npz), gate_path=str(gate_json))
    require(vfi._module.config.channels == (256, 160, 112, 80), "full-width RIFE")
    require(vfi.base_config.scene_warp_ssim_threshold != 1.0, "calibrated scene gate loaded")
    frames = [game_frame(i, dev) for i in range(PAIRS + 1)]
    out_hw = (1440, 2560)
    t0 = _phase("load", t0)

    # warm-up pair, recording every kernel launch's inputs for the checks
    real_warp = kw.warp_windowed
    recorded = []
    kw.warp_windowed = _recording(kw, recorded)
    try:
        with origin_table_raises(kw):
            vfi.fused_stream_step(frames[0], frames[1], SCALE, TS)
            torch.cuda.synchronize()
    finally:
        kw.warp_windowed = real_warp
    require(len(recorded) == LAUNCHES_PER_PAIR, f"{len(recorded)} warp launches in a pair")
    t0 = _phase("warmup_record", t0)

    # the main path, counted and timed
    vfi.reset_history()
    torch.cuda.reset_peak_memory_stats()
    outs, pair_ms = [], []
    with origin_table_raises(kw):
        kw.launches = 0
        for i in range(PAIRS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs.append(vfi.fused_stream_step(frames[i], frames[i + 1], SCALE, TS))
            end.record()
            end.synchronize()
            pair_ms.append(start.elapsed_time(end))
        launches = kw.launches
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    require(launches == LAUNCHES_PER_PAIR * PAIRS, f"{launches} kernel launches in {PAIRS} pairs")
    t0 = _phase("main_path", t0)

    # outputs
    for up in outs:
        require(up.dtype == torch.uint8 and tuple(up.shape) == (1 + len(TS), *out_hw, 3),
                f"output {up.dtype} {tuple(up.shape)}")
    gain = []
    for i, up in enumerate(outs):
        x0 = frames[i].float()[None] / 255.0
        require(torch.equal(up[0], to_uint8(resize(x0, out_hw, "lanczos4"))[0]), "endpoint frame")
        for k, t in enumerate(TS):
            truth = to_uint8(resize(game_frame(i + t, dev).float()[None] / 255.0, out_hw, "lanczos4"))[0]
            p_mid, p_dup = psnr(up[1 + k], truth), psnr(up[0], truth)
            gain.append(p_mid - p_dup)
            require(p_mid > p_dup, f"pair {i} t={t}: interpolated {p_mid:.2f} dB <= duplicate {p_dup:.2f} dB")
    print(f"midpoint PSNR gain over frame duplication (dB): min {min(gain):.3f} "
          f"mean {sum(gain) / len(gain):.3f}")

    def plain_warp(img, flow, t=1.0, r=8, border="replicate", compute_dtype=torch.float32):
        return kw.warp_windowed_plain(img, flow, t, r, border, compute_dtype)

    vfi.reset_history()
    up_kernel = vfi.fused_stream_step(frames[0], frames[1], SCALE, TS)
    vfi.reset_history()
    kw.warp_windowed = plain_warp
    try:
        up_plain = vfi.fused_stream_step(frames[0], frames[1], SCALE, TS)
    finally:
        kw.warp_windowed = real_warp
    d = (up_kernel.int() - up_plain.int()).abs()
    print(f"pair with kernel vs with plain twin: max {d.max().item()} LSB, "
          f"mean {d.float().mean().item():.6f} LSB (tolerance max 2, mean 0.05)")
    require(d.max().item() <= 2 and d.float().mean().item() <= 0.05, "kernel vs twin in the step")
    t0 = _phase("outputs", t0)

    # the kernels' origins, and the kernel against its plain twin
    max_err = 0.0
    for j, a in enumerate(recorded):
        check_origins(kw, f"main-path launch {j}", a)
        max_err = max(max_err, check_warp(kw, f"main-path launch {j}", a))
    for a in synthetic_cases(dev):
        check_origins(kw, a["name"], a)
        max_err = max(max_err, check_warp(kw, a["name"], a))
    require_whole_c(kw, "flagship", recorded)
    # channel groups: K1 at C in GROUPED_C (an f32 image at r = 8 takes
    # groups past 9 channels)
    for a in grouped_cases(dev):
        p = kw.plan(a["img"], a["r"], a["compute_dtype"])
        require(p is not None and p["grouped"] == 1, f"plan of {_label(a)}: {p}")
        print(f"plan {_label(a)}: {p}")
        max_err = max(max_err, check_warp(kw, a["name"], a))
    # the origin's edge cases: origins, K1 and K2 (K2's line takes its
    # max_abs_err from the training's launches; these only gate)
    for a in adversarial_cases(dev):
        check_origins(kw, a["name"], a)
        max_err = max(max_err, check_warp(kw, a["name"], a))
        check_warp_grad(kw, a["name"], a)
    t0 = _phase("kernel_checks", t0)

    # per-launch timing at the main path's shapes
    totals = dict(kernel=0.0, host=0.0, wrapper=0.0, plain=0.0, bound=0.0, library=0.0)
    by_shape = shape_times(kw, recorded, time_launch)
    for key, s in by_shape.items():
        print(f"launch shape {key[0]} {str(key[1])[6:]} window {str(key[2])[6:]} r={key[3]} x{s['n']}/pair: "
              f"kernel {s['kernel']:.4f} ms, bound {s['bound']:.4f} ms ({s['by']}), "
              f"wrapper host {s['host']:.4f} ms, wrapper {s['wrapper']:.4f} ms, "
              f"plain {s['plain']:.4f} ms, grid_sample {s['library']:.4f} ms")
        for k in totals:
            totals[k] += s["n"] * s[k]
    totals["by"] = "bytes" if {s["by"] for s in by_shape.values()} == {"bytes"} else "operations"
    largest = max(by_shape, key=lambda k: torch.Size(k[0]).numel())
    print(f"grid_sample at the largest launch shape {largest[0]}: {by_shape[largest]['library']:.4f} ms")
    t0 = _phase("timing", t0)

    # where a pair's time goes: each stage of the step alone, after warm-up
    x0, x1 = (f.float()[None] / 255.0 for f in frames[:2])
    hist, hcnt = init_history(1, dev)
    cfg = dataclasses.replace(vfi.base_config, out_hw=out_hw)
    four = torch.cat([x0, x1, x1, x1])
    stages = {
        "analysis (push_history + analyze_small)":
            lambda: analyze_small(x0, x1, *push_history(hist, hcnt, x0), cfg),
        "rife (interpolate_batch: pad + shared_flow_apply)":
            lambda: vfi.interpolate_batch(x0, x1, TS),
        "sr (lanczos4 to 2560x1440 + to_uint8, 4 frames)":
            lambda: to_uint8(resize(four, out_hw, "lanczos4")),
    }
    with torch.no_grad():
        for name, fn in stages.items():
            print(f"stage {name}: {time_ms(fn, 5):.3f} ms")
    t0 = _phase("breakdown", t0)

    ms = sum(pair_ms) / len(pair_ms)
    print(f"flagship step 1080p->1440p, {len(TS)} midpoints: ms/pair {ms:.3f} "
          f"(pairs: {', '.join(f'{x:.3f}' for x in pair_ms)}); interpolated fps "
          f"{len(TS) * 1000.0 / ms:.2f}; output fps {(1 + len(TS)) * 1000.0 / ms:.2f}; "
          f"max_memory_allocated {peak_mb:.1f} MB")
    print(f"warp kernel per pair: {LAUNCHES_PER_PAIR} launches, kernel {totals['kernel']:.4f} ms, "
          f"bound {totals['bound']:.4f} ms, wrapper host {totals['host']:.4f} ms, "
          f"wrapper {totals['wrapper']:.4f} ms, "
          f"plain {totals['plain']:.4f} ms, grid_sample {totals['library']:.4f} ms")
    k1_flagship = path_numbers(launches, max_err, totals, PAIRS)
    k1_stream_flagship = stream_flagship_phase(kw, rife_npz, card, totals)
    k1_train, k2_train = train_phase(kw, rife_npz)
    k1_adaptive, per_route = adaptive_phase(kw)
    k1_stream_adaptive = stream_adaptive_phase(kw, card, per_route, k1_adaptive["err"])
    k1_safa = safa_phase(kw)
    span_phase(kw)
    k1_safa_train, k2_safa_train = train_safa_phase(kw)
    train_span_phase(kw)
    k1_evaluation = evaluation_phase(kw)
    k1_bench = bench_phase(kw, totals)
    k1_sweep = sweep_phase(kw, card)
    k1_triplet = triplet_phase(kw, card)
    k1_ingest, ingest_tmp = ingest_phase(kw, card)
    try:
        k1_data, k2_data = data_phase(kw, card, Path(ingest_tmp.name) / "processed")
        k1_calibration = calibration_phase(kw, card)
        k1_mamba, k2_mamba = mamba_train_phase(kw, card)
        k1_export = export_phase(kw, card, rife_npz)
        k1_scaleout, k2_scaleout = scaleout_phase(kw, card)
        k1_study, study_tmp = blind_study_phase(kw, card, Path(ingest_tmp.name) / "data")
        try:
            k1_step26 = study_slice_phase(kw, card, vfi, rife_npz, gate_json,
                                          Path(ingest_tmp.name), Path(study_tmp.name))
        finally:
            study_tmp.cleanup()
        k1_step27, k1_tiled, k2_tiled = last_slice_phase(kw, card, Path(ingest_tmp.name))
    finally:
        ingest_tmp.cleanup()
    print(f"wall {time.perf_counter() - wall0:.2f} s")
    # each kernel's launches counted on every path that runs it, and the
    # device time of exactly those launches
    print(json.dumps({"kernels": [
        kernel_entry("warp_windowed", [k1_flagship, k1_stream_flagship, k1_train, k1_adaptive,
                                       k1_stream_adaptive, k1_safa, k1_safa_train, k1_evaluation,
                                       k1_bench, k1_sweep, k1_triplet, k1_ingest, k1_data,
                                       k1_calibration, k1_mamba, k1_export, k1_scaleout,
                                       k1_study, k1_step26, k1_step27]),
        kernel_entry("warp_windowed_grad", [k2_train, k2_safa_train, k2_data, k2_mamba,
                                            k2_scaleout]),
        kernel_entry("warp_tiled", [k1_tiled], "vfisr_tpu_torch/csrc/warp_tiled.cu"),
        kernel_entry("warp_tiled_grad", [k2_tiled], "vfisr_tpu_torch/csrc/warp_tiled.cu")]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
