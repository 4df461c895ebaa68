#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (`loltracer_tpu_torch`) on one
NVIDIA GPU: every kernel against its plain version and its twins, every
entry point's launches, every kernel's bound and device time, and the
CUDA-event timing of the kernels that no benchmark cell runs
(BENCHMARK.json's cells time K1, K1r / K2, K3 / K4x / K4xb, K5 and K5r /
K6 end to end on their paths).

    python3 chip_smoke.py
    python3 chip_smoke.py --march-ab   # K3 / K4 alone: checks, K4's times, host time
    python3 chip_smoke.py --bench      # phase 39 alone: cli bench on every route
    python3 chip_smoke.py --scaling    # phase 40 alone: the weak-scaling harness

Phases, one line each:

0. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
1. build the fused forward kernel for the four example structures (nvcc,
   at first use, into loltracer_tpu_torch/_build/), and its twins built
   with `shadow_cull=False` (the shadow segment cull left out);
2. kernel vs its plain PyTorch version on the card: the four examples at
   97x161 (ragged edges), scene4 with antialiasing and scene2 with a custom
   config; |diff| <= 5e-5 on every pixel but at most max(2, 1e-4 * pixels)
   (and whether it is bitwise); the image bitwise its shadow_cull=False
   twin's; the share of lanes the cull skips per light (the plain flags);
3. the main path: `loltracer_tpu_torch.cli render examples/scene4.lol
   --size 1920x1080`, which must launch the kernel; its image must be
   finite, in [0, 1], bitwise the twin's and match the plain version at
   1920x1080 to the tolerance of phase 2;
4. the segment cull at scene4 @1920x1080: the culled share of lanes per
   light, the plain loops' SDF evaluations a ray with the cull (culled
   lanes started done) and without (K1's bound from them);
5. build the training kernels (lol_train_fwd, lol_train_bwd and its reduce)
   for the four example structures with envelope shadows and for scene4
   with antialiasing, and their shadow_cull=False twins; all builds start
   together in phase 1, one nvcc each; ptxas registers and spills of
   scene4's kernels and of scene4 AA's lol_train_bwd, whose resident warps
   a SM the occupancy calculator gives;
6. lol_train_fwd vs lol_render_fused, its twin and its plain version at
   97x161 on those five cases: the image bitwise equal to lol_render_fused's,
   image and residual planes bitwise the twin's, and within the phase-2
   rule of the plain one; hit and material equal and t_sh, res, t* within
   1e-4 * max(1, |x|) on all but max(2, 1e-4 * pixels) pixels; the IFT
   denominator within rtol 1e-4 on hit pixels with |den| > 1e-2;
7. lol_train_fwd at the main path's shape, scene4 AA at 1920x1080, held
   the same way as in phase 6 (its culled share printed); then
   lol_train_bwd vs its plain version on the kernel's own residuals and a
   seeded cotangent, the five cases at 97x161 and scene4 AA at 1920x1080:
   every field within 1e-4 * max|grad|, dcam within rtol 2e-3 (atol 1e-5
   * max(1, max|dcam|)), and two launches bitwise equal;
8. the training path: `fit_scene` on scene4 @1920x1080 with antialiasing
   and envelope shadows, sphere points trainable, 5 Adam steps, against the
   port's render of scene4 with its sphere points moved, through the
   row-sharded step of parallel/sharded.py on a mesh of one rank (a world
   of one, made by fit_scene), under a CUDA-only torch.profiler in a
   process of its own (`chip_smoke.py --profile-fit`): the device trace
   must show each training kernel once a step; the step must run its first
   call eagerly, capture on the second and replay the graph on it and on
   the other three (`train_step.*`), the wrappers count the eager step's
   launches, each with its row table (the capture launches nothing, a replay
   launches without them), and the loss must fall; from that trace the
   device ms a launch of K1r, K2 and K2's reduce; K1's device ms over one
   frame (`chip_smoke.py --profile-fused`, a process of its own); the
   bounds of K1, K1r and K2 by operations and sqrt-weighted;
9. build lol_instanced_render (the instanced tier, started with the other
   builds in phase 1; its search the cell grid of csrc/grid_scene.cuh, with
   the run walk alone and the counting grid as check entries) for clamp 2,
   exact, clamp 2 + AA and clamp 2 with shadow clamp 8; ptxas registers and
   spills of the three;
10. lol_instanced_render vs its plain version at 97x161: instanced:10000 in
   those four configs, and instanced:1 and instanced:300 (seed 9) at clamp
   2, by the phase-2 rule, and bitwise the run walk's image;
11. the main path: `loltracer_tpu_torch.cli render instanced:10000
   --step-clamp 2 --size 1920x1080`, which must launch the kernel exactly
   once; its image finite, in [0, 1], equal to the PNG, and within the
   phase-2 rule of the plain version on three full-width 16-row bands (top,
   middle, bottom), each rendered through the camera pack's row0; the plain
   loops count SDF evaluations and, per evaluated point on those bands, the
   spheres within its cut and the runs whose bounding ball reaches within
   it (the work model of the instanced bounds of phases 21, 24 and 29);
12. the 1080p image bitwise the run walk's at clamp 2 and exact, and bitwise
   the counting twin's, with the share of grid searches that fell back to
   the walk; device time by kernel over one frame (`chip_smoke.py
   --profile-instanced`, a process of its own); K5's bound;
13. build lol_instanced_fwd and lol_instanced_bwd (the instanced training
   pair, both over the cell grid, with lol_instanced_bwd's run-walk and
   counting twins; started with the other builds in phase 1) for clamp 2,
   exact and clamp 2 + AA with envelope shadows; ptxas registers and
   spills;
14. at 97x161, instanced:10000 in those three configs and instanced:300
   and :1 at clamp 2: lol_instanced_fwd's image bitwise
   lol_instanced_render's, its residual planes by the phase-6 rule against
   the plain version; lol_instanced_bwd over the grid bitwise
   lol_instanced_bwd_walk and a second launch in its records, grads and
   sphere table, the sphere table bitwise its records summed per row in
   increasing record index (`serial_row_sums`), and vs the plain version
   on the kernel's residuals and a seeded cotangent by the phase-7 rule,
   the sphere table (x y z r per sorted row) included;
15. the main path: `fit_scene` on instanced:10000 @1920x1080, clamp 2,
   envelope shadows, sphere points trainable, 3 Adam steps against K5's
   render with the spheres moved, through the sharded step on a mesh of
   one rank: one launch of each kernel (each with its row table) and one
   cell grid built per step, and the loss falls. Then both kernels against the
   plain version on two full-width 16-row bands through the camera pack's
   row0 (the bands' launches bitwise the frame's rows), and
   lol_instanced_bwd's full-frame launch, held as in phase 14 against its
   walk twin and its records, and against the plain version run on every
   16-row band of the frame and summed, by the phase-7 rule;
16. one fwd+bwd step of `make_instanced_training_renderer` builds one
   cell grid; lol_instanced_bwd's grid searches (its counting twin, bitwise
   the kernel: searches, fallbacks, entries read), the records per
   sphere-table row, its ptxas lines; device time by kernel over one step
   (`chip_smoke.py --profile-instanced-train`, a process of its own); the
   bounds of K5r and K6;
17. build the value march kernels (K3 `lol_march` and K4 `lol_shadow_march`
   for the four examples and their `shadow_cull=False` twins;
   `lol_march_instanced` and `lol_shadow_march_instanced` for clamp 2,
   exact and shadow clamp 8, at every lane-group width of
   `cuda_scene.MARCH_LANES`; all started with the other builds in phase 1);
   ptxas registers and spills of scene4's pair and its twin's and per lane
   width (a lane group must not spill);
18. at 97x161 (instanced:10000 at 49x81), K3 vs its plain version
   (`march_values_reference`) on the camera rays and K4 vs its plain
   version (`shadow_values_reference`) on the real shadow rays of each
   light: the four examples and scene4 AA bitwise, K4 also its
   shadow_cull=False twin, the culled plain loops bitwise the unculled,
   with the share of lanes culled per light; instanced:10000 at clamp 2,
   exact and shadow clamp 8, instanced:300 and :1 at clamp 2 at every
   compiled lane width, bitwise expected, else within atol/rtol 1e-4 on
   all but max(2, 1e-4 * rays);
19. main path A: `loltracer_tpu_torch.cli fit examples/scene4.lol --target
   T.npy --steps 3 -o ...` (AA, exact shadows; sphere points trainable,
   lr 3e-2) against scene4 with its sphere points moved, rendered by
   lol_render_fused at 1920x1080: exactly one K3 launch per step and one
   for `-o`, one K4x a light in each and one K4xb a light a step (the
   exact shadow's kernels), no K4; the three losses fall; peak memory.
   Then K4x / K4xb against their plain versions on each light's shadow
   rays of scene4 AA at 960x540 and 1920x1080 (`exact_checks`): K4x's res
   bitwise the loop's, K4's and its twin's; K4xb's g_ro / g_rd within
   1e-4 of the largest on all but 4 rays, its summed g_fields within 4e-6
   of the float64 total of the plain version's float32 terms in units of
   their magnitudes (a launch missing one tile's rays outside it), two
   launches bitwise; SDF evaluations a ray, the bounds by operations (K4x
   as K4: the segment bound on every ray, E + 17 a step; K4xb that, and
   the sweep, E + adjoint_ops + 30, a step) and sqrt-weighted, and ptxas;
   their `kernels` entries take phase 19's launches and phase 20's device
   times;
20. main path B: `render_image` of scene4 @1920x1080 with AA and envelope
   shadows under autograd: one K3 and two K4 launches; the image within
   the phase-2 rule of lol_render_fused's; MSE gradients, the penumbra band
   masked out of the loss (tests/_penumbra.py), within 2e-2 * max|grad|
   per field of make_training_renderer's (K1r/K2). Then path B's step
   (median of 2) timed; K3 and, per light, K4 at path B's rays held
   bitwise against their plain versions (K4 also its shadow_cull=False
   twin), the plain loops counting each ray's SDF evaluations with the
   cull and without (K3's evaluations, K4's culled share and both warp
   efficiencies from them); CUDA events (median of 10): each light's K4 in
   turns with its twin (twin, kernel, kernel, twin), its plain version
   once; the host time per call of shadow_values and the renderer's shadow
   function (`host_us`, 100 calls); device time of K3, of each light's K4
   and twin, and of each light's K4x and K4xb call on the same rays
   (`chip_smoke.py --profile-march`, a process of its own); K3's and K4's
   bounds by operations and sqrt-weighted (counting K4's segment bound on
   every lane);
21. main path C: `render_image_banded` of instanced:10000, clamp 2, envelope
   @1920x1080 in 16-row bands without autograd: 68 lol_march_instanced and
   136 lol_shadow_march_instanced launches, the image within the phase-2
   rule of lol_instanced_render's; fwd+bwd of three 16-row bands (each the
   banded renderer's band body, `render_rays` over that band's rays)
   against K5r/K6 on the same band by phase 20's gradient rule; `fit_scene`
   on instanced:300 @48x81 with exact shadows, 2 steps, one K3 launch per
   band forward and one per band recompute; the instanced kernels held and
   timed on the middle band at the width `march_kernels.lanes_for` picks
   there (median of 5; plain once), their bounds; every compiled width on
   the middle band (held against the plain version), the middle half of
   the frame and the whole frame (the camera rays and light 0's shadow
   rays; held against width 1), timed (band median of 5, the others of 3),
   with the width the rule picks at each size; device time by kernel
   (the `--profile-march` process of phase 20) over one path B step, one
   round of K3, K4 and the instanced pair and path C's middle band, and one
   path B step's peak memory by allocating line.

22. build the regrouped instanced forward K9 (`lol_rg_march`,
   `lol_rg_shadow` and `lol_rg_shade` over the cell grid, their run-walk
   twins, the counting launches of the walk and of the grid; started with
   the other builds in phase 1) for clamp 2, exact, clamp 2 + AA and shadow
   clamp 8, ptxas registers and spills of every kernel;
   at 97x161, on phase 10's instanced cases, the three kernels over the
   grid bitwise their walk twins, each kernel against its plain
   version (`march_track_reference`: hit and material equal, the rest by
   phase 18's rule; `shadow_sorted_reference` per light over the Morton
   order; `shade_planes_reference` by the phase-2 rule), and the
   pipeline's image bitwise `lol_instanced_render`'s;
23. main path D: `make_instanced_renderer_regrouped` of instanced:10000
   @1920x1080, clamp 2 and exact: one cell grid built, one lol_rg_march,
   one lol_rg_shadow per light and one lol_rg_shade, no walk twin and no
   lol_instanced_render; the image bitwise lol_instanced_render's. At
   clamp 2, lol_rg_march and lol_rg_shade bitwise their walk twins and
   lol_rg_shadow's planes equal sorted and in pixel order (the identity
   permutation), over the grid and the walk; lol_rg_shade's grid searches
   at clamp 2, clamp 2 + AA and exact (its counting twin). Then (CUDA
   events, median of 3): lol_rg_march and its walk twin, the grid build,
   the glue (`hit_box`, the Morton keys and argsorts), lol_rg_shade and
   its walk twin, the frame, lol_rg_shadow per light sorted and
   unsorted over the grid and the walk, lol_instanced_render in the same
   call, and the exact frame beside lol_instanced_render's;
   `shadow_gather_stats` per light sorted and unsorted over the grid
   (searches, fallbacks, list entries, distinct lists per warp step) and
   over the walk; device time
   by kernel and the idle share (`chip_smoke.py --profile-regroup`, a
   process of its own); the plain version on the middle 16-row band
   (through the pack's row0, the band launch bitwise the frame's rows),
   the pieces timed on it;
24. the bounds of the three K9 kernels, lol_rg_shadow's for each light;
25. path E, run right after phase 1, before any bound:
   `loltracer_tpu_torch.cli peak` at full size (its record into a
   temporary file), the measured FMA rate between 95 % and 105 % of the
   modelled ceiling 132 SMs x 128 lanes x 2 flops x the card's maximum SM
   clock; the three chain kernels bitwise the plain chains on the full
   lane count at 8 iterations (the fused and mul + add plain chains
   differing); device time of one full-size call of each chain
   (`chip_smoke.py --profile-peak`, a process of its own);
26. build K7, `lol_instanced_eval` (for step clamps 2, none and 8, started
   with the other builds in phase 1; over the cell grid, with the run walk
   and the counting grid as check entries); its registers and spills; at
   the 97x161 camera points (a quarter, half and all of the way to the
   plain march's hits) and shadow points (0, a tenth and half of the way
   to each light, at most 30 units) against its plain version
   (`instanced_eval_reference`) and bitwise the run walk: instanced:10000
   at clamp 2, exact and clamp 8, and the second shard of instanced:10001
   padded over 2 (one sentinel sphere) under the AABB of all its spheres;
   bitwise expected, else by phase 18's rule;
27. the main path of object sharding: `make_object_sharded_renderer` of
   instanced:10000 @1920x1080, clamp 2, `march_backend="pallas"`, over
   `make_mesh()` (a world of one rank, NCCL): K7 launched for every `sdf`
   / `shadow_sdf` evaluation and its plain version never; the image
   bitwise lol_instanced_render's (else by phase 2's rule). The frame
   (CUDA events, median of 2), the plain sharded `sdf_id` at the 2.07 M
   hit points and one K7 launch there (median of 5; over the grid the
   renderer builds once a frame, its build timed apart, and over the run
   walk in turns around it, bitwise equal) and its plain version, timed
   apart; device time by kernel and the idle share over one frame
   (`chip_smoke.py --profile-objects`, a process of its own);
28. the same renderer over two ranks on the one card (`chip_smoke.py
   --objects-rank`, two processes, gloo through the host; NCCL refuses two
   ranks on one device) at 480x272: its image bitwise the one-rank image
   of phase 27's world (else by phase 2's rule);
29. K7's bound at the hit points: 16 bytes a point, and 22 operations a
   point + 9 for each sphere within the cut there (phase 16's model, the
   spheres counted on the card);
30. the cell grid (`grid_phase`): K7 over the grid bitwise K7 over the run
   walk on a full 1080p frame of points (the hit points, the camera rays at
   a quarter and half of the way, each light's shadow rays at 0, a tenth
   and half of the way) under step clamps 2, none and 8, with the share of
   searches that fell back; the cell-size sweep (0.5, 1 and 2 units): the
   build's time, the lists' lengths, K5 @1080p clamp 2 over each grid (its
   image bitwise, its fallback share) and K7 at the hit points;
31. the row table (`rowtab_phase`): K1r and K2 launched with the table
   rowtab[k] = 8k bitwise their launches without one (image, residual
   planes, dcam, dfields) on the five phase-6 cases at 97x161 and scene4
   AA at 1920x1080, K5r and K6 with 16k bitwise theirs (records and dsph
   included) on instanced:10000 clamp 2 at 97x161 and 1920x1080; the LPT
   deal of scene4 AA and of instanced:10000 clamp 2 at 1920x1088 over 2
   shards (the cost model run on the card) rendered as two launches, one a
   shard's table: each launch's rows bitwise the full frame's, the summed
   gradients within the phase-7 rule of the full frame's;
32. two ranks on the one card (`chip_smoke.py --sharded-rank`, two
   processes, gloo: a correctness phase, NCCL refuses two ranks on one
   device): `make_sharded_renderer` and 3 (scene4 AA envelope) / 2
   (instanced:10000 clamp 2 envelope) `make_sharded_train_step` steps at
   1920x1088 over `make_mesh(2)` with the LPT deal, against one rank in
   this process: both ranks' images bitwise the one-rank image, each loss
   within rtol 1e-5, the first step's gradient within the phase-7 rule,
   the params bitwise equal across ranks; each rank's fwd + bwd over its
   rows timed alone (the card's view of the deal's balance);
33. checkpoints: `fit_scene` on scene4 AA @1920x1080, 4 steps, bitwise 2
   steps and a resume to 4 (`checkpoint_every=2`: losses and params);
   `cli fit --checkpoint` at 480x270 resumes at step 1; a corrupt
   checkpoint refused;
34. `cli stats` at 320x240 on the card: scene4 against the CPU run (the
   count planes equal on all but max(2, 1e-3 * pixels) pixels, off by at
   most 1; whether the JSON is equal), instanced:10000 through K7's
   counts equal to the plain SDF's on the card;
35. the golden oracle: `cli render --backend golden` (float64 NumPy, on
   the CPU, no launch) against `cli render --backend pallas` (one K1
   launch each) on the four examples, every pixel within atol 2e-4 at
   32x24 (the JAX package's tolerance) and max |diff| and pixels over
   printed at 97x161; K5 on instanced_spheres(150, seed=3) at 32x24
   within 3e-4 of the oracle;
36. `cli roofline` at 1920x1080: scene4 fwd (K1), scene4 fwdbwd (K1r +
   K2), instanced:10000 clamp 2 fwd (K5); each kernel launched exactly 1
   + 3 times (warm-up + reps), the peak read from
   artifacts/gpu_peak.json, the fraction of it in (0, 1.05] for scene4
   (the instanced record's operation model prices an evaluation at every
   sphere, K5 searches the cell grid: its fraction is printed, above 1);
   each record printed;
37. the viewer: `SizeAdaptiveRenderer` frames of scene4 at 160x90 after
   `move_camera` with w, right and space, one lol_render_fused launch
   each, bitwise `make_cuda_renderer` at the moved camera and within the
   phase-2 rule of the plain version, then a resize that re-resolves;
   `cli view examples/scene4.lol --size 160x90` in a child on a pty, fed
   w, d, right, q: exit 0 within 120 s after at least two frames;
38. the native parser (`lol/native.py`) built with g++: its AST equals
   the Python parser's on the four examples;
39. `cli bench` (loltracer_tpu_torch/bench.py: the root bench.py's routes
   on the port), one child process a route, BENCH_REPS=3: scene4
   @1920x1080 fwd (K1), fwdbwd (K1r + K2) and fwdbwd with BENCH_AA=1;
   instanced:10000 clamp 2 @1920x1080 fwd (K5), fwd with BENCH_REGROUP=1
   (K9) and fwdbwd (K5r + K6); the two routes of plain glue at a cut
   size, printed: jnp fwdbwd on scene4 at 480x272 (K3 / K4, path B) and
   the banded jnp fwd on instanced:10000 at 1920x48 (three 16-row bands,
   K3i / K4i, path C). Each record parses and its metric is bench.py's
   label; each kernel of the route launched (1 + reps x frames) x its
   launches a frame and no other counter moved; in this process
   `bench.build`'s scalar is bitwise the same renderer's called directly
   (phases 2, 8, 12, 16, 19-21 and 23 hold those renderers against their
   plain versions), and the best sample's time a frame is at least 0.95 x
   the least time of the route's kernels launched alone on its inputs
   just before (CUDA events);
40. the weak-scaling harness (loltracer_tpu_torch/bench_scaling.py: the
   root bench_scaling.py's ladders on the port), one child process of
   `python -m loltracer_tpu_torch.bench_scaling` a ladder, SCALE_OUT in a
   temporary directory: the device-time ladder (SCALE_DEVICE_TIME=1) at
   SCALE_ROWS 128 x 1920 (n = 8 is 1024 x 1920) for scene4 under the LPT
   and the contiguous deal and for instanced:10000 clamp 2 under LPT. Each
   rung's deal and row tables those this process makes from the cost
   model counted here, each band's launches exactly (1 + 3) x frames of
   K1r and K2 (K5r and K6), band_s the best sample's device time (the
   profiler's kernels of the sample), each sample's device time inside
   its CUDA-event window, the record's efficiency from them and the
   ladder in SCALE_OUT; the measured efficiency printed beside the
   (8, 128)-tile model's for the same deal; the 8-shard rung's slowest
   band's scalar bitwise the training renderer's called directly on its
   table. Then the wall ladder over the machine's world of one (scene4
   fwdbwd, one rung, whose train step is one CUDA graph from its second
   call): the wrappers count 2 K1r launches (the target and the eager
   warm-up step) and 1 K2 (the capture launches nothing, the timed steps
   replay the graph), every step's loss the same (the params restored),
   its record.

The CLI phases (3, 11) pass `--backend pallas`: `cli render` defaults to
the differentiable renderer, as the JAX package's does.

Then a JSON line with each kernel's launches on its main path, error,
bound and device time, and, for the kernels no benchmark cell runs, its
CUDA-event times (an entry of a kernel a cell times names the cell under
`timed_by` and has no `ms`), and last the line {"ok": true, "device":
{...}}. Any failure
raises: the traceback is printed, the exit code is not 0 and the last line
is not printed. Without CUDA, or without the package beside this file, it
fails the same way.

The march kernels' launches in the `kernels` line are those of their main
paths: lol_march in path A (its device time and bound at path B's rays),
lol_exact_shadow and lol_exact_shadow_bwd in path A (their device times
and bounds the mean of the two lights' at 1920x1080, each size's bounds
under `sizes`), lol_shadow_march in path B (its `ms`,
`plain_ms`, `device_ms` and bounds the mean of the two lights' launches,
each light's under `lights`, with its twin's times, culled share,
evaluations a ray and warp efficiency; its sqrt-weighted bound and
wrapper host times), the instanced pair in path C's frame (their `ms` per
16-row band at the rule's `lanes`, `frame_ms` one full-frame launch at the
rule's `frame_lanes`, `sweep_ms` [band, half frame, frame] per width);
the instanced training pair's those of phase 15's `fit_scene` (lol_instanced_bwd
with its fallback share and entries per search); the K9 kernels'
those of path D's clamp-2 frame (their `ms` per launch over the grid
beside their walk twins' `walk_ms`, lol_rg_shadow for light 0 sorted
beside `unsorted_ms` and, under `lights`, each light's times and bound;
lol_rg_shade's entry carries the frame, the glue, K5's time, the exact
frame's and the fallback shares of its searches);
K1r / K2 / K5r / K6 also carry `scaling` (phase 40: each ladder's rungs,
band_s, measured and modelled efficiency; K1r the wall rung) and `rowtab`:
their launches with the row table on the main path (phases 8 and 15) and
`bitwise` (phase 31); K1r and K5r `deal` (phase 31) and `two_ranks`
(phase 32: each rank's fwd + bwd ms alone and their balance);
K8's those of `cli peak` (its `ms` the best full-size call, `device_ms`
the profiler's, `plain_ms` at `plain_ms_iters` iterations); K7's those of
phase 27's frame (its `ms` one launch at the frame's hit points, beside
`frame_ms` and `sdf_id_ms`).

A kernel's bound is the least time the card could take for its work: the
larger of its bytes (inputs read once, outputs written once) over 3.35 TB/s
and its FP32 operations over the modelled FP32 ceiling of this card (132
SMs x 128 lanes x 2 flops x its maximum SM clock from nvidia-smi), which
phase 25's measured FMA rate confirms. Operations
are counted with an operation model (`sdf_ops` per SDF evaluation of the
generated code, a fixed count per pixel for the rest) times the SDF
evaluations this run's rays need, counted by the plain version's own march
and shadow loops on the card (their `live` counts).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import typing
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXAMPLES = ROOT / "examples"
SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
ATOL = 5e-5
MAIN_W, MAIN_H = 1920, 1080
BAND = 16  # rows of each 1080p band held against the plain version
HBM_BYTES_PER_MS = 3.35e12 / 1e3  # H100 SXM
PEAK_LOW, PEAK_HIGH = 0.95, 1.05  # the measured FMA rate over the modelled ceiling


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def compare(kernel_img, plain_img, what: str):
    """(max |diff|, pixels over ATOL); raises beyond the tolerance."""
    import torch

    require(kernel_img.shape == plain_img.shape, f"{what}: shapes differ")
    require(bool(torch.isfinite(kernel_img).all()), f"{what}: non-finite pixels")
    diff = (kernel_img - plain_img).abs()
    max_err = float(diff.max())
    over = int((diff > ATOL).any(dim=-1).sum())
    pixels = kernel_img.shape[0] * kernel_img.shape[1]
    allowed = max(2, int(1e-4 * pixels))
    if over > allowed:
        bad = (diff > ATOL).any(dim=-1).nonzero()[:8].tolist()
        detail = "; ".join(
            f"(y={y}, x={x}) kernel {kernel_img[y, x].tolist()} plain {plain_img[y, x].tolist()}"
            for y, x in bad
        )
        raise RuntimeError(
            f"{what}: {over} pixels differ by more than {ATOL} (allowed {allowed}); "
            f"max |diff| {max_err:.3g}; first: {detail}"
        )
    return max_err, over


def check_residuals(k_res, p_res, what: str) -> str:
    """Residual planes of lol_train_fwd vs its plain version: hit and
    material equal and t_sh, res, t* within 1e-4 * max(1, |x|) on all but
    max(2, 1e-4 * pixels) pixels; den within rtol 1e-4 on hit pixels with
    |den| > 1e-2. Raises beyond; returns a summary."""
    import torch

    require(k_res.shape == p_res.shape, f"{what}: residual shapes differ")
    pixels = k_res.shape[1] * k_res.shape[2]
    allowed = max(2, int(1e-4 * pixels))
    counts = []
    for i in range(k_res.shape[0]):
        a, b = k_res[i], p_res[i]
        if i in (1, 2):
            bad = a != b
        elif i == 3:
            live = (p_res[1] > 0.5) & (k_res[1] > 0.5) & (b.abs() > 1e-2)
            rel = torch.where(live, (a - b).abs() / b.abs(), torch.zeros_like(b))
            require(float(rel.max()) <= 1e-4,
                    f"{what}: den beyond rtol 1e-4 on {int((rel > 1e-4).sum())} hit "
                    f"pixels, max rel {float(rel.max()):.3g}")
            counts.append(0)
            continue
        else:
            bad = ~((a == b) | ((a - b).abs() <= 1e-4 * torch.clamp_min(b.abs(), 1.0)))
        n = int(bad.sum())
        require(n <= allowed, f"{what}: residual plane {i} differs on {n} pixels "
                              f"(allowed {allowed})")
        counts.append(n)
    return "pixels over tolerance per plane " + str(counts)


def time_ms(fn, reps: int) -> float:
    """Median of `reps` calls of fn, each timed with CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_lines(log: str):
    """(kernel, "N registers, M bytes spill stores, K bytes spill loads")
    per compiled entry function of an nvcc -Xptxas -v log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m and "rg_" in m.group(1):  # K9: the search, and whether it counts
            grid = re.search(r"GridSceneI\w*?Lb([01])E", m.group(1))
            view = re.search(r"Li(\d+)EJ", m.group(1))  # rg_shadow_kernel's RgShadowView
            counting = grid.group(1) == "1" if grid else bool(view) and view.group(1) != "0"
            kind = next(x for x in ("rg_march", "rg_shadow", "rg_shade") if x in m.group(1))
            name = (f"{kind}_kernel ({'grid' if grid else 'walk'}"
                    f"{', counting' if counting else ''})")
        elif m and "march" in m.group(1):  # K3 / K4: march_kernel<kShadow, ...>
            coop = re.search(r"WarpGroupILi(\d+)E", m.group(1))  # the lane-group kernels
            lanes = coop.group(1) if coop else "1" if "instanced" in m.group(1) else None
            tile = re.search(r"SceneELi(\d+)E", m.group(1))  # the compiled warp tile width
            name = ("lol_shadow_march" if "ILb1E" in m.group(1) else "lol_march") + (
                f"_instanced @{lanes} lanes" if lanes else
                f" @{tile.group(1)}x{32 // int(tile.group(1))}" if tile else "")
        elif m:
            name = next(k for k in ("instanced_fwd_kernel", "instanced_bwd_kernel",
                                    "instanced_eval_kernel",
                                    "fused_fwd_kernel", "fused_bwd_kernel",
                                    "bwd_reduce_kernel", "rec_count_kernel",
                                    "rec_part_kernel", "rec_row_kernel", "rec_start_kernel",
                                    "rec_cursor_kernel", "rec_place_kernel",
                                    "rec_sum_kernel", m.group(1))
                        if k in m.group(1))
            if name in ("instanced_fwd_kernel", "instanced_bwd_kernel", "instanced_eval_kernel"):
                # the search: the cell grid (its counting twin), or the run walk
                grid = re.search(r"GridSceneI\w*?Lb([01])E", m.group(1))
                name += (" (walk)" if not grid else
                         " (grid, counting)" if grid.group(1) == "1" else " (grid)")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m2 = re.search(r"Used (\d+) registers", line)
        if m2 and name:
            out.append(f"{name}: {m2.group(1)} registers, {spill}")
            name = None
    return out


def sdf_ops(structure) -> int:
    """FP32 operations of one SDF evaluation, counted on the generated code
    (+ - * / sqrt abs min max and a compare-select each 1): sphere 10, box
    23, plane 1, smooth-min 16 on top of its children, and n - 1 for the
    min over objects."""
    def node(n):
        kind = n[0]
        if kind == "smin":
            return 16 + node(n[2]) + node(n[3])
        return {"sphere": 10, "box": 23, "plane": 1}[kind]

    return sum(node(n) for n in structure.objects) + len(structure.objects) - 1


def sdf_sqrts(structure) -> int:
    """IEEE sqrtf of one SDF evaluation of the generated code: one a sphere
    or box."""
    def node(n):
        if n[0] == "smin":
            return node(n[2]) + node(n[3])
        return 1 if n[0] in ("sphere", "box") else 0

    return sum(node(n) for n in structure.objects)


def seg_cost(structure):
    """(operations, sqrtf) of one Scene::segment_lit, counted on the
    generated code as sdf_ops counts: seg_dist 22 with 1 sqrt, a sphere 23,
    a box 30 with 2 sqrt, smooth-min 3 on top of its children, a plane 8,
    and 4 a bounded object for its test."""
    def node(n):
        kind = n[0]
        if kind == "smin":
            a, b = node(n[2]), node(n[3])
            return 3 + a[0] + b[0], a[1] + b[1]
        return {"sphere": (23, 1), "box": (30, 2), "plane": (8, 0)}[kind]

    costs = [node(n) for n in structure.objects]
    bounded = sum(1 for n in structure.objects if n[0] != "plane")
    return sum(c[0] for c in costs) + 4 * bounded, sum(c[1] for c in costs)


def culled_shares(structure, cam, fields, res, cfg):
    """Per light, the share of a frame's lanes whose shadow march the
    segment cull skips: the plain flags (shading.segment_lit) on the shadow
    rays from the residual planes' shading distance res[0]."""
    import torch

    from loltracer_tpu_torch.render.camera import rays_from_pack
    from loltracer_tpu_torch.render.fused_train import _params_of
    from loltracer_tpu_torch.render.shading import segment_lit

    params = _params_of(structure, cam, fields)
    ro, rd = rays_from_pack(cam, torch.arange(res.shape[1], device=cam.device), res.shape[1],
                            res.shape[2])
    with torch.no_grad():
        return [float(segment_lit(structure, params, so, ld, dist, cfg.shadow_w).float().mean())
                for so, ld, dist in shadow_rays(params, ro, rd, res[0], cfg)]


def warp_efficiency(counts, tile_w: int) -> float:
    """The share of a warp's lane-steps that do work when each warp of 32
    lanes is a tile_w x (32 / tile_w) tile of the per-ray SDF evaluation
    counts [H, W] and runs as long as its longest ray (lanes past the
    frame's edge idle): sum / (32 x the sum over warps of their max)."""
    import torch

    th = 32 // tile_w
    h, w = counts.shape
    c = torch.nn.functional.pad(counts.float(), (0, -w % tile_w, 0, -h % th))
    c = c.reshape(c.shape[0] // th, th, c.shape[1] // tile_w, tile_w)
    worst = c.amax(dim=(1, 3))
    return float(counts.sum()) / float(32 * worst.sum())


def profile_steps(step, n: int, split=()) -> str:
    """Device time per step by kernel (torch.profiler, CUPTI), the wall
    time per step on the host clock, and the device's idle share; for each
    name part in `split`, the device time of the kernels whose names hold
    it. One more step runs first, traced and dropped (the profiler's
    warm-up): a profile's first kernel was seen missing from its records
    (the fused FMA chain of `--profile-peak`, the first of its three
    launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(n):
            step()
            if i == n - 1:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / n
            prof.step()
    rows = []
    for e in prof.key_averages():
        # the schedule's step marker spans the step on the device's clock
        if e.device_type != DeviceType.CUDA or e.key.startswith("ProfilerStep"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0) if us is None else us
        rows.append((us / 1e3 / n, e.count // n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    top = "; ".join(f"{ms:.4f} ms x{cnt} {key[:60]}" for ms, cnt, key in rows[:6])
    parts = "".join(
        f"; {part}: {sum(r[0] for r in rows if part in r[2]):.4f} ms in "
        f"{sum(r[1] for r in rows if part in r[2])} kernels" for part in split)
    return (f"wall {wall:.3f} ms/step, device busy {busy:.3f} ms/step in "
            f"{sum(r[1] for r in rows)} kernels, idle {1 - busy / wall:.1%}; top: {top}{parts}")


def profile_instanced(train: bool) -> int:
    """`chip_smoke.py --profile-instanced` / `--profile-instanced-train`:
    torch.profiler over one frame of lol_instanced_render, or one fwd+bwd
    step of make_instanced_training_renderer with envelope shadows
    (instanced:10000, clamp 2, MAIN_W x MAIN_H), one line on stdout.
    Phases 12 and 16 run it as a process of its own: a second profiling
    session in one process reported no device events (torch 2.11 on an
    H100 machine)."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render import instanced_fwd
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced
    from loltracer_tpu_torch.render.instanced_train import make_instanced_training_renderer
    from loltracer_tpu_torch.scenes import instanced_spheres

    sc = instanced_spheres(n=10_000, device=torch.device("cuda", 0))
    if train:
        cfg = RenderConfig(step_clamp=2.0, shadow_grad="envelope")
        render = make_instanced_training_renderer(sc.structure, MAIN_H, MAIN_W, cfg,
                                                  device=torch.device("cuda", 0))
        leaves = dataclasses.replace(
            sc.params, sphere_point=sc.params.sphere_point.clone().requires_grad_(True))

        def frame():
            ((render(leaves) - 0.5) ** 2).mean().backward()
    else:
        cfg = RenderConfig(step_clamp=2.0)
        cam = camera_pack(sc.params, MAIN_H, MAIN_W, cfg)
        fields, tab = pack_fields(sc.structure, sc.params), pack_instanced(sc.structure, sc.params)

        def frame():
            instanced_fwd.instanced_forward(sc.structure, cfg, cam, fields, tab, MAIN_H, MAIN_W)

    frame()
    # the forward kernel, and lol_instanced_bwd's kernel apart from its
    # scatter's (rec_*, and the memset of its counts)
    print(profile_steps(frame, 1, split=("instanced_fwd_kernel",) + (
        ("instanced_bwd_kernel", "rec_", "Memset") if train else ())))
    return 0


def peak_breakdown(fn) -> str:
    """fn() run under the CUDA allocator's history: the bytes alive at the
    peak of its allocations, by the innermost frame of the port (or of
    torch.autograd's backward) that allocated them, largest first."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
    fn()
    torch.cuda.synchronize()
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])["size"]
    sites = {}
    for ev in at_peak.values():
        frame = next((f"{Path(f['filename']).name}:{f['line']}" for f in ev.get("frames", [])
                      if "loltracer_tpu_torch" in f["filename"]), "autograd / other")
        sites[frame] = sites.get(frame, 0) + ev["size"]
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:6]
    return (f"peak {peak / 2**20:.0f} MiB allocated in the call: "
            + "; ".join(f"{k} {v / 2**20:.0f} MiB" for k, v in top))


def profile_march() -> int:
    """`chip_smoke.py --profile-march`: torch.profiler over one fwd+bwd step
    of path B (render_image, scene4 AA envelope, MAIN_W x MAIN_H), and over
    one round of the four march kernels alone (lol_march and
    lol_shadow_march for light 0 on path B's rays; lol_march_instanced and
    lol_shadow_march_instanced for light 0 on the middle 16-row band of
    instanced:10000 at clamp 2); then one path B step under the allocator's
    history (peak_breakdown); then path C's band body (`render_rays`, no
    autograd) on that middle band; then, a session each (3 calls; a session
    that records no device event is run again, at most three times), the
    device ms of lol_march on path B's rays and, on each light's, of
    lol_shadow_march with the cull and its shadow_cull=False twin, of
    lol_exact_shadow and of a lol_exact_shadow_bwd call (its kernel, reduce
    and gradient fill, a seeded cotangent), as a JSON object. One line on stdout, the five
    joined by " || "."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.camera import camera_rays, camera_rays_for_rows
    from loltracer_tpu_torch.render.torch_renderer import render_image, render_rays
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    dev = torch.device("cuda", 0)
    s4 = build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=dev)
    b_cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    leaves = grad_leaves(s4.params)

    def step():
        ((render_image(s4.structure, leaves, MAIN_H, MAIN_W, b_cfg) - 0.5) ** 2).mean().backward()

    ro4, rd4 = camera_rays(s4.params, MAIN_H, MAIN_W, b_cfg)
    scene4 = mk.pack_march_scene(s4.structure, s4.params)
    m4 = mk.march_values(s4.structure, b_cfg, ro4, rd4, scene4)
    t_sh = torch.where(m4.t < b_cfg.max_dist, m4.t, m4.t_close)
    so4, ld4, dist4 = shadow_rays(s4.params, ro4, rd4, t_sh, b_cfg)[0]
    big = instanced_spheres(n=10_000, device=dev)
    c_cfg = RenderConfig(step_clamp=2.0, shadow_grad="envelope")
    r0 = (MAIN_H - BAND) // 2
    ro, rd = camera_rays_for_rows(big.params, torch.arange(r0, r0 + BAND), MAIN_H, MAIN_W, c_cfg)
    scene = mk.pack_march_scene(big.structure, big.params)
    t = mk.march_values(big.structure, c_cfg, ro, rd, scene).t
    so, ld, dist = shadow_rays(big.params, ro, rd, t, c_cfg)[0]

    def band():
        mk.march_values(s4.structure, b_cfg, ro4, rd4, scene4)
        mk.shadow_values(s4.structure, b_cfg, so4, ld4, dist4, scene4)
        mk.march_values(big.structure, c_cfg, ro, rd, scene)
        mk.shadow_values(big.structure, c_cfg, so, ld, dist, scene)

    def band_c():  # path C's band body on the middle band, no autograd
        with torch.no_grad():
            render_rays(big.structure, big.params, ro, rd, c_cfg, march_scene=scene)

    lights = shadow_rays(s4.params, ro4, rd4, t_sh, b_cfg)
    twin = b_cfg.replace(shadow_cull=False)

    def busy(fn, tries: int = 3) -> float:
        # a session now and then records no device event (seen on the K3
        # session, the fifth of this process): measure again, at most
        # `tries` sessions; the parent fails on a 0 that remains
        for _ in range(tries):
            line = profile_steps(fn, 3)
            ms = float(re.search(r"device busy ([\d.]+) ms/step", line).group(1))
            if ms > 0:
                break
        return ms

    def k4(li, c):
        return lambda: mk.shadow_values(s4.structure, c, *lights[li], scene4)

    # path A's exact shadow (cli fit's config) on the same rays
    x_cfg = RenderConfig(antialias=True)
    x_lib, x_entry = mk.exact_library(s4.structure, x_cfg), mk._exact_entry(s4.structure, x_cfg)

    def k4x(li):
        return lambda: mk._launch(x_entry, s4.structure, scene4, *lights[li], 1)

    def k4xb(li):
        so, ld, dist = lights[li]
        g = torch.randn(dist.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(li))
        return lambda: mk._launch_exact_bwd(x_lib.lib, s4.structure, so, ld, dist,
                                            scene4.fields, g)

    step(), band(), band_c()
    parts = [profile_steps(step, 1), profile_steps(band, 1), peak_breakdown(step),
             profile_steps(band_c, 1)]
    parts.append(json.dumps({
        "k3": busy(lambda: mk.march_values(s4.structure, b_cfg, ro4, rd4, scene4)),
        "k4x": [busy(k4x(li)) for li in range(len(lights))],
        "k4xb": [busy(k4xb(li)) for li in range(len(lights))],
        "k4": [busy(k4(li, b_cfg)) for li in range(len(lights))],
        "k4_twin": [busy(k4(li, twin)) for li in range(len(lights))]}))
    print(" || ".join(parts))
    return 0


def run_profile(*args: str) -> str:
    """A profiling line (profile_march's and the like), from a child
    process run with `args` (it loads the kernels the parent built from the
    build cache)."""
    import torch

    torch.cuda.empty_cache()  # the child needs the memory this process keeps cached
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), *args],
        capture_output=True, text=True, timeout=300,
    )
    require(out.returncode == 0,
            f"the profiling process failed (rc {out.returncode}): {out.stderr[-2000:]}")
    return out.stdout.strip().splitlines()[-1]


def bound(nbytes: float, ops: float, fp32_ops_per_ms: float):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and FP32
    operations / the FP32 ceiling fp32_ops_per_ms (phase 25's)."""
    b, o = nbytes / HBM_BYTES_PER_MS, ops / fp32_ops_per_ms
    return (b, "bytes") if b > o else (o, "operations")


def entry(name, source, replaces, launches, err, ms=None, plain=None, bnd=(None, None),
          timed_by=None):
    """One kernel's object of the `kernels` line; a kernel that a benchmark
    cell times names the cell (`timed_by`) in place of its CUDA-event
    times."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, "timed_by": timed_by}


def penumbra_keep(res, num_lights: int):
    """[H, W, 1] f32 from residual planes [4 + 2L, H, W]: 0 on the penumbra
    band of tests/_penumbra.py (res in (-0.2, 1) for some light, dilated
    by one pixel), where the envelope gradient hangs on near-tied argmins,
    1 elsewhere."""
    import torch

    pen = torch.zeros(res.shape[1:], dtype=torch.bool, device=res.device)
    for li in range(num_lights):
        r = res[4 + 2 * li]
        pen |= (r > -0.2) & (r < 1.0)
    pen = torch.nn.functional.max_pool2d(pen[None, None].float(), 3, stride=1, padding=1)[0, 0]
    return (pen == 0).float()[..., None]


def check_values(got, want, what: str):
    """A march kernel's planes vs its plain version's: bitwise expected;
    else within atol/rtol 1e-4 (infinities equal) on all but max(2, 1e-4 *
    rays). Raises beyond; returns (max |diff| where finite, rays not
    bitwise equal)."""
    import torch

    worst, differ = 0.0, 0
    for i, (a, b) in enumerate(zip(got, want)):
        require(a.shape == b.shape, f"{what}: plane {i} shapes differ")
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        fin = torch.isfinite(a) & torch.isfinite(b)
        diff = torch.where(fin, (a - b).abs(), torch.zeros_like(a))
        bad = ~(same | (fin & (diff <= 1e-4 + 1e-4 * b.abs())))
        allowed = max(2, int(1e-4 * a.numel()))
        require(int(bad.sum()) <= allowed,
                f"{what}: plane {i} off on {int(bad.sum())} rays (allowed {allowed}), "
                f"max |diff| {float(diff.max()):.3g}")
        worst, differ = max(worst, float(diff.max())), differ + int((~same).sum())
    return worst, differ


def same_planes(got, want, what: str) -> None:
    """A march kernel's planes bitwise its reference's (NaNs and -0
    included); raises naming the first plane that differs."""
    for i, (a, b) in enumerate(zip(got, want)):
        require(same_bits(a, b), f"{what}: plane {i} not bitwise "
                                 f"({int((a != b).sum())} values differ)")


def host_us(fn, calls: int = 100) -> float:
    """Host time per call of fn in microseconds: the host clock over
    `calls` calls with no synchronisation inside (the card's queue
    absorbs the launches), the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def march_inputs(dev):
    """Path B's march inputs at MAIN_W x MAIN_H (scene4, AA, envelope):
    (scene, cfg, packed MarchScene, ro, rd, the kernel's march, each
    light's shadow rays (origin, direction, distance) from its hits)."""
    import torch

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.camera import camera_rays
    from loltracer_tpu_torch.scene import build_scene

    s4 = build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=dev)
    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    ro, rd = camera_rays(s4.params, MAIN_H, MAIN_W, cfg)
    scene = mk.pack_march_scene(s4.structure, s4.params)
    m = mk.march_values(s4.structure, cfg, ro, rd, scene)
    t_sh = torch.where(m.t < cfg.max_dist, m.t, m.t_close)
    return s4, cfg, scene, ro, rd, m, shadow_rays(s4.params, ro, rd, t_sh, cfg)


def march_ab() -> int:
    """`chip_smoke.py --march-ab`: K3 and K4 (each light) of the package
    beside this file at path B's rays, held bitwise against their plain
    versions (K4 also its shadow_cull=False twin); K4 timed with CUDA
    events (median of 10, in turns) and by the host clock per call
    (host_us) through shadow_values and through make_cuda_shadow_march's
    function (K3's time is the `scene4-fit-exact-540p` cell's). One JSON
    line on stdout. Run from a checkout of another commit with this file
    copied into it, it times that commit's wrapper and kernel the same way
    (the before / after of PERF.md)."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.render import march_kernels as mk

    dev = torch.device("cuda", 0)
    s4, cfg, scene, ro, rd, m, lights = march_inputs(dev)
    st = s4.structure
    twin = cfg.replace(shadow_cull=False)
    same_planes(m, mk.march_values_reference(st, cfg, ro, rd, scene), "lol_march")
    for li, (so, ld, dist) in enumerate(lights):
        want = mk.shadow_values_reference(st, cfg, so, ld, dist, scene)
        same_planes(mk.shadow_values(st, cfg, so, ld, dist, scene), want,
                    f"lol_shadow_march light {li}")
        same_planes(mk.shadow_values(st, twin, so, ld, dist, scene), want,
                    f"lol_shadow_march twin light {li}")
    out = {"card": card_line()}

    def k4(li, c=cfg):
        return lambda: mk.shadow_values(st, c, *lights[li], scene)

    k4(0)(), k4(1)()
    k4_ms = {li: [time_ms(k4(li), 10)] for li in (0, 1)}
    k4_ms = {li: v + [time_ms(k4(li), 10)] for li, v in k4_ms.items()}
    out["k4_ms"] = [k4_ms[0], k4_ms[1]]
    out["k4_twin_ms"] = [[time_ms(k4(li, twin), 10) for _ in range(2)] for li in (0, 1)]
    shadow_fn = functools.partial(mk.make_cuda_shadow_march(st, cfg), scene=scene)
    shadow_fn(s4.params, *lights[0])
    out["host_us"] = {
        "shadow_values": host_us(k4(0)),
        "shadow_fn": host_us(lambda: shadow_fn(s4.params, *lights[0])),
    }
    print(json.dumps(out))
    return 0


def adjoint_ops(structure) -> int:
    """FP32 operations of one generated Scene::dist_bwd past its forward
    (which sdf_ops counts), as sdf_ops counts them: a sphere's reverse 17,
    a box's 46, a plane's 2, a smooth-min's 36 on top of its children's,
    and 7 for each min over objects (its forward and min_bwd)."""
    def node(n):
        kind = n[0]
        if kind == "smin":
            return 36 + node(n[2]) + node(n[3])
        return {"sphere": 17, "box": 46, "plane": 2}[kind]

    return sum(node(n) for n in structure.objects) + 7 * (len(structure.objects) - 1)


EXACT_W, EXACT_H = 960, 540  # the scene4-fit-exact-540p cell's frame
# K4xb against its plain version: each ray's g_ro, g_rd within 1e-4 of the
# largest on all but EXACT_RAYS_OFF rays; the summed g_fields within
# EXACT_FIELDS_TOL of the float64 total of the plain version's float32
# terms, in units of their magnitudes, at least EXACT_MASS_FLOOR of the
# largest (chip_tests/test_exact_shadow_chip.py's limits and why)
EXACT_RAYS_OFF, EXACT_FIELDS_TOL, EXACT_MASS_FLOOR = 4, 4e-6, 1e-6


def exact_checks(s4, cfg, ceiling, sqrt_slots):
    """Phase 19's check of the exact soft shadow's kernels K4x
    (`lol_exact_shadow`) and K4xb (`lol_exact_shadow_bwd` with K2's
    reduce) on scene4 AA, per light on the shadow rays of K3's shading
    points at the exact cell's 960x540 and at MAIN_W x MAIN_H: K4x's res
    bitwise the plain loop's, K4's and its shadow_cull=False twin's; for a
    seeded signed cotangent, K4xb's g_ro and g_rd within 1e-4 of the
    largest of exact_shadow_reference's on all but EXACT_RAYS_OFF rays, its
    summed g_fields within EXACT_FIELDS_TOL of the reference's float64
    total in units of its terms' magnitudes (beside it the float32
    reference's own sums, and a launch with the 32 x 4 tile of the largest
    g_ro left out, which must fail the limit), two launches bitwise equal;
    SDF evaluations a ray (the plain loop's counts, culled rays started
    done); the bounds by operations (K4x as K4: segment_lit on every ray,
    E + 17 a step; K4xb segment_lit, the march again, E + 17, and the
    sweep, E + adjoint_ops + 30, a step) and sqrt-weighted; ptxas'
    registers and spills. Returns {"build_s", "ptxas", "sizes": {"WxH":
    [one dict a light]}}."""
    import torch

    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.camera import camera_rays
    from loltracer_tpu_torch.render.cuda_scene import packed_size

    st = s4.structure
    twin = cfg.replace(shadow_cull=False)
    t0 = time.perf_counter()
    lib = mk.exact_library(st, cfg)
    out = {"build_s": time.perf_counter() - t0, "sizes": {}}
    out["ptxas"] = [
        f"{'exact_shadow_bwd_kernel' if 'bwd' in m.group(1) else 'exact_shadow_kernel'}: "
        f"{m.group(3)}, {m.group(2)}" for m in re.finditer(
            r"Compiling entry function '(\w*exact_shadow\w*)'.*?"
            r"(\d+ bytes stack frame[^\n]*).*?(Used \d+ registers)", lib.log, re.S)]
    E, S, A = sdf_ops(st), sdf_sqrts(st), adjoint_ops(st)
    seg_ops, seg_sqrts = seg_cost(st)
    small = 4 * packed_size(st)
    scene = mk.pack_march_scene(st, s4.params)
    entry_x, entry_twin = mk._exact_entry(st, cfg), mk._exact_entry(st, twin)
    for w, h in ((EXACT_W, EXACT_H), (MAIN_W, MAIN_H)):
        ro, rd = camera_rays(s4.params, h, w, cfg)
        m = mk.march_values(st, cfg, ro, rd, scene)
        t_sh = torch.where(m.t < cfg.max_dist, m.t, m.t_close)
        lights, rays = [], h * w
        for li, (so, ld, dist) in enumerate(shadow_rays(s4.params, ro, rd, t_sh, cfg)):
            live = []
            loop = mk.shadow_values_reference(st, cfg, so, ld, dist, scene, live=live)[0]
            k4x = mk._launch(entry_x, st, scene, so, ld, dist, 1)[0]
            require(torch.equal(k4x, loop), f"K4x light {li} at {w}x{h}: not bitwise the loop "
                                            f"({int((k4x != loop).sum())} rays differ)")
            require(torch.equal(k4x, mk.shadow_values(st, cfg, so, ld, dist, scene)[0]),
                    f"K4x light {li} at {w}x{h}: not bitwise K4's res")
            require(torch.equal(k4x, mk._launch(entry_twin, st, scene, so, ld, dist, 1)[0]),
                    f"K4x light {li} at {w}x{h}: not bitwise its shadow_cull=False twin")
            g = torch.randn(dist.shape, device=dist.device,
                            generator=torch.Generator(device=dist.device).manual_seed(li))

            def bwd(so=so, ld=ld, dist=dist, g=g):
                return mk._launch_exact_bwd(lib.lib, st, so, ld, dist, scene.fields, g)

            got, again = bwd(), bwd()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"K4xb light {li} at {w}x{h}: two launches differ")
            ref = mk.exact_shadow_reference(st, cfg, so, ld, dist, scene.fields, g)
            mass = []
            total = mk.exact_shadow_reference(st, cfg, so, ld, dist, scene.fields, g,
                                              sum_dtype=torch.float64, mass=mass)[2]
            has = mass[0] > 0
            unit = mass[0][has].clamp(min=EXACT_MASS_FLOOR * float(mass[0].max()))

            def of_mass(v):  # worst |v - total| in units of the terms' magnitudes
                return float(((v.double() - total).abs()[has] / unit).max())

            errs, off = [], []
            for what, a, b in zip(("g_ro", "g_rd"), got, ref):
                scale = max(float(b.abs().max()), 1e-6)
                bad = ((a - b).abs() > 1e-4 * scale).any(dim=-1)
                errs.append(float((a - b).abs()[~bad].max()) / scale)
                off.append(int(bad.sum()))
                require(off[-1] <= EXACT_RAYS_OFF,
                        f"K4xb light {li} at {w}x{h} {what}: {off[-1]} rays off by > 1e-4 of max")
            fields_abs = float((got[2].double() - total).abs().max())
            errs.append(of_mass(got[2]))
            control = of_mass(ref[2])
            y, x = divmod(int(got[0].norm(dim=-1).argmax()), w)
            lost = g.clone()  # a lost tile: the rays of the largest g_ro's left out
            lost[y // 4 * 4:y // 4 * 4 + 4, x // 32 * 32:x // 32 * 32 + 32] = 0
            lost_err = of_mass(bwd(g=lost)[2])
            require(not got[2][~has].any(), f"K4xb light {li} at {w}x{h}: a field gradient "
                                            f"where no term reaches")
            require(errs[-1] <= EXACT_FIELDS_TOL < lost_err,
                    f"K4xb light {li} at {w}x{h} g_fields: {errs[-1]:.3g} of the terms' "
                    f"magnitudes off the float64 total, a lost tile {lost_err:.3g} (the float32 "
                    f"reference {control:.3g})")
            evals = float(sum(live))
            culled = float(mk.segment_lit(st, s4.params, so, ld, dist, cfg.shadow_w)
                           .float().mean())
            fwd_ops = rays * seg_ops + evals * (E + 17)
            bwd_ops = rays * seg_ops + evals * (E + 17) + evals * (E + A + 30)
            fwd_sqrts = rays * seg_sqrts + evals * S
            bwd_sqrts = rays * seg_sqrts + evals * 3 * S
            d = {"culled": culled, "evals_per_ray": evals / rays, "grad_err": errs,
                 "grad_rays_off": off, "fields_abs_err": fields_abs,
                 "fields_of_max": fields_abs / max(float(total.abs().max()), 1e-12),
                 "fields_ref32_err": control, "fields_lost_tile_err": lost_err,
                 "mass_over_max": float(mass[0].max()) / max(float(total.abs().max()), 1e-12),
                 "k4x_bound": bound(small + 32 * rays, fwd_ops, ceiling),
                 "k4x_bound_sqrt": bound(small + 32 * rays,
                                         fwd_ops + (sqrt_slots - 1) * fwd_sqrts, ceiling),
                 "k4xb_bound": bound(small + 56 * rays, bwd_ops, ceiling),
                 "k4xb_bound_sqrt": bound(small + 56 * rays,
                                          bwd_ops + (sqrt_slots - 1) * bwd_sqrts, ceiling)}
            lights.append(d)
            d_max = d["fields_of_max"]
            print(f"[19] {w}x{h} light {li}: K4x bitwise the loop, K4 and its twin; K4xb "
                  f"launches bitwise, g_ro / g_rd within {errs[0]:.2e} / {errs[1]:.2e} of max "
                  f"({off} rays off), g_fields {errs[2]:.2e} of its terms' magnitudes off the "
                  f"float64 total ({d_max:.2e} of its largest; the float32 reference "
                  f"{control:.2e}, a lost tile {lost_err:.2e}); culled "
                  f"{culled:.3f}, {evals / rays:.2f} evaluations a ray; bounds K4x "
                  f"{d['k4x_bound'][0]:.4f} (sqrt {d['k4x_bound_sqrt'][0]:.4f}), K4xb "
                  f"{d['k4xb_bound'][0]:.4f} (sqrt {d['k4xb_bound_sqrt'][0]:.4f})", flush=True)
            del ref, total, got, again, mass
        out["sizes"][f"{w}x{h}"] = lights
    print(f"[19] K4x / K4xb library built in {out['build_s']:.1f} s; ptxas "
          + " | ".join(out["ptxas"]), flush=True)
    return out


def exact_entries(exact, a_counts, dev_ms):
    """The `kernels` entries of K4x and K4xb from exact_checks' record (the
    bounds of the main shape, averaged over the lights), phase 19's
    launches and phase 20's device times (`--profile-march`, the same
    rays, averaged over the lights)."""
    x_main = exact["sizes"][f"{MAIN_W}x{MAIN_H}"]

    def per_light(key):
        return statistics.mean(d[key][0] for d in x_main)

    def sizes(keys):
        return {size: [{k: d[k] for k in keys} for d in lights]
                for size, lights in exact["sizes"].items()}

    cell = "scene4-fit-exact-540p"
    return [
        dict(entry("lol_exact_shadow", "loltracer_tpu_torch/csrc/exact_shadow.cuh",
                   "loltracer_tpu/render/shading.py:59", a_counts["lol_exact_shadow"], 0.0,
                   bnd=(per_light("k4x_bound"), x_main[0]["k4x_bound"][1]), timed_by=cell),
             device_ms=statistics.mean(dev_ms["k4x"]),
             device_ms_is="the mean of the two lights' launches at 1920x1080",
             bound_sqrt_ms=per_light("k4x_bound_sqrt"), ptxas=exact["ptxas"],
             build_s=exact["build_s"],
             sizes=sizes(("culled", "evals_per_ray", "k4x_bound", "k4x_bound_sqrt"))),
        dict(entry("lol_exact_shadow_bwd", "loltracer_tpu_torch/csrc/exact_shadow.cuh",
                   "loltracer_tpu/render/shading.py:59", a_counts["lol_exact_shadow_bwd"],
                   max(d["fields_abs_err"] for ls in exact["sizes"].values() for d in ls),
                   bnd=(per_light("k4xb_bound"), x_main[0]["k4xb_bound"][1]), timed_by=cell),
             device_ms=statistics.mean(dev_ms["k4xb"]),
             device_ms_is="the mean of the two lights' calls at 1920x1080: kernel, reduce, fill",
             err_is="g_fields against the float64 total of the plain version's terms",
             bound_sqrt_ms=per_light("k4xb_bound_sqrt"),
             sizes=sizes(("grad_err", "grad_rays_off", "fields_abs_err", "fields_of_max",
                          "fields_ref32_err", "fields_lost_tile_err", "mass_over_max",
                          "k4xb_bound", "k4xb_bound_sqrt"))),
    ]


def shadow_rays(params, ro, rd, t_sh, cfg):
    """Per light, the rays shading.phong hands the shadow march from the
    shading points at t_sh: (origin, direction, distance to the light)."""
    import torch

    from loltracer_tpu_torch.render.vecmath import dot, normalize

    p = ro + t_sh[..., None] * rd
    out = []
    for li in range(params.light_point.shape[0]):
        to_light = params.light_point[li] - p
        light_dir = normalize(to_light)
        out.append(tuple(x.contiguous() for x in (
            p + light_dir * cfg.shadow_offset, light_dir, torch.sqrt(dot(to_light, to_light)))))
    return out


def grad_leaves(params):
    """Fresh leaf copies of every field of params, each requiring grad."""
    from loltracer_tpu_torch.scene import FIELDS, SceneParams

    return SceneParams(**{f: getattr(params, f).detach().clone().requires_grad_(True)
                          for f in FIELDS})


def check_grads(got, want, what: str) -> float:
    """Per field, |got - want| <= 2e-2 * max(max|want|, 1e-6) (the
    fused-vs-jnp gradient rule of tests/test_train.py:127-136); returns
    the worst max |diff| / max|want|."""
    import torch

    from loltracer_tpu_torch.scene import FIELDS

    worst = 0.0
    for f in FIELDS:
        a, b = getattr(got, f).grad, getattr(want, f).grad
        if b is None or b.numel() == 0:
            continue
        a = torch.zeros_like(b) if a is None else a
        require(bool(a.isfinite().all()), f"{what}: d{f} non-finite")
        scale = max(float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        require(err <= 2e-2 * scale, f"{what}: d{f} max |diff| {err:.3g} > 2e-2 * {scale:.3g}")
        worst = max(worst, err / scale)
    return worst


def march_phases(dev, card, scenes, inst, march_built, t0, e_inst, it_target, ceiling,
                 sqrt_slots):
    """Phases 17-21: the value march kernels K3 / K4, the exact shadow's
    K4x / K4xb and the three paths that run them (module docstring).
    Returns their six `kernels` entries."""
    import numpy as np
    import torch

    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.opt import fit_scene
    from loltracer_tpu_torch.render import fused_fwd, fused_train, instanced_fwd, instanced_train
    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.camera import camera_pack, camera_rays, camera_rays_for_rows
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.render.cuda_scene import (
        MARCH_LANES,
        MARCH_TILE_W,
        pack_fields,
        packed_size,
    )
    from loltracer_tpu_torch.render.shading import segment_lit
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced
    from loltracer_tpu_torch.render.torch_renderer import (
        render_image,
        render_image_banded,
        render_rays,
    )
    from loltracer_tpu_torch.utils.image import read_png

    def reset_counts():
        for k in mk.launches:
            mk.launches[k] = 0
        fused_fwd.launches = instanced_fwd.launches = 0
        fused_train.launches_fwd = fused_train.launches_bwd = 0
        instanced_train.launches_fwd = instanced_train.launches_bwd = 0

    def counts():
        return {k: v for k, v in mk.launches.items() if v}

    clamp2 = RenderConfig(step_clamp=2.0)

    def compiled_case(what, sc, c, h=97, w=161):
        """Phase 18 on a compiled structure: K3 bitwise its plain version;
        per light K4 (with the segment cull), its shadow_cull=False twin and
        its plain version (culled rays started done) all bitwise the plain
        loops without the cull; prints the culled share per light."""
        st, twin = sc.structure, c.replace(shadow_cull=False)
        scene = mk.pack_march_scene(st, sc.params)
        ro, rd = camera_rays(sc.params, h, w, c)
        want = mk.march_values_reference(st, c, ro, rd, scene)
        same_planes(mk.march_values(st, c, ro, rd, scene), want, f"{what} lol_march")
        t_sh = torch.where(want.t < c.max_dist, want.t, want.t_close) if c.antialias else want.t
        shares = []
        for li, (so, ld, dist) in enumerate(shadow_rays(sc.params, ro, rd, t_sh, c)):
            plain = mk.shadow_values_reference(st, twin, so, ld, dist, scene)
            same_planes(mk.shadow_values_reference(st, c, so, ld, dist, scene), plain,
                        f"{what} light {li}: the culled plain loops vs the unculled")
            same_planes(mk.shadow_values(st, twin, so, ld, dist, scene), plain,
                        f"{what} light {li}: the shadow_cull=False twin")
            same_planes(mk.shadow_values(st, c, so, ld, dist, scene), plain,
                        f"{what} light {li}: lol_shadow_march")
            shares.append(float(segment_lit(st, sc.params, so, ld, dist,
                                            c.shadow_w).float().mean()))
        print(f"[18] {what} {h}x{w}: lol_march bitwise the plain version; per light "
              f"lol_shadow_march with the segment cull, its shadow_cull=False twin and the "
              f"culled plain loops bitwise the plain loops; lanes culled per light "
              f"{[round(v, 4) for v in shares]}")

    # --- 17. build ----------------------------------------------------------------
    built = [f.result() for f in march_built]
    k34_ptxas = {"cull": ptxas_lines(built[3].log), "twin": ptxas_lines(built[7 + 3].log)}
    require(all(len(v) == 2 for v in k34_ptxas.values()),
            f"scene4's march libraries: ptxas reported {k34_ptxas}")
    print(f"[17] build: {len(built)} march libraries (lol_march + lol_shadow_march for the 4 "
          f"examples and their shadow_cull=False twins; lol_march_instanced + "
          f"lol_shadow_march_instanced for clamp 2, exact, shadow clamp 8, each at lane widths "
          f"{MARCH_LANES}) done {time.perf_counter() - t0:.1f} s after the builds started; "
          f"ptxas scene4: " + " | ".join(k34_ptxas["cull"])
          + "; its twin: " + " | ".join(k34_ptxas["twin"]))
    for tag, lib in zip(("clamp 2", "exact", "shadow clamp 8"), built[4:7]):
        lines = ptxas_lines(lib.log)
        require(len(lines) == 2 * len(MARCH_LANES), f"instanced {tag}: ptxas reported {lines}")
        # one lane a ray is csrc/march.cuh's kernel as it was (32 registers
        # and 8-12 B of spills); the lane groups must not spill
        require(all(" 0 B spill stores, 0 B spill loads" in x for x in lines
                    if "@1 lanes" not in x), f"instanced {tag}: a lane group spills: {lines}")
        print(f"[17] ptxas instanced {tag}, per width: " + " | ".join(lines))

    # --- 18. K3 / K4 vs their plain versions at 97x161 ---------------------------------
    h, w = 97, 161
    cases = ([(n, scenes[n], RenderConfig()) for n in SCENES]
             + [("scene4.lol AA", scenes["scene4.lol"], RenderConfig(antialias=True))]
             + [(f"instanced:10000 {tag}", inst[10_000], c) for tag, c in (
                 ("clamp 2", clamp2), ("exact", RenderConfig()),
                 ("shadow clamp 8", RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0)))]
             + [(f"instanced:{n} clamp 2", inst[n], clamp2) for n in (300, 1)])
    errs = {name: 0.0 for name in mk.launches}
    for what, sc, c in cases:
        if not sc.structure.instanced:
            compiled_case(what, sc, c)
            continue
        # the plain loops over 10 000 spheres take seconds a case: those at 49x81
        ch, cw = (49, 81) if sc.structure.num_spheres == 10_000 else (97, 161)
        k3_name = "lol_march_instanced" if sc.structure.instanced else "lol_march"
        k4_name = k3_name.replace("march", "shadow_march", 1)
        # instanced: every compiled lane width against the plain version
        widths = MARCH_LANES if sc.structure.instanced else (None,)
        scene = mk.pack_march_scene(sc.structure, sc.params)
        ro, rd = camera_rays(sc.params, ch, cw, c)
        want = mk.march_values_reference(sc.structure, c, ro, rd, scene)
        line = []
        for lanes in widths:
            got = mk.march_values(sc.structure, c, ro, rd, scene, lanes=lanes)
            torch.cuda.synchronize()
            err, differ = check_values(got, want, f"{what} {k3_name} lanes {lanes}")
            errs[k3_name] = max(errs[k3_name], err)
            line.append(f"K3{'' if lanes is None else f' @{lanes}'} max |diff| {err:.3g}, "
                        f"{differ} values not bitwise")
        hit = got.t < c.max_dist
        t_sh = torch.where(hit, got.t, got.t_close) if c.antialias else got.t
        for li, (so, ld, dist) in enumerate(shadow_rays(sc.params, ro, rd, t_sh, c)):
            want_s = mk.shadow_values_reference(sc.structure, c, so, ld, dist, scene)
            for lanes in widths:
                got_s = mk.shadow_values(sc.structure, c, so, ld, dist, scene, lanes=lanes)
                torch.cuda.synchronize()
                err, differ = check_values(got_s, want_s, f"{what} {k4_name} light {li} "
                                                          f"lanes {lanes}")
                errs[k4_name] = max(errs[k4_name], err)
                line.append(f"K4 light {li}{'' if lanes is None else f' @{lanes}'} max |diff| "
                            f"{err:.3g}, {differ} not bitwise")
        print(f"[18] {what} {ch}x{cw}: " + "; ".join(line))

    # --- 19. path A: cli fit, exact shadows -----------------------------------------
    s4 = scenes["scene4.lol"]
    st4 = s4.structure
    a_cfg = RenderConfig(antialias=True)  # cli fit's: --aa on by default, exact shadows
    moved = s4.params.sphere_point + torch.from_numpy(np.random.default_rng(0).uniform(
        -0.1, 0.1, tuple(s4.params.sphere_point.shape)).astype(np.float32)).to(dev)
    target = make_cuda_renderer(st4, MAIN_H, MAIN_W, a_cfg, device=dev)(
        dataclasses.replace(s4.params, sphere_point=moved))
    fit_steps = 3
    with tempfile.TemporaryDirectory() as tmp:
        tgt, out = Path(tmp) / "target.npy", Path(tmp) / "fit.png"
        np.save(tgt, target.cpu().numpy())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a_base = torch.cuda.memory_allocated()
        reset_counts()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli.main(["fit", str(EXAMPLES / "scene4.lol"), "--target", str(tgt), "--steps",
                      str(fit_steps), "--trainable", "sphere_point", "--lr", "3e-2",
                      "-o", str(out)])
        torch.cuda.synchronize()
        a_peak = torch.cuda.max_memory_allocated() - a_base
        a_counts = counts()
        other = (fused_fwd.launches, fused_train.launches_fwd, fused_train.launches_bwd)
        png = read_png(str(out))
    a_losses = [float(v) for v in re.findall(r"^\[fit\] step \d+ loss (\S+)$",
                                             printed.getvalue(), re.M)]
    a_want = {"lol_march": fit_steps + 1, "lol_exact_shadow": st4.num_lights * (fit_steps + 1),
              "lol_exact_shadow_bwd": st4.num_lights * fit_steps}
    require(a_counts == a_want,
            f"cli fit ({fit_steps} steps and -o) launched {a_counts}, not {a_want}")
    require(other == (0, 0, 0), f"cli fit launched a fused kernel: {other}")
    require(len(a_losses) == fit_steps and all(map(math.isfinite, a_losses)),
            f"cli fit printed losses {a_losses}")
    require(all(a > b for a, b in zip(a_losses, a_losses[1:])), f"the loss did not fall: {a_losses}")
    require(png.shape == (MAIN_H, MAIN_W, 3), f"fitted render {png.shape}")
    print(f"[19] main path A: cli fit scene4 {MAIN_W}x{MAIN_H} (AA, exact shadows, "
          f"{fit_steps} Adam steps on sphere_point, -o) -> {a_counts}; losses {a_losses}; "
          f"peak {a_peak / 2**20:.0f} MiB allocated above the {a_base / 2**20:.0f} MiB live "
          f"before it")
    exact = exact_checks(s4, a_cfg, ceiling, sqrt_slots)

    # --- 20. path B: render_image with envelope shadows under autograd -------------------
    b_cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    cam_b, fields_b = camera_pack(s4.params, MAIN_H, MAIN_W, b_cfg), pack_fields(st4, s4.params)
    k1_img = fused_fwd.fused_forward(st4, b_cfg, cam_b, fields_b, MAIN_H, MAIN_W)
    _, res_b = fused_train.train_forward(st4, b_cfg, cam_b, fields_b, MAIN_H, MAIN_W)
    keep_b = penumbra_keep(res_b, st4.num_lights)
    b_leaves, k_leaves = grad_leaves(s4.params), grad_leaves(s4.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b_base = torch.cuda.memory_allocated()
    reset_counts()
    img_b = render_image(st4, b_leaves, MAIN_H, MAIN_W, b_cfg)
    (keep_b * (img_b - target) ** 2).mean().backward()
    torch.cuda.synchronize()
    b_peak, b_counts = torch.cuda.max_memory_allocated() - b_base, counts()
    require(b_counts == {"lol_march": 1, "lol_shadow_march": 2},
            f"path B launched {b_counts}, not lol_march once and lol_shadow_march twice")
    b_err, b_over = compare(img_b.detach(), k1_img, "path B image vs lol_render_fused")
    render_k = fused_train.make_training_renderer(st4, MAIN_H, MAIN_W, b_cfg, device=dev)
    (keep_b * (render_k(k_leaves) - target) ** 2).mean().backward()
    b_worst = check_grads(b_leaves, k_leaves, "path B gradients vs lol_train_fwd/bwd")
    print(f"[20] main path B: render_image scene4 {MAIN_W}x{MAIN_H} AA envelope under "
          f"autograd -> {b_counts}; image vs lol_render_fused max |diff| {b_err:.3g}, "
          f"{b_over} px over {ATOL}; MSE gradients ({float(keep_b.mean()):.1%} of pixels "
          f"outside the penumbra band) vs lol_train_fwd/bwd: worst field max |diff| / "
          f"max|grad| {b_worst:.3g}; peak {b_peak / 2**20:.0f} MiB allocated above the "
          f"{b_base / 2**20:.0f} MiB live before it")

    def step_b():
        img = render_image(st4, b_leaves, MAIN_H, MAIN_W, b_cfg)
        (keep_b * (img - target) ** 2).mean().backward()

    b_step_ms = time_ms(step_b, 2)

    # K3 and K4 at the main shape (path B's rays): K3 and, per light, K4 and
    # its shadow_cull=False twin held bitwise against the plain versions,
    # the plain loops counting each ray's SDF evaluations (K4's with the
    # cull and without); then K4's times
    ro, rd = camera_rays(s4.params, MAIN_H, MAIN_W, b_cfg)
    scene_b = mk.pack_march_scene(st4, s4.params)
    twin_b = b_cfg.replace(shadow_cull=False)
    rays = MAIN_W * MAIN_H

    def ray_counts():
        return torch.zeros((MAIN_H, MAIN_W), dtype=torch.int32, device=dev)

    k3_live, k3_counts = [], ray_counts()
    k3 = mk.march_values(st4, b_cfg, ro, rd, scene_b)
    same_planes(k3, mk.march_values_reference(st4, b_cfg, ro, rd, scene_b, k3_live,
                                              counts=k3_counts), "lol_march 1080p")
    t_sh = torch.where(k3.t < b_cfg.max_dist, k3.t, k3.t_close)
    b_rays = shadow_rays(s4.params, ro, rd, t_sh, b_cfg)
    del k3, t_sh

    def k4_call(li, c=b_cfg):
        return lambda: mk.shadow_values(st4, c, *b_rays[li], scene_b)

    k4_lights = []
    for li, (so, ld, dist) in enumerate(b_rays):
        live_c, live_t, cnt_c, cnt_t = [], [], ray_counts(), ray_counts()
        p4 = mk.shadow_values_reference(st4, b_cfg, so, ld, dist, scene_b, live_c, counts=cnt_c)
        p4t = mk.shadow_values_reference(st4, twin_b, so, ld, dist, scene_b, live_t,
                                         counts=cnt_t)
        same_planes(p4, p4t, f"light {li} 1080p: the culled plain loops vs the unculled")
        same_planes(mk.shadow_values(st4, twin_b, so, ld, dist, scene_b), p4t,
                    f"light {li} 1080p: the shadow_cull=False twin")
        same_planes(mk.shadow_values(st4, b_cfg, so, ld, dist, scene_b), p4t,
                    f"light {li} 1080p: lol_shadow_march")
        del p4, p4t
        share = float(segment_lit(st4, s4.params, so, ld, dist, b_cfg.shadow_w).float().mean())
        k4_lights.append(dict(culled_share=share, evals=sum(live_c) / rays,
                              twin_evals=sum(live_t) / rays, live=sum(live_c),
                              warp_efficiency=warp_efficiency(cnt_c, MARCH_TILE_W),
                              twin_warp_efficiency=warp_efficiency(cnt_t, MARCH_TILE_W)))
    # times: each light's K4 in turns with its twin (twin, kernel, kernel,
    # twin; median of 10 each), then the plain versions (once, warm)
    for fn in (k4_call(0), k4_call(1), k4_call(0, twin_b), k4_call(1, twin_b)):
        fn()
    for li, d in enumerate(k4_lights):
        d["twin_ms"] = [time_ms(k4_call(li, twin_b), 10)]
        d["runs"] = [time_ms(k4_call(li), 10), time_ms(k4_call(li), 10)]
        d["twin_ms"].append(time_ms(k4_call(li, twin_b), 10))
        d["ms"] = statistics.median(d["runs"])
    for li, d in enumerate(k4_lights):
        d["plain_ms"] = time_ms(lambda: mk.shadow_values_reference(st4, b_cfg, *b_rays[li],
                                                                   scene_b), 1)
    # host time per call (host_us): the helper and the renderer's function
    shadow_fn = functools.partial(mk.make_cuda_shadow_march(st4, b_cfg), scene=scene_b)
    shadow_fn(s4.params, *b_rays[0])
    wrapper_us = {"shadow_values": host_us(k4_call(0)),
                  "shadow_fn": host_us(lambda: shadow_fn(s4.params, *b_rays[0]))}
    # Operation model (csrc/march.cuh over the generated Scene): per march
    # step E + 15 (the step and the closest-approach tracking), per shadow
    # step E + 17 (the penumbra value and its argmin), E = sdf_ops; K4's
    # segment bound (seg_cost) on every lane, its loop on the lanes it does
    # not cull; the sqrt-weighted bound counts each IEEE sqrtf (sdf_sqrts an
    # evaluation, seg_cost's in the bound) at phase 25's FMA slots. Bytes:
    # K3 reads 12 B and writes 16 B per ray, K4 reads 28 B and writes 8 B
    E, S = sdf_ops(st4), sdf_sqrts(st4)
    seg_ops, seg_sqrts = seg_cost(st4)
    small = 4 * (3 + packed_size(st4))
    k3_evals = sum(k3_live)
    k3_bound = bound(small + 28 * rays, k3_evals * (E + 15), ceiling)
    k3_bound_sqrt = bound(small + 28 * rays,
                          k3_evals * (E + 15) + (sqrt_slots - 1.0) * k3_evals * S, ceiling)
    k3_eff = warp_efficiency(k3_counts, MARCH_TILE_W)
    for d in k4_lights:
        ops = rays * seg_ops + d["live"] * (E + 17)
        sqrts = rays * seg_sqrts + d["live"] * S
        d["bound"] = bound(small + 36 * rays, ops, ceiling)
        d["bound_sqrt"] = bound(small + 36 * rays, ops + (sqrt_slots - 1.0) * sqrts, ceiling)
        d["bound_ms"], d["bound_sqrt_ms"] = d["bound"][0], d["bound_sqrt"][0]
    march_prof = run_profile("--profile-march").split(" || ")
    dev_ms = json.loads(march_prof[4])
    require(all(v > 0 for k in ("k4", "k4_twin", "k4x", "k4xb") for v in dev_ms[k])
            and dev_ms["k3"] > 0, f"the profile saw no device time of K3 / K4 / K4x / K4xb: "
            f"{dev_ms}")
    for li, d in enumerate(k4_lights):
        d.update(device_ms=dev_ms["k4"][li], twin_device_ms=dev_ms["k4_twin"][li])
    print(f"[20] scene4 AA {MAIN_W}x{MAIN_H} on {card}: path B fwd+bwd (envelope) "
          f"{b_step_ms:.1f} ms; lol_march and lol_shadow_march bitwise the plain versions, "
          f"lol_shadow_march bitwise its shadow_cull=False twin on both lights; lol_march "
          f"device {dev_ms['k3']:.4f} ms, bound {k3_bound[0]:.4f} ms by {k3_bound[1]}, "
          f"sqrt-weighted {k3_bound_sqrt[0]:.4f}, {k3_evals / rays:.2f} evaluations per ray, "
          f"warp efficiency {k3_eff:.4f}; per light on the same rays lol_exact_shadow device "
          f"{dev_ms['k4x']} ms, lol_exact_shadow_bwd (kernel, reduce, fill) {dev_ms['k4xb']} ms")
    for li, d in enumerate(k4_lights):
        print(f"[20] lol_shadow_march light {li}: {d['ms']:.4f} ms (runs {d['runs']}; device "
              f"{d['device_ms']:.4f}), its shadow_cull=False twin {d['twin_ms']} in turns "
              f"around it (device {d['twin_device_ms']:.4f}); plain {d['plain_ms']:.1f} ms; "
              f"lanes culled {d['culled_share']:.4f}; SDF evaluations a ray {d['evals']:.2f} "
              f"with the cull, {d['twin_evals']:.2f} without; bound {d['bound'][0]:.4f} ms by "
              f"{d['bound'][1]}, sqrt-weighted {d['bound_sqrt'][0]:.4f}; warp efficiency "
              f"({MARCH_TILE_W}x{32 // MARCH_TILE_W} tiles) {d['warp_efficiency']:.4f} (twin "
              f"{d['twin_warp_efficiency']:.4f})")
    print(f"[20] host time per call (host clock over 100 calls, no sync inside): "
          + ", ".join(f"{k} {v:.1f} us" for k, v in wrapper_us.items()))
    del b_leaves, k_leaves, img_b

    # --- 21. path C: render_image_banded over instanced:10000 ---------------------------
    big = inst[10_000]
    st10 = big.structure
    c_cfg = RenderConfig(step_clamp=2.0, shadow_grad="envelope")
    cam_c, fields_c = camera_pack(big.params, MAIN_H, MAIN_W, c_cfg), pack_fields(st10, big.params)
    tab_c = pack_instanced(st10, big.params)
    k5_img = instanced_fwd.instanced_forward(st10, c_cfg, cam_c, fields_c, tab_c, MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    reset_counts()
    t_frame = time.perf_counter()
    with torch.no_grad():
        c_img = render_image_banded(st10, big.params, MAIN_H, MAIN_W, c_cfg, band_rows=BAND)
    torch.cuda.synchronize()
    c_frame_ms = (time.perf_counter() - t_frame) * 1e3
    c_counts = counts()
    n_bands = -(-MAIN_H // BAND)
    require(c_counts == {"lol_march_instanced": n_bands, "lol_shadow_march_instanced":
                         n_bands * st10.num_lights},
            f"path C's frame launched {c_counts}, not {n_bands} lol_march_instanced and "
            f"{n_bands * st10.num_lights} lol_shadow_march_instanced")
    c_err, c_over = compare(c_img, k5_img, "path C frame vs lol_instanced_render")
    print(f"[21] main path C: render_image_banded instanced:10000 clamp 2 envelope "
          f"{MAIN_W}x{MAIN_H}, {BAND}-row bands, no autograd -> {c_counts}; vs "
          f"lol_instanced_render max |diff| {c_err:.3g}, {c_over} px over {ATOL}; "
          f"{c_frame_ms:.0f} ms")
    del c_img

    scene_c = mk.pack_march_scene(st10, big.params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c_base = torch.cuda.memory_allocated()
    c_worst, c_band_s = 0.0, []
    for name, r0 in {"top": 0, "middle": (MAIN_H - BAND) // 2, "bottom": MAIN_H - BAND}.items():
        want = grad_leaves(big.params)
        bcam = camera_pack(want, MAIN_H, MAIN_W, c_cfg, row0=r0)
        bfields, btab = pack_fields(st10, want), pack_instanced(st10, want)
        det = type(btab)(*(t.detach() for t in btab))
        kimg, kres = instanced_train.instanced_train_forward(
            st10, c_cfg, bcam.detach(), bfields.detach(), det, BAND, MAIN_W, MAIN_H)
        keep = penumbra_keep(kres, st10.num_lights)
        tgt = it_target[r0:r0 + BAND]
        ct = (2.0 / kimg.numel()) * keep * (kimg - tgt)
        dcam, dfields, dsph = instanced_train.instanced_train_backward(
            st10, c_cfg, bcam.detach(), bfields.detach(), det, kres, ct.contiguous(), MAIN_H)
        torch.autograd.backward([bcam, bfields, btab.spheres], [dcam, dfields, dsph])

        got = grad_leaves(big.params)
        reset_counts()
        t_band = time.perf_counter()
        ro, rd = camera_rays_for_rows(got, torch.arange(r0, r0 + BAND), MAIN_H, MAIN_W, c_cfg)
        img = render_rays(st10, got, ro, rd, c_cfg, march_scene=scene_c)
        (keep * (img - tgt) ** 2).mean().backward()
        torch.cuda.synchronize()
        c_band_s.append(time.perf_counter() - t_band)
        band_counts = counts()
        require(band_counts == {"lol_march_instanced": 1,
                                "lol_shadow_march_instanced": st10.num_lights},
                f"{name} band fwd+bwd launched {band_counts}")
        err, over = compare(img.detach(), k5_img[r0:r0 + BAND], f"path C {name} band image")
        worst = check_grads(got, want, f"path C {name} band gradients vs lol_instanced_fwd/bwd")
        c_worst = max(c_worst, worst)
        print(f"[21] {name} band (rows {r0}-{r0 + BAND - 1}) fwd+bwd -> {band_counts}; image vs "
              f"lol_instanced_render max |diff| {err:.3g}, {over} px over; gradients "
              f"({float(keep.mean()):.1%} of pixels outside the penumbra band) vs "
              f"lol_instanced_fwd/bwd: worst field max |diff| / max|grad| {worst:.3g}; "
              f"{c_band_s[-1]:.2f} s")
    c_peak = torch.cuda.max_memory_allocated() - c_base

    # fit_scene with exact shadows on an instanced structure: 16-row bands,
    # each checkpointed, so K3 runs once per band forward and once more in
    # the backward's recompute
    s300, fh, fw = inst[300], 48, 81
    moved = s300.params.sphere_point + torch.from_numpy(np.random.default_rng(1).uniform(
        -0.2, 0.2, tuple(s300.params.sphere_point.shape)).astype(np.float32)).to(dev)
    tgt300 = make_cuda_renderer(s300.structure, fh, fw, clamp2, device=dev)(
        dataclasses.replace(s300.params, sphere_point=moved))
    reset_counts()
    fit300 = fit_scene(s300.structure, s300.params, tgt300, steps=2, learning_rate=1e-2,
                       trainable=("sphere_point",), cfg=clamp2, device=dev)
    f_counts, bands300 = counts(), -(-fh // 16)
    require(f_counts == {"lol_march_instanced": 2 * 2 * bands300},
            f"fit_scene instanced:300 exact (2 steps, {bands300} bands) launched {f_counts}")
    require(bool(np.isfinite(fit300.losses).all()), f"non-finite losses {fit300.losses}")
    print(f"[21] fit_scene instanced:300 clamp 2 exact shadows {fh}x{fw}, 2 Adam steps -> "
          f"{f_counts}; losses {[float(v) for v in fit300.losses]}")

    # the instanced kernels at the main shape (the middle band), held and
    # timed at the width the rule picks there; then every compiled width on
    # the band (held against the plain version), the middle half of the
    # frame and the whole frame (camera rays and light 0's shadow rays from
    # their hits; held against width 1)
    r0 = (MAIN_H - BAND) // 2
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ro, rd = camera_rays_for_rows(big.params, torch.arange(r0, r0 + BAND), MAIN_H, MAIN_W, c_cfg)
    live = {"march": [], "shadow": []}
    k3 = mk.march_values(st10, c_cfg, ro, rd, scene_c)
    p3 = mk.march_values_reference(st10, c_cfg, ro, rd, scene_c, live["march"])
    so, ld, dist = shadow_rays(big.params, ro, rd, k3.t, c_cfg)[0]
    p4 = mk.shadow_values_reference(st10, c_cfg, so, ld, dist, scene_c, live["shadow"])
    sizes = {"band": (ro, rd, so, ld, dist, (p3, p4))}
    for size, rows in (("half", MAIN_H // 2), ("frame", MAIN_H)):
        h0 = (MAIN_H - rows) // 2
        ro_s, rd_s = camera_rays_for_rows(big.params, torch.arange(h0, h0 + rows), MAIN_H, MAIN_W,
                                          c_cfg)
        t1 = mk.march_values(st10, c_cfg, ro_s, rd_s, scene_c, lanes=1)
        shadow_s = shadow_rays(big.params, ro_s, rd_s, t1.t, c_cfg)[0]
        sizes[size] = (ro_s, rd_s, *shadow_s,
                       (t1, mk.shadow_values(st10, c_cfg, *shadow_s, scene_c, lanes=1)))
    rays = {size: v[1].numel() // 3 for size, v in sizes.items()}
    # the rule's width per size and kernel
    rule = {size: {k: mk.lanes_for(n, sms, shadow=k == "k4") for k in ("k3", "k4")}
            for size, n in rays.items()}
    sweep, differ = {}, {}  # per width: {size_k3: ms, ...}, {size: (K3i, K4i) values not bitwise}
    for lanes in MARCH_LANES:
        sweep[lanes], differ[lanes] = {}, {}
        for size, (ro_s, rd_s, so_s, ld_s, dist_s, (want3, want4)) in sizes.items():
            g3 = mk.march_values(st10, c_cfg, ro_s, rd_s, scene_c, lanes=lanes)
            g4 = mk.shadow_values(st10, c_cfg, so_s, ld_s, dist_s, scene_c, lanes=lanes)
            torch.cuda.synchronize()
            against = "the plain version" if size == "band" else "width 1"
            err3, d3 = check_values(g3, want3, f"lol_march_instanced {size} @{lanes} vs {against}")
            err4, d4 = check_values(g4, want4, f"lol_shadow_march_instanced {size} light 0 "
                                               f"@{lanes} vs {against}")
            if size == "band":
                errs["lol_march_instanced"] = max(errs["lol_march_instanced"], err3)
                errs["lol_shadow_march_instanced"] = max(errs["lol_shadow_march_instanced"], err4)
            differ[lanes][size] = (d3, d4)
            del g3, g4
            reps = 5 if size == "band" else 3
            sweep[lanes][f"{size}_k3"] = time_ms(
                lambda: mk.march_values(st10, c_cfg, ro_s, rd_s, scene_c, lanes=lanes), reps)
            sweep[lanes][f"{size}_k4"] = time_ms(
                lambda: mk.shadow_values(st10, c_cfg, so_s, ld_s, dist_s, scene_c, lanes=lanes),
                reps)
    band_lanes, frame_lanes = rule["band"], rule["frame"]
    k3i_ms, k4i_ms = sweep[band_lanes["k3"]]["band_k3"], sweep[band_lanes["k4"]]["band_k4"]
    k3f_ms, k4f_ms = sweep[frame_lanes["k3"]]["frame_k3"], sweep[frame_lanes["k4"]]["frame_k4"]
    p3i_ms = time_ms(lambda: mk.march_values_reference(st10, c_cfg, ro, rd, scene_c), 1)
    p4i_ms = time_ms(lambda: mk.shadow_values_reference(st10, c_cfg, so, ld, dist, scene_c), 1)
    # per evaluation e_inst operations (phase 16's model: 9 per sphere
    # within the cut, counted on the bands, + 22), plus the step's 15 / 17
    band_rays = rays["band"]
    tables = 4 * sum(t.numel() for t in scene_c.tables) + 4 * (3 + fields_c.numel())
    k3i_bound = bound(tables + 28 * band_rays, sum(live["march"]) * (e_inst + 15), ceiling)
    k4i_bound = bound(tables + 36 * band_rays, sum(live["shadow"]) * (e_inst + 17), ceiling)
    print(f"[21] instanced:10000 clamp 2 on {card}: path C frame {c_frame_ms:.0f} ms (no "
          f"autograd), three bands fwd+bwd {sum(c_band_s):.1f} s (peak {c_peak / 2**20:.0f} MiB "
          f"allocated above the {c_base / 2**20:.0f} MiB live before them); per {BAND}-row band "
          f"({band_rays} rays, {sms} SMs) at the rule's widths: lol_march_instanced "
          f"@{band_lanes['k3']} {k3i_ms:.3f} ms (plain {p3i_ms:.0f} ms, bound "
          f"{k3i_bound[0]:.4f} ms by {k3i_bound[1]}, {sum(live['march']) / band_rays:.1f} "
          f"evaluations per ray), lol_shadow_march_instanced light 0 @{band_lanes['k4']} "
          f"{k4i_ms:.3f} ms (plain {p4i_ms:.0f} ms, bound {k4i_bound[0]:.4f} ms by "
          f"{k4i_bound[1]}, {sum(live['shadow']) / band_rays:.1f} evaluations per ray); max "
          f"|diff| vs plain here and in phase 18: {errs['lol_march_instanced']:.3g} / "
          f"{errs['lol_shadow_march_instanced']:.3g}")
    for size, n in rays.items():
        print(f"[21] {size} ({n} rays; CUDA events, median of {5 if size == 'band' else 3}; "
              f"the rule picks {rule[size]}): "
              + "; ".join(f"@{w}: K3i {sweep[w][size + '_k3']:.3f} ms, K4i light 0 "
                          f"{sweep[w][size + '_k4']:.3f} ms (values not bitwise "
                          f"{'the plain version' if size == 'band' else 'width 1'}'s: "
                          f"{differ[w][size][0]} / {differ[w][size][1]})" for w in MARCH_LANES))
    print(f"[21] the rule's frame widths against width 1: K3i "
          f"{k3f_ms / sweep[1]['frame_k3']:.4f}x, K4i {k4f_ms / sweep[1]['frame_k4']:.4f}x")
    del sizes
    print(f"[21] torch.profiler (`chip_smoke.py --profile-march`, run in phase 20) over one "
          f"path B step: {march_prof[0]}")
    print(f"[21] torch.profiler over one round of the four march kernels (K3, K4 light 0 at "
          f"path B's rays; the instanced pair on the middle band): {march_prof[1]}")
    print(f"[21] one path B step in a process of its own, under the allocator's history: "
          f"{march_prof[2]}")
    print(f"[21] torch.profiler over path C's band body on the middle band (no autograd): "
          f"{march_prof[3]}")


    def per_launch(key):  # K4's per-light numbers, averaged over path B's two launches
        return statistics.mean(d[key] for d in k4_lights)

    k4_mean_bound = (per_launch("bound_ms"), k4_lights[0]["bound"][1])
    return [
        dict(entry("lol_march", "loltracer_tpu_torch/csrc/march.cuh",
                   "loltracer_tpu/render/pallas_march.py:94", a_counts["lol_march"],
                   errs["lol_march"], bnd=k3_bound, timed_by="scene4-fit-exact-540p"),
             device_ms=dev_ms["k3"], bound_sqrt_ms=k3_bound_sqrt[0], tile_w=MARCH_TILE_W,
             warp_efficiency=k3_eff, evals_per_ray=k3_evals / (MAIN_W * MAIN_H)),
        dict(entry("lol_shadow_march", "loltracer_tpu_torch/csrc/march.cuh",
                   "loltracer_tpu/render/pallas_march.py:111", b_counts["lol_shadow_march"],
                   errs["lol_shadow_march"], per_launch("ms"), per_launch("plain_ms"),
                   k4_mean_bound),
             ms_is="the mean of the two lights' launches", device_ms=per_launch("device_ms"),
             bound_sqrt_ms=per_launch("bound_sqrt_ms"), tile_w=MARCH_TILE_W,
             culled_share_per_light=[d["culled_share"] for d in k4_lights],
             lights=[{k: d[k] for k in ("ms", "runs", "twin_ms", "device_ms", "twin_device_ms",
                                         "plain_ms", "culled_share", "evals", "twin_evals",
                                         "bound_ms", "bound_sqrt_ms", "warp_efficiency",
                                         "twin_warp_efficiency")}
                     for d in k4_lights],
             host_us=wrapper_us),
        dict(entry("lol_march_instanced", "loltracer_tpu_torch/csrc/coop_march.cuh",
                   "loltracer_tpu/render/pallas_march.py:94",
                   c_counts["lol_march_instanced"], errs["lol_march_instanced"], k3i_ms, p3i_ms,
                   k3i_bound), plain_ms_rows=BAND, ms_rows=BAND, lanes=band_lanes["k3"],
             frame_ms=k3f_ms, frame_lanes=frame_lanes["k3"],
             sweep_ms={w: [t["band_k3"], t["half_k3"], t["frame_k3"]] for w, t in sweep.items()}),
        dict(entry("lol_shadow_march_instanced", "loltracer_tpu_torch/csrc/coop_march.cuh",
                   "loltracer_tpu/render/pallas_march.py:111",
                   c_counts["lol_shadow_march_instanced"], errs["lol_shadow_march_instanced"],
                   k4i_ms, p4i_ms, k4i_bound), plain_ms_rows=BAND, ms_rows=BAND,
             lanes=band_lanes["k4"], frame_ms=k4f_ms, frame_lanes=frame_lanes["k4"],
             sweep_ms={w: [t["band_k4"], t["half_k4"], t["frame_k4"]] for w, t in sweep.items()}),
        *exact_entries(exact, a_counts, dev_ms),
    ]


def peak_phase(dev, card, peak_built):
    """Phase 25, run right after the builds, before any bound: path E, `cli
    peak` at full size (its record into a temporary file), the measured
    FMA rate within PEAK_LOW..PEAK_HIGH of the modelled ceiling 132 SMs x
    128 lanes x 2 flops x the card's maximum SM clock, the chain kernels
    bitwise the plain chains on the full lane count at 8 iterations, and
    the device time of one full-size call of each chain. Returns the K8
    `kernels` entries, the ceiling every bound divides by (FP32
    operations per ms: the modelled one, which the measured rate
    confirms) and the FMA slots one IEEE sqrt costs (the measured rates'
    ratio, which the sqrt-weighted bounds use)."""
    import torch

    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.utils import peak

    peak_built.result()
    for k in peak.launches:
        peak.launches[k] = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "gpu_peak.json"
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            require(cli.main(["peak", "--out", str(out)]) == 0, "cli peak failed")
        rec = json.loads(out.read_text())
    e_counts = dict(peak.launches)
    require(e_counts["lol_peak_fma"] > 0 and e_counts["lol_peak_sqrt"] > 0,
            f"cli peak launched {e_counts}")
    for key in ("fma_flops_per_s", "muladd_flops_per_s", "sqrt_evals_per_s"):
        require(math.isfinite(rec[key]) and rec[key] > 0, f"{key} {rec[key]}")
    dev_info = rec["device"]
    modelled = dev_info["modelled_fma_flops_per_s"]
    share = rec["fma_flops_per_s"] / modelled
    require(PEAK_LOW <= share <= PEAK_HIGH,
            f"measured FMA rate {rec['fma_flops_per_s']:.6g} flop/s is {share:.4f} of 132 SMs x "
            f"128 x 2 x {dev_info['max_sm_clock_mhz']} MHz, outside [{PEAK_LOW}, {PEAK_HIGH}]: "
            f"a fault of the probe, or a card held below its clock")
    ceiling = modelled / 1e3
    print(f"[25] path E: cli peak on {card} -> {printed.getvalue().strip().splitlines()[-1]}")
    det = rec["detail"]
    print(f"[25] lol_peak_fma fused {det['fma']['flops_per_s'] / 1e12:.4f} TFLOP/s "
          f"({det['fma']['iters']} iterations, {det['fma']['best_seconds'] * 1e3:.3f} ms), "
          f"{share:.4f} of the modelled ceiling at {dev_info['max_sm_clock_mhz']:.0f} MHz "
          f"{modelled / 1e12:.4f} TFLOP/s, which every bound below divides by; mul + add "
          f"{det['muladd']['flops_per_s'] / 1e12:.4f} TFLOP/s "
          f"({det['muladd']['best_seconds'] * 1e3:.3f} ms); lol_peak_sqrt "
          f"{det['sqrt']['evals_per_s'] / 1e12:.4f} T evaluations/s "
          f"({det['sqrt']['best_seconds'] * 1e3:.3f} ms); transcendental weight "
          f"{rec['transcendental_weight']:.3f}; launches {e_counts}")

    lanes, iters = peak.LANES, 8
    x = torch.linspace(1.0, 2.0, lanes, dtype=torch.float32, device=dev)
    errs, plain_ms, small_ms, want = {}, {}, {}, {}
    for kind in peak.KINDS:
        got = peak.peak_chain(x, kind, iters)
        want[kind] = peak.peak_chain_reference(x, kind, iters)
        torch.cuda.synchronize()
        errs[kind] = float((got - want[kind]).abs().max())
        require(torch.equal(got, want[kind]),
                f"{kind} chain: max |diff| {errs[kind]:.3g} vs the plain chain (bitwise expected)")
        small_ms[kind] = time_ms(lambda: peak.peak_chain(x, kind, iters), 3)
        plain_ms[kind] = time_ms(lambda: peak.peak_chain_reference(x, kind, iters), 1)
        print(f"[25] {kind} chain, {lanes} lanes x {iters} iterations: bitwise the plain chain; "
              f"kernel {small_ms[kind]:.3f} ms, plain {plain_ms[kind]:.1f} ms")
    # the two FMA chains' plain versions round differently, so the bitwise
    # checks above tell a fused kernel from a mul + add one
    differ = int((want["fma"] != want["muladd"]).sum())
    require(differ > 0, "the fused and mul + add plain chains agree on every lane")
    print(f"[25] the fused and mul + add chains differ on {differ} of {lanes} lanes")

    its = {k: det[k]["iters"] for k in peak.KINDS}
    prof = run_profile("--profile-peak", *(str(its[k]) for k in peak.KINDS))
    dev_ms = {}
    for ms, kk in re.findall(r"([\d.]+) ms x1 [^;]*peak_kernel<(\d)>", prof):
        dev_ms[{"1": "fma", "0": "muladd", "2": "sqrt"}[kk]] = float(ms)
    require(set(dev_ms) == set(peak.KINDS), f"no device time of each chain in: {prof}")
    print(f"[25] torch.profiler (`chip_smoke.py --profile-peak`) over one full-size call of "
          f"each chain: {prof}")
    fma_lanes, sqrt_lanes = det["fma"]["lanes"], det["sqrt"]["lanes"]
    fma_ops = fma_lanes * its["fma"] * peak.STEPS * 2.0
    sqrt_ops = sqrt_lanes * its["sqrt"] * peak.STEPS
    return [
        dict(entry("lol_peak_fma", "loltracer_tpu_torch/csrc/peak.cuh",
                   "loltracer_tpu/utils/peak.py:39", e_counts["lol_peak_fma"],
                   max(errs["fma"], errs["muladd"]), det["fma"]["best_seconds"] * 1e3,
                   plain_ms["fma"], bound(8.0 * fma_lanes, fma_ops, ceiling)),
             ms_iters=its["fma"], plain_ms_iters=iters, device_ms=dev_ms["fma"],
             flops_per_s=rec["fma_flops_per_s"], muladd_device_ms=dev_ms["muladd"],
             muladd_flops_per_s=rec["muladd_flops_per_s"]),
        dict(entry("lol_peak_sqrt", "loltracer_tpu_torch/csrc/peak.cuh",
                   "loltracer_tpu/utils/peak.py:39", e_counts["lol_peak_sqrt"], errs["sqrt"],
                   det["sqrt"]["best_seconds"] * 1e3, plain_ms["sqrt"],
                   bound(8.0 * sqrt_lanes, sqrt_ops, ceiling)),
             ms_iters=its["sqrt"], plain_ms_iters=iters, device_ms=dev_ms["sqrt"]),
    ], ceiling, rec["transcendental_weight"]


def fit_target(s4, cfg, dev):
    """Phase 8's target: the port's render of scene4 at MAIN_W x MAIN_H
    with its sphere points moved by a seeded draw in [-0.1, 0.1]."""
    import numpy as np
    import torch

    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer

    gen = np.random.default_rng(0)
    moved = s4.params.sphere_point + torch.from_numpy(
        gen.uniform(-0.1, 0.1, tuple(s4.params.sphere_point.shape)).astype(np.float32)).to(dev)
    return make_cuda_renderer(s4.structure, MAIN_H, MAIN_W, cfg, device=dev)(
        dataclasses.replace(s4.params, sphere_point=moved))


def profile_fit() -> int:
    """`chip_smoke.py --profile-fit`: phase 8's fit_scene (scene4 AA at
    MAIN_W x MAIN_H, 5 Adam steps on sphere_point toward fit_target) under
    a CUDA-only torch.profiler; one JSON line on stdout: the runs of K1r,
    K2 and K2's reduce on the device trace and their device ms a launch,
    the wrappers' launch counts, the `train_step` counters and the
    losses. A process of its own, as every profile here: a second
    torch.profiler session in one process saw no device events (torch
    2.11 on an H100 machine)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.opt import fit_scene
    from loltracer_tpu_torch.render import fused_train
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.utils import tracing

    dev = torch.device("cuda", 0)
    s4 = build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=dev)
    cfg = RenderConfig(shadow_grad="envelope", antialias=True)
    target = fit_target(s4, cfg, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fit = fit_scene(s4.structure, s4.params, target, steps=5, learning_rate=3e-2,
                        trainable=("sphere_point",), cfg=cfg, device=dev)
        torch.cuda.synchronize()
    runs = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA and "lol::" in e.name]
    kernels = ("fused_fwd_kernel", "fused_bwd_kernel", "bwd_reduce_kernel")
    ran = {k: [us for n, us in runs if k in n] for k in kernels}
    counts = tracing.counters()
    print(json.dumps({
        "ran": {k: len(v) for k, v in ran.items()},
        "device_ms": {k: sum(v) / len(v) / 1e3 if v else 0.0 for k, v in ran.items()},
        "wrappers": {"lol_train_fwd": fused_train.launches_fwd,
                     "lol_train_bwd": fused_train.launches_bwd,
                     "table": fused_train.launches_table},
        "train_step": {k: counts[f"train_step.{k}"] for k in ("captures", "replays", "eager")},
        "losses": [float(v) for v in fit.losses]}))
    return 0


def profile_fused() -> int:
    """`chip_smoke.py --profile-fused`: torch.profiler over one frame of
    lol_render_fused (scene4, MAIN_W x MAIN_H), one line on stdout. Phase 8
    runs it as a process of its own, apart from `--profile-fit`'s trace of
    the training step, whose lol_train_fwd shares lol_render_fused's
    kernel name."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.render import fused_fwd
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.scene import build_scene

    s4 = build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=torch.device("cuda", 0))
    cfg = RenderConfig()
    cam, fields = camera_pack(s4.params, MAIN_H, MAIN_W, cfg), pack_fields(s4.structure, s4.params)

    def frame():
        fused_fwd.fused_forward(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)

    frame()
    print(profile_steps(frame, 3))
    return 0


def profile_peak(iters) -> int:
    """`chip_smoke.py --profile-peak F M S`: torch.profiler over one
    full-size call of each chain (lol_peak_fma fused at F iterations and mul
    + add at M, lol_peak_sqrt at S), one line on stdout."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.utils import peak

    x = torch.linspace(1.0, 2.0, peak.LANES, dtype=torch.float32, device=torch.device("cuda", 0))

    def step():
        for kind, n in zip(peak.KINDS, iters):
            peak.peak_chain(x, kind, int(n))

    step()
    print(profile_steps(step, 1))
    return 0


def same_bits(a, b) -> bool:
    """Whether two f32 tensors are bitwise equal (NaNs and -0 included)."""
    import torch

    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def same_backward(a, b) -> bool:
    """Whether two lol_instanced_bwd results with their records (dcam,
    dfields, dsph, rows, vals) are bitwise equal: the gradients, every
    record's row, and the vals of the slots that hold a row (the others
    are never written)."""
    import torch

    rows, other = a[3], b[3]
    return (all(same_bits(x, y) for x, y in zip(a[:3], b[:3])) and torch.equal(rows, other)
            and same_bits(a[4][rows >= 0], b[4][other >= 0]))


def serial_row_sums(rows, vals, ns: int):
    """[ns, 4] f32 on the host: per sphere-table row the sum of its records
    in increasing record index, added one by one from 0 (numpy's float32
    cumsum, np.add.accumulate, is sequential): the scatter's contract."""
    import numpy as np

    r = rows.reshape(-1).cpu().numpy()
    keep = np.flatnonzero(r >= 0)
    order = keep[np.argsort(r[keep], kind="stable")]
    v = vals.reshape(-1, 4).cpu().numpy()[order]
    ends = np.cumsum(np.bincount(r[keep], minlength=ns))
    out = np.zeros((ns, 4), np.float32)
    for row in np.flatnonzero(np.diff(ends, prepend=0)):
        out[row] = np.cumsum(v[(ends[row - 1] if row else 0):ends[row]], axis=0,
                             dtype=np.float32)[-1]
    return out


def regroup_phases(dev, card, inst, inst_cfgs, regroup_built, t0, e_inst, evals_march,
                   ceiling):
    """Phases 22-24: the regrouped instanced forward K9 (lol_rg_march,
    lol_rg_shadow over the cell grid, their run-walk twins, lol_rg_shade)
    and path D (module docstring). regroup_built: the four libraries;
    e_inst is phase 16's operations per instanced evaluation,
    evals_march phase 11's march evaluations per ray. Returns the three
    `kernels` entries."""
    import torch

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render import cell_grid, instanced_fwd, regroup
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cell_grid import grid_for
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced

    names = ("lol_rg_march", "lol_rg_shadow", "lol_rg_shade")

    def reset():
        for k in regroup.launches:
            regroup.launches[k] = 0
        instanced_fwd.launches = 0

    # --- 22. build; K9 over the grid vs its walk twins and the plain versions --------
    built = [f.result() for f in regroup_built]
    print(f"[22] build: {len(built)} K9 libraries (clamp 2, exact, clamp 2 AA, shadow clamp 8) "
          f"done {time.perf_counter() - t0:.1f} s after the builds started; ptxas (clamp 2): "
          + " | ".join(ptxas_lines(built[0].log)))
    h, w = 97, 161
    clamp2 = RenderConfig(step_clamp=2.0)
    errs = {k: 0.0 for k in names}
    cases = [(10_000, c) for c in inst_cfgs] + [(1, clamp2), (300, clamp2)]
    for n, c in cases:
        sc = inst[n]
        st = sc.structure
        cam = camera_pack(sc.params, h, w, c)
        fields, tab = pack_fields(st, sc.params), pack_instanced(st, sc.params)
        grid = grid_for(tab, c.step_clamp)
        what = (f"instanced:{n} step_clamp={c.step_clamp} shadow_step_clamp="
                f"{c.shadow_step_clamp} antialias={c.antialias}")
        got = regroup.march_track(st, c, cam, fields, tab, h, w, grid=grid)
        walked = regroup.march_track(st, c, cam, fields, tab, h, w, walk=True)
        want = regroup.march_track_reference(st, c, cam, fields, tab, h, w)
        torch.cuda.synchronize()
        require(all(same_bits(a, b) for a, b in zip(got, walked)),
                f"{what}: lol_rg_march differs from lol_rg_march_walk")
        require(torch.equal(got.track[1:], want.track[1:]), f"{what}: lol_rg_march hit / material")
        err, differ = check_values([got.track[0], *got.hitp, *got.rec.reshape(-1, h, w)],
                                   [want.track[0], *want.hitp, *want.rec.reshape(-1, h, w)],
                                   f"{what} lol_rg_march")
        errs["lol_rg_march"] = max(errs["lol_rg_march"], err)
        line = [f"lol_rg_march bitwise its walk twin, vs plain max |diff| {err:.3g}, {differ} "
                f"values not bitwise"]
        lo, hi = regroup.hit_box(got.hitp)
        shadow = torch.empty((st.num_lights, 2, h, w), device=dev)
        for li in range(st.num_lights):
            perm = regroup.shadow_order(got.rec[li], lo, hi)
            regroup.shadow_sorted(st, c, fields, tab, got.rec[li], perm, out=shadow[li],
                                  grid=grid)
            walk_s = regroup.shadow_sorted(st, c, fields, tab, got.rec[li], perm, walk=True)
            want_s = regroup.shadow_sorted_reference(st, c, fields, tab, got.rec[li], perm)
            torch.cuda.synchronize()
            require(same_bits(shadow[li], walk_s),
                    f"{what}: lol_rg_shadow light {li} differs from lol_rg_shadow_walk")
            err, differ = check_values(shadow[li], want_s, f"{what} lol_rg_shadow light {li}")
            errs["lol_rg_shadow"] = max(errs["lol_rg_shadow"], err)
            line.append(f"lol_rg_shadow light {li} bitwise its walk twin, vs plain max |diff| "
                        f"{err:.3g}, {differ} not bitwise")
        k_img = regroup.shade_planes(st, c, cam, fields, tab, got.track, shadow, h, w,
                                     grid=grid)
        walk_img = regroup.shade_planes(st, c, cam, fields, tab, got.track, shadow, h, w,
                                        walk=True)
        p_img = regroup.shade_planes_reference(st, c, cam, fields, tab, got.track, shadow, h, w)
        torch.cuda.synchronize()
        require(same_bits(k_img, walk_img),
                f"{what}: lol_rg_shade differs from lol_rg_shade_walk")
        err, over = compare(k_img, p_img, f"{what} lol_rg_shade")
        errs["lol_rg_shade"] = max(errs["lol_rg_shade"], err)
        k5 = instanced_fwd.instanced_forward(st, c, cam, fields, tab, h, w)
        pipe = regroup.regrouped_forward(st, c, cam, fields, tab, h, w)
        torch.cuda.synchronize()
        require(torch.equal(pipe, k5) and torch.equal(k_img, k5),
                f"{what}: the regrouped image differs from lol_instanced_render's (max |diff| "
                f"{float((pipe - k5).abs().max()):.3g})")
        line.append(f"lol_rg_shade bitwise its walk twin, vs plain max |diff| {err:.3g}, "
                    f"{over} px over {ATOL}; image bitwise lol_instanced_render's")
        print(f"[22] {what} {h}x{w}: " + "; ".join(line))

    # --- 23. path D: the regrouped renderer at 1080p --------------------------------
    big = inst[10_000]
    st = big.structure
    L = st.num_lights
    k5_imgs = {}
    for tag, c in (("clamp 2", clamp2), ("exact", RenderConfig())):
        render = regroup.make_instanced_renderer_regrouped(st, MAIN_H, MAIN_W, c, device=dev)
        reset()
        cell_grid.builds = 0
        img = render(big.params)
        torch.cuda.synchronize()
        d_counts = {k: v for k, v in regroup.launches.items() if v}
        require(d_counts == {"lol_rg_march": 1, "lol_rg_shadow": L, "lol_rg_shade": 1}
                and instanced_fwd.launches == 0 and cell_grid.builds == 1,
                f"path D ({tag}) launched {d_counts}, lol_instanced_render "
                f"{instanced_fwd.launches} times, and built {cell_grid.builds} grids")
        if tag == "clamp 2":
            main_counts = d_counts
        cam, fields, tab = (camera_pack(big.params, MAIN_H, MAIN_W, c),
                            pack_fields(st, big.params), pack_instanced(st, big.params))
        k5 = instanced_fwd.instanced_forward(st, c, cam, fields, tab, MAIN_H, MAIN_W)
        torch.cuda.synchronize()
        require(tuple(img.shape) == (MAIN_H, MAIN_W, 3) and bool(torch.isfinite(img).all()),
                f"path D ({tag}): image {tuple(img.shape)}, finite "
                f"{bool(torch.isfinite(img).all())}")
        require(torch.equal(img, k5), f"path D ({tag}): the image differs from "
                f"lol_instanced_render's, max |diff| {float((img - k5).abs().max()):.3g}")
        k5_imgs[tag] = k5
        print(f"[23] main path D: make_instanced_renderer_regrouped instanced:10000 {tag} "
              f"{MAIN_W}x{MAIN_H} -> {d_counts}, one cell grid built, no walk twin launched; "
              f"image bitwise lol_instanced_render's")

    c = clamp2
    cam, fields, tab = (camera_pack(big.params, MAIN_H, MAIN_W, c), pack_fields(st, big.params),
                        pack_instanced(st, big.params))
    grid = grid_for(tab, c.step_clamp)
    tr = regroup.march_track(st, c, cam, fields, tab, MAIN_H, MAIN_W, grid=grid)
    tr_walk = regroup.march_track(st, c, cam, fields, tab, MAIN_H, MAIN_W, walk=True)
    lo, hi = regroup.hit_box(tr.hitp)
    orders = {"sorted": [regroup.shadow_order(tr.rec[li], lo, hi) for li in range(L)],
              "unsorted": [regroup.shadow_order(tr.rec[0], lo, hi, sort=False)] * L}
    planes = {}
    for order, perms in orders.items():
        for walk in (False, True):
            out = torch.empty((L, 2, MAIN_H, MAIN_W), device=dev)
            for li in range(L):
                regroup.shadow_sorted(st, c, fields, tab, tr.rec[li], perms[li], out=out[li],
                                      grid=None if walk else grid, walk=walk)
            planes[(order, walk)] = out
    torch.cuda.synchronize()
    require(all(same_bits(a, b) for a, b in zip(tr, tr_walk)),
            "lol_rg_march at 1080p differs from lol_rg_march_walk")
    shadow = planes[("sorted", False)]
    require(all(same_bits(v, shadow) for v in planes.values()),
            "lol_rg_shadow at 1080p: sorted / unsorted, grid / walk planes differ")
    shaded = regroup.shade_planes(st, c, cam, fields, tab, tr.track, shadow, MAIN_H, MAIN_W,
                                  grid=grid)
    require(same_bits(shaded, regroup.shade_planes(st, c, cam, fields, tab, tr.track, shadow,
                                                   MAIN_H, MAIN_W, walk=True)),
            "lol_rg_shade at 1080p differs from lol_rg_shade_walk")
    print("[23] 1080p clamp 2: lol_rg_march and lol_rg_shade bitwise their walk twins; "
          "lol_rg_shadow's planes equal sorted and unsorted, over the grid and the walk")
    # the shade's grid searches (lol_rg_shade_stats, bitwise lol_rg_shade):
    # the normal taps, and with AA a miss's material lookup, which is
    # unbounded
    shade_stats = {}
    for tag, sc_cfg in (("clamp 2", c), ("clamp 2 AA", RenderConfig(step_clamp=2.0,
                                                                    antialias=True)),
                        ("exact", RenderConfig())):
        scam = camera_pack(big.params, MAIN_H, MAIN_W, sc_cfg)
        sgrid = grid_for(tab, sc_cfg.step_clamp)
        str_ = regroup.march_track(st, sc_cfg, scam, fields, tab, MAIN_H, MAIN_W, grid=sgrid)
        slo, shi = regroup.hit_box(str_.hitp)
        sshadow = torch.stack([regroup.shadow_sorted(
            st, sc_cfg, fields, tab, str_.rec[li], regroup.shadow_order(str_.rec[li], slo, shi),
            grid=sgrid) for li in range(L)])
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        counted = regroup.shade_planes(st, sc_cfg, scam, fields, tab, str_.track, sshadow,
                                       MAIN_H, MAIN_W, grid=sgrid, stats=counts)
        require(same_bits(counted, regroup.shade_planes(st, sc_cfg, scam, fields, tab,
                                                        str_.track, sshadow, MAIN_H, MAIN_W,
                                                        grid=sgrid)),
                f"{tag}: lol_rg_shade_stats differs from lol_rg_shade")
        n_search, n_fall, n_read = counts.tolist()
        shade_stats[tag] = (n_fall / max(n_search, 1), n_read / max(n_search, 1),
                            n_search / (MAIN_W * MAIN_H))
    print("[23] lol_rg_shade's grid searches at 1080p (the counting twin, bitwise the kernel): "
          + "; ".join(f"{k}: {v[2]:.2f} searches a pixel, {v[0]:.4%} fell back to the walk, "
                      f"{v[1]:.2f} list entries read a search" for k, v in shade_stats.items()))

    def glue():
        lo_, hi_ = regroup.hit_box(tr.hitp)
        for li in range(L):
            regroup.shadow_order(tr.rec[li], lo_, hi_)

    def frame():
        regroup.regrouped_forward(st, c, cam, fields, tab, MAIN_H, MAIN_W)

    def shadow_ms(li, order, walk, reps=3):
        return time_ms(lambda: regroup.shadow_sorted(
            st, c, fields, tab, tr.rec[li], orders[order][li], out=shadow[li],
            grid=None if walk else grid, walk=walk), reps)

    t = {
        "lol_rg_march": time_ms(lambda: regroup.march_track(st, c, cam, fields, tab, MAIN_H,
                                                            MAIN_W, grid=grid), 3),
        "lol_rg_march_walk": time_ms(lambda: regroup.march_track(
            st, c, cam, fields, tab, MAIN_H, MAIN_W, walk=True), 3),
        "grid build": time_ms(lambda: grid_for(tab, c.step_clamp), 3),
        "glue": time_ms(glue, 3),
        "lol_rg_shade_walk": time_ms(lambda: regroup.shade_planes(
            st, c, cam, fields, tab, tr.track, shadow, MAIN_H, MAIN_W, walk=True), 3),
        "lol_rg_shade": time_ms(lambda: regroup.shade_planes(
            st, c, cam, fields, tab, tr.track, shadow, MAIN_H, MAIN_W, grid=grid), 3),
        "frame": time_ms(frame, 3),
    }
    for li in range(L):
        for order in orders:
            t[f"lol_rg_shadow light {li} {order}"] = shadow_ms(li, order, False)
            t[f"lol_rg_shadow_walk light {li} {order}"] = shadow_ms(li, order, True)
    k5_ms = time_ms(lambda: instanced_fwd.instanced_forward(st, c, cam, fields, tab, MAIN_H,
                                                            MAIN_W), 3)
    print(f"[23] instanced:10000 clamp 2 {MAIN_W}x{MAIN_H} on {card}, CUDA events (median of 3): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in t.items())
          + f"; lol_instanced_render {k5_ms:.3f} ms in the same call")
    exact = RenderConfig()
    ecam = camera_pack(big.params, MAIN_H, MAIN_W, exact)
    exact_ms = {
        "frame": time_ms(lambda: regroup.regrouped_forward(st, exact, ecam, fields, tab, MAIN_H,
                                                           MAIN_W), 3),
        "lol_instanced_render": time_ms(lambda: instanced_fwd.instanced_forward(
            st, exact, ecam, fields, tab, MAIN_H, MAIN_W), 3),
    }
    print(f"[23] instanced:10000 exact {MAIN_W}x{MAIN_H}, CUDA events (median of 3): path D frame "
          f"{exact_ms['frame']:.3f} ms; lol_instanced_render {exact_ms['lol_instanced_render']:.3f}"
          f" ms in the same call")
    stats = {}
    for li in range(L):
        for sort in (True, False):
            for walk in (False, True):
                s = regroup.shadow_gather_stats(st, big.params, MAIN_H, MAIN_W, c, light=li,
                                                sort=sort, device=dev, walk=walk)
                stats[(li, sort, walk)] = s
                keys = (("evals_per_ray", "worst_lane_evals_per_warp", "warp_efficiency",
                         "runs_per_ray_eval", "runs_per_warp_step") if walk else
                        ("searches_per_ray", "fallback_share", "entries_per_search",
                         "worst_lane_searches_per_warp", "warp_efficiency",
                         "lists_per_warp_step", "one_list_share"))
                print(f"[23] shadow_gather_stats light {li} {'sorted' if sort else 'unsorted'} "
                      f"over the {'run walk' if walk else 'grid'}: "
                      + json.dumps({k: s[k] for k in keys + ("warps",)}))
            require(stats[(li, sort, False)]["searches_per_ray"]
                    == stats[(li, sort, True)]["evals_per_ray"],
                    f"light {li}: the grid's searches differ from the walk's evaluations")
    rg_profile = run_profile("--profile-regroup")
    print(f"[23] torch.profiler (`chip_smoke.py --profile-regroup`) over one regrouped frame: "
          f"{rg_profile}")

    # the plain version on the middle 16-row band, through the pack's row0
    r0 = (MAIN_H - BAND) // 2
    bcam = camera_pack(big.params, MAIN_H, MAIN_W, c, row0=r0)
    k_band = regroup.regrouped_forward(st, c, bcam, fields, tab, BAND, MAIN_W, MAIN_H)
    t_band = time.perf_counter()
    p_band = regroup.regrouped_forward_reference(st, c, bcam, fields, tab, BAND, MAIN_W, MAIN_H)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_band) * 1e3
    require(torch.equal(k_band, k5_imgs["clamp 2"][r0:r0 + BAND]),
            "path D middle band: the band launch differs from lol_instanced_render's rows")
    err, over = compare(k_band, p_band, "path D middle band vs regrouped_forward_reference")
    errs["lol_rg_shade"] = max(errs["lol_rg_shade"], err)
    print(f"[23] middle band (rows {r0}-{r0 + BAND - 1}): kernels bitwise lol_instanced_render's "
          f"rows; vs regrouped_forward_reference max |diff| {err:.3g}, {over} px over {ATOL}; "
          f"plain {plain_ms:.0f} ms")
    plain_pieces = {
        "lol_rg_march": time_ms(lambda: regroup.march_track_reference(
            st, c, bcam, fields, tab, BAND, MAIN_W, MAIN_H), 1),
    }
    btr = regroup.march_track(st, c, bcam, fields, tab, BAND, MAIN_W, MAIN_H, grid=grid)
    blo, bhi = regroup.hit_box(btr.hitp)
    bperms = [regroup.shadow_order(btr.rec[li], blo, bhi) for li in range(L)]
    for li in range(L):
        plain_pieces[f"lol_rg_shadow light {li}"] = time_ms(
            lambda: regroup.shadow_sorted_reference(st, c, fields, tab, btr.rec[li], bperms[li]),
            1)
    bshadow = torch.stack([regroup.shadow_sorted(st, c, fields, tab, btr.rec[li], bperms[li],
                                                 grid=grid) for li in range(L)])
    plain_pieces["lol_rg_shade"] = time_ms(lambda: regroup.shade_planes_reference(
        st, c, bcam, fields, tab, btr.track, bshadow, BAND, MAIN_W, MAIN_H), 1)

    # --- 24. bounds -----------------------------------------------------------------
    # per evaluation e_inst operations (phase 16's model), per march step 9
    # more and per shadow step 15; lol_rg_march per pixel the camera ray 33,
    # the material lookup (e_inst + 10) and 30 per light record; lol_rg_shade
    # per pixel 4 normal taps (e_inst + 12), their normalize 10, Phong 70 per
    # light and the output 30. Shadow evaluations: this frame's, per light,
    # counted by the stats launches; march evaluations per ray: phase 11's bands.
    px = MAIN_W * MAIN_H
    tables = 4 * (fields.numel() + sum(t_.numel() for t_ in tab))
    rg_march_bound = bound(tables + 64 + 4 * (6 + 7 * L) * px,
                           px * (evals_march * (e_inst + 9) + 33 + e_inst + 10 + 30 * L),
                           ceiling)
    rg_shadow_bounds = [
        bound(tables + (28 + 8 + 8) * px,
              stats[(li, True, False)]["searches_per_ray"] * px * (e_inst + 15), ceiling)
        for li in range(L)]
    rg_shade_bound = bound(tables + 64 + 4 * (3 + 2 * L + 3) * px,
                           px * (4 * (e_inst + 12) + 10 + 70 * L + 30), ceiling)
    print(f"[24] bounds (FP32 ceiling {ceiling / 1e9:.4f} TFLOP/s): lol_rg_march "
          f"{rg_march_bound[0]:.4f} ms by {rg_march_bound[1]} ({evals_march:.2f} march "
          f"evaluations per ray at {e_inst:.1f} operations); "
          + "; ".join(f"lol_rg_shadow light {li} {b[0]:.4f} ms by {b[1]} "
                      f"({stats[(li, True, False)]['searches_per_ray']:.2f} evaluations per ray)"
                      for li, b in enumerate(rg_shadow_bounds))
          + f"; lol_rg_shade {rg_shade_bound[0]:.4f} ms by {rg_shade_bound[1]}")

    src = "loltracer_tpu_torch/csrc/regroup.cuh"
    return [
        dict(entry("lol_rg_march", src, "loltracer_tpu/render/pallas_regroup.py:88",
                   main_counts["lol_rg_march"], errs["lol_rg_march"], t["lol_rg_march"],
                   plain_pieces["lol_rg_march"], rg_march_bound), plain_ms_rows=BAND,
             walk_ms=t["lol_rg_march_walk"], grid_build_ms=t["grid build"]),
        dict(entry("lol_rg_shadow", src, "loltracer_tpu/render/pallas_regroup.py:179",
                   main_counts["lol_rg_shadow"], errs["lol_rg_shadow"],
                   t["lol_rg_shadow light 0 sorted"], plain_pieces["lol_rg_shadow light 0"],
                   rg_shadow_bounds[0]),
             plain_ms_rows=BAND, ms_light=0, unsorted_ms=t["lol_rg_shadow light 0 unsorted"],
             walk_ms=t["lol_rg_shadow_walk light 0 sorted"],
             lights=[{"light": li, "ms": t[f"lol_rg_shadow light {li} sorted"],
                      "unsorted_ms": t[f"lol_rg_shadow light {li} unsorted"],
                      "walk_ms": t[f"lol_rg_shadow_walk light {li} sorted"],
                      "walk_unsorted_ms": t[f"lol_rg_shadow_walk light {li} unsorted"],
                      "plain_ms": plain_pieces[f"lol_rg_shadow light {li}"],
                      "bound_ms": rg_shadow_bounds[li][0], "bound_by": rg_shadow_bounds[li][1]}
                     for li in range(L)]),
        dict(entry("lol_rg_shade", src, "loltracer_tpu/render/pallas_regroup.py:266",
                   main_counts["lol_rg_shade"], errs["lol_rg_shade"], t["lol_rg_shade"],
                   plain_pieces["lol_rg_shade"], rg_shade_bound), plain_ms_rows=BAND,
             walk_ms=t["lol_rg_shade_walk"], frame_ms=t["frame"], glue_ms=t["glue"],
             k5_ms=k5_ms, exact_frame_ms=exact_ms["frame"],
             exact_k5_ms=exact_ms["lol_instanced_render"],
             fallback_share={k: v[0] for k, v in shade_stats.items()}),
    ]


def profile_regroup() -> int:
    """`chip_smoke.py --profile-regroup`: torch.profiler over one frame of the
    regrouped renderer (instanced:10000, clamp 2, MAIN_W x MAIN_H): device
    time by kernel (the three K9 kernels, the Morton keys and the sort) and
    the device's idle share, one line on stdout."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render.regroup import make_instanced_renderer_regrouped
    from loltracer_tpu_torch.scenes import instanced_spheres

    sc = instanced_spheres(n=10_000, device=torch.device("cuda", 0))
    render = make_instanced_renderer_regrouped(sc.structure, MAIN_H, MAIN_W,
                                               RenderConfig(step_clamp=2.0),
                                               device=torch.device("cuda", 0))

    def frame():
        render(sc.params)

    frame()
    print(profile_steps(frame, 1))
    return 0


OBJ_W, OBJ_H = 480, 272  # the two-rank world's frame (phase 28)


def object_points(structure, params, cfg, h, w):
    """K7's check points at h x w (phase 26): along the camera rays at a
    quarter, half and all of the plain march's hit distance, and along each
    light's shadow rays from those hits at 0, a tenth and half of the way
    (at most 30 units); [n, 3] each, contiguous."""
    import torch

    from loltracer_tpu_torch.render.camera import camera_rays
    from loltracer_tpu_torch.render.march_kernels import march_values_reference, pack_march_scene

    ro, rd = camera_rays(params, h, w, cfg)
    t = march_values_reference(structure, cfg, ro, rd,
                               pack_march_scene(structure, params)).t_query
    cam = torch.cat([(ro + (s * t)[..., None] * rd).reshape(-1, 3) for s in (0.25, 0.5, 1.0)])
    shadow = []
    for so, ld, dist in shadow_rays(params, ro, rd, t, cfg):
        reach = torch.clamp(dist, max=30.0)
        shadow += [(so + (s * reach)[..., None] * ld).reshape(-1, 3) for s in (0.0, 0.1, 0.5)]
    return cam.contiguous(), torch.cat(shadow).contiguous()


def near_spheres(points, pos, rad, bbox, clamp, chunk=8192) -> int:
    """The spheres within the cut max(clamp, distance to bbox) of each
    point, summed over the points: what an exact evaluation there must
    look at (phase 16's work model)."""
    import torch

    from loltracer_tpu_torch.render.sdf import bbox_cut

    total = 0
    for i in range(0, points.shape[0], chunk):
        p = points[i:i + chunk]
        d = torch.cdist(p, pos) - rad
        total += int((d <= bbox_cut(bbox[:3], bbox[3:], p, clamp)[:, None]).sum())
    return total


def objects_world(dev, ranks: int):
    """The mesh of this process' world, of `ranks` ranks, and its object
    axis (parallel/objects.ObjectAxis)."""
    from loltracer_tpu_torch.parallel import AXIS, make_mesh, objects

    mesh = make_mesh(device=dev.type)
    require(mesh.size(0) == ranks, f"a world of {mesh.size(0)} ranks, not {ranks}")
    return mesh, objects.ObjectAxis(mesh.get_group(AXIS), ranks, mesh.get_local_rank(AXIS))


def objects_rank(world: int, rank: int, store: str, out: str) -> int:
    """`chip_smoke.py --objects-rank WORLD RANK STORE OUT`: one rank of the
    two-rank world of phase 28, on the one card: gloo (it carries CUDA
    tensors through the host; NCCL refuses two ranks on one device), the
    object-sharded renderer at OBJ_W x OBJ_H, clamp 2, through K7; rank 0
    writes the image and its K7 launches to OUT."""
    import torch
    import torch.distributed as dist

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.parallel import AXIS, make_object_sharded_renderer
    from loltracer_tpu_torch.render import march_kernels
    from loltracer_tpu_torch.render.cuda_scene import INSTANCED_EVAL
    from loltracer_tpu_torch.scenes import instanced_spheres

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    mesh, _ = objects_world(dev, world)
    sc = instanced_spheres(n=10_000, device=dev)
    render = make_object_sharded_renderer(
        sc.structure, mesh, OBJ_H, OBJ_W, RenderConfig(step_clamp=2.0, march_backend="pallas"),
        obj_axis=AXIS, device=dev)
    march_kernels.launches[INSTANCED_EVAL] = 0
    t = time.perf_counter()
    with torch.no_grad():
        img = render(sc.params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    if rank == 0:
        torch.save({"img": img.cpu(), "launches": march_kernels.launches[INSTANCED_EVAL],
                    "wall_s": wall, "backend": dist.get_backend()}, out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def profile_objects() -> int:
    """`chip_smoke.py --profile-objects`: torch.profiler over one frame of
    the one-rank object-sharded renderer (instanced:10000, clamp 2, K7,
    MAIN_W x MAIN_H), one line on stdout."""
    import torch
    import torch.distributed as dist

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.parallel import AXIS, make_object_sharded_renderer
    from loltracer_tpu_torch.scenes import instanced_spheres

    dev = torch.device("cuda", 0)
    mesh, _ = objects_world(dev, 1)
    sc = instanced_spheres(n=10_000, device=dev)
    render = make_object_sharded_renderer(
        sc.structure, mesh, MAIN_H, MAIN_W, RenderConfig(step_clamp=2.0, march_backend="pallas"),
        obj_axis=AXIS, device=dev)

    def frame():
        with torch.no_grad():
            render(sc.params)

    frame()
    print(profile_steps(frame, 1))
    dist.destroy_process_group()
    return 0


def objects_phases(dev, card, inst, eval_built, t0, ceiling):
    """Phases 26-29: K7 (`lol_instanced_eval`) against its plain version,
    the object-sharded renderer over a one-rank world at 1080p (the main
    path of this slice), the same renderer over a two-rank world on the
    same card, and K7's bound. Returns K7's `kernels` entry."""
    import torch
    import torch.distributed as dist

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.parallel import AXIS, make_object_sharded_renderer, objects
    from loltracer_tpu_torch.render import instanced_fwd, march_kernels
    from loltracer_tpu_torch.render.camera import camera_pack, camera_rays
    from loltracer_tpu_torch.render.cuda_scene import INSTANCED_EVAL, pack_fields
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced
    from loltracer_tpu_torch.render.cell_grid import grid_for
    from loltracer_tpu_torch.render.march_kernels import (instanced_eval_reference,
                                                          make_instanced_eval, pack_eval_tables)
    from loltracer_tpu_torch.scenes import instanced_spheres

    # --- 26. K7 vs its plain version ------------------------------------------------
    built = [f.result() for f in eval_built]
    print(f"[26] build: {len(built)} lol_instanced_eval libraries (clamp 2, exact, clamp 8) "
          f"done {time.perf_counter() - t0:.1f} s after the builds started; ptxas (clamp 2): "
          + " | ".join(ptxas_lines(built[0].log)))
    big = inst[10_000]
    h, w = 97, 161
    clamp2 = RenderConfig(step_clamp=2.0)
    cam_pts, shadow_pts = object_points(big.structure, big.params, clamp2, h, w)
    # a shard: the second half of instanced:10001 padded over 2 (one
    # sentinel sphere), under the AABB of all 10001 spheres
    odd = instanced_spheres(n=10_001, seed=0, device=dev)
    axis2 = objects.ObjectAxis(None, 2, 1)
    shard = objects.shard_spheres(objects.pad_spheres_for_sharding(odd.params, 2), axis2)
    require(int((shard.sphere_radius < -1e29).sum()) == 1, "the shard holds no sentinel")
    whole = pack_eval_tables(odd.params).bbox
    shard_tables = pack_eval_tables(shard)
    require(bool((shard_tables.bbox[:3] > whole[:3]).any() or
                 (shard_tables.bbox[3:] < whole[3:]).any()),
            "the shard's own AABB is as wide as the combined one")
    shard_st = dataclasses.replace(odd.structure, num_spheres=shard.sphere_radius.shape[0], material_ids=())
    eval_cases = [
        ("instanced:10000 clamp 2", big, big.structure, pack_eval_tables(big.params), clamp2),
        ("instanced:10000 exact", big, big.structure, pack_eval_tables(big.params),
         RenderConfig()),
        ("instanced:10000 shadow clamp 8", big, big.structure, pack_eval_tables(big.params),
         RenderConfig(step_clamp=8.0)),
        ("instanced:10001 shard 2 of 2, combined AABB, clamp 2", odd, shard_st,
         shard_tables._replace(bbox=whole), clamp2),
    ]
    k7_err = 0.0
    for what, sc, st, tables, c in eval_cases:
        fn = make_instanced_eval(st, c)
        for kind, pts in (("camera", cam_pts), ("shadow", shadow_pts)):
            got = fn(tables, sc.params.plane_y, pts)
            walked = fn(tables, sc.params.plane_y, pts, walk=True)
            want = instanced_eval_reference(tables, sc.params.plane_y, pts, c.step_clamp)
            torch.cuda.synchronize()
            require(torch.equal(got, walked), f"{what} {kind} points: grid != run walk")
            err, differ = check_values([got], [want], f"{what} {kind} points")
            k7_err = max(k7_err, err)
            print(f"[26] {what}, {pts.shape[0]} {kind} points of {h}x{w}: the grid = the run "
                  "walk bitwise; vs plain " + ("bitwise equal" if differ == 0 else
                     f"{differ} differ, max |diff| {err:.3g} (within atol/rtol 1e-4)"))

    # --- 27. the main path: one-rank object-sharded frame at 1080p through K7 ---------
    mesh, axis = objects_world(dev, 1)
    render = make_object_sharded_renderer(big.structure, mesh, MAIN_H, MAIN_W,
                                          RenderConfig(step_clamp=2.0, march_backend="pallas"),
                                          obj_axis=AXIS, device=dev)
    twin_calls = [0]
    real_twin = march_kernels.instanced_eval_reference

    def counted_twin(*a, **k):
        twin_calls[0] += 1
        return real_twin(*a, **k)

    march_kernels.instanced_eval_reference = counted_twin
    try:
        march_kernels.launches[INSTANCED_EVAL] = 0
        t_first = time.perf_counter()
        with torch.no_grad():
            img = render(big.params)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t_first
        k7_launches = march_kernels.launches[INSTANCED_EVAL]
    finally:
        march_kernels.instanced_eval_reference = real_twin
    require(k7_launches > 0, "the object-sharded frame launched lol_instanced_eval no time")
    require(twin_calls[0] == 0, f"the kernel tier ran the plain K7 {twin_calls[0]} times")
    require(tuple(img.shape) == (MAIN_H, MAIN_W, 3), f"image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "non-finite pixels")
    cam = camera_pack(big.params, MAIN_H, MAIN_W, clamp2)
    fields, tab = pack_fields(big.structure, big.params), pack_instanced(big.structure,
                                                                         big.params)
    k5 = instanced_fwd.instanced_forward(big.structure, clamp2, cam, fields, tab, MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    if torch.equal(img, k5):
        k5_rule = "bitwise lol_instanced_render's"
    else:
        err, over = compare(img, k5, "object-sharded 1080p vs lol_instanced_render")
        k5_rule = f"within the phase-2 rule of lol_instanced_render's (max |diff| {err:.3g}, {over} px)"

    def frame():
        with torch.no_grad():
            render(big.params)

    frame_ms = time_ms(frame, 2)
    # the hit-id lookup stays the plain sharded sdf_id (as in the JAX package), timed apart
    ro, rd = camera_rays(big.params, MAIN_H, MAIN_W, clamp2)
    t_q = march_kernels.march_values(big.structure, clamp2, ro, rd,
                                     march_kernels.pack_march_scene(big.structure, big.params))
    hit_pts = (ro + t_q.t_query[..., None] * rd).reshape(-1, 3).contiguous()
    bbox = objects.combined_bbox(big.params, axis)
    _, sdf_id, _ = objects._sharded_sdfs(big.structure, clamp2, axis, bbox)

    def id_lookup():
        with torch.no_grad():
            sdf_id(big.params, hit_pts)

    id_lookup()
    id_ms = time_ms(id_lookup, 2)
    tables = pack_eval_tables(big.params)._replace(bbox=bbox)
    k7 = make_instanced_eval(big.structure, clamp2)
    grid = grid_for(tables, 2.0)  # as the renderer builds it, once a frame

    def k7_once():
        k7(tables, big.params.plane_y, hit_pts, grid)

    def k7_walk():
        k7(tables, big.params.plane_y, hit_pts, walk=True)

    def k7_grid():
        grid_for(tables, 2.0)

    def k7_plain():
        instanced_eval_reference(tables, big.params.plane_y, hit_pts, 2.0)

    k7_once(), k7_walk()
    k7_walk_ms = [time_ms(k7_walk, 5)]
    k7_ms = time_ms(k7_once, 5)
    k7_walk_ms.append(time_ms(k7_walk, 5))
    k7_build_ms = time_ms(k7_grid, 5)
    got_hit = k7(tables, big.params.plane_y, hit_pts, grid)
    require(torch.equal(got_hit, k7(tables, big.params.plane_y, hit_pts, walk=True)),
            "K7 at the 1080p hit points: grid != run walk")
    want_hit = instanced_eval_reference(tables, big.params.plane_y, hit_pts, 2.0)
    err, differ = check_values([got_hit], [want_hit], "lol_instanced_eval at the 1080p hit points")
    k7_err = max(k7_err, err)
    k7_plain_ms = time_ms(k7_plain, 1)
    prof = run_profile("--profile-objects")
    m = re.search(r"([\d.]+) ms x(\d+) [^;]*instanced_eval_kernel", prof)
    dev_k7_ms = float(m.group(1)) / int(m.group(2)) if m else None
    dev_k7 = f"{dev_k7_ms:.4f} ms" if m else "not in the profile"
    print(f"[27] main path: make_object_sharded_renderer(instanced:10000, make_mesh() of one "
          f"rank, {MAIN_W}x{MAIN_H}, clamp 2, march_backend='pallas') -> {k7_launches} "
          f"lol_instanced_eval launches per frame, the plain K7 never; image {k5_rule}; first "
          f"frame {t_first:.2f} s (builds loaded)")
    print(f"[27] on {card}: frame {frame_ms:.3f} ms (CUDA events, median of 2); the plain "
          f"sdf_id at the {MAIN_W * MAIN_H} hit points {id_ms:.3f} ms; one K7 launch there "
          f"{k7_ms:.4f} ms (median of 5; the grid, built once a frame in {k7_build_ms:.3f} ms; "
          f"the run walk {k7_walk_ms[0]:.4f} / {k7_walk_ms[1]:.4f} ms before / after, bitwise "
          f"equal; " + ("bitwise its plain version" if differ == 0 else
                        f"{differ} points differ, max |diff| {err:.3g}")
          + f"), its plain version {k7_plain_ms:.1f} ms; torch.profiler over one frame "
          f"(`chip_smoke.py --profile-objects`): K7 {dev_k7} per launch on the device; {prof}")

    # --- 28. two ranks on the one card (gloo) against one rank -----------------------
    render_small = make_object_sharded_renderer(
        big.structure, mesh, OBJ_H, OBJ_W, RenderConfig(step_clamp=2.0, march_backend="pallas"),
        obj_axis=AXIS, device=dev)
    with torch.no_grad():
        one = render_small(big.params)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--objects-rank", "2", str(r), str(Path(tmp) / "store"),
                                   str(Path(tmp) / "rank0.pt")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log[-2000:]) for r, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
        require(not bad, f"the two-rank world failed: {bad}")
        two = torch.load(Path(tmp) / "rank0.pt")
    require(two["launches"] > 0, "the two-rank world launched lol_instanced_eval no time")
    two_img = two["img"].to(dev)
    if torch.equal(two_img, one):
        pair_rule = "bitwise the one-rank image"
    else:
        err, over = compare(two_img, one, "two ranks vs one rank")
        pair_rule = f"within the phase-2 rule of the one-rank image (max |diff| {err:.3g}, {over} px)"
    print(f"[28] two ranks on the one card ({two['backend']}, `chip_smoke.py --objects-rank`), "
          f"instanced:10000 split 5000 + 5000, {OBJ_W}x{OBJ_H}, clamp 2: {two['launches']} "
          f"lol_instanced_eval launches on rank 0, frame {two['wall_s']:.2f} s on the host "
          f"clock; image {pair_rule}")
    dist.destroy_process_group()

    # --- 29. K7's bound ---------------------------------------------------------------
    n = hit_pts.shape[0]
    near = near_spheres(hit_pts, big.params.sphere_point, big.params.sphere_radius, bbox, 2.0)
    k7_bound = bound(16.0 * n, n * 22.0 + 9.0 * near, ceiling)
    print(f"[29] bound: lol_instanced_eval at the {n} hit points {k7_bound[0]:.4f} ms by "
          f"{k7_bound[1]} ({near / n:.2f} spheres within the cut per point, 9 operations each "
          f"+ 22; {16 * n / 1e6:.1f} MB)")
    return dict(entry("lol_instanced_eval", "loltracer_tpu_torch/csrc/march.cuh",
                      "loltracer_tpu/render/pallas_march.py:222", k7_launches, k7_err, k7_ms,
                      k7_plain_ms, k7_bound),
                frame_ms=frame_ms, sdf_id_ms=id_ms, walk_ms=k7_walk_ms,
                grid_build_ms=k7_build_ms, device_ms=dev_k7_ms), hit_pts


def grid_phase(dev, card, inst, hit_pts) -> None:
    """Phase 30: the cell grid (render/cell_grid.py) and GridScene
    (csrc/grid_scene.cuh) at instanced:10000: K7 over the grid bitwise K7
    over the run walk on a full 1080p frame of points (phase 27's hit
    points, the camera rays at a quarter and half of the way, and each
    light's shadow rays from the hits at 0, a tenth and half of the way, at
    most 30 units) under step clamps 2, none and 8, with the share of
    searches that fell back; then the cell-size sweep: per cell size the
    grid's build time (CUDA events, median of 5), its list lengths, K5's
    1080p frame at clamp 2 over it (median of 2, its image bitwise the
    default grid's) with its fallback share, and K7 at the hit points
    (median of 5, bitwise)."""
    import torch

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render import instanced_fwd, march_kernels
    from loltracer_tpu_torch.render.camera import camera_pack, camera_rays
    from loltracer_tpu_torch.render.cell_grid import CELL, build_cell_grid, reach_for
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced

    big = inst[10_000]
    st, params = big.structure, big.params
    clamp2 = RenderConfig(step_clamp=2.0)
    ro, rd = camera_rays(params, MAIN_H, MAIN_W, clamp2)
    t = (hit_pts.reshape(MAIN_H, MAIN_W, 3) - ro).norm(dim=-1)
    frame = [hit_pts] + [(ro + (s * t)[..., None] * rd).reshape(-1, 3) for s in (0.25, 0.5)]
    for l in range(st.num_lights):
        to = params.light_point[l] - hit_pts
        dist = to.norm(dim=-1, keepdim=True)
        reach = torch.clamp(dist, max=30.0)
        frame += [hit_pts + s * reach * to / dist for s in (0.0, 0.1, 0.5)]
    frame = torch.cat(frame).contiguous()
    tables = march_kernels.pack_eval_tables(params)
    for c in (2.0, None, 8.0):
        cfg = RenderConfig(step_clamp=c)
        k7 = march_kernels.make_instanced_eval(st, cfg)
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        got = k7(tables, params.plane_y, frame, stats=counts)
        require(torch.equal(got, k7(tables, params.plane_y, frame)),
                "K7's counting twin differs from K7")
        require(torch.equal(got, k7(tables, params.plane_y, frame, walk=True)),
                f"K7 step clamp {c}: the grid search != the run walk on the 1080p frame points")
        n_search, n_fall, n_read = counts.tolist()
        print(f"[30] lol_instanced_eval step clamp {c}, {frame.shape[0]} points of a "
              f"{MAIN_W}x{MAIN_H} frame: the grid search = the run walk bitwise; "
              f"{n_fall / n_search:.4%} fell back, {n_read / n_search:.2f} list entries read "
              f"a search")

    cam = camera_pack(params, MAIN_H, MAIN_W, clamp2)
    fields, tab = pack_fields(st, params), pack_instanced(st, params)
    ref = instanced_fwd.instanced_forward(st, clamp2, cam, fields, tab, MAIN_H, MAIN_W)
    k7 = march_kernels.make_instanced_eval(st, clamp2)
    k7_ref = k7(tables, params.plane_y, hit_pts)
    reach = reach_for(tab, 2.0)
    for cell in (0.5, 1.0, 2.0):
        grid = build_cell_grid(tab, reach, cell)
        lens = (grid.cell_start[1:] - grid.cell_start[:-1]).float()
        build_ms = time_ms(lambda: build_cell_grid(tab, reach, cell), 5)
        egrid = build_cell_grid(tables, reach, cell)

        def k5():
            instanced_fwd.instanced_forward(st, clamp2, cam, fields, tab, MAIN_H, MAIN_W,
                                            grid=grid)

        def k7_once():
            k7(tables, params.plane_y, hit_pts, egrid)

        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        img = instanced_fwd.instanced_forward(st, clamp2, cam, fields, tab, MAIN_H, MAIN_W,
                                              grid=grid, stats=counts)
        require(torch.equal(img, ref), f"cell {cell}: K5's image differs from the default's")
        require(torch.equal(k7(tables, params.plane_y, hit_pts, egrid), k7_ref),
                f"cell {cell}: K7 differs from the default grid's")
        k5()
        k5_ms = time_ms(k5, 2)
        k7_once()
        k7_ms = time_ms(k7_once, 5)
        n_search, n_fall, n_read = counts.tolist()
        print(f"[30] cell {cell}{' (the default)' if cell == CELL else ''} on {card}: grid "
              f"{grid.dims} = {lens.numel()} cells, {grid.cell_rows.numel()} entries "
              f"({grid.cell_rows.numel() * 20 / 1e6:.1f} MB: a row and a sphere each), "
              f"list length mean "
              f"{float(lens.mean()):.2f} (over non-empty cells "
              f"{float(lens[lens > 0].mean()):.2f}), max {int(lens.max())}; build "
              f"{build_ms:.3f} ms; lol_instanced_render clamp 2 {MAIN_W}x{MAIN_H} {k5_ms:.3f} ms "
              f"(image bitwise; {n_fall / n_search:.4%} of {n_search} searches fell back, "
              f"{n_read / n_search:.2f} entries read a search); lol_instanced_eval at the "
              f"{hit_pts.shape[0]} hit points {k7_ms:.4f} ms (bitwise)")


DEAL_H = 1088  # rows of the dealt frames (phases 31-32): 1088 = 2 x 16 x 34 deals over 2 ranks
DEAL_SPHERES = 10_000  # the instanced scene of phase 32


def check_sum_grads(got, want, names, what: str) -> float:
    """The phase-7 rule: each gradient in `got` within 1e-4 * max|want| of
    `want` (per field of `names`, a dict name -> (got, want)), dcam within
    rtol 2e-3 (atol 1e-5 * max(1, max|dcam|)). Returns max |diff| / scale."""
    worst = 0.0
    for f, (g, v) in names.items():
        if v.numel() == 0:
            continue
        scale = max(float(v.abs().max()), 1e-6)
        err = float((g - v).abs().max())
        worst = max(worst, err / scale)
        require(err <= 1e-4 * scale, f"{what}: d{f} max |diff| {err:.3g} > 1e-4 * {scale:.3g}")
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    require(bool(((got - want).abs() <= atol + 2e-3 * want.abs()).all()),
            f"{what}: dcam {got.tolist()} vs {want.tolist()}")
    return worst


def rowtab_phase(dev, scenes, inst, train_cases, h, w):
    """Phase 31: the row table of K1r / K2 / K5r / K6 against cam[15]
    (`nullptr`) and the two-launch LPT frames at DEAL_H x MAIN_W. Returns
    the deal of each (`deal`'s part of the kernels' entries)."""
    import numpy as np
    import torch

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.parallel.sharded import _row_permutation, row_granularity
    from loltracer_tpu_torch.render import fused_train, instanced_train
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cell_grid import grid_for
    from loltracer_tpu_torch.render.cuda_scene import pack_fields, unpack_fields
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced

    def table(rows, block):
        return torch.as_tensor(np.asarray(rows)[::block], dtype=torch.float32, device=dev)

    def seeded_ct(hh, ww):
        gen = np.random.default_rng(0)
        return torch.from_numpy(gen.uniform(-1, 1, (hh, ww, 3)).astype(np.float32)).to(dev)

    def same_grads(g, t_g):
        # dcam[15], row0's slot, is 0 under a table: the rows are the table's
        return (all(same_bits(a, b) for a, b in zip(g[1:3], t_g[1:3]))
                and same_bits(g[0][:15], t_g[0][:15]) and float(t_g[0][15]) == 0.0)

    def k1r_k2(st, c, cam, fields, hh, ww):
        """(nullptr, 8k) launches of K1r and K2 over hh x ww: bitwise."""
        tab = table(range(hh), 8)
        img, res = fused_train.train_forward(st, c, cam, fields, hh, ww)
        t_img, t_res = fused_train.train_forward(st, c, cam, fields, hh, ww, rowtab=tab)
        ct = seeded_ct(hh, ww)
        g = fused_train.train_backward(st, c, cam, fields, res, ct)
        t_g = fused_train.train_backward(st, c, cam, fields, t_res, ct, rowtab=tab)
        torch.cuda.synchronize()
        return same_bits(img, t_img) and same_bits(res, t_res) and same_grads(g, t_g)

    def k5r_k6(sc, c, cam, fields, tab_i, hh, ww, grid):
        """(nullptr, 16k) launches of K5r and K6 (records included): bitwise."""
        tab = table(range(hh), 16)
        st = sc.structure
        img, res = instanced_train.instanced_train_forward(st, c, cam, fields, tab_i, hh, ww,
                                                           grid=grid)
        t_img, t_res = instanced_train.instanced_train_forward(st, c, cam, fields, tab_i, hh, ww,
                                                               grid=grid, rowtab=tab)
        ct = seeded_ct(hh, ww)
        g = instanced_train.instanced_train_backward(st, c, cam, fields, tab_i, res, ct,
                                                     grid=grid, records=True)
        t_g = instanced_train.instanced_train_backward(st, c, cam, fields, tab_i, t_res, ct,
                                                       grid=grid, records=True, rowtab=tab)
        torch.cuda.synchronize()
        # the records (rows, vals) where the launches return them
        records = (all(torch.equal(a, b) for a, b in zip(g[3:4], t_g[3:4]))
                   and all(same_bits(a[r >= 0], b[r >= 0])
                           for a, b, r in zip(g[4:5], t_g[4:5], g[3:4])))
        return (same_bits(img, t_img) and same_bits(res, t_res) and same_grads(g, t_g)
                and records)

    # --- the five phase-6 cases at h x w, and scene4 AA at MAIN_W x MAIN_H
    for name, c in train_cases:
        s = scenes[name]
        ok = k1r_k2(s.structure, c, camera_pack(s.params, h, w, c),
                    pack_fields(s.structure, s.params), h, w)
        require(ok, f"{name} antialias={c.antialias} {h}x{w}: a K1r / K2 launch with the row "
                    "table 8k differs from its nullptr launch")
    s4, c_aa = scenes["scene4.lol"], train_cases[-1][1]
    cam4, fields4 = camera_pack(s4.params, MAIN_H, MAIN_W, c_aa), pack_fields(s4.structure,
                                                                            s4.params)
    require(k1r_k2(s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W),
            f"scene4 AA {MAIN_W}x{MAIN_H}: K1r / K2 with the row table 8k differ from their "
            "nullptr launches")
    big, clamp2_env = inst[10_000], RenderConfig(step_clamp=2.0, shadow_grad="envelope")
    st10 = big.structure
    fields_i, tab_i = pack_fields(st10, big.params), pack_instanced(st10, big.params)
    grid = grid_for(tab_i, clamp2_env.step_clamp)
    for hh, ww in ((h, w), (MAIN_H, MAIN_W)):
        cam_i = camera_pack(big.params, hh, ww, clamp2_env)
        ok = k5r_k6(big, clamp2_env, cam_i, fields_i, tab_i, hh, ww, grid)
        require(ok, f"instanced:10000 clamp 2 {hh}x{ww}: a K5r / K6 launch with the row table "
                    "16k differs from its nullptr launch (image, residuals, records, grads, "
                    "dsph)")
    print(f"[31] row table = cam[15]: K1r and K2 with rowtab 8k bitwise their nullptr launches "
          f"(image, residual planes, dcam, dfields) on the {len(train_cases)} phase-6 cases at "
          f"{h}x{w} and scene4 AA at {MAIN_W}x{MAIN_H}; K5r and K6 with 16k bitwise theirs "
          f"(image, residuals, records, dcam, dfields, dsph) on instanced:10000 clamp 2 at "
          f"{h}x{w} and {MAIN_W}x{MAIN_H}")

    # --- the LPT deal over 2 shards at DEAL_H rows, rendered as two launches
    deal = {}
    for tag, sc, c in (("scene4 AA", s4, c_aa), ("instanced:10000 clamp 2", big, clamp2_env)):
        st, G = sc.structure, row_granularity(sc.structure)
        t = time.perf_counter()
        perm = _row_permutation(st, DEAL_H, MAIN_W, 2, c, True, sc.params)[0]
        model_s = time.perf_counter() - t
        cam = camera_pack(sc.params, DEAL_H, MAIN_W, c)
        fields = pack_fields(st, sc.params)
        ct = seeded_ct(DEAL_H, MAIN_W)
        half = DEAL_H // 2
        shards = [perm[r * half:(r + 1) * half] for r in range(2)]
        if st.instanced:
            def fwd(hh, tab=None, fh=None):
                return instanced_train.instanced_train_forward(st, c, cam, fields, tab_i, hh,
                                                               MAIN_W, fh, grid=grid, rowtab=tab)

            def bwd(res, ct_, tab=None, fh=None):
                return instanced_train.instanced_train_backward(st, c, cam, fields, tab_i, res,
                                                                ct_, fh, grid=grid, rowtab=tab)
        else:
            def fwd(hh, tab=None, fh=None):
                return fused_train.train_forward(st, c, cam, fields, hh, MAIN_W, fh, tab)

            def bwd(res, ct_, tab=None, fh=None):
                return fused_train.train_backward(st, c, cam, fields, res, ct_, fh, tab)

        img, res = fwd(DEAL_H)
        full = bwd(res, ct)
        sums = None
        for rows in shards:
            tab = table(rows, G)
            s_img, s_res = fwd(half, tab, DEAL_H)
            idx = torch.as_tensor(rows, device=dev)
            require(same_bits(s_img, img[idx]) and same_bits(s_res, res[:, idx]),
                    f"{tag} {MAIN_W}x{DEAL_H}: a shard's launch differs from the full frame's "
                    "rows")
            part = bwd(s_res, ct[idx].contiguous(), tab, DEAL_H)
            sums = part if sums is None else tuple(a + b for a, b in zip(sums, part))
        torch.cuda.synchronize()
        pairs = {f: (g, unpack_fields(st, full[1])[f])
                 for f, g in unpack_fields(st, sums[1]).items()}
        if st.instanced:
            pairs["sphere table"] = (sums[2], full[2])
        # dcam[15] (row0's slot) is 0 under the tables
        require(float(sums[0][15]) == 0.0, f"{tag}: dcam[15] under the row tables")
        worst = check_sum_grads(sums[0][:15], full[0][:15], pairs,
                                f"{tag} two-launch gradients")
        blocks = np.asarray(perm).reshape(-1, G)[:, 0] // G
        deal[tag] = {"model_s": model_s, "worst": worst, "blocks": [blocks[:half // G].tolist()[:6],
                                                                    blocks[half // G:].tolist()[:6]]}
        print(f"[31] {tag} {MAIN_W}x{DEAL_H}: the LPT deal over 2 shards of {G}-row blocks "
              f"(the cost model on the card, {model_s:.1f} s; shard 0's first blocks "
              f"{deal[tag]['blocks'][0]}, shard 1's {deal[tag]['blocks'][1]}) as two launches "
              f"with their row tables: each shard's image and residual planes bitwise the full "
              f"frame's rows; the summed gradients within the phase-7 rule of the full frame's "
              f"(max |diff| / max|grad| {worst:.3g})")
    return deal


def sharded_cases():
    """(tag, scene maker, config, steps) of the two-rank phase 32."""
    from loltracer_tpu_torch.config import RenderConfig

    return [("scene4", RenderConfig(antialias=True, shadow_grad="envelope"), 3),
            ("instanced", RenderConfig(step_clamp=2.0, shadow_grad="envelope"), 2)]


def sharded_scene(tag, dev):
    import numpy as np
    import torch

    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    sc = (build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=dev)
          if tag == "scene4" else instanced_spheres(n=DEAL_SPHERES, device=dev))
    moved = sc.params.sphere_point + torch.from_numpy(np.random.default_rng(0).uniform(
        -0.1, 0.1, tuple(sc.params.sphere_point.shape)).astype(np.float32)).to(dev)
    return sc, moved


def sharded_run(mesh, dev, timed: bool, barrier=None):
    """On `mesh` (every rank calls it): for each of sharded_cases(), the
    image of make_sharded_renderer and `steps` steps of
    make_sharded_train_step (Adam on sphere_point, lr 1e-2, from scene's
    params toward its image with the spheres moved), both over the LPT
    deal of the cost model; returns tag -> {"img", "losses", "grads" (the
    first step's), "params"} and, with `timed`, each rank's K1r + K2 /
    K5r + K6 launches over its rows timed alone (its turn between
    barriers: CUDA events, median of 3)."""
    import torch

    from loltracer_tpu_torch.opt import masked_optimizer, trainable_leaves
    from loltracer_tpu_torch.parallel import make_sharded_renderer, make_sharded_train_step
    from loltracer_tpu_torch.parallel.sharded import _sharding
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.scene import FIELDS

    out = {}
    for tag, c, steps in sharded_cases():
        sc, moved = sharded_scene(tag, dev)
        st = sc.structure
        with torch.no_grad():
            target = make_cuda_renderer(st, DEAL_H, MAIN_W, c, device=dev)(
                dataclasses.replace(sc.params, sphere_point=moved))
        img = make_sharded_renderer(st, mesh, DEAL_H, MAIN_W, c, balance_params=sc.params,
                                    device=dev)(sc.params)
        leaves = trainable_leaves(sc.params, ("sphere_point",))
        opt = masked_optimizer(leaves, ("sphere_point",), lr=1e-2)
        step = make_sharded_train_step(st, mesh, DEAL_H, MAIN_W, opt, c,
                                       balance_params=sc.params, device=dev)
        losses, grads = [], None
        for _ in range(steps):
            losses.append(step(leaves, target).item())
            if grads is None:
                grads = leaves.sphere_point.grad.detach().clone()
        rec = {"img": img, "losses": losses, "grads": grads,
               "params": {f: getattr(leaves, f).detach().clone() for f in FIELDS}}
        if timed:
            sh = _sharding(st, mesh, DEAL_H, MAIN_W, c, torch.float32, "auto", True, sc.params,
                           dev, "phase 32")

            def launch():
                leaves.sphere_point.grad = None
                loss = ((sh.render_rows(leaves, sh.rows) - target[sh.rows]) ** 2).sum()
                loss.backward()

            ms = []
            for r in range(mesh.size()):
                barrier()
                if r == sh.shard.index:
                    launch()
                    ms = [time_ms(launch, 1) for _ in range(3)]
                barrier()
            rec["rank_ms"] = statistics.median(ms)
        out[tag] = rec
    return out


def sharded_rank(world: int, rank: int, store: str, out: str) -> int:
    """`chip_smoke.py --sharded-rank WORLD RANK STORE OUT`: one rank of the
    two-rank world of phase 32 on the one card (gloo, as phase 28):
    sharded_run over make_mesh(WORLD); writes its results to OUT.RANK."""
    import torch
    import torch.distributed as dist

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from loltracer_tpu_torch.parallel import make_mesh
    from loltracer_tpu_torch.render import fused_train, instanced_train

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    mesh = make_mesh(world, device="cuda")
    t = time.perf_counter()
    res = sharded_run(mesh, dev, timed=True, barrier=dist.barrier)
    res["wall_s"] = time.perf_counter() - t
    res["backend"] = dist.get_backend()
    res["table_launches"] = fused_train.launches_table + instanced_train.launches_table
    torch.save({k: v for k, v in res.items()}, f"{out}.{rank}")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def sharded_phase(dev, card):
    """Phase 32: two ranks on one card (`--sharded-rank` children, gloo)
    against one rank (this process, a world of one)."""
    import torch
    import torch.distributed as dist

    from loltracer_tpu_torch.parallel import make_mesh

    mesh = make_mesh(device=dev.type)
    one = sharded_run(mesh, dev, timed=False)
    dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                   "--sharded-rank", "2", str(r), str(Path(tmp) / "store"),
                                   str(Path(tmp) / "rank")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=400)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode, log[-2000:]) for r, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
        require(not bad, f"the two-rank world failed: {bad}")
        ranks = [torch.load(Path(tmp) / f"rank.{r}", map_location=dev) for r in range(2)]
    require(all(r["table_launches"] > 0 for r in ranks),
            "a rank launched no training kernel with a row table")
    summary = {}
    for tag, _, steps in sharded_cases():
        a, b, ref = ranks[0][tag], ranks[1][tag], one[tag]
        require(same_bits(a["img"], ref["img"]) and same_bits(b["img"], ref["img"]),
                f"{tag}: a rank's sharded image differs from the one-rank image")
        for r in (a, b):
            require(all(abs(x - y) <= 1e-5 * abs(y) for x, y in zip(r["losses"], ref["losses"])),
                    f"{tag}: losses {r['losses']} vs one rank's {ref['losses']}")
        scale = max(float(ref["grads"].abs().max()), 1e-6)
        err = float((a["grads"] - ref["grads"]).abs().max())
        require(err <= 1e-4 * scale,
                f"{tag}: first-step d sphere_point max |diff| {err:.3g} > 1e-4 * {scale:.3g}")
        require(all(same_bits(a["params"][f], b["params"][f]) for f in a["params"]),
                f"{tag}: the ranks' params differ after {steps} steps")
        ms = [ranks[0][tag]["rank_ms"], ranks[1][tag]["rank_ms"]]
        summary[tag] = {"rank_ms": ms, "balance": sum(ms) / (2 * max(ms))}
        print(f"[32] {tag} {MAIN_W}x{DEAL_H}, two ranks on one card ({ranks[0]['backend']}, "
              f"`chip_smoke.py --sharded-rank`; a correctness phase: both processes share the "
              f"card and gloo copies through the host): images bitwise the one-rank image; "
              f"losses {a['losses']} within rtol 1e-5 of one rank's {ref['losses']}; the first "
              f"step's d sphere_point within {err / scale:.3g} * max|g| of one rank's; params "
              f"bitwise equal across ranks after {steps} steps; each rank's fwd + bwd launches "
              f"over its rows alone on {card}: {ms[0]:.3f} / {ms[1]:.3f} ms (balance "
              f"{summary[tag]['balance']:.4f}); wall {ranks[0]['wall_s']:.1f} s / "
              f"{ranks[1]['wall_s']:.1f} s")
    return summary


def checkpoint_phase(dev, card, s4):
    """Phase 33: a resumed fit_scene bitwise an unbroken one, `cli fit
    --checkpoint`, a corrupt checkpoint refused."""
    import numpy as np
    import torch

    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.opt import fit_scene, load_checkpoint
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.scene import FIELDS

    c = RenderConfig(antialias=True, shadow_grad="envelope")
    moved = s4.params.sphere_point + torch.from_numpy(np.random.default_rng(0).uniform(
        -0.1, 0.1, tuple(s4.params.sphere_point.shape)).astype(np.float32)).to(dev)
    target = make_cuda_renderer(s4.structure, MAIN_H, MAIN_W, c, device=dev)(
        dataclasses.replace(s4.params, sphere_point=moved))
    kw = dict(trainable=("sphere_point",), cfg=c, learning_rate=3e-2, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "fit.ckpt")
        t = time.perf_counter()
        whole = fit_scene(s4.structure, s4.params, target, steps=4, **kw)
        first = fit_scene(s4.structure, s4.params, target, steps=2, checkpoint_path=path,
                          checkpoint_every=2, **kw)
        require(load_checkpoint(path, s4.structure)[0] == 2, "no checkpoint at step 2")
        rest = fit_scene(s4.structure, s4.params, target, steps=4, checkpoint_path=path,
                         checkpoint_every=2, **kw)
        fit_s = time.perf_counter() - t
        losses = list(first.losses) + list(rest.losses)
        require(losses == list(whole.losses), f"resumed losses {losses} vs {list(whole.losses)}")
        require(all(same_bits(getattr(rest.params, f), getattr(whole.params, f)) for f in FIELDS),
                "the resumed fit's params differ from the unbroken fit's")
        # cli fit --checkpoint (its config: AA, exact shadows) at a quarter size
        small = make_cuda_renderer(s4.structure, MAIN_H // 4, MAIN_W // 4, c, device=dev)(
            dataclasses.replace(s4.params, sphere_point=moved))
        npy, cpath = str(Path(tmp) / "t.npy"), str(Path(tmp) / "cli.ckpt")
        np.save(npy, small.cpu().numpy())
        fit_scene(s4.structure, s4.params, small, steps=1, checkpoint_path=cpath,
                  checkpoint_every=1, trainable=("sphere_point",),
                  cfg=RenderConfig(antialias=True), device=dev)
        args = ["fit", str(EXAMPLES / "scene4.lol"), "--target", npy, "--steps", "2",
                "--trainable", "sphere_point", "--checkpoint", cpath, "--device", dev.type]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(args)
        printed = re.findall(r"^\[fit\] step (\d+)", buf.getvalue(), re.M)
        require(printed == ["1"], f"cli fit --checkpoint ran steps {printed}, not step 1 alone")
        with open(cpath, "wb") as f:
            f.write(b"not a checkpoint")
        try:
            cli.main(args)
            refused = False
        except ValueError as e:
            refused = "corrupt or truncated" in str(e)
        require(refused, "cli fit took a corrupt checkpoint")
    print(f"[33] checkpoints on {card}: fit_scene scene4 AA envelope {MAIN_W}x{MAIN_H}, 4 steps "
          f"= 2 steps + a resume to 4 bitwise (losses {[float(v) for v in losses]}, params); `cli fit --checkpoint` "
          f"at {MAIN_W // 4}x{MAIN_H // 4} resumed at step 1 and ran it alone; a corrupt checkpoint refused "
          f"({fit_s:.1f} s for the three fits)")


def stats_phase(dev, card):
    """Phase 34: `cli stats` on the card against the same counts elsewhere."""
    import numpy as np

    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.utils import profiling

    def stats_json(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["stats", *args])
        return json.loads(buf.getvalue())

    t = time.perf_counter()
    s4_card = stats_json([str(EXAMPLES / "scene4.lol"), "--device", dev.type])
    s4_cpu = stats_json([str(EXAMPLES / "scene4.lol"), "--device", "cpu"])
    inst_card = stats_json([f"instanced:{DEAL_SPHERES}", "--device", dev.type])
    stats_s = time.perf_counter() - t
    from loltracer_tpu_torch.scenes import instanced_spheres
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    big = instanced_spheres(n=DEAL_SPHERES, device=dev)
    plain = profiling.march_step_stats(big.structure, big.params, 240, 320,
                                       RenderConfig(march_backend="jnp"))
    require(inst_card == plain, f"instanced:10000: cli stats through K7 {inst_card} != the plain "
                                f"SDF's on the card {plain}")
    s4 = {d: build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=d)
          for d in (dev, "cpu")}
    counts = {d: profiling.march_step_counts(s.structure, s.params, 240, 320)
              for d, s in s4.items()}
    diff = np.abs(counts[dev].astype(np.int64) - counts["cpu"])
    require(diff.max() <= 1 and (diff > 0).sum() <= max(2, 1e-3 * diff.size),
            f"scene4: card and CPU step counts differ on {(diff > 0).sum()} pixels, by up to "
            f"{diff.max()}")
    print(f"[34] cli stats at 320x240 on {card} ({stats_s:.1f} s with the CPU run): scene4 "
          f"{json.dumps(s4_card)} ({'=' if s4_card == s4_cpu else '!='} the CPU run's JSON; the "
          f"count planes differ on {(diff > 0).sum()} pixels); instanced:10000 through K7 "
          f"{json.dumps(inst_card)} = the plain SDF's on the card")


GOLDEN_SIZES = ((32, 24), (161, 97))  # (W, H): tests/test_jnp_renderer.py's, then phase 2's
GOLDEN_ATOL = 2e-4  # K1 vs the golden oracle (tests/test_jnp_renderer.py:29)
GOLDEN_INST_ATOL = 3e-4  # K5 vs the golden oracle (tests/test_instanced.py:63)
ROOF_SIZE = f"{MAIN_W}x{MAIN_H}"
ROOF_REPS = 3
ROOF_MAX_FRACTION = 1.05
ROOF_INSTANCED = "instanced:10000"
VIEW_H, VIEW_W = 90, 160
VIEW_RESIZE = (72, 128)  # (H, W) of phase 37's resize
VIEW_TIMEOUT_S = 120


def beyond_golden(img, gold, atol: float):
    """(max |diff|, pixels beyond np.testing.assert_allclose(img, gold,
    atol) — the JAX package's test: |diff| <= atol + 1e-7 |gold|)."""
    import numpy as np

    diff = np.abs(np.asarray(img, np.float64) - gold)
    bad = ~(diff <= atol + 1e-7 * np.abs(gold))
    return float(diff.max()), int(bad.any(axis=-1).sum())


def golden_phase(dev, card) -> dict:
    """Phase 35: `cli render --backend golden` (the float64 oracle, on the
    CPU) against `cli render --backend pallas` (one K1 launch each) on the
    four examples, and K5 against the oracle on instanced_spheres(150,
    seed=3). Returns {case: (max |diff|, pixels over the tolerance)}."""
    import numpy as np

    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.golden import render_golden
    from loltracer_tpu_torch.render import cuda_renderer, fused_fwd, instanced_fwd
    from loltracer_tpu_torch.scenes import instanced_spheres

    def cli_image(args, out):
        with contextlib.redirect_stdout(io.StringIO()):
            require(cli.main(["render", *args, "-o", str(out)]) == 0, f"cli render {args} failed")
        return np.load(out)

    t = time.perf_counter()
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for w, h in GOLDEN_SIZES:
            for name in SCENES:
                common = [str(EXAMPLES / name), "--size", f"{w}x{h}", "--device", dev.type]
                fused_fwd.launches = 0
                gold = cli_image([*common, "--backend", "golden"], Path(tmp) / "gold.npy")
                require(fused_fwd.launches == 0, f"{name}: --backend golden launched K1")
                img = cli_image([*common, "--backend", "pallas"], Path(tmp) / "k1.npy")
                require(fused_fwd.launches == 1,
                        f"{name}: --backend pallas made {fused_fwd.launches} K1 launches, not 1")
                require(gold.dtype == np.float64 and gold.shape == (h, w, 3) == img.shape,
                        f"{name} {w}x{h}: golden {gold.dtype} {gold.shape}, K1 {img.shape}")
                errs[f"{name} {w}x{h}"] = beyond_golden(img, gold, GOLDEN_ATOL)
        w, h = GOLDEN_SIZES[0]
        inst = instanced_spheres(n=150, seed=3, device=dev)
        instanced_fwd.launches = 0
        k5 = cuda_renderer.make_cuda_renderer(inst.structure, h, w, RenderConfig(), device=dev)(
            inst.params).cpu().numpy()
        require(instanced_fwd.launches == 1, f"instanced:150: {instanced_fwd.launches} K5 launches")
        errs[f"instanced:150 seed 3 {w}x{h}"] = beyond_golden(k5, render_golden(inst, w, h),
                                                              GOLDEN_INST_ATOL)
    golden_s = time.perf_counter() - t
    small = [k for k in errs if k.endswith(f"{w}x{h}")]
    print(f"[35] golden oracle ({golden_s:.1f} s) on {card}, K1 through `cli render --backend "
          f"pallas` (1 launch each) against `--backend golden` (no launch; float64, the CPU), "
          f"atol {GOLDEN_ATOL} (K5 {GOLDEN_INST_ATOL}), (max |diff|, pixels over): "
          + "; ".join(f"{k} ({v[0]:.3g}, {v[1]})" for k, v in errs.items()))
    missed = {k: v for k, v in errs.items() if k in small and v[1]}
    require(not missed, f"K1 / K5 beyond the JAX package's golden tolerance: {missed}")
    return errs


def roofline_phase(dev, card) -> dict:
    """Phase 36: `cli roofline` at 1080p (scene4 fwd: K1; scene4 fwdbwd:
    K1r + K2; instanced:10000 clamp 2 fwd: K5), each launch counted from
    0 over the command. Returns {case: record}."""
    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.render import fused_fwd, fused_train, instanced_fwd

    cases = [
        ("scene4 fwd", [str(EXAMPLES / "scene4.lol")], "fwd",
         (fused_fwd, ("launches",))),
        ("scene4 fwdbwd", [str(EXAMPLES / "scene4.lol")], "fwdbwd",
         (fused_train, ("launches_fwd", "launches_bwd"))),
        (f"{ROOF_INSTANCED} clamp 2 fwd", [ROOF_INSTANCED, "--step-clamp", "2"], "fwd",
         (instanced_fwd, ("launches",))),
    ]
    records = {}
    for tag, args, mode, (mod, names) in cases:
        for n in names:
            setattr(mod, n, 0)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            require(cli.main(["roofline", *args, "--mode", mode, "--size", ROOF_SIZE, "--reps",
                              str(ROOF_REPS), "--device", dev.type]) == 0, f"cli roofline {tag}")
        wall = time.perf_counter() - t
        got = {n: getattr(mod, n) for n in names}
        rec = json.loads(buf.getvalue())
        require(all(v == ROOF_REPS + 1 for v in got.values()),
                f"roofline {tag}: launches {got}, expected {ROOF_REPS + 1} each (warm-up + reps)")
        require(rec["peak_source"] == "measured_artifact",
                f"roofline {tag}: peak_source {rec['peak_source']}")
        require(rec["fraction_of_peak"] > 0, f"roofline {tag}: fraction {rec['fraction_of_peak']}")
        records[tag] = dict(rec, launches=got, wall_s=wall)
        print(f"[36] cli roofline {tag} --size {ROOF_SIZE} on {card} ({wall:.1f} s; launches "
              f"{got}): {json.dumps(rec)}")
    # The operation model prices an instanced evaluation at every sphere
    # (sdf_eval_cost, the JAX package's brute-force count), while K5 reads
    # one cell list of the grid: its "fraction" is the brute-force work's
    # rate over the peak, above 1 by design, so the limit holds the
    # compiled records only.
    over = {k: r["fraction_of_peak"] for k, r in records.items()
            if not k.startswith("instanced") and r["fraction_of_peak"] > ROOF_MAX_FRACTION}
    require(not over, f"roofline fraction of the measured peak above {ROOF_MAX_FRACTION}: {over}")
    return records


def view_pty(args, keys, timeout: float):
    """Run `python -m loltracer_tpu_torch.cli view *args` on a pseudo-
    terminal, each of `keys` sent once the output shows one more status
    line; (the frame numbers of its status lines, its output). It must
    exit 0; it is killed past `timeout`."""
    import os
    import pty
    import select

    status = re.compile(rb"\d+x\d+  frame (\d+)  time")
    master, slave = pty.openpty()
    proc = subprocess.Popen([sys.executable, "-m", "loltracer_tpu_torch.cli", "view", *args],
                            stdin=slave, stdout=slave, stderr=subprocess.PIPE, cwd=ROOT)
    os.close(slave)
    out, fed = b"", 0
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            ready = select.select([master], [], [], 0.1)[0]
            if ready:
                try:
                    chunk = os.read(master, 1 << 16)
                except OSError:  # the child closed its end
                    break
                if not chunk:
                    break
                out += chunk
            if fed < len(keys) and len(status.findall(out)) > fed:
                os.write(master, keys[fed])
                fed += 1
            if not ready and proc.poll() is not None:
                break
    finally:
        # the pty closes before the child is reaped: wait out the deadline
        try:
            rc, timed_out = proc.wait(timeout=max(1.0, deadline - time.monotonic())), False
        except subprocess.TimeoutExpired:
            proc.kill()
            rc, timed_out = proc.wait(timeout=30), True
        err = proc.stderr.read().decode(errors="replace")
        proc.stderr.close()
        os.close(master)
    tail = out[-300:].decode(errors="replace")
    require(not timed_out, f"cli view {args} still running after {timeout} s: {err[-2000:]} "
                           f"output tail {tail!r}")
    require(rc == 0, f"cli view {args} exited {rc}: {err[-2000:]} output tail {tail!r}")
    return [int(n) for n in status.findall(out)], out


def view_phase(dev, card, s4) -> None:
    """Phase 37: the viewer. In this process, SizeAdaptiveRenderer frames of
    scene4 at VIEW_W x VIEW_H after moves, one K1 launch each, bitwise
    make_cuda_renderer at the moved camera and within the phase-2 rule of
    the plain version, then a resize; in a child on a pty, `cli view`
    driven by keys to its exit."""
    import torch

    from loltracer_tpu_torch import interactive
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render import fused_fwd
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.render.cuda_scene import pack_fields

    cfg = RenderConfig()
    adaptive = interactive.SizeAdaptiveRenderer(s4, cfg)
    params = s4.params
    notes = []
    for keys in ({"w"}, {"right"}, {"space"}):
        params = interactive.move_camera(params, keys)
        require(params.cam_point.device == s4.params.cam_point.device
                and params.cam_point.dtype == torch.float32, "move_camera moved the camera's device")
        fused_fwd.launches = 0
        frame = adaptive.frame(params, size=(VIEW_H, VIEW_W))
        require(fused_fwd.launches == 1, f"{keys}: {fused_fwd.launches} K1 launches a frame")
        want = make_cuda_renderer(s4.structure, VIEW_H, VIEW_W, cfg, device=dev)(params)
        require(torch.equal(torch.from_numpy(frame), want.cpu()),
                f"{keys}: the viewer's frame != make_cuda_renderer's")
        plain = fused_fwd.fused_forward_reference(
            s4.structure, cfg, camera_pack(params, VIEW_H, VIEW_W, cfg),
            pack_fields(s4.structure, params), VIEW_H, VIEW_W)
        err, over = compare(want, plain, f"viewer {keys}")
        notes.append(f"{sorted(keys)} max |diff| {err:.3g}, {over} px over {ATOL}")
    fused_fwd.launches = 0
    resized = adaptive.frame(params, size=VIEW_RESIZE)
    require(fused_fwd.launches == 1 and resized.shape == VIEW_RESIZE + (3,)
            and set(adaptive.first_frame_s) == {(VIEW_H, VIEW_W), VIEW_RESIZE},
            f"the resize did not re-resolve: {sorted(adaptive.first_frame_s)}")
    t = time.perf_counter()
    frames, out = view_pty([str(EXAMPLES / "scene4.lol"), "--size", f"{VIEW_W}x{VIEW_H}",
                               "--device", dev.type], [b"w", b"d", b"\x1b[C", b"q"],
                              VIEW_TIMEOUT_S)
    pty_s = time.perf_counter() - t
    require(len(frames) >= 2 and frames[:2] == [1, 2],
            f"cli view printed {len(frames)} status lines")
    first = [ms for ms in re.findall(rb"first (\d+)ms", out)][:1]
    print(f"[37] viewer on {card}: {VIEW_W}x{VIEW_H} frames after w / right / space, 1 "
          f"lol_render_fused launch each, = make_cuda_renderer's bitwise; vs plain: "
          + "; ".join(notes) + f"; a resize to {VIEW_RESIZE[1]}x{VIEW_RESIZE[0]} re-resolved (first "
          f"frames {[round(v, 4) for v in adaptive.first_frame_s.values()]} s); `cli view` on a "
          f"pty fed w, d, right, q: exit 0 after {len(frames)} frames in {pty_s:.1f} s (first "
          f"frame {first[0].decode() if first else '?'} ms)")


def native_phase(card) -> None:
    """Phase 38: the native parser, built with g++ here, against the
    Python parser on the four examples (tests/test_native_parser.py's
    rule: the camera direction and fov to 1e-12, the rest equal)."""
    from loltracer_tpu_torch._build import BUILD_DIR
    from loltracer_tpu_torch.lol import native, parse_scene_file

    before = set(BUILD_DIR.glob("liblolparse-*.so"))
    t = time.perf_counter()
    require(native.native_available(), "the native parser did not build (g++)")
    build_s = time.perf_counter() - t
    so = native._compile()
    how = ("loaded, built before this run" if so in before
           else f"built with g++ in {build_s:.1f} s")
    for name in SCENES:
        path = str(EXAMPLES / name)
        py, cc = parse_scene_file(path), native.parse_scene_file_native(path)
        same = (py.materials == cc.materials and py.ambient_color == cc.ambient_color
                and py.lights == cc.lights and py.objects == cc.objects
                and py.camera.point == cc.camera.point
                and all(abs(a - b) <= 1e-12 for a, b in zip(py.camera.direction,
                                                            cc.camera.direction))
                and abs(py.camera.fov - cc.camera.fov) <= 1e-12)
        require(same, f"{name}: the native AST differs from the Python parser's")
    print(f"[38] native parser on {card}'s host: {so.name} {how}; its AST = the Python "
          f"parser's on the four examples")


BENCH_REPS = 3  # samples of each phase-39 route
BENCH_CUT_JNP = (480, 272)  # (W, H) of phase 39's path-B route (1.29 s a 1080p step)
BENCH_CUT_BANDED = (1920, 48)  # three 16-row bands of phase 39's path-C route (4.1 s a frame)
BENCH_FLOOR = 0.95  # a route's frame over its kernels' least time, at least
BENCH_INSTANCED = "instanced:10000"


class BenchRoute(typing.NamedTuple):
    """One route of phase 39."""

    tag: str
    scene: str  # BENCH_SCENE
    mode: str  # BENCH_MODE
    env: dict  # the other BENCH_* overrides
    size: tuple  # (W, H)
    metric: str  # bench.py's label for it
    cfg: object  # the RenderConfig it must take
    make: typing.Callable  # (structure, H, W, cfg, dev) -> (params -> image), called directly
    per_frame: dict  # {(counter family, kernel): launches a frame}
    alone: str  # the kernels `kernels_ms` launches alone for it


def bench_routes():
    """Phase 39's routes (`BenchRoute`)."""
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render import cuda_renderer, fused_train, instanced_train, regroup
    from loltracer_tpu_torch.render import torch_renderer

    env = RenderConfig(shadow_grad="envelope")
    clamp2 = env.replace(step_clamp=2.0)
    s4, inst = str(EXAMPLES / "scene4.lol"), BENCH_INSTANCED
    full, tag = (MAIN_W, MAIN_H), f"{MAIN_W}x{MAIN_H}"
    jw, jh = BENCH_CUT_JNP
    bw, bh = BENCH_CUT_BANDED
    train = {("fused_train", "lol_train_fwd"): 1, ("fused_train", "lol_train_bwd"): 1}

    def banded(st, h, w, cfg, dev):
        return lambda p: torch_renderer.render_image_banded(st, p, h, w, cfg, band_rows=16)

    def plain(st, h, w, cfg, dev):
        return lambda p: torch_renderer.render_image(st, p, h, w, cfg)

    return [
        BenchRoute("scene4 fwd", s4, "fwd", {}, full,
                   f"rays/s/chip fwd/pallas scene4.lol {tag} frames_per_fetch=8", env,
                   cuda_renderer.make_cuda_renderer, {("fused_fwd", "lol_render_fused"): 1},
                   "k1"),
        BenchRoute("scene4 fwdbwd", s4, "fwdbwd", {}, full,
                   f"rays/s/chip fwdbwd/pallas scene4.lol {tag} frames_per_fetch=8 "
                   f"shadow_grad=envelope", env, fused_train.make_training_renderer, train,
                   "k1r+k2"),
        BenchRoute("scene4 fwdbwd AA", s4, "fwdbwd", {"BENCH_AA": "1"}, full,
                   f"rays/s/chip fwdbwd/pallas scene4.lol {tag} frames_per_fetch=8 "
                   f"shadow_grad=envelope aa", env.replace(antialias=True),
                   fused_train.make_training_renderer, train, "k1r+k2"),
        BenchRoute(f"{inst} fwd", inst, "fwd", {}, full,
                   f"rays/s/chip fwd/pallas-fused-instanced {inst} {tag} clamp=2", clamp2,
                   cuda_renderer.make_instanced_renderer,
                   {("instanced_fwd", "lol_instanced_render"): 1}, "k5"),
        BenchRoute(f"{inst} fwd regrouped", inst, "fwd", {"BENCH_REGROUP": "1"}, full,
                   f"rays/s/chip fwd/pallas-instanced-regrouped {inst} {tag} clamp=2", clamp2,
                   regroup.make_instanced_renderer_regrouped,
                   {("regroup", "lol_rg_march"): 1, ("regroup", "lol_rg_shadow"): 2,
                    ("regroup", "lol_rg_shade"): 1}, "k9"),
        BenchRoute(f"{inst} fwdbwd", inst, "fwdbwd", {}, full,
                   f"rays/s/chip fwdbwd/pallas-fused-instanced {inst} {tag} "
                   f"shadow_grad=envelope clamp=2", clamp2,
                   instanced_train.make_instanced_training_renderer,
                   {("instanced_train", "lol_instanced_fwd"): 1,
                    ("instanced_train", "lol_instanced_bwd"): 1}, "k5r+k6"),
        BenchRoute("scene4 fwdbwd jnp (cut)", s4, "fwdbwd", {"BENCH_BACKEND": "jnp"}, (jw, jh),
                   f"rays/s/chip fwdbwd/jnp scene4.lol {jw}x{jh} frames_per_fetch=8 "
                   f"shadow_grad=envelope", env, plain,
                   {("march_kernels", "lol_march"): 1, ("march_kernels", "lol_shadow_march"): 2},
                   "k3+k4"),
        BenchRoute(f"{inst} fwd banded (cut)", inst, "fwd", {"BENCH_BACKEND": "jnp"}, (bw, bh),
                   f"rays/s/chip fwd/banded-pallas-march {inst} {bw}x{bh} clamp=2", clamp2,
                   banded, {("march_kernels", "lol_march_instanced"): -(-bh // 16),
                            ("march_kernels", "lol_shadow_march_instanced"): 2 * -(-bh // 16)},
                   "k3i+k4i bands"),
    ]


def kernels_ms(dev, alone, scene, cfg, h, w, reps: int = 3) -> float:
    """The least time (CUDA events, of `reps`) of the kernels one frame of
    a phase-39 route launches (`BenchRoute.alone`), launched alone on the
    route's inputs: the packing, the autograd glue and the cell grid's
    build left out."""
    import torch

    from loltracer_tpu_torch.render import fused_fwd, fused_train, instanced_fwd, instanced_train
    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render import regroup
    from loltracer_tpu_torch.render.camera import camera_pack, camera_rays, camera_rays_for_rows
    from loltracer_tpu_torch.render.cell_grid import grid_for
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced

    st, params = scene.structure, scene.params
    cam, fields = camera_pack(params, h, w, cfg), pack_fields(st, params)
    tab = pack_instanced(st, params) if st.instanced else None
    grid = grid_for(tab, cfg.step_clamp) if st.instanced else None

    def marches(ro, rd):
        scene_m = mk.pack_march_scene(st, params)

        def run():
            m = mk.march_values(st, cfg, ro, rd, scene_m)
            for o, d, dist in shadow_rays(params, ro, rd, m.t, cfg):
                mk.shadow_values(st, cfg, o, d, dist, scene_m)
        return run

    if alone == "k1":
        def fn():
            fused_fwd.fused_forward(st, cfg, cam, fields, h, w)
    elif alone == "k1r+k2":
        img, res = fused_train.train_forward(st, cfg, cam, fields, h, w)
        ct = 2.0 * img / img.numel()  # d mean(img ** 2) / d img

        def fn():
            fused_train.train_forward(st, cfg, cam, fields, h, w)
            fused_train.train_backward(st, cfg, cam, fields, res, ct)
    elif alone == "k5":
        def fn():
            instanced_fwd.instanced_forward(st, cfg, cam, fields, tab, h, w, grid=grid)
    elif alone == "k9":
        tr = regroup.march_track(st, cfg, cam, fields, tab, h, w, grid=grid)
        lo, hi = regroup.hit_box(tr.hitp)
        perms = [regroup.shadow_order(tr.rec[li], lo, hi) for li in range(st.num_lights)]
        shadow = torch.empty((st.num_lights, 2, h, w), dtype=torch.float32, device=dev)

        def fn():
            t = regroup.march_track(st, cfg, cam, fields, tab, h, w, grid=grid)
            for li in range(st.num_lights):
                regroup.shadow_sorted(st, cfg, fields, tab, t.rec[li], perms[li], out=shadow[li],
                                      grid=grid)
            regroup.shade_planes(st, cfg, cam, fields, tab, t.track, shadow, h, w, grid=grid)
    elif alone == "k5r+k6":
        img, res = instanced_train.instanced_train_forward(st, cfg, cam, fields, tab, h, w,
                                                           grid=grid)
        ct = 2.0 * img / img.numel()

        def fn():
            instanced_train.instanced_train_forward(st, cfg, cam, fields, tab, h, w, grid=grid)
            instanced_train.instanced_train_backward(st, cfg, cam, fields, tab, res, ct,
                                                     grid=grid)
    elif alone == "k3+k4":
        fn = marches(*camera_rays(params, h, w, cfg))
    elif alone == "k3i+k4i bands":
        bands = [marches(*camera_rays_for_rows(params, torch.arange(r0, min(r0 + 16, h),
                                                                    device=dev), h, w, cfg))
                 for r0 in range(0, h, 16)]

        def fn():
            for band in bands:
                band()
    else:
        raise ValueError(f"unknown kernels {alone!r}")
    fn()
    return min(time_ms(fn, 1) for _ in range(reps))


def build_bench_libraries(dev) -> float:
    """The libraries of phase 39's routes, built together (one nvcc each;
    those built before load from the build cache). Returns the seconds."""
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.render import fused_fwd, fused_train, instanced_fwd, instanced_train
    from loltracer_tpu_torch.render import march_kernels, regroup
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    s4 = build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=dev).structure
    inst = instanced_spheres(n=10, device=dev).structure  # one source for every sphere count
    env = RenderConfig(shadow_grad="envelope")
    clamp2 = env.replace(step_clamp=2.0)
    jobs = [(fused_fwd.library, s4, env), (fused_train.library, s4, env),
            (fused_train.library, s4, env.replace(antialias=True)),
            (march_kernels.library, s4, env), (march_kernels.library, inst, clamp2),
            (instanced_fwd.library, clamp2, inst), (regroup.library, clamp2, inst),
            (instanced_train.library, clamp2, inst)]
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for f in [pool.submit(*job) for job in jobs]:
            f.result()
    return time.perf_counter() - t


def bench_only() -> int:
    """`chip_smoke.py --bench`: phase 39 alone, its libraries built first."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"[39] the routes' libraries built or loaded in {build_bench_libraries(dev):.1f} s")
    bench_phase(dev, card)
    return 0


def route_scalar(render, params, mode):
    """bench.py's timed scalar of one frame of `render`, computed here:
    sum(image), or mean(image ** 2) + the sum of every leaf's squared
    gradient."""
    import torch

    from loltracer_tpu_torch.scene import FIELDS

    if mode == "fwd":
        with torch.no_grad():
            return torch.sum(render(params))
    leaves = grad_leaves(params)
    img = render(leaves)
    loss = torch.mean(img * img)
    loss.backward()
    grads = [getattr(leaves, f).grad for f in FIELDS]
    return loss.detach() + sum(torch.sum(g * g) for g in grads if g is not None)


def bench_phase(dev, card) -> dict:
    """Phase 39: `cli bench` on each route of `bench_routes` in a child
    process of its own: its record, its launches, its frame time against the
    kernels' least time, and in this process `bench.build`'s scalar
    bitwise the directly called renderer's. Returns {tag: record}."""
    import os

    import torch

    from loltracer_tpu_torch import bench

    scenes = {}
    base_env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    records = {}
    t_phase = time.perf_counter()
    for r in bench_routes():
        tag, (w, h) = r.tag, r.size
        if r.scene not in scenes:
            scenes[r.scene] = bench.load_scene(r.scene, dev)
        sc = scenes[r.scene]
        env = dict(r.env, BENCH_REPS=str(BENCH_REPS))
        b = bench.build(bench.Settings.from_env(dict(
            env, BENCH_SCENE=r.scene, BENCH_MODE=r.mode, BENCH_W=str(w), BENCH_H=str(h))),
            dev, scene=sc)
        require(b.metric == r.metric, f"{tag}: bench.build's metric {b.metric!r}")
        require(b.cfg == r.cfg, f"{tag}: bench.build's config {b.cfg}")
        got = b.fn()
        want = route_scalar(r.make(sc.structure, h, w, r.cfg, dev), sc.params, r.mode)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"{tag}: the route's scalar {got.item()!r} != the renderer's {want.item()!r}")
        k_ms = kernels_ms(dev, r.alone, sc, r.cfg, h, w)
        del b, got, want
        torch.cuda.empty_cache()  # the child needs the memory this process keeps cached

        t = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "loltracer_tpu_torch.cli", "bench", r.scene, "--mode", r.mode,
             "--size", f"{w}x{h}", "--device", dev.type],
            env={**base_env, **env}, cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
        wall = time.perf_counter() - t
        require(out.returncode == 0, f"cli bench {tag} exited {out.returncode}: "
                                     f"{out.stderr[-2000:]}")
        lines = out.stdout.strip().splitlines()
        rec, detail = json.loads(lines[-1]), json.loads(lines[-2])
        require(set(rec) == {"metric", "value", "unit", "vs_baseline"} and rec["unit"] == "rays/s",
                f"{tag}: record {rec}")
        require(rec["metric"] == r.metric, f"{tag}: metric {rec['metric']!r}, want "
                                           f"{r.metric!r}")
        frames = detail["frames"]
        want_n = {k: n * (1 + BENCH_REPS * frames) for k, n in r.per_frame.items()}
        seen = {(fam, k): n for fam, ks in detail["launches"].items() for k, n in ks.items() if n}
        require(seen == want_n, f"{tag}: launches {seen}, want {want_n}")
        require(detail["card"] == card, f"{tag}: card {detail['card']!r}")
        frame_ms = detail["best_ms"] / frames
        require(frame_ms >= BENCH_FLOOR * k_ms,
                f"{tag}: {frame_ms:.4f} ms a frame, under {BENCH_FLOOR} x its kernels' "
                f"{k_ms:.4f} ms: the timed window does not hold them")
        require(math.isclose(rec["value"], round(w * h * frames / (detail["best_ms"] / 1e3), 1)),
                f"{tag}: value {rec['value']} vs the best sample {detail['best_ms']} ms")
        records[tag] = dict(rec, samples_ms=detail["samples_ms"], frame_ms=frame_ms,
                            kernels_ms=k_ms, launches={f"{f}.{k}": n for (f, k), n in seen.items()},
                            wall_s=wall)
        cut = "" if (w, h) == (MAIN_W, MAIN_H) else f" (cut from {MAIN_W}x{MAIN_H})"
        print(f"[39] cli bench {tag} {w}x{h}{cut} on {card} ({wall:.1f} s): "
              f"{json.dumps(rec)}; samples {detail['samples_ms']} ms of {frames} frame(s), "
              f"{frame_ms:.4f} ms a frame >= {BENCH_FLOOR} x the kernels' {k_ms:.4f} ms alone; "
              f"launches {records[tag]['launches']}; the scalar bitwise the renderer's")
    print(f"[39] cli bench: {len(records)} routes in {time.perf_counter() - t_phase:.1f} s")
    return records


SCALE_ROWS = 128  # phase 40: rows a device (bench_scaling.py's default)
SCALE_REPS = 3
SCALE_LADDERS = (  # (tag, SCALE_SCENE, SCALE_ASSIGN) of phase 40's device-time ladders
    ("scene4 lpt", "examples/scene4.lol", "lpt"),
    ("scene4 contiguous", "examples/scene4.lol", "contiguous"),
    ("instanced:10000 lpt", "instanced:10000", "lpt"),
)


def build_scaling_libraries(dev) -> float:
    """The libraries of phase 40, built together: the training pairs of
    scene4 and of instanced scenes at clamp 2 with envelope shadows, and K7
    without a clamp (the instanced cost model). Returns the seconds."""
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.render import fused_train, instanced_train, march_kernels
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    s4 = build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=dev).structure
    inst = instanced_spheres(n=10, device=dev).structure
    env = RenderConfig(shadow_grad="envelope")
    jobs = [(fused_train.library, s4, env),
            (instanced_train.library, env.replace(step_clamp=2.0), inst),
            (march_kernels.eval_library, inst, RenderConfig(step_clamp=None))]
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        for f in [pool.submit(*job) for job in jobs]:
            f.result()
    return time.perf_counter() - t


def scaling_only() -> int:
    """`chip_smoke.py --scaling`: phase 40 alone, its libraries built first."""
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"[40] the ladders' libraries built or loaded in {build_scaling_libraries(dev):.1f} s")
    scaling_phase(dev, card)
    return 0


def run_scaling(env: dict, out: str):
    """`python -m loltracer_tpu_torch.bench_scaling` in a child with `env`
    (SCALE_* and SCALE_OUT=out): ([(detail, record)] of its rungs, the
    file's ladders, its wall seconds)."""
    import os

    import torch

    torch.cuda.empty_cache()  # the child needs the memory this process keeps cached
    base = {k: v for k, v in os.environ.items() if not k.startswith("SCALE_")}
    t = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "loltracer_tpu_torch.bench_scaling"],
                         env={**base, **env, "SCALE_OUT": out}, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    wall = time.perf_counter() - t
    require(res.returncode == 0, f"bench_scaling {env} exited {res.returncode}: "
                                 f"{res.stderr[-2000:]}")
    lines = [json.loads(line) for line in res.stdout.strip().splitlines()]
    with open(out) as f:
        ladders = json.load(f)["ladders"]
    return list(zip(lines[0::2], lines[1::2])), ladders, wall


def modelled_deal(structure, per_row, height, n, assign):
    """(perm, modelled balance) of the deal `assign` over n shards on the
    worst-lane (8, 128) tile model (utils/profiling.py; `per_row` its cost
    of each 8-row tile row, counted on the card): LPT over the block costs
    block_row_costs gives, or contiguous bands; each shard costs the tile
    rows its rows fall in (shard_balance's and band_balance's rule)."""
    import numpy as np

    from loltracer_tpu_torch.parallel.sharded import interleave_rows, row_granularity

    G = row_granularity(structure)
    if assign == "lpt":
        perm = interleave_rows(height, n, G, per_row.reshape(height // G, G // 8).sum(axis=1))[0]
    else:
        perm = np.arange(height)
    rows = height // n
    costs = np.array([per_row[np.unique(perm[i * rows:(i + 1) * rows] // 8)].sum()
                      for i in range(n)])
    return perm, float(costs.sum() / (n * costs.max()))


def scaling_phase(dev, card) -> dict:
    """Phase 40: the weak-scaling harness (loltracer_tpu_torch/bench_scaling.py)
    on the card. The device-time ladder of each of SCALE_LADDERS at
    SCALE_ROWS x MAIN_W, a child process each: every rung's deal and row
    tables those this process makes from the cost model counted here,
    each band's launch counts exactly (1 + reps) x frames of its pair,
    band_s the best sample's device time, each sample's device time
    inside its CUDA-event window, the record's efficiency from those, the
    ladder merged into SCALE_OUT, the measured efficiency printed beside
    the modelled one; one band of the 8-shard rung's scalar bitwise the
    training renderer's called directly on that table. Then the wall
    ladder over this machine's world of one (scene4 fwdbwd at SCALE_ROWS x
    MAIN_W, one rung). Returns {kernel: its `scaling` entry}."""
    import numpy as np
    import torch

    from loltracer_tpu_torch import bench, bench_scaling
    from loltracer_tpu_torch.render.fused_train import make_training_renderer
    from loltracer_tpu_torch.render.instanced_train import make_instanced_training_renderer
    from loltracer_tpu_torch.utils.profiling import _tile_row_costs

    t_phase = time.perf_counter()
    w, reps = MAIN_W, SCALE_REPS
    scenes, ladders, tmp = {}, {}, tempfile.mkdtemp(prefix="scaling-")
    costs = {}  # (scene, height) -> the tile model's cost a tile row
    keys = {"devices", "height", "assignment", "band_s", "efficiency_device_time", "mode"}
    for tag, scene_name, assign in SCALE_LADDERS:
        out = str(Path(tmp) / f"{tag.replace(' ', '_').replace(':', '')}.json")
        rungs, file_ladders, wall = run_scaling(
            {"SCALE_DEVICE_TIME": "1", "SCALE_W": str(w), "SCALE_ROWS": str(SCALE_ROWS),
             "SCALE_SCENE": scene_name, "SCALE_ASSIGN": assign, "SCALE_REPS": str(reps)}, out)
        if scene_name not in scenes:
            scenes[scene_name] = bench.load_scene(scene_name, dev)
        sc = scenes[scene_name]
        st = sc.structure
        cfg = bench_scaling.RenderConfig(shadow_grad="envelope",
                                         step_clamp=2.0 if st.instanced else None)
        G = bench_scaling.row_granularity(st)
        pair = [f"{fam}.{k}" for fam, k in bench_scaling.band_kernels(st)]
        frames = 1 if st.instanced else 32
        require([d["devices"] for d, _ in rungs] == list(bench_scaling.DEVICE_TIME_COUNTS),
                 f"{tag}: rungs {[d['devices'] for d, _ in rungs]}")
        summary = []
        for detail, rec in rungs:
            n, h = detail["devices"], SCALE_ROWS * detail["devices"]
            require(set(rec) == keys and rec["height"] == h and rec["mode"] == "fwdbwd",
                    f"{tag} n={n}: record {rec}")
            require(rec["assignment"] == detail["deal"] == assign and detail["card"] == card,
                    f"{tag} n={n}: deal {detail['deal']}, card {detail['card']!r}")
            if (scene_name, h) not in costs:
                costs[scene_name, h] = _tile_row_costs(st, sc.params, h, w, cfg, (8, 128))
            perm, model = modelled_deal(st, costs[scene_name, h], h, n, assign)
            want_tabs = [perm[i * SCALE_ROWS:(i + 1) * SCALE_ROWS][::G].tolist() for i in range(n)]
            require(detail["tables"] == want_tabs, f"{tag} n={n}: the row tables differ from "
                                                   "the deal of the costs counted here")
            want_n = {k: (1 + reps) * frames for k in pair}
            require(detail["launches"] == [want_n] * n,
                    f"{tag} n={n}: launches {detail['launches']}, want {want_n} a band")
            dev_ms, win_ms = detail["band_device_ms"], detail["band_window_ms"]
            require(all(len(d) == len(wi) == reps for d, wi in zip(dev_ms, win_ms)),
                    f"{tag} n={n}: samples")
            require(all(0 < d <= wi for ds, ws in zip(dev_ms, win_ms) for d, wi in zip(ds, ws)),
                    f"{tag} n={n}: a sample's device time outside its window: {dev_ms} vs "
                    f"{win_ms}")
            band_s = [min(d) / 1e3 for d in dev_ms]
            require(rec["band_s"] == [round(t, 5) for t in band_s]
                    and rec["efficiency_device_time"] == round(sum(band_s) / (n * max(band_s)), 4),
                    f"{tag} n={n}: the record {rec} is not its samples'")
            summary.append({"n": n, "band_s": rec["band_s"],
                            "efficiency_device_time": rec["efficiency_device_time"],
                            "model": model, "window_ms_best": [min(x) for x in win_ms]})
            print(f"[40] {tag} n={n} ({h}x{w}, deal {detail['deal']}) on {card}: band device "
                  f"ms (best of {reps} x {frames} frames) {[round(t * 1e3, 3) for t in band_s]}, "
                  f"efficiency {rec['efficiency_device_time']} measured vs {model:.4f} modelled; "
                  f"event windows {[round(min(x), 2) for x in win_ms]} ms; launches {want_n} a "
                  f"band; the profile's stop / reading {detail['profiler_s']} s")
        lad = [x for x in file_ladders if x["platform"] == f"device_time-{assign}"]
        require(len(lad) == 1 and lad[0]["records"] == [r for _, r in rungs]
                and lad[0]["backend"] == "pallas" and lad[0]["width"] == w,
                f"{tag}: SCALE_OUT holds {file_ladders}")

        # one band of the 8-shard rung: the harness's frame and the training
        # renderer called directly on the same table
        n, h = 8, 8 * SCALE_ROWS
        detail = rungs[-1][0]
        i = int(np.argmax([min(d) for d in detail["band_device_ms"]]))
        tab = torch.tensor(detail["tables"][i], dtype=torch.float32, device=dev)
        band = bench_scaling.band_renderer(st, SCALE_ROWS, w, h, cfg, dev)
        got = bench.fwdbwd_frame(lambda p: band(p, tab), sc.params)[1]()
        make = make_instanced_training_renderer if st.instanced else make_training_renderer
        direct = make(st, SCALE_ROWS, w, cfg, device=dev, full_height=h, with_row_table=True)
        want = route_scalar(lambda p: direct(p, tab), sc.params, "fwdbwd")
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"{tag}: band {i}'s scalar {got.item()!r} != the "
                                        f"renderer's {want.item()!r}")
        ladders[tag] = {"rungs": summary, "wall_s": wall}
        print(f"[40] {tag}: n=8 band {i} (the slowest) scalar {got.item():.9g} bitwise the "
              f"training renderer's on its table; the child took {wall:.1f} s")

    out = str(Path(tmp) / "wall.json")
    rungs, file_ladders, wall = run_scaling(
        {"SCALE_W": str(w), "SCALE_ROWS": str(SCALE_ROWS), "SCALE_REPS": str(reps)}, out)
    require(len(rungs) == 1, f"the wall ladder on one card has {len(rungs)} rungs")
    detail, rec = rungs[0]
    require(set(rec) == {"devices", "height", "rays_per_s", "efficiency", "mode"}
            and rec["devices"] == 1 and rec["height"] == SCALE_ROWS and rec["efficiency"] == 1.0
            and rec["mode"] == "fwdbwd", f"wall: record {rec}")
    # the target's K1r and the eager warm-up step's K1r and K2; the step
    # captures on the first timed call and replays on every timed call
    want_n = {"fused_train.lol_train_fwd": 2, "fused_train.lol_train_bwd": 1}
    require(detail["launches"] == want_n, f"wall: launches {detail['launches']}, want {want_n}")
    require(len(set(detail["loss"])) == 1, f"wall: the steps' losses {detail['loss']} differ")
    require(rec["rays_per_s"] == round(SCALE_ROWS * w / min(detail["samples_s"]), 1),
            f"wall: {rec} vs {detail['samples_s']}")
    require(file_ladders[-1]["platform"] == "cuda" and file_ladders[-1]["records"] == [rec],
            f"wall: SCALE_OUT holds {file_ladders}")
    wall_entry = {"rays_per_s": rec["rays_per_s"], "samples_s": detail["samples_s"],
                  "wall_s": wall}
    print(f"[40] wall ladder (world of one, scene4 fwdbwd {SCALE_ROWS}x{w}, Adam step from "
          f"the same params each time) on {card}: {json.dumps(rec)}; steps "
          f"{[round(t * 1e3, 3) for t in detail['samples_s']]} ms; launches {want_n}; the child "
          f"took {wall:.1f} s")
    print(f"[40] bench_scaling: {len(SCALE_LADDERS)} device-time ladders and the wall ladder "
          f"in {time.perf_counter() - t_phase:.1f} s")
    s4 = {k: ladders[k] for k in ("scene4 lpt", "scene4 contiguous")}
    inst = {"instanced:10000 lpt": ladders["instanced:10000 lpt"]}
    return {"lol_train_fwd": dict(s4, wall=wall_entry), "lol_train_bwd": s4,
            "lol_instanced_fwd": inst, "lol_instanced_bwd": inst}


def main() -> int:
    import numpy as np
    import torch

    require(
        torch.cuda.is_available(),
        "torch.cuda.is_available() is false: this check needs a CUDA GPU",
    )
    require(
        (ROOT / "loltracer_tpu_torch" / "__init__.py").is_file(),
        f"loltracer_tpu_torch not found beside {Path(__file__).name}",
    )
    sys.path.insert(0, str(ROOT))
    import loltracer_tpu_torch
    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.opt import fit_scene
    from loltracer_tpu_torch.render import fused_fwd, fused_train, instanced_fwd, instanced_train
    from loltracer_tpu_torch.render import cell_grid, march_kernels, regroup
    from loltracer_tpu_torch.utils import peak
    from loltracer_tpu_torch.render.cell_grid import grid_for
    from loltracer_tpu_torch.render.instanced_pack import GROUP, pack_instanced, sphere_bbox
    from loltracer_tpu_torch.render.sdf import bbox_cut
    from loltracer_tpu_torch.scenes import instanced_spheres
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.render.cuda_scene import pack_fields, packed_size, unpack_fields
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.utils.image import image_to_u8, read_png

    require(
        Path(loltracer_tpu_torch.__file__).resolve().parent == ROOT / "loltracer_tpu_torch",
        f"imported loltracer_tpu_torch from {loltracer_tpu_torch.__file__}",
    )
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # --- 0. card -----------------------------------------------------------
    card = card_line()
    print(card)
    print(f"[0] card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | {torch.cuda.device_count()} device(s)")

    scenes = {
        n: build_scene(parse_scene_file(str(EXAMPLES / n)), device=dev) for n in SCENES
    }
    cases = [(n, RenderConfig()) for n in SCENES] + [
        ("scene4.lol", RenderConfig(antialias=True)),
        ("scene2.lol", RenderConfig(max_steps=64, shadow_steps=32, gamma=1.0)),
    ]

    def no_cull(c):
        return c.replace(shadow_cull=False)

    env = RenderConfig(shadow_grad="envelope")
    train_cases = [(n, env) for n in SCENES] + [
        ("scene4.lol", RenderConfig(shadow_grad="envelope", antialias=True)),
    ]

    inst = {n: instanced_spheres(n=n, seed=0 if n == 10_000 else 9, device=dev)
            for n in (1, 300, 10_000)}
    clamp2 = RenderConfig(step_clamp=2.0)
    inst_cfgs = [clamp2, RenderConfig(), RenderConfig(step_clamp=2.0, antialias=True),
                 RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0)]
    clamp2_env = RenderConfig(step_clamp=2.0, shadow_grad="envelope")
    inst_train_cfgs = [clamp2_env, RenderConfig(shadow_grad="envelope"),
                       RenderConfig(step_clamp=2.0, antialias=True, shadow_grad="envelope")]

    # --- 1. build ------------------------------------------------------------
    # every kernel of phases 1, 5, 9 and 13 starts building now, one nvcc each
    t0 = time.perf_counter()
    # the march kernels (phase 17): one library per structure for the four
    # examples (AA and the estimator are not compiled in), per clamp for
    # instanced structures (one text for every sphere count), and the
    # examples' shadow_cull=False twins (K4 without the segment cull)
    march_libs = [(scenes[n].structure, RenderConfig()) for n in SCENES] + [
        (inst[10_000].structure, c) for c in (clamp2, RenderConfig(),
                                              RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0))
    ] + [(scenes[n].structure, RenderConfig(shadow_cull=False)) for n in SCENES]
    eval_clamps = (2.0, None, 8.0)  # K7 (phase 26): the one source per step clamp
    pool = ThreadPoolExecutor(max_workers=2 * len(cases) + 2 * len(train_cases)
                              + 2 * len(inst_cfgs) + len(inst_train_cfgs) + len(march_libs)
                              + len(eval_clamps) + 1)
    peak_built = pool.submit(peak.library)
    eval_built = [pool.submit(march_kernels.eval_library, inst[10_000].structure,
                              RenderConfig(step_clamp=c)) for c in eval_clamps]
    regroup_built = [pool.submit(regroup.library, c, inst[10_000].structure) for c in inst_cfgs]
    march_built = [pool.submit(march_kernels.library, st, c) for st, c in march_libs]
    inst_train_built = [pool.submit(instanced_train.library, c, inst[10_000].structure)
                        for c in inst_train_cfgs]
    train_built = [pool.submit(fused_train.library, scenes[n].structure, c)
                   for n, c in train_cases]
    # K1 / K1r built without the shadow segment cull: the bitwise twins of
    # phases 2-8 (cfg.shadow_cull, the JAX package's own A/B knob)
    train_twin_built = [pool.submit(fused_train.library, scenes[n].structure, no_cull(c))
                        for n, c in train_cases]
    twin_built = [pool.submit(fused_fwd.library, scenes[n].structure, no_cull(c))
                  for n, c in cases]
    inst_built = [pool.submit(instanced_fwd.library, c, inst[10_000].structure)
                  for c in inst_cfgs]
    built = [f.result() for f in
             [pool.submit(fused_fwd.library, scenes[n].structure, c) for n, c in cases]]
    twin_built = [f.result() for f in twin_built]
    build_s = time.perf_counter() - t0
    regs = [l.split(":", 1)[-1].strip() for l in built[3].log.splitlines()
            if "registers" in l or "spill" in l]
    print(f"[1] build: {len(built)} kernels ({len(SCENES)} structures + AA + custom "
          f"config) and their shadow_cull=False twins in {build_s:.1f} s; scene4 ptxas: "
          f"{' | '.join(regs)}")

    # --- 25. path E: cli peak, the measured ceiling (before any bound) --------------
    peak_entries, ceiling, sqrt_slots = peak_phase(dev, card, peak_built)

    # --- 2. kernel vs plain version on the card ------------------------------
    h, w = 97, 161
    for name, cfg in cases:
        s = scenes[name]
        cam = camera_pack(s.params, h, w, cfg)
        fields = pack_fields(s.structure, s.params)
        k_img = fused_fwd.fused_forward(s.structure, cfg, cam, fields, h, w)
        t_img = fused_fwd.fused_forward(s.structure, no_cull(cfg), cam, fields, h, w)
        p_img = fused_fwd.fused_forward_reference(s.structure, cfg, cam, fields, h, w)
        _, p_res = fused_train.train_forward_reference(s.structure, cfg, cam, fields, h, w)
        torch.cuda.synchronize()
        what = f"{name} antialias={cfg.antialias} max_steps={cfg.max_steps}"
        require(torch.equal(k_img, t_img), f"{what}: image != its shadow_cull=False twin's")
        err, over = compare(k_img, p_img, what)
        shares = culled_shares(s.structure, cam, fields, p_res, cfg)
        tag = ("aa" if cfg.antialias else
               "custom" if cfg.max_steps != RenderConfig().max_steps else "default")
        print(f"[2] {name} {tag} {h}x{w}: = the shadow_cull=False twin bitwise; max |diff| "
              f"{err:.3g} ({'bitwise' if torch.equal(k_img, p_img) else 'not bitwise'}), "
              f"{over} px over {ATOL}; lanes culled per light {[round(v, 4) for v in shares]}")

    # --- 3. main path --------------------------------------------------------
    s4 = scenes["scene4.lol"]
    cfg = RenderConfig()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.png"
        fused_fwd.launches = 0
        cli.main(["render", str(EXAMPLES / "scene4.lol"), "--backend", "pallas",
                  "--size", f"{MAIN_W}x{MAIN_H}", "-o", str(out)])
        main_launches = fused_fwd.launches
        require(main_launches > 0, "the main path did not launch lol_render_fused")
        require(out.is_file(), f"{out} was not written")
        png = read_png(str(out))
    cam = camera_pack(s4.params, MAIN_H, MAIN_W, cfg)
    fields = pack_fields(s4.structure, s4.params)
    k_img = fused_fwd.fused_forward(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)
    p_img = fused_fwd.fused_forward_reference(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    require(tuple(k_img.shape) == (MAIN_H, MAIN_W, 3), f"image shape {tuple(k_img.shape)}")
    require(bool(((k_img >= 0) & (k_img <= 1)).all()), "image outside [0, 1]")
    require((image_to_u8(k_img.cpu().numpy()) == png).all(),
            "the CLI's PNG differs from the kernel's image")
    main_err, main_over = compare(k_img, p_img, "scene4 1920x1080")
    t_img = fused_fwd.fused_forward(s4.structure, no_cull(cfg), cam, fields, MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    require(torch.equal(k_img, t_img), "scene4 1920x1080: image != its shadow_cull=False twin's")
    print(f"[3] main path: cli render scene4 {MAIN_W}x{MAIN_H} -> {main_launches} "
          f"launch(es); PNG = kernel image = the shadow_cull=False twin's bitwise; vs plain: "
          f"max |diff| {main_err:.3g} ({'bitwise' if torch.equal(k_img, p_img) else 'not bitwise'})"
          f", {main_over} px over {ATOL}")
    del t_img

    # --- 4. the segment cull ------------------------------------------------------
    # the plain loops' SDF evaluations with the cull (culled lanes started
    # done, as the kernel skips them) and without, per ray
    rays = MAIN_W * MAIN_H
    live_main, live_twin = ({"march": [], "shadow": []} for _ in range(2))
    _, res_main = fused_train.train_forward_reference(s4.structure, cfg, cam, fields, MAIN_H,
                                                      MAIN_W, live=live_main)
    fused_train.train_forward_reference(s4.structure, no_cull(cfg), cam, fields, MAIN_H,
                                        MAIN_W, live=live_twin)
    main_shares = culled_shares(s4.structure, cam, fields, res_main, cfg)
    del res_main
    print(f"[4] the segment cull at scene4 {MAIN_W}x{MAIN_H}: lanes culled per light "
          f"{[round(v, 4) for v in main_shares]}; SDF evaluations a ray, march + shadow: "
          f"{sum(live_main['march']) / rays:.2f} + {sum(live_main['shadow']) / rays:.2f} with "
          f"the cull, {sum(live_twin['march']) / rays:.2f} + "
          f"{sum(live_twin['shadow']) / rays:.2f} without")

    # --- 5. build the training kernels ------------------------------------------
    train_built = [f.result() for f in train_built]
    train_twin_built = [f.result() for f in train_twin_built]
    train_s = time.perf_counter() - t0
    bwd_ptxas = [l for l in ptxas_lines(train_built[4].log) if "fused_bwd_kernel" in l]
    bwd_warps = 4 * fused_train.bwd_blocks_per_sm(s4.structure, train_cases[-1][1])
    print(f"[5] build: {len(train_built)} training libraries (4 structures + scene4 AA) and "
          f"their shadow_cull=False twins done {train_s:.1f} s after the builds started; "
          f"scene4 ptxas: " + " | ".join(ptxas_lines(train_built[3].log))
          + f"; scene4 AA lol_train_bwd: {' | '.join(bwd_ptxas)}, {bwd_warps} warps resident "
          f"a SM (the occupancy calculator: {bwd_warps // 4} blocks of 4 warps)")

    # --- 6. lol_train_fwd vs lol_render_fused and the plain version -------------
    residuals = {}
    for name, c in train_cases:
        s = scenes[name]
        cam = camera_pack(s.params, h, w, c)
        fields = pack_fields(s.structure, s.params)
        k_img, k_res = fused_train.train_forward(s.structure, c, cam, fields, h, w)
        t_img, t_res = fused_train.train_forward(s.structure, no_cull(c), cam, fields, h, w)
        f_img = fused_fwd.fused_forward(s.structure, c, cam, fields, h, w)
        p_img, p_res = fused_train.train_forward_reference(s.structure, c, cam, fields, h, w)
        torch.cuda.synchronize()
        what = f"{name} antialias={c.antialias}"
        require(torch.equal(k_img, f_img), f"{what}: lol_train_fwd image != lol_render_fused's")
        require(torch.equal(k_img, t_img) and torch.equal(k_res, t_res),
                f"{what}: lol_train_fwd image or residuals != its shadow_cull=False twin's")
        err, over = compare(k_img, p_img, what)
        res_over = check_residuals(k_res, p_res, what)
        residuals[(name, c.antialias)] = (cam, fields, k_res)
        print(f"[6] {what} {h}x{w}: image = lol_render_fused bitwise, image and residual planes"
              f" = the shadow_cull=False twin's bitwise; vs plain max |diff| {err:.3g}, {over} px"
              f" over {ATOL}; residual planes: {res_over}"
              f"{' (all bitwise)' if torch.equal(k_res, p_res) else ''}")

    # --- 7. lol_train_bwd vs the plain version -------------------------------------
    def check_bwd(s, c, cam, fields, res, hh, ww, what):
        gen = np.random.default_rng(0)
        ct = torch.from_numpy(gen.uniform(-1, 1, (hh, ww, 3)).astype(np.float32)).to(dev)
        dcam, dfields = fused_train.train_backward(s.structure, c, cam, fields, res, ct)
        dcam2, dfields2 = fused_train.train_backward(s.structure, c, cam, fields, res, ct)
        pcam, pfields = fused_train.train_backward_reference(s.structure, c, cam, fields, res, ct)
        torch.cuda.synchronize()
        require(torch.equal(dcam, dcam2) and torch.equal(dfields, dfields2),
                f"{what}: two lol_train_bwd launches differ")
        require(bool(torch.isfinite(dcam).all() and torch.isfinite(dfields).all()),
                f"{what}: non-finite gradients")
        worst, worst_abs = 0.0, 0.0
        for f, want in unpack_fields(s.structure, pfields).items():
            got = unpack_fields(s.structure, dfields)[f]
            if want.numel() == 0:
                continue
            scale = max(float(want.abs().max()), 1e-6)
            err = float((got - want).abs().max())
            worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
            require(err <= 1e-4 * scale, f"{what}: d{f} max |diff| {err:.3g} > 1e-4 * {scale:.3g}")
        atol = 1e-5 * max(1.0, float(pcam.abs().max()))
        cam_err = (dcam - pcam).abs()
        require(bool((cam_err <= atol + 2e-3 * pcam.abs()).all()),
                f"{what}: dcam {dcam.tolist()} vs plain {pcam.tolist()}")
        return worst, worst_abs, float(cam_err.max()), ct

    for name, c in train_cases:
        cam, fields, res = residuals[(name, c.antialias)]
        worst, _, cam_err, _ = check_bwd(scenes[name], c, cam, fields, res, h, w,
                                      f"{name} antialias={c.antialias}")
        print(f"[7] {name} antialias={c.antialias} {h}x{w}: fields max |diff| / max|grad| "
              f"{worst:.3g}, dcam max |diff| {cam_err:.3g}; two launches bitwise equal")
    c_aa = train_cases[-1][1]
    cam4 = camera_pack(s4.params, MAIN_H, MAIN_W, c_aa)
    fields4 = pack_fields(s4.structure, s4.params)
    img4, res4 = fused_train.train_forward(s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W)
    t_img4, t_res4 = fused_train.train_forward(s4.structure, no_cull(c_aa), cam4, fields4, MAIN_H,
                                               MAIN_W)
    f_img4 = fused_fwd.fused_forward(s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W)
    live_aa = {"march": [], "shadow": []}
    p_img4, p_res4 = fused_train.train_forward_reference(
        s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W, live=live_aa)
    torch.cuda.synchronize()
    what = f"scene4 AA {MAIN_W}x{MAIN_H}"
    require(tuple(img4.shape) == (MAIN_H, MAIN_W, 3), f"{what}: image shape {tuple(img4.shape)}")
    require(torch.equal(img4, f_img4), f"{what}: lol_train_fwd image != lol_render_fused's")
    require(torch.equal(img4, t_img4) and torch.equal(res4, t_res4),
            f"{what}: lol_train_fwd image or residuals != its shadow_cull=False twin's")
    fwd_err, over = compare(img4, p_img4, what)
    res_over = check_residuals(res4, p_res4, what)
    aa_shares = culled_shares(s4.structure, cam4, fields4, res4, c_aa)
    res_bitwise = torch.equal(res4, p_res4)
    del f_img4, p_img4, p_res4, t_img4, t_res4
    print(f"[7] lol_train_fwd {what}: image = lol_render_fused bitwise, image and residual "
          f"planes = the shadow_cull=False twin's bitwise; vs plain max |diff| {fwd_err:.3g}, "
          f"{over} px over {ATOL}; residual planes: {res_over}"
          f"{' (all bitwise)' if res_bitwise else ''}; lanes culled per light "
          f"{[round(v, 4) for v in aa_shares]}")
    worst, bwd_err, cam_err, _ = check_bwd(s4, c_aa, cam4, fields4, res4, MAIN_H, MAIN_W,
                                           "scene4 AA 1920x1080")
    print(f"[7] scene4 AA {MAIN_W}x{MAIN_H}: fields max |diff| / max|grad| {worst:.3g}, "
          f"max |diff| {bwd_err:.3g}, "
          f"dcam max |diff| {cam_err:.3g}; two launches bitwise equal")

    # --- 8. the training path ------------------------------------------------------
    fit8 = json.loads(run_profile("--profile-fit"))
    ran, graph, wrapped = fit8["ran"], fit8["train_step"], fit8["wrappers"]
    fwd_launches, bwd_launches = ran["fused_fwd_kernel"], ran["fused_bwd_kernel"]
    fit_table, dev_ms = wrapped["table"], fit8["device_ms"]
    require(fwd_launches == bwd_launches == ran["bwd_reduce_kernel"] == 5,
            f"fit_scene (5 steps): the device trace ran lol_train_fwd {fwd_launches}, "
            f"lol_train_bwd {bwd_launches}, its reduce {ran['bwd_reduce_kernel']} times")
    require(graph == {"captures": 1, "replays": 4, "eager": 1},
            f"fit_scene (5 steps): train_step counted {graph}")
    require(wrapped["lol_train_fwd"] == wrapped["lol_train_bwd"] == 1 and fit_table == 2,
            f"fit_scene (5 steps): the wrappers counted {wrapped} launches")
    losses = fit8["losses"]
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    print(f"[8] main path: fit_scene scene4 AA {MAIN_W}x{MAIN_H}, 5 Adam steps on "
          f"sphere_point through the sharded step on a mesh of one rank -> the device trace "
          f"ran lol_train_fwd x{fwd_launches}, lol_train_bwd x{bwd_launches}; train_step "
          f"captures {graph['captures']}, replays {graph['replays']}, eager {graph['eager']}; "
          f"the wrappers launched lol_train_fwd x{wrapped['lol_train_fwd']}, lol_train_bwd "
          f"x{wrapped['lol_train_bwd']} (the eager step), {fit_table} with the row table; "
          f"losses {losses}; device ms a launch: lol_train_fwd "
          f"{dev_ms['fused_fwd_kernel']:.4f}, lol_train_bwd {dev_ms['fused_bwd_kernel']:.4f} and "
          f"its reduce {dev_ms['bwd_reduce_kernel']:.4f}")
    k1_prof = run_profile("--profile-fused")
    k1_dev = float(re.search(r"device busy ([\d.]+) ms/step", k1_prof).group(1))
    require(k1_dev > 0, f"the profile saw no device time of K1: {k1_prof}")
    print(f"[8] torch.profiler over one lol_render_fused frame (`chip_smoke.py "
          f"--profile-fused`): {k1_prof}")

    # --- bounds from this run's data ------------------------------------------------
    st = s4.structure
    ops_eval = sdf_ops(st)
    L, px4 = st.num_lights, MAIN_H * MAIN_W
    small_bytes = 4 * (16 + packed_size(st))
    # phase 4's counts (phase 3's config), with the cull as the kernel runs
    m_fwd, sh_fwd = sum(live_main["march"]), sum(live_main["shadow"])
    m_aa, sh_aa = sum(live_aa["march"]), sum(live_aa["shadow"])
    # Operation model, counted on csrc/fused_fwd.cuh and csrc/fused_bwd.cuh
    # around E = sdf_ops per evaluation: per ray the camera ray 33, per
    # march step E + 9 (+ 6 with AA), per shadow step E + 15 (+ 2 for t*),
    # 4 normal taps E + 12 each and their normalize 10, the material
    # lookup E + 10, Phong 70 per light, the output 30; per light the
    # segment cull's bound (seg_cost); the IFT denominator one SDF adjoint
    # (3 E: its forward and reverse) + 15. The sqrt-weighted bound counts
    # each IEEE sqrtf at K8's measured cost in FMA slots (phase 25):
    # sdf_sqrts a evaluation, twice that an adjoint, and the normalizes
    # and light distances (1 each).
    E, aa, S = ops_eval, 6, sdf_sqrts(st)
    seg_ops, seg_sqrts = seg_cost(st)

    def fwd_ops(march, shadow, with_aa, residuals):
        per_ray = 33 + 4 * (E + 12) + 10 + (E + 10) + 70 * L + 30 + L * seg_ops
        if residuals:
            per_ray += 3 * E + 15
        return (march * (E + 9 + (aa if with_aa else 0))
                + shadow * (E + 15 + (2 if residuals else 0)) + px4 * per_ray)

    def fwd_sqrts(march, shadow, residuals):
        # camera, normal and camera-direction normalizes, the material
        # lookup and 4 taps, per light its distance, normalize and bound
        per_ray = 3 + 5 * S + L * (2 + seg_sqrts) + (2 * S if residuals else 0)
        return (march + shadow) * S + px4 * per_ray

    def weighted(ops, sqrts):
        return ops + (sqrt_slots - 1.0) * sqrts

    k1_ops = fwd_ops(m_fwd, sh_fwd, False, False)
    k1_bound = bound(small_bytes + 12 * px4, k1_ops, ceiling)
    k1_bound_sqrt = bound(small_bytes + 12 * px4,
                          weighted(k1_ops, fwd_sqrts(m_fwd, sh_fwd, False)), ceiling)
    n_res = fused_train.num_residuals(st)
    k1r_ops = fwd_ops(m_aa, sh_aa, True, True)
    k1r_bound = bound(small_bytes + (12 + 4 * n_res) * px4, k1r_ops, ceiling)
    k1r_bound_sqrt = bound(small_bytes + (12 + 4 * n_res) * px4,
                           weighted(k1r_ops, fwd_sqrts(m_aa, sh_aa, True)), ceiling)
    hit = res4[1] > 0.5
    live_fat = int((hit | (res4[0] > 0)).sum())
    valid = sum(int(((res4[5 + 2 * l] > 0) & (res4[4 + 2 * l] > 0) & (res4[4 + 2 * l] < 1)).sum())
                for l in range(L))
    # K2 per pixel: forward (ray 33, 4 taps E + 12 and normalize 10, camera
    # direction 13, Phong 60 per light, output 45) and reverse (110 per
    # light, 4 tap adjoints 3 E + 10, normalize 20, ray 40); per pixel with
    # a live f_at one more adjoint 3 E + 6, per valid penumbra 3 E + 20
    k2_ops = (px4 * (33 + 4 * (E + 12) + 10 + 13 + 60 * L + 45
                     + 110 * L + 4 * (3 * E + 10) + 20 + 40)
              + live_fat * (3 * E + 6) + valid * (3 * E + 20))
    k2_bound = bound(small_bytes * 2 + 4 * (n_res + 3) * px4, k2_ops, ceiling)
    # K2's sqrtf per pixel: forward 3 normalizes, 4 taps, L light normalizes;
    # reverse L light normalizes and their adjoints, 2 normalize adjoints,
    # 4 tap adjoints (2 S each), the ray's; a live f_at 3 S, a valid
    # penumbra 2 S
    k2_sqrts = px4 * (3 + 4 * S + 3 * L + 3 + 8 * S) + live_fat * 3 * S + valid * 2 * S
    k2_bound_sqrt = bound(small_bytes * 2 + 4 * (n_res + 3) * px4, weighted(k2_ops, k2_sqrts),
                          ceiling)
    print(f"[8] bounds: SDF evaluation {ops_eval} ops, {S} of them sqrtf; the segment bound "
          f"{seg_ops} ops, {seg_sqrts} sqrtf a light; scene4 march {m_fwd / px4:.1f} + "
          f"shadow {sh_fwd / px4:.1f} evaluations per ray with the cull (AA: "
          f"{m_aa / px4:.1f} + {sh_aa / px4:.1f}); operation model: lol_render_fused "
          f"{k1_bound[0]:.4f} ms, lol_train_fwd {k1r_bound[0]:.4f} ms, lol_train_bwd "
          f"{k2_bound[0]:.4f} ms, by {k1_bound[1]} / {k1r_bound[1]} / {k2_bound[1]}; each sqrtf "
          f"at {sqrt_slots:.3f} FMA slots (phase 25): {k1_bound_sqrt[0]:.4f} / "
          f"{k1r_bound_sqrt[0]:.4f} / {k2_bound_sqrt[0]:.4f} ms")

    # --- 9. build the instanced kernel -----------------------------------------------
    inst_built = [f.result() for f in inst_built]
    inst_s = time.perf_counter() - t0
    print(f"[9] build: {len(inst_built)} lol_instanced_render libraries (clamp 2, exact, "
          f"clamp 2 AA, shadow clamp 8) done {inst_s:.1f} s after the builds started; "
          f"ptxas (clamp 2): " + " | ".join(ptxas_lines(inst_built[0].log)))

    # --- 10. lol_instanced_render vs its plain version ------------------------------
    def inst_inputs(scene, c, hh, ww, row0=0):
        return (camera_pack(scene.params, hh, ww, c, row0=row0),
                pack_fields(scene.structure, scene.params),
                pack_instanced(scene.structure, scene.params))

    inst_cases = [(10_000, c) for c in inst_cfgs] + [(1, clamp2), (300, clamp2)]
    for n, c in inst_cases:
        sc = inst[n]
        cam, fields, tab = inst_inputs(sc, c, h, w)
        k_img = instanced_fwd.instanced_forward(sc.structure, c, cam, fields, tab, h, w)
        w_img = instanced_fwd.instanced_forward(sc.structure, c, cam, fields, tab, h, w,
                                                walk=True)
        p_img = instanced_fwd.instanced_forward_reference(sc.structure, c, cam, fields, tab, h, w)
        torch.cuda.synchronize()
        what = (f"instanced:{n} step_clamp={c.step_clamp} shadow_step_clamp="
                f"{c.shadow_step_clamp} antialias={c.antialias}")
        require(torch.equal(k_img, w_img), f"{what}: the grid search's image != the run walk's")
        err, over = compare(k_img, p_img, what)
        print(f"[10] {what} {h}x{w}: = the run walk's image bitwise; vs plain max |diff| "
              f"{err:.3g}, {over} px over {ATOL}")

    # --- 11. main path: cli render instanced:10000 ------------------------------------
    big = inst[10_000]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.png"
        instanced_fwd.launches = 0
        cli.main(["render", "instanced:10000", "--backend", "pallas", "--step-clamp", "2",
                  "--size", f"{MAIN_W}x{MAIN_H}", "-o", str(out)])
        inst_launches = instanced_fwd.launches
        require(inst_launches == 1,
                f"the main path launched lol_instanced_render {inst_launches} times, not once")
        png = read_png(str(out))
    cam, fields, tab = inst_inputs(big, clamp2, MAIN_H, MAIN_W)
    k_img = instanced_fwd.instanced_forward(big.structure, clamp2, cam, fields, tab,
                                            MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    require(tuple(k_img.shape) == (MAIN_H, MAIN_W, 3), f"image shape {tuple(k_img.shape)}")
    require(bool(torch.isfinite(k_img).all()), "non-finite pixels")
    require(bool(((k_img >= 0) & (k_img <= 1)).all()), "image outside [0, 1]")
    require((image_to_u8(k_img.cpu().numpy()) == png).all(),
            "the CLI's PNG differs from the kernel's image")

    # the plain version on three bands, counting SDF evaluations and, per
    # evaluated point, the spheres within its cut (what an exact search
    # must evaluate: the bound's work model)
    lo, hi = sphere_bbox(big.params.sphere_point, big.params.sphere_radius)
    near_total, runs_total = [0], [0]

    def probe(pts):
        # also the runs whose ball reaches within the cut: those the
        # kernel's search may visit (at most; its bound only shrinks)
        ctr, ball_r = tab.groups[:, :3], tab.groups[:, 3]
        for i in range(0, pts.shape[0], 4096):
            p = pts[i:i + 4096]
            c = big.params.sphere_point
            dx, dy, dz = (p[:, 0, None] - c[:, 0], p[:, 1, None] - c[:, 1],
                          p[:, 2, None] - c[:, 2])
            d = torch.sqrt((dx * dx + dy * dy) + dz * dz) - big.params.sphere_radius
            cut = bbox_cut(lo, hi, p, 2.0)[:, None]
            near_total[0] += int((d <= cut).sum())
            runs_total[0] += int((torch.cdist(p, ctr) - ball_r <= cut).sum())

    bands = {"top": 0, "middle": (MAIN_H - BAND) // 2, "bottom": MAIN_H - BAND}
    live_inst = {"march": [], "shadow": [], "probe": probe}
    inst_err = 0.0
    for name, r0 in bands.items():
        bcam = camera_pack(big.params, MAIN_H, MAIN_W, clamp2, row0=r0)
        p_band = instanced_fwd.instanced_forward_reference(
            big.structure, clamp2, bcam, fields, tab, BAND, MAIN_W, MAIN_H, live=live_inst)
        k_band = instanced_fwd.instanced_forward(big.structure, clamp2, bcam, fields, tab,
                                                 BAND, MAIN_W, MAIN_H)
        torch.cuda.synchronize()
        require(torch.equal(k_band, k_img[r0:r0 + BAND]),
                f"{name} band: the kernel's band launch differs from its frame's rows")
        err, over = compare(k_img[r0:r0 + BAND], p_band, f"instanced:10000 {name} band")
        inst_err = max(inst_err, err)
        print(f"[11] {name} band (rows {r0}-{r0 + BAND - 1}): max |diff| {err:.3g}, {over} px "
              f"over {ATOL}")
    band_px = BAND * MAIN_W * len(bands)
    m_inst, sh_inst = sum(live_inst["march"]), sum(live_inst["shadow"])
    evals = m_inst + sh_inst
    print(f"[11] main path: cli render instanced:10000 --step-clamp 2 {MAIN_W}x{MAIN_H} -> "
          f"{inst_launches} launch; PNG = kernel image; bands: march {m_inst / band_px:.1f} + "
          f"shadow {sh_inst / band_px:.1f} SDF evaluations per ray, "
          f"{near_total[0] / evals:.1f} spheres within the cut per evaluation, "
          f"{runs_total[0] / evals:.1f} runs of {GROUP} whose ball reaches within it")

    # --- 12. the grid against the run walk and the counting twin ---------------------
    w_img = instanced_fwd.instanced_forward(big.structure, clamp2, cam, fields, tab, MAIN_H,
                                            MAIN_W, walk=True)
    require(torch.equal(k_img, w_img), "the 1080p grid image != the run walk's image")
    del w_img
    inst_stats = {}
    for name, c in (("clamp 2", clamp2), ("exact", RenderConfig())):
        counts = torch.zeros(3, dtype=torch.int64, device=dev)
        s_img = instanced_fwd.instanced_forward(big.structure, c, cam, fields, tab, MAIN_H,
                                                MAIN_W, stats=counts)
        if name == "clamp 2":
            require(torch.equal(s_img, k_img), "the counting grid kernel's image differs")
        else:
            e_img = instanced_fwd.instanced_forward(big.structure, c, cam, fields, tab,
                                                    MAIN_H, MAIN_W, walk=True)
            require(torch.equal(s_img, e_img), "exact 1080p: the grid image != the walk's")
            del e_img
        n_search, n_fall, n_read = counts.tolist()
        inst_stats[name] = (n_fall / n_search, n_read / n_search, n_search / (MAIN_W * MAIN_H))
        del s_img
    print(f"[12] instanced:10000 {MAIN_W}x{MAIN_H}: the grid's image bitwise the run walk's at "
          f"clamp 2 and exact; grid searches (the counting twin, its image bitwise the "
          f"kernel's): " + "; ".join(f"{k}: {v[2]:.1f} searches a pixel, {v[0]:.4%} fell back "
                                     f"to the walk, {v[1]:.2f} list entries read a search"
                                     for k, v in inst_stats.items()))
    inst_profile = run_profile("--profile-instanced")
    print(f"[12] torch.profiler over one frame at {MAIN_W}x{MAIN_H}: {inst_profile}")

    # K5 work model (independent of the kernel's traversal): per evaluation
    # 9 operations for each sphere within the cut of the point (counted on
    # the bands by the plain version), 20 for the cut and 2 for the plane,
    # plus the march step (9) or shadow step (15); per pixel K1's shading
    # work (ray, normals, material, Phong, output) with its 5 evaluations
    # counted at the cut and plane only. The bands' totals scale to the
    # frame by pixels: a sample of 48 of 1080 rows.
    inst_ops_bands = (9 * near_total[0] + 22 * evals + 9 * m_inst + 15 * sh_inst
                      + band_px * (33 + 4 * 12 + 10 + 10 + 5 * 22 + 70 * big.structure.num_lights
                                   + 30))
    inst_ops = inst_ops_bands * (MAIN_W * MAIN_H) / band_px
    inst_bytes = (4 * (16 + fields.numel() + tab.spheres.numel() + tab.ids.numel()
                       + tab.groups.numel() + 6) + 12 * MAIN_W * MAIN_H)
    k5_bound = bound(inst_bytes, inst_ops, ceiling)
    inst_dev = float(re.search(r"instanced_fwd_kernel: ([\d.]+) ms in", inst_profile).group(1))
    require(inst_dev > 0, f"the profile saw no device time of K5: {inst_profile}")
    print(f"[12] bound: lol_instanced_render {k5_bound[0]:.4f} ms by {k5_bound[1]} "
          f"({inst_ops:.4g} operations per 1080p frame, scaled from the bands)")

    # --- 13. build the instanced training kernels ------------------------------------
    inst_train_built = [f.result() for f in inst_train_built]
    pool.shutdown()
    it_s = time.perf_counter() - t0
    print(f"[13] build: {len(inst_train_built)} lol_instanced_fwd + lol_instanced_bwd "
          f"libraries (clamp 2, exact, clamp 2 AA; envelope) done {it_s:.1f} s after the "
          f"builds started; ptxas (clamp 2): " + " | ".join(ptxas_lines(inst_train_built[0].log)))

    # --- 14. lol_instanced_fwd / lol_instanced_bwd vs the plain versions --------------
    def check_inst_bwd(sc, c, cam, fields, tab, res, hh, full_h, what, ref_rows=None):
        # lol_instanced_bwd over the cell grid: bitwise a second launch and
        # lol_instanced_bwd_walk (records, grads, dsph), dsph bitwise the
        # records summed per row in increasing record index, and against
        # the plain version by the phase-7 rule. ref_rows: run the plain
        # version on bands of that many rows (the pack's row0 moved down
        # by each band's offset) and add their gradients up: the VJP is a
        # sum over pixels
        gen = np.random.default_rng(0)
        ct = torch.from_numpy(gen.uniform(-1, 1, (hh, res.shape[2], 3)).astype(np.float32)).to(dev)
        grid = grid_for(tab, c.step_clamp)
        got, again, walked = (instanced_train.instanced_train_backward(
            sc.structure, c, cam, fields, tab, res, ct, full_h, grid=grid, records=True, walk=walk)
            for walk in (False, False, True))
        torch.cuda.synchronize()
        require(same_backward(got, again), f"{what}: two lol_instanced_bwd launches differ")
        require(same_backward(got, walked), f"{what}: lol_instanced_bwd over the grid differs "
                "from lol_instanced_bwd_walk (records, grads or dsph)")
        serial = serial_row_sums(got[3], got[4], sc.structure.num_spheres)
        require(same_bits(got[2].cpu(), torch.from_numpy(serial)),
                f"{what}: dsph is not its records summed per row in increasing record index")
        n_rec = int((got[3] >= 0).sum())
        got = got[:3]
        want, step = None, ref_rows or hh
        for r in range(0, hh, step):
            rcam = cam.clone()
            rcam[15] += r
            part = instanced_train.instanced_train_backward_reference(
                sc.structure, c, rcam, fields, tab, res[:, r:r + step], ct[r:r + step], full_h)
            want = part if want is None else tuple(a + b for a, b in zip(want, part))
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(g).all()) for g in got), f"{what}: non-finite gradients")
        pairs = [(f, unpack_fields(sc.structure, got[1])[f], v)
                 for f, v in unpack_fields(sc.structure, want[1]).items()]
        pairs.append(("sphere table", got[2], want[2]))
        worst, worst_abs = 0.0, 0.0
        for f, g, v in pairs:
            if v.numel() == 0:
                continue
            scale = max(float(v.abs().max()), 1e-6)
            err = float((g - v).abs().max())
            worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
            require(err <= 1e-4 * scale, f"{what}: d{f} max |diff| {err:.3g} > 1e-4 * {scale:.3g}")
        dcam, pcam = got[0], want[0]
        cam_err = (dcam - pcam).abs()
        atol = 1e-5 * max(1.0, float(pcam.abs().max()))
        require(bool((cam_err <= atol + 2e-3 * pcam.abs()).all()),
                f"{what}: dcam {dcam.tolist()} vs plain {pcam.tolist()}")
        return worst, worst_abs, float(cam_err.max()), n_rec

    it_cases = [(10_000, c) for c in inst_train_cfgs] + [(300, clamp2_env), (1, clamp2_env)]
    for n, c in it_cases:
        sc = inst[n]
        cam, fields, tab = inst_inputs(sc, c, h, w)
        k_img, k_res = instanced_train.instanced_train_forward(sc.structure, c, cam, fields, tab,
                                                               h, w)
        f_img = instanced_fwd.instanced_forward(sc.structure, c, cam, fields, tab, h, w)
        p_img, p_res = instanced_train.instanced_train_forward_reference(
            sc.structure, c, cam, fields, tab, h, w)
        torch.cuda.synchronize()
        what = f"instanced:{n} step_clamp={c.step_clamp} antialias={c.antialias}"
        require(torch.equal(k_img, f_img),
                f"{what}: lol_instanced_fwd image != lol_instanced_render's")
        err, over = compare(k_img, p_img, what)
        res_over = check_residuals(k_res, p_res, what)
        worst, _, cam_err, n_rec = check_inst_bwd(sc, c, cam, fields, tab, k_res, h, h, what)
        print(f"[14] {what} {h}x{w}: image = lol_instanced_render bitwise; vs plain max |diff| "
              f"{err:.3g}, {over} px over {ATOL}; residual planes: {res_over}; "
              f"lol_instanced_bwd (grid) = lol_instanced_bwd_walk bitwise in its {n_rec} "
              f"records, grads and dsph, dsph = its records summed in record order; fields and "
              f"sphere table max |diff| / max|grad| {worst:.3g} vs plain, dcam max |diff| "
              f"{cam_err:.3g}; two launches bitwise equal")

    # --- 15. main path: fit_scene on instanced:10000 ------------------------------------
    st10 = big.structure
    gen = np.random.default_rng(0)
    moved = big.params.sphere_point + torch.from_numpy(
        gen.uniform(-0.2, 0.2, tuple(big.params.sphere_point.shape)).astype(np.float32)).to(dev)
    it_target = make_cuda_renderer(st10, MAIN_H, MAIN_W, clamp2_env, device=dev)(
        dataclasses.replace(big.params, sphere_point=moved))
    fit_steps = 3
    instanced_train.launches_fwd = instanced_train.launches_bwd = cell_grid.builds = 0
    instanced_train.launches_table = 0
    it_fit = fit_scene(st10, big.params, it_target, steps=fit_steps, learning_rate=1e-2,
                       trainable=("sphere_point",), cfg=clamp2_env, device=dev)
    it_fwd_launches, it_bwd_launches = instanced_train.launches_fwd, instanced_train.launches_bwd
    it_builds, it_table = cell_grid.builds, instanced_train.launches_table
    require(it_fwd_launches == fit_steps and it_bwd_launches == fit_steps
            and it_builds == fit_steps and it_table == 2 * fit_steps,
            f"fit_scene ({fit_steps} steps) launched lol_instanced_fwd {it_fwd_launches}, "
            f"lol_instanced_bwd {it_bwd_launches} times ({it_table} with a row table) and "
            f"built {it_builds} cell grids")
    it_losses = [float(v) for v in it_fit.losses]
    require(all(map(math.isfinite, it_losses)), f"non-finite loss: {it_losses}")
    require(it_losses[-1] < it_losses[0], f"the loss did not fall: {it_losses}")
    print(f"[15] main path: fit_scene instanced:10000 clamp 2 envelope {MAIN_W}x{MAIN_H}, "
          f"{fit_steps} Adam steps on sphere_point through the sharded step on a mesh of one "
          f"rank -> lol_instanced_fwd x{it_fwd_launches}, lol_instanced_bwd x{it_bwd_launches}, "
          f"each with the row table, {it_builds} cell grids built (one a step, searched by "
          f"both); losses {it_losses}")

    cam_it, fields_it, tab_it = inst_inputs(big, clamp2_env, MAIN_H, MAIN_W)
    img_it, res_it = instanced_train.instanced_train_forward(st10, clamp2_env, cam_it, fields_it,
                                                             tab_it, MAIN_H, MAIN_W)
    it_fwd_err, it_bwd_err = 0.0, 0.0
    for name in ("middle", "bottom"):  # two of phase 11's bands
        r0 = bands[name]
        bcam = camera_pack(big.params, MAIN_H, MAIN_W, clamp2_env, row0=r0)
        k_band, k_bres = instanced_train.instanced_train_forward(
            st10, clamp2_env, bcam, fields_it, tab_it, BAND, MAIN_W, MAIN_H)
        p_band, p_bres = instanced_train.instanced_train_forward_reference(
            st10, clamp2_env, bcam, fields_it, tab_it, BAND, MAIN_W, MAIN_H)
        torch.cuda.synchronize()
        what = f"instanced:10000 training {name} band"
        require(torch.equal(k_band, img_it[r0:r0 + BAND])
                and torch.equal(k_bres, res_it[:, r0:r0 + BAND]),
                f"{what}: the band launch differs from its frame's rows")
        err, over = compare(k_band, p_band, what)
        res_over = check_residuals(k_bres, p_bres, what)
        worst, werr, cam_err, _ = check_inst_bwd(big, clamp2_env, bcam, fields_it, tab_it,
                                                 k_bres, BAND, MAIN_H, what)
        it_fwd_err, it_bwd_err = max(it_fwd_err, err), max(it_bwd_err, werr)
        print(f"[15] {name} band (rows {r0}-{r0 + BAND - 1}): lol_instanced_fwd = frame rows "
              f"bitwise, vs plain max |diff| {err:.3g}, {over} px over; residual planes: "
              f"{res_over}; lol_instanced_bwd = its walk twin bitwise, max |diff| / max|grad| "
              f"{worst:.3g} (max |diff| {werr:.3g}), dcam max |diff| {cam_err:.3g}; two "
              f"launches bitwise equal")
    # lol_instanced_bwd at the main path's shape: one launch over the whole
    # frame (its reduce and scatter sum across all of it), the plain version
    # band by band on the same residuals and cotangent
    t_full = time.perf_counter()
    worst, werr, cam_err, n_rec = check_inst_bwd(
        big, clamp2_env, cam_it, fields_it, tab_it, res_it, MAIN_H, MAIN_H,
        "instanced:10000 training full frame", ref_rows=BAND)
    it_bwd_err = max(it_bwd_err, werr)
    print(f"[15] full frame {MAIN_W}x{MAIN_H}: lol_instanced_bwd (grid) = lol_instanced_bwd_walk "
          f"bitwise in its {n_rec} records, grads and dsph, dsph = its records summed in record "
          f"order; vs the plain version summed over {-(-MAIN_H // BAND)} bands of {BAND} rows: "
          f"max |diff| / max|grad| {worst:.3g} (max |diff| {werr:.3g}), dcam max |diff| "
          f"{cam_err:.3g}; two launches bitwise equal ({time.perf_counter() - t_full:.1f} s)")

    # --- 16. the instanced training step: one grid, the counting twin ----------------
    it_render = instanced_train.make_instanced_training_renderer(st10, MAIN_H, MAIN_W,
                                                                 clamp2_env, device=dev)
    it_leaves = dataclasses.replace(
        big.params, sphere_point=big.params.sphere_point.clone().requires_grad_(True))

    def it_step():
        loss = ((it_render(it_leaves) - it_target) ** 2).mean()
        loss.backward()

    it_step()
    torch.cuda.synchronize()
    cell_grid.builds = 0
    it_step()
    require(cell_grid.builds == 1, f"one training step built {cell_grid.builds} cell grids")
    del it_render, it_leaves
    ct_it = torch.from_numpy(np.random.default_rng(0).uniform(
        -1e-3, 1e-3, (MAIN_H, MAIN_W, 3)).astype(np.float32)).to(dev)
    grid_it = grid_for(tab_it, 2.0)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    s_out = instanced_train.instanced_train_backward(st10, clamp2_env, cam_it, fields_it,
                                                     tab_it, res_it, ct_it, grid=grid_it,
                                                     stats=counts, records=True)
    k_out = instanced_train.instanced_train_backward(st10, clamp2_env, cam_it, fields_it,
                                                     tab_it, res_it, ct_it, grid=grid_it,
                                                     records=True)
    torch.cuda.synchronize()
    require(same_backward(s_out, k_out), "lol_instanced_bwd_stats differs from lol_instanced_bwd")
    n_search, n_fall, n_read = counts.tolist()
    k6_stats = (n_fall / n_search, n_read / n_search, n_search / (MAIN_W * MAIN_H))
    row_recs = torch.bincount(k_out[3][k_out[3] >= 0].long(), minlength=st10.num_spheres)
    del s_out, k_out
    print(f"[16] instanced:10000 clamp 2 envelope {MAIN_W}x{MAIN_H}: a fwd+bwd step of "
          f"make_instanced_training_renderer builds one cell grid; lol_instanced_bwd's grid "
          f"searches (the counting twin, bitwise the kernel): {k6_stats[2]:.2f} searches a "
          f"pixel, {k6_stats[0]:.4%} fell back to the walk, {k6_stats[1]:.2f} list entries read "
          f"a search; records per sphere-table row: max {int(row_recs.max())}, mean "
          f"{float(row_recs.float().mean()):.1f} (the sum's longest chain); ptxas (clamp 2): "
          + " | ".join(l for l in ptxas_lines(inst_train_built[0].log)
                       if "instanced_bwd" in l or "rec_" in l))

    it_profile = run_profile("--profile-instanced-train")
    it_dev = {k: float(v) for k, v in re.findall(r"; (\w+): ([\d.]+) ms in", it_profile)}
    require(all(it_dev.get(k, 0) > 0 for k in ("instanced_fwd_kernel", "instanced_bwd_kernel")),
            f"the profile saw no device time of K5r / K6: {it_profile}")
    print(f"[16] torch.profiler over one step: {it_profile}")

    # Bounds on K5's work model (phase 12): an evaluation costs 9 operations
    # per sphere within the cut (the bands' average) + 22, its adjoint 15
    # more. lol_instanced_fwd: K5's work + one adjoint evaluation per pixel
    # (the IFT denominator) + the residual planes' bytes. lol_instanced_bwd:
    # the evaluations its data needs (4 taps per pixel, the numerator where
    # hit or AA-missed, the Danskin term per valid penumbra) at that cost,
    # K2's reverse arithmetic per pixel (phase 8's model without the SDF),
    # and the bytes of its inputs (camera, fields, tables, residuals,
    # cotangent) and outputs (grads, sphere table). The record buffer is the
    # scatter's intermediate, not the function's: its traffic (20 B per
    # slot, written and read once) is printed beside the bound, not in it.
    px_main = MAIN_W * MAIN_H
    e_inst = 9 * near_total[0] / evals + 22
    n_res_i = instanced_train.num_residuals(st10)
    k5r_bound = bound(inst_bytes + 4 * n_res_i * px_main, inst_ops + px_main * (e_inst + 15),
                      ceiling)
    Li = st10.num_lights
    hit_it = res_it[1] > 0.5
    fat_it = int((hit_it | (res_it[0] > 0)).sum())
    valid_it = sum(int(((res_it[5 + 2 * l] > 0) & (res_it[4 + 2 * l] > 0)
                        & (res_it[4 + 2 * l] < 1)).sum()) for l in range(Li))
    k6_evals = 4 * px_main + fat_it + valid_it
    k6_ops = (k6_evals * (e_inst + 15)
              + px_main * (33 + 4 * 12 + 10 + 13 + 60 * Li + 45 + 110 * Li + 4 * 10 + 20 + 40))
    sites = instanced_train.num_sites(st10)
    k6_bytes = ((inst_bytes - 12 * px_main) + 4 * (n_res_i + 3) * px_main
                + 4 * (16 + fields_it.numel() + 4 * st10.num_spheres))
    k6_bound = bound(k6_bytes, k6_ops, ceiling)
    rec_bytes = 2 * 20 * sites * px_main
    print(f"[16] bounds: lol_instanced_fwd {k5r_bound[0]:.4f} ms by {k5r_bound[1]}; "
          f"lol_instanced_bwd {k6_bound[0]:.4f} ms by {k6_bound[1]} ({k6_evals / px_main:.2f} "
          f"adjoint evaluations per pixel at {e_inst:.1f} operations, {k6_ops:.4g} operations, "
          f"{k6_bytes / 1e6:.1f} MB); its record buffer moves {rec_bytes / 1e6:.1f} MB more "
          f"({rec_bytes / HBM_BYTES_PER_MS:.4f} ms at {HBM_BYTES_PER_MS / 1e9:.2f} TB/s), "
          f"not counted in the bound")

    march_entries = march_phases(dev, card, scenes, inst, march_built, t0, e_inst, it_target,
                                 ceiling, sqrt_slots)
    regroup_entries = regroup_phases(dev, card, inst, inst_cfgs, regroup_built, t0, e_inst,
                                     m_inst / band_px, ceiling)
    objects_entry, hit_pts = objects_phases(dev, card, inst, eval_built, t0, ceiling)
    grid_phase(dev, card, inst, hit_pts)
    deal = rowtab_phase(dev, scenes, inst, train_cases, h, w)
    # the main paths' launches with the row table (phases 8 and 15), bitwise
    # their launches without one (phase 31)
    rowtab = {"fit": {"launches": fit_table // 2, "bitwise": True},
              "instanced_fit": {"launches": it_table // 2, "bitwise": True}}
    ranks2 = sharded_phase(dev, card)
    checkpoint_phase(dev, card, s4)
    stats_phase(dev, card)
    golden_phase(dev, card)
    roofline_phase(dev, card)
    view_phase(dev, card, s4)
    native_phase(card)
    build_bench_libraries(dev)
    bench_phase(dev, card)
    build_scaling_libraries(dev)
    scaling = scaling_phase(dev, card)

    print(json.dumps({"kernels": [
        dict(entry("lol_render_fused", "loltracer_tpu_torch/csrc/fused_fwd.cuh",
                   "loltracer_tpu/render/pallas_train.py:346", main_launches, main_err,
                   bnd=k1_bound, timed_by="scene4-frames-1080p"),
             device_ms=k1_dev, bound_sqrt_ms=k1_bound_sqrt[0], culled_share=main_shares,
             shadow_evals_per_ray={"cull": sum(live_main["shadow"]) / rays,
                                   "twin": sum(live_twin["shadow"]) / rays}),
        dict(entry("lol_train_fwd", "loltracer_tpu_torch/csrc/fused_fwd.cuh",
                   "loltracer_tpu/render/pallas_train.py:346", fwd_launches, fwd_err,
                   bnd=k1r_bound, timed_by="scene4-fit-1080p"),
             device_ms=dev_ms["fused_fwd_kernel"], bound_sqrt_ms=k1r_bound_sqrt[0],
             culled_share=aa_shares, rowtab=rowtab["fit"], deal=deal["scene4 AA"],
             two_ranks=ranks2["scene4"], scaling=scaling["lol_train_fwd"]),
        dict(entry("lol_train_bwd", "loltracer_tpu_torch/csrc/fused_bwd.cuh",
                   "loltracer_tpu/render/pallas_train.py:469", bwd_launches, bwd_err,
                   bnd=k2_bound, timed_by="scene4-fit-1080p"),
             device_ms=dev_ms["fused_bwd_kernel"], reduce_device_ms=dev_ms["bwd_reduce_kernel"],
             bound_sqrt_ms=k2_bound_sqrt[0], ptxas=bwd_ptxas, warps_per_sm=bwd_warps,
             rowtab=rowtab["fit"], scaling=scaling["lol_train_bwd"]),
        dict(entry("lol_instanced_render", "loltracer_tpu_torch/csrc/grid_scene.cuh",
                   "loltracer_tpu/render/pallas_train.py:840", inst_launches, inst_err,
                   bnd=k5_bound, timed_by="instanced10k-frames-4k"),
             device_ms=inst_dev, fallback_share={k: v[0] for k, v in inst_stats.items()}),
        dict(entry("lol_instanced_fwd", "loltracer_tpu_torch/csrc/grid_scene.cuh",
                   "loltracer_tpu/render/pallas_train.py:840", it_fwd_launches, it_fwd_err,
                   bnd=k5r_bound, timed_by="instanced10k-fit-1080p"),
             device_ms=it_dev["instanced_fwd_kernel"], rowtab=rowtab["instanced_fit"],
             deal=deal["instanced:10000 clamp 2"], two_ranks=ranks2["instanced"],
             scaling=scaling["lol_instanced_fwd"]),
        dict(entry("lol_instanced_bwd", "loltracer_tpu_torch/csrc/instanced_bwd.cuh",
                   "loltracer_tpu/render/pallas_train.py:1314", it_bwd_launches, it_bwd_err,
                   bnd=k6_bound, timed_by="instanced10k-fit-1080p"),
             device_ms=it_dev["instanced_bwd_kernel"],
             scatter_device_ms=it_dev.get("rec_", 0.0) + it_dev.get("Memset", 0.0),
             record_bytes=rec_bytes, fallback_share=k6_stats[0], entries_per_search=k6_stats[1],
             rowtab=rowtab["instanced_fit"], scaling=scaling["lol_instanced_bwd"]),
        *march_entries,
        *regroup_entries,
        *peak_entries,
        objects_entry,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] in (["--profile-instanced"], ["--profile-instanced-train"]):
        sys.exit(profile_instanced(train=sys.argv[1].endswith("-train")))
    if sys.argv[1:] == ["--profile-march"]:
        sys.exit(profile_march())
    if sys.argv[1:] == ["--march-ab"]:
        sys.exit(march_ab())
    if sys.argv[1:] == ["--bench"]:
        sys.exit(bench_only())
    if sys.argv[1:] == ["--scaling"]:
        sys.exit(scaling_only())
    if sys.argv[1:] == ["--profile-regroup"]:
        sys.exit(profile_regroup())
    if sys.argv[1:2] == ["--profile-peak"]:
        sys.exit(profile_peak(sys.argv[2:]))
    if sys.argv[1:] == ["--profile-fused"]:
        sys.exit(profile_fused())
    if sys.argv[1:] == ["--profile-fit"]:
        sys.exit(profile_fit())
    if sys.argv[1:] == ["--profile-objects"]:
        sys.exit(profile_objects())
    if sys.argv[1:2] == ["--objects-rank"]:
        sys.exit(objects_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
