#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (`loltracer_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:

0. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
1. build the fused forward kernel for the four example structures (nvcc,
   at first use, into loltracer_tpu_torch/_build/);
2. kernel vs its plain PyTorch version on the card: the four examples at
   97x161 (ragged edges), scene4 with antialiasing and scene2 with a custom
   config; |diff| <= 5e-5 on every pixel but at most max(2, 1e-4 * pixels);
3. the main path: `loltracer_tpu_torch.cli render examples/scene4.lol
   --size 1920x1080`, which must launch the kernel; its image must be
   finite, in [0, 1], and match the plain version at 1920x1080 to the
   tolerance of phase 2;
4. frame times at scene4 @1920x1080: the kernel (median of 10 warm frames)
   and the plain version (once, warm), CUDA events;
5. build the training kernels (lol_train_fwd, lol_train_bwd and its reduce)
   for the four example structures with envelope shadows and for scene4
   with antialiasing; all builds start together in phase 1, one nvcc each;
   ptxas registers and spills of scene4's kernels;
6. lol_train_fwd vs lol_render_fused and vs its plain version at 97x161 on
   those five cases: the image bitwise equal to lol_render_fused's and
   within the phase-2 rule of the plain one; hit and material equal and
   t_sh, res, t* within 1e-4 * max(1, |x|) on all but max(2, 1e-4 *
   pixels) pixels; the IFT denominator within rtol 1e-4 on hit pixels with
   |den| > 1e-2;
7. lol_train_fwd at the main path's shape, scene4 AA at 1920x1080, held
   the same way as in phase 6; then lol_train_bwd vs its plain version on
   the kernel's own residuals and a seeded cotangent, the five cases at
   97x161 and scene4 AA at 1920x1080: every field within 1e-4 *
   max|grad|, dcam within rtol 2e-3 (atol 1e-5 * max(1, max|dcam|)), and
   two launches bitwise equal;
8. the training path: `fit_scene` on scene4 @1920x1080 with antialiasing
   and envelope shadows, sphere points trainable, 5 Adam steps, against the
   port's render of scene4 with its sphere points moved; it must launch
   both training kernels and lower the loss. Then one fwd+bwd step of
   `make_training_renderer` timed (median of 10, CUDA events), its two
   kernels timed apart, the plain versions (once, warm), peak memory;
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
   it;
12. kernel frame times (CUDA events; median of 3 warm frames at 1920x1080,
   of 2 at 3840x2160; each call builds its cell grid, timed apart), the run
   walk's in turns around them (walk, grid, walk), its 1080p image bitwise
   the grid's at clamp 2 and exact, the share of grid searches that fell
   back to the walk (the counting twin); device time (torch.profiler, in a
   process of its own: `chip_smoke.py --profile-instanced`), the plain
   version's time on one band, and the bound;
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
   render with the spheres moved: one launch of each kernel and one cell
   grid built per step, and the loss falls. Then both kernels against the
   plain version on two full-width 16-row bands through the camera pack's
   row0 (the bands' launches bitwise the frame's rows), and
   lol_instanced_bwd's full-frame launch, held as in phase 14 against its
   walk twin and its records, and against the plain version run on every
   16-row band of the frame and summed, by the phase-7 rule;
16. one fwd+bwd step of `make_instanced_training_renderer` (one grid
   built in it) timed (median of 3, CUDA events); over a built grid its
   two kernels timed apart, lol_instanced_bwd_walk in turns around them,
   the grid build apart; lol_instanced_bwd's grid searches (its counting
   twin: searches, fallbacks, entries read), the records per sphere-table
   row, its ptxas lines; device time (`chip_smoke.py
   --profile-instanced-train`, a process of its own, with the kernel's and
   the scatter's device time apart), peak memory, the plain versions on
   one band, and the bounds;
17. build the value march kernels (K3 `lol_march` and K4 `lol_shadow_march`
   for the four examples; `lol_march_instanced` and
   `lol_shadow_march_instanced` for clamp 2, exact and shadow clamp 8, at
   every lane-group width of `cuda_scene.MARCH_LANES`; all started with
   the other builds in phase 1); ptxas registers and spills per width (a
   lane group must not spill);
18. at 97x161 (instanced:10000 at 49x81), K3 vs its plain version
   (`march_values_reference`) on the camera rays and K4 vs its plain
   version (`shadow_values_reference`) on the real shadow rays of each
   light: the four examples, scene4 AA, instanced:10000 at clamp 2, exact
   and shadow clamp 8, instanced:300 and :1 at clamp 2, the instanced ones
   at every compiled width; bitwise expected, else within atol/rtol 1e-4
   on all but max(2, 1e-4 * rays);
19. main path A: `loltracer_tpu_torch.cli fit examples/scene4.lol --target
   T.npy --steps 3 -o ...` (AA, exact shadows; sphere points trainable,
   lr 3e-2) against scene4 with its sphere points moved, rendered by
   lol_render_fused at 1920x1080: exactly one K3 launch per step and one
   for `-o`, no K4; the three losses fall; peak memory;
20. main path B: `render_image` of scene4 @1920x1080 with AA and envelope
   shadows under autograd: one K3 and two K4 launches; the image within
   the phase-2 rule of lol_render_fused's; MSE gradients, the penumbra band
   masked out of the loss (tests/_penumbra.py), within 2e-2 * max|grad|
   per field of make_training_renderer's (K1r/K2). Then path A's step
   (once) and path B's (median of 2) timed; K3 and K4 at path B's
   rays held against their plain versions and timed (median of 10; plain
   median of 2), their bounds from the plain loops' live counts;
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
   (`chip_smoke.py --profile-march`, a process of its own) over one path B
   step, one round of the four march kernels and path C's middle band, and
   one path B step's peak memory by allocating line.

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
   image bitwise, its fallback share) and K7 at the hit points.

The CLI phases (3, 11) pass `--backend pallas`: `cli render` defaults to
the differentiable renderer, as the JAX package's does.

Then a JSON line with each kernel's launches on its main path, error,
times and bound, and last the line {"ok": true, "device": {...}}. Any
failure raises: the traceback is printed, the exit code is not 0 and the
last line is not printed. Without CUDA, or without the package beside this
file, it fails the same way.

The march kernels' launches in the `kernels` line are those of their main
paths: lol_march in path A, lol_shadow_march in path B, the instanced pair
in path C's frame (their `ms` per 16-row band at the rule's `lanes`,
`frame_ms` one full-frame launch at the rule's `frame_lanes`, `sweep_ms`
[band, half frame, frame] per width); the instanced training pair's those
of phase 15's `fit_scene` (their `ms` over a built grid, `grid_build_ms`
beside; lol_instanced_bwd's walk twin's under `walk_ms`, before and
after, with its fallback share and entries per search); the K9 kernels'
those of path D's clamp-2 frame (their `ms` per launch over the grid
beside their walk twins' `walk_ms`, lol_rg_shadow for light 0 sorted
beside `unsorted_ms` and, under `lights`, each light's times and bound;
lol_rg_shade's entry carries the frame, the glue, K5's time, the exact
frame's and the fallback shares of its searches);
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
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXAMPLES = ROOT / "examples"
SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
ATOL = 5e-5
MAIN_W, MAIN_H = 1920, 1080
UHD_W, UHD_H = 3840, 2160
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
            name = ("lol_shadow_march" if "ILb1E" in m.group(1) else "lol_march") + (
                f"_instanced @{lanes} lanes" if lanes else "")
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
    # lol_instanced_bwd's kernel apart from its scatter's (rec_*, and the
    # memset of its counts)
    print(profile_steps(frame, 1, split=("instanced_bwd_kernel", "rec_", "Memset")
                        if train else ()))
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
    autograd) on that middle band. One line on stdout, the four joined by
    " || "."""
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

    step(), band(), band_c()
    print(profile_steps(step, 1) + " || " + profile_steps(band, 1) + " || "
          + peak_breakdown(step) + " || " + profile_steps(band_c, 1))
    return 0


def run_profile(*args: str) -> str:
    """A profiling line (profile_instanced's and the like), from a child
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


def entry(name, source, replaces, launches, err, ms, plain, bnd):
    """One kernel's object of the `kernels` line."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


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


def march_phases(dev, card, scenes, inst, march_built, t0, e_inst, it_target, ceiling):
    """Phases 17-21: the value march kernels K3 / K4 and the three paths
    that run them (module docstring). Returns their four `kernels`
    entries."""
    import numpy as np
    import torch

    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.opt import fit_scene
    from loltracer_tpu_torch.render import fused_fwd, fused_train, instanced_fwd, instanced_train
    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.camera import camera_pack, camera_rays, camera_rays_for_rows
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.render.cuda_scene import MARCH_LANES, pack_fields, packed_size
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

    # --- 17. build ----------------------------------------------------------------
    built = [f.result() for f in march_built]
    print(f"[17] build: {len(built)} march libraries (lol_march + lol_shadow_march for the 4 "
          f"examples; lol_march_instanced + lol_shadow_march_instanced for clamp 2, exact, "
          f"shadow clamp 8, each at lane widths {MARCH_LANES}) done "
          f"{time.perf_counter() - t0:.1f} s after the builds started; "
          f"ptxas scene4: " + " | ".join(ptxas_lines(built[3].log)))
    for tag, lib in zip(("clamp 2", "exact", "shadow clamp 8"), built[4:]):
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
        t_fit = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli.main(["fit", str(EXAMPLES / "scene4.lol"), "--target", str(tgt), "--steps",
                      str(fit_steps), "--trainable", "sphere_point", "--lr", "3e-2",
                      "-o", str(out)])
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t_fit
        a_peak = torch.cuda.max_memory_allocated() - a_base
        a_counts = counts()
        other = (fused_fwd.launches, fused_train.launches_fwd, fused_train.launches_bwd)
        png = read_png(str(out))
    a_losses = [float(v) for v in re.findall(r"^\[fit\] step \d+ loss (\S+)$",
                                             printed.getvalue(), re.M)]
    require(a_counts == {"lol_march": fit_steps + 1},
            f"cli fit ({fit_steps} steps and -o) launched {a_counts}, not lol_march "
            f"{fit_steps + 1} times and nothing else")
    require(other == (0, 0, 0), f"cli fit launched a fused kernel: {other}")
    require(len(a_losses) == fit_steps and all(map(math.isfinite, a_losses)),
            f"cli fit printed losses {a_losses}")
    require(all(a > b for a, b in zip(a_losses, a_losses[1:])), f"the loss did not fall: {a_losses}")
    require(png.shape == (MAIN_H, MAIN_W, 3), f"fitted render {png.shape}")
    print(f"[19] main path A: cli fit scene4 {MAIN_W}x{MAIN_H} (AA, exact shadows, "
          f"{fit_steps} Adam steps on sphere_point, -o) -> {a_counts}; losses {a_losses}; "
          f"{t_fit:.1f} s with the -o render; peak {a_peak / 2**20:.0f} MiB allocated above the "
          f"{a_base / 2**20:.0f} MiB live before it")

    a_leaves = grad_leaves(s4.params)

    def step_a():
        ((render_image(st4, a_leaves, MAIN_H, MAIN_W, a_cfg) - target) ** 2).mean().backward()

    step_a()
    a_step_ms = time_ms(step_a, 1)

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

    # K3 and K4 at the main shape (path B's rays), held and timed
    ro, rd = camera_rays(s4.params, MAIN_H, MAIN_W, b_cfg)
    scene_b = mk.pack_march_scene(st4, s4.params)
    live = {"march": [], "shadow": []}
    k3 = mk.march_values(st4, b_cfg, ro, rd, scene_b)
    p3 = mk.march_values_reference(st4, b_cfg, ro, rd, scene_b, live["march"])
    torch.cuda.synchronize()
    err, _ = check_values(k3, p3, "lol_march 1080p")
    errs["lol_march"] = max(errs["lol_march"], err)
    t_sh = torch.where(k3.t < b_cfg.max_dist, k3.t, k3.t_close)
    so, ld, dist = shadow_rays(s4.params, ro, rd, t_sh, b_cfg)[0]
    k4 = mk.shadow_values(st4, b_cfg, so, ld, dist, scene_b)
    p4 = mk.shadow_values_reference(st4, b_cfg, so, ld, dist, scene_b, live["shadow"])
    torch.cuda.synchronize()
    err, _ = check_values(k4, p4, "lol_shadow_march 1080p light 0")
    errs["lol_shadow_march"] = max(errs["lol_shadow_march"], err)
    k3_ms = time_ms(lambda: mk.march_values(st4, b_cfg, ro, rd, scene_b), 10)
    k4_ms = time_ms(lambda: mk.shadow_values(st4, b_cfg, so, ld, dist, scene_b), 10)
    p3_ms = time_ms(lambda: mk.march_values_reference(st4, b_cfg, ro, rd, scene_b), 2)
    p4_ms = time_ms(lambda: mk.shadow_values_reference(st4, b_cfg, so, ld, dist, scene_b), 2)
    # Operation model (csrc/march.cuh over the generated Scene): per march
    # step E + 15 (the step and the closest-approach tracking), per shadow
    # step E + 17 (the penumbra value and its argmin), E = sdf_ops; bytes:
    # K3 reads 12 B and writes 16 B per ray, K4 reads 28 B and writes 8 B
    E, rays = sdf_ops(st4), MAIN_W * MAIN_H
    small = 4 * (3 + packed_size(st4))
    k3_bound = bound(small + 28 * rays, sum(live["march"]) * (E + 15), ceiling)
    k4_bound = bound(small + 36 * rays, sum(live["shadow"]) * (E + 17), ceiling)
    print(f"[20] scene4 AA {MAIN_W}x{MAIN_H} on {card}: path A step (exact) {a_step_ms:.1f} ms, "
          f"path B fwd+bwd (envelope) {b_step_ms:.1f} ms; lol_march {k3_ms:.4f} ms (plain "
          f"{p3_ms:.1f} ms, bound {k3_bound[0]:.4f} ms by {k3_bound[1]}, "
          f"{sum(live['march']) / rays:.1f} evaluations per ray), lol_shadow_march light 0 "
          f"{k4_ms:.4f} ms (plain {p4_ms:.1f} ms, bound {k4_bound[0]:.4f} ms by {k4_bound[1]}, "
          f"{sum(live['shadow']) / rays:.1f} evaluations per ray); max |diff| vs plain here "
          f"and in phase 18: lol_march {errs['lol_march']:.3g}, lol_shadow_march "
          f"{errs['lol_shadow_march']:.3g}")
    del a_leaves, b_leaves, k_leaves, img_b, k3, p3, k4, p4

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

    march_profile = run_profile("--profile-march").split(" || ")
    print(f"[21] torch.profiler (`chip_smoke.py --profile-march`) over one path B step: "
          f"{march_profile[0]}")
    print(f"[21] torch.profiler over one round of the four march kernels (K3, K4 light 0 at "
          f"path B's rays; the instanced pair on the middle band): {march_profile[1]}")
    print(f"[21] one path B step in a process of its own, under the allocator's history: "
          f"{march_profile[2]}")
    print(f"[21] torch.profiler over path C's band body on the middle band (no autograd): "
          f"{march_profile[3]}")

    return [
        entry("lol_march", "loltracer_tpu_torch/csrc/march.cuh",
              "loltracer_tpu/render/pallas_march.py:94", a_counts["lol_march"], errs["lol_march"],
              k3_ms, p3_ms, k3_bound),
        entry("lol_shadow_march", "loltracer_tpu_torch/csrc/march.cuh",
              "loltracer_tpu/render/pallas_march.py:111", b_counts["lol_shadow_march"],
              errs["lol_shadow_march"],
              k4_ms, p4_ms, k4_bound),
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
    ]


def peak_phase(dev, card, peak_built):
    """Phase 25, run right after the builds, before any bound: path E, `cli
    peak` at full size (its record into a temporary file), the measured
    FMA rate within PEAK_LOW..PEAK_HIGH of the modelled ceiling 132 SMs x
    128 lanes x 2 flops x the card's maximum SM clock, the chain kernels
    bitwise the plain chains on the full lane count at 8 iterations, and
    the device time of one full-size call of each chain. Returns the K8
    `kernels` entries and the ceiling every bound divides by (FP32
    operations per ms): the modelled one, which the measured rate
    confirms."""
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
    ], ceiling


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
    # instanced structures (one text for every sphere count)
    march_libs = [(scenes[n].structure, RenderConfig()) for n in SCENES] + [
        (inst[10_000].structure, c) for c in (clamp2, RenderConfig(),
                                              RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0))]
    eval_clamps = (2.0, None, 8.0)  # K7 (phase 26): the one source per step clamp
    pool = ThreadPoolExecutor(max_workers=len(cases) + len(train_cases) + 2 * len(inst_cfgs)
                              + len(inst_train_cfgs) + len(march_libs) + len(eval_clamps) + 1)
    peak_built = pool.submit(peak.library)
    eval_built = [pool.submit(march_kernels.eval_library, inst[10_000].structure,
                              RenderConfig(step_clamp=c)) for c in eval_clamps]
    regroup_built = [pool.submit(regroup.library, c, inst[10_000].structure) for c in inst_cfgs]
    march_built = [pool.submit(march_kernels.library, st, c) for st, c in march_libs]
    inst_train_built = [pool.submit(instanced_train.library, c, inst[10_000].structure)
                        for c in inst_train_cfgs]
    train_built = [pool.submit(fused_train.library, scenes[n].structure, c)
                   for n, c in train_cases]
    inst_built = [pool.submit(instanced_fwd.library, c, inst[10_000].structure)
                  for c in inst_cfgs]
    built = [f.result() for f in
             [pool.submit(fused_fwd.library, scenes[n].structure, c) for n, c in cases]]
    build_s = time.perf_counter() - t0
    regs = [l.split(":", 1)[-1].strip() for l in built[3].log.splitlines()
            if "registers" in l or "spill" in l]
    print(f"[1] build: {len(built)} kernels ({len(SCENES)} structures + AA + custom "
          f"config) in {build_s:.1f} s; scene4 ptxas: {' | '.join(regs)}")

    # --- 25. path E: cli peak, the measured ceiling (before any bound) --------------
    peak_entries, ceiling = peak_phase(dev, card, peak_built)

    # --- 2. kernel vs plain version on the card ------------------------------
    h, w = 97, 161
    for name, cfg in cases:
        s = scenes[name]
        cam = camera_pack(s.params, h, w, cfg)
        fields = pack_fields(s.structure, s.params)
        k_img = fused_fwd.fused_forward(s.structure, cfg, cam, fields, h, w)
        p_img = fused_fwd.fused_forward_reference(s.structure, cfg, cam, fields, h, w)
        torch.cuda.synchronize()
        err, over = compare(k_img, p_img, f"{name} antialias={cfg.antialias} max_steps={cfg.max_steps}")
        tag = ("aa" if cfg.antialias else
               "custom" if cfg.max_steps != RenderConfig().max_steps else "default")
        print(f"[2] {name} {tag} {h}x{w}: max |diff| {err:.3g}, {over} px over {ATOL}")

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
    print(f"[3] main path: cli render scene4 {MAIN_W}x{MAIN_H} -> {main_launches} "
          f"launch(es); PNG = kernel image; vs plain: max |diff| {main_err:.3g}, "
          f"{main_over} px over {ATOL}")

    # --- 4. frame times ------------------------------------------------------
    def kernel():
        fused_fwd.fused_forward(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)

    def plain():
        fused_fwd.fused_forward_reference(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)

    for _ in range(3):
        kernel()
    k_ms = time_ms(kernel, 10)
    plain()
    p_ms = time_ms(plain, 1)
    rays = MAIN_W * MAIN_H
    print(f"[4] scene4 {MAIN_W}x{MAIN_H} on {card}: kernel {k_ms:.3f} ms/frame "
          f"({rays / k_ms / 1e3:.1f} M rays/s), plain {p_ms:.1f} ms/frame "
          f"({rays / p_ms / 1e3:.2f} M rays/s), kernel {p_ms / k_ms:.0f}x faster")

    # --- 5. build the training kernels ------------------------------------------
    train_built = [f.result() for f in train_built]
    train_s = time.perf_counter() - t0
    print(f"[5] build: {len(train_built)} training libraries (4 structures + scene4 AA) "
          f"done {train_s:.1f} s after the builds started; scene4 ptxas: "
          + " | ".join(ptxas_lines(train_built[3].log)))

    # --- 6. lol_train_fwd vs lol_render_fused and the plain version -------------
    residuals = {}
    for name, c in train_cases:
        s = scenes[name]
        cam = camera_pack(s.params, h, w, c)
        fields = pack_fields(s.structure, s.params)
        k_img, k_res = fused_train.train_forward(s.structure, c, cam, fields, h, w)
        f_img = fused_fwd.fused_forward(s.structure, c, cam, fields, h, w)
        p_img, p_res = fused_train.train_forward_reference(s.structure, c, cam, fields, h, w)
        torch.cuda.synchronize()
        what = f"{name} antialias={c.antialias}"
        require(torch.equal(k_img, f_img), f"{what}: lol_train_fwd image != lol_render_fused's")
        err, over = compare(k_img, p_img, what)
        res_over = check_residuals(k_res, p_res, what)
        residuals[(name, c.antialias)] = (cam, fields, k_res)
        print(f"[6] {what} {h}x{w}: image = lol_render_fused bitwise; vs plain max |diff| "
              f"{err:.3g}, {over} px over {ATOL}; residual planes: {res_over}")

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
    f_img4 = fused_fwd.fused_forward(s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W)
    live_aa = {"march": [], "shadow": []}
    p_img4, p_res4 = fused_train.train_forward_reference(
        s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W, live=live_aa)
    torch.cuda.synchronize()
    what = f"scene4 AA {MAIN_W}x{MAIN_H}"
    require(tuple(img4.shape) == (MAIN_H, MAIN_W, 3), f"{what}: image shape {tuple(img4.shape)}")
    require(torch.equal(img4, f_img4), f"{what}: lol_train_fwd image != lol_render_fused's")
    fwd_err, over = compare(img4, p_img4, what)
    res_over = check_residuals(res4, p_res4, what)
    del f_img4, p_img4, p_res4
    print(f"[7] lol_train_fwd {what}: image = lol_render_fused bitwise; vs plain max |diff| "
          f"{fwd_err:.3g}, {over} px over {ATOL}; residual planes: {res_over}")
    worst, bwd_err, cam_err, ct4 = check_bwd(s4, c_aa, cam4, fields4, res4, MAIN_H, MAIN_W,
                                             "scene4 AA 1920x1080")
    print(f"[7] scene4 AA {MAIN_W}x{MAIN_H}: fields max |diff| / max|grad| {worst:.3g}, "
          f"max |diff| {bwd_err:.3g}, "
          f"dcam max |diff| {cam_err:.3g}; two launches bitwise equal")

    # --- 8. the training path ------------------------------------------------------
    gen = np.random.default_rng(0)
    moved = s4.params.sphere_point + torch.from_numpy(
        gen.uniform(-0.1, 0.1, tuple(s4.params.sphere_point.shape)).astype(np.float32)).to(dev)
    target = make_cuda_renderer(s4.structure, MAIN_H, MAIN_W, c_aa, device=dev)(
        dataclasses.replace(s4.params, sphere_point=moved))
    fused_fwd.launches = fused_train.launches_fwd = fused_train.launches_bwd = 0
    fit = fit_scene(s4.structure, s4.params, target, steps=5, learning_rate=3e-2,
                    trainable=("sphere_point",), cfg=c_aa, device=dev)
    fwd_launches, bwd_launches = fused_train.launches_fwd, fused_train.launches_bwd
    require(fwd_launches > 0 and bwd_launches > 0,
            f"fit_scene launched lol_train_fwd {fwd_launches}, lol_train_bwd {bwd_launches} times")
    losses = [float(v) for v in fit.losses]
    require(all(map(math.isfinite, losses)), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    print(f"[8] main path: fit_scene scene4 AA {MAIN_W}x{MAIN_H}, 5 Adam steps on "
          f"sphere_point -> lol_train_fwd x{fwd_launches}, lol_train_bwd x{bwd_launches}; "
          f"losses {losses}")

    render = fused_train.make_training_renderer(s4.structure, MAIN_H, MAIN_W, c_aa, device=dev)
    leaves = dataclasses.replace(
        s4.params, sphere_point=s4.params.sphere_point.clone().requires_grad_(True))

    def step():
        loss = ((render(leaves) - target) ** 2).mean()
        loss.backward()

    def k1r():
        fused_train.train_forward(s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W)

    def k2():
        fused_train.train_backward(s4.structure, c_aa, cam4, fields4, res4, ct4)

    def plain_fwd():
        fused_train.train_forward_reference(s4.structure, c_aa, cam4, fields4, MAIN_H, MAIN_W)

    def plain_bwd():
        fused_train.train_backward_reference(s4.structure, c_aa, cam4, fields4, res4, ct4)

    for _ in range(3):
        step(), k1r(), k2()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(step, 10)
    peak = torch.cuda.max_memory_allocated()
    k1r_ms, k2_ms = time_ms(k1r, 10), time_ms(k2, 10)
    plain_fwd()
    pf_ms = time_ms(plain_fwd, 1)
    plain_bwd()
    pb_ms = time_ms(plain_bwd, 1)
    breakdown = profile_steps(step, 5)
    print(f"[8] scene4 AA {MAIN_W}x{MAIN_H} on {card}: fwd+bwd step {step_ms:.3f} ms "
          f"(peak {peak / 2**20:.0f} MiB allocated); lol_train_fwd {k1r_ms:.3f} ms, "
          f"lol_train_bwd {k2_ms:.3f} ms; plain fwd {pf_ms:.1f} ms, plain bwd {pb_ms:.1f} ms")
    print(f"[8] torch.profiler over 5 steps: {breakdown}")

    # --- bounds from this run's data ------------------------------------------------
    st = s4.structure
    ops_eval = sdf_ops(st)
    L, px4 = st.num_lights, MAIN_H * MAIN_W
    small_bytes = 4 * (16 + packed_size(st))
    cam_main = camera_pack(s4.params, MAIN_H, MAIN_W, cfg)  # phase 3's config
    live_main = {"march": [], "shadow": []}
    fused_train.train_forward_reference(st, cfg, cam_main, fields4, MAIN_H, MAIN_W,
                                        live=live_main)
    m_fwd, sh_fwd = sum(live_main["march"]), sum(live_main["shadow"])
    m_aa, sh_aa = sum(live_aa["march"]), sum(live_aa["shadow"])
    # Operation model, counted on csrc/fused_fwd.cuh and csrc/fused_bwd.cuh
    # around E = sdf_ops per evaluation: per ray the camera ray 33, per
    # march step E + 9 (+ 6 with AA), per shadow step E + 15 (+ 2 for t*),
    # 4 normal taps E + 12 each and their normalize 10, the material
    # lookup E + 10, Phong 70 per light, the output 30; the IFT denominator
    # one SDF adjoint (3 E: its forward and reverse) + 15.
    E, aa = ops_eval, 6

    def fwd_ops(march, shadow, with_aa, residuals):
        per_ray = 33 + 4 * (E + 12) + 10 + (E + 10) + 70 * L + 30
        if residuals:
            per_ray += 3 * E + 15
        return (march * (E + 9 + (aa if with_aa else 0))
                + shadow * (E + 15 + (2 if residuals else 0)) + px4 * per_ray)

    k1_bound = bound(small_bytes + 12 * px4, fwd_ops(m_fwd, sh_fwd, False, False), ceiling)
    n_res = fused_train.num_residuals(st)
    k1r_bound = bound(small_bytes + (12 + 4 * n_res) * px4, fwd_ops(m_aa, sh_aa, True, True), ceiling)
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
    print(f"[8] bounds: SDF evaluation {ops_eval} ops; scene4 march {m_fwd / px4:.1f} + "
          f"shadow {sh_fwd / px4:.1f} evaluations per ray (AA: {m_aa / px4:.1f} + "
          f"{sh_aa / px4:.1f}); lol_render_fused {k1_bound[0]:.4f} ms, lol_train_fwd "
          f"{k1r_bound[0]:.4f} ms, lol_train_bwd {k2_bound[0]:.4f} ms, all by "
          f"{k1_bound[1]} / {k1r_bound[1]} / {k2_bound[1]}")

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
    inst_err, band_ms = 0.0, None
    for name, r0 in bands.items():
        bcam = camera_pack(big.params, MAIN_H, MAIN_W, clamp2, row0=r0)
        t_band = time.perf_counter()
        p_band = instanced_fwd.instanced_forward_reference(
            big.structure, clamp2, bcam, fields, tab, BAND, MAIN_W, MAIN_H, live=live_inst)
        torch.cuda.synchronize()
        t_band = (time.perf_counter() - t_band) * 1e3
        k_band = instanced_fwd.instanced_forward(big.structure, clamp2, bcam, fields, tab,
                                                 BAND, MAIN_W, MAIN_H)
        torch.cuda.synchronize()
        require(torch.equal(k_band, k_img[r0:r0 + BAND]),
                f"{name} band: the kernel's band launch differs from its frame's rows")
        err, over = compare(k_img[r0:r0 + BAND], p_band, f"instanced:10000 {name} band")
        inst_err = max(inst_err, err)
        print(f"[11] {name} band (rows {r0}-{r0 + BAND - 1}): max |diff| {err:.3g}, {over} px "
              f"over {ATOL}; plain {t_band:.0f} ms with counting")
    band_px = BAND * MAIN_W * len(bands)
    m_inst, sh_inst = sum(live_inst["march"]), sum(live_inst["shadow"])
    evals = m_inst + sh_inst
    print(f"[11] main path: cli render instanced:10000 --step-clamp 2 {MAIN_W}x{MAIN_H} -> "
          f"{inst_launches} launch; PNG = kernel image; bands: march {m_inst / band_px:.1f} + "
          f"shadow {sh_inst / band_px:.1f} SDF evaluations per ray, "
          f"{near_total[0] / evals:.1f} spheres within the cut per evaluation, "
          f"{runs_total[0] / evals:.1f} runs of {GROUP} whose ball reaches within it")

    # --- 12. frame times -----------------------------------------------------------
    def inst_kernel():
        instanced_fwd.instanced_forward(big.structure, clamp2, cam, fields, tab, MAIN_H, MAIN_W)

    cam_uhd, fields_uhd, tab_uhd = inst_inputs(big, clamp2, UHD_H, UHD_W)

    def inst_kernel_uhd():
        instanced_fwd.instanced_forward(big.structure, clamp2, cam_uhd, fields_uhd, tab_uhd,
                                        UHD_H, UHD_W)

    bcam = camera_pack(big.params, MAIN_H, MAIN_W, clamp2, row0=bands["middle"])

    def inst_plain_band():
        instanced_fwd.instanced_forward_reference(big.structure, clamp2, bcam, fields, tab,
                                                  BAND, MAIN_W, MAIN_H)

    def inst_walk():
        instanced_fwd.instanced_forward(big.structure, clamp2, cam, fields, tab, MAIN_H, MAIN_W,
                                        walk=True)

    def inst_walk_uhd():
        instanced_fwd.instanced_forward(big.structure, clamp2, cam_uhd, fields_uhd, tab_uhd,
                                        UHD_H, UHD_W, walk=True)

    def grid_build():
        grid_for(tab, 2.0)

    inst_kernel(), inst_kernel_uhd(), inst_walk()
    # parent-style turns: walk, grid, grid, walk (one card, one call)
    walk_ms = [time_ms(inst_walk, 2)]
    inst_ms = time_ms(inst_kernel, 3)
    uhd_ms = time_ms(inst_kernel_uhd, 2)
    walk_ms.append(time_ms(inst_walk, 2))
    walk_uhd_ms = time_ms(inst_walk_uhd, 1)
    build_ms = time_ms(grid_build, 5)
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
    inst_plain_ms = time_ms(inst_plain_band, 1)
    inst_profile = run_profile("--profile-instanced")
    print(f"[12] instanced:10000 clamp 2 on {card}: kernel (cell grid) {inst_ms:.3f} ms/frame "
          f"at {MAIN_W}x{MAIN_H} ({MAIN_W * MAIN_H / inst_ms / 1e3:.3f} M rays/s; the grid "
          f"build {build_ms:.3f} ms of it), {uhd_ms:.3f} ms/frame at {UHD_W}x{UHD_H} "
          f"({UHD_W * UHD_H / uhd_ms / 1e3:.3f} M rays/s); the run walk {walk_ms[0]:.3f} / "
          f"{walk_ms[1]:.3f} ms at {MAIN_W}x{MAIN_H} (before / after), {walk_uhd_ms:.3f} ms "
          f"at {UHD_W}x{UHD_H}; the 1080p image bitwise the walk's; plain "
          f"{inst_plain_ms:.1f} ms for one {BAND}-row band")
    print("[12] grid searches at 1080p (the counting twin, its image bitwise the kernel's): "
          + "; ".join(f"{k}: {v[2]:.1f} searches a pixel, {v[0]:.4%} fell back to the walk, "
                      f"{v[1]:.2f} list entries read a search" for k, v in inst_stats.items()))
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
    it_fit = fit_scene(st10, big.params, it_target, steps=fit_steps, learning_rate=1e-2,
                       trainable=("sphere_point",), cfg=clamp2_env, device=dev)
    it_fwd_launches, it_bwd_launches = instanced_train.launches_fwd, instanced_train.launches_bwd
    it_builds = cell_grid.builds
    require(it_fwd_launches == fit_steps and it_bwd_launches == fit_steps
            and it_builds == fit_steps,
            f"fit_scene ({fit_steps} steps) launched lol_instanced_fwd {it_fwd_launches}, "
            f"lol_instanced_bwd {it_bwd_launches} times and built {it_builds} cell grids")
    it_losses = [float(v) for v in it_fit.losses]
    require(all(map(math.isfinite, it_losses)), f"non-finite loss: {it_losses}")
    require(it_losses[-1] < it_losses[0], f"the loss did not fall: {it_losses}")
    print(f"[15] main path: fit_scene instanced:10000 clamp 2 envelope {MAIN_W}x{MAIN_H}, "
          f"{fit_steps} Adam steps on sphere_point -> lol_instanced_fwd x{it_fwd_launches}, "
          f"lol_instanced_bwd x{it_bwd_launches}, {it_builds} cell grids built (one a step, "
          f"searched by both); losses {it_losses}")

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

    # --- 16. the instanced training step: times, memory, bounds ----------------------
    it_render = instanced_train.make_instanced_training_renderer(st10, MAIN_H, MAIN_W,
                                                                 clamp2_env, device=dev)
    it_leaves = dataclasses.replace(
        big.params, sphere_point=big.params.sphere_point.clone().requires_grad_(True))

    def it_step():
        loss = ((it_render(it_leaves) - it_target) ** 2).mean()
        loss.backward()

    ct_it = torch.from_numpy(np.random.default_rng(0).uniform(
        -1e-3, 1e-3, (MAIN_H, MAIN_W, 3)).astype(np.float32)).to(dev)

    grid_it = grid_for(tab_it, 2.0)

    def k5r():
        instanced_train.instanced_train_forward(st10, clamp2_env, cam_it, fields_it, tab_it,
                                                MAIN_H, MAIN_W, grid=grid_it)

    def k6(walk=False):
        instanced_train.instanced_train_backward(st10, clamp2_env, cam_it, fields_it, tab_it,
                                                 res_it, ct_it, grid=grid_it, walk=walk)

    bcam = camera_pack(big.params, MAIN_H, MAIN_W, clamp2_env, row0=bands["middle"])
    _, bres = instanced_train.instanced_train_forward(st10, clamp2_env, bcam, fields_it, tab_it,
                                                      BAND, MAIN_W, MAIN_H)
    ct_band = ct_it[:BAND]

    def it_plain_fwd():
        instanced_train.instanced_train_forward_reference(
            st10, clamp2_env, bcam, fields_it, tab_it, BAND, MAIN_W, MAIN_H)

    def it_plain_bwd():
        instanced_train.instanced_train_backward_reference(
            st10, clamp2_env, bcam, fields_it, tab_it, bres, ct_band, MAIN_H)

    it_step(), k6(), k6(walk=True)
    torch.cuda.synchronize()
    cell_grid.builds = 0
    it_step()
    require(cell_grid.builds == 1, f"one training step built {cell_grid.builds} cell grids")
    torch.cuda.reset_peak_memory_stats()
    it_step_ms = time_ms(it_step, 3)
    it_peak = torch.cuda.max_memory_allocated()
    # turns: walk, grid, grid, walk (one card, one call)
    k6_walk_ms = [time_ms(lambda: k6(walk=True), 2)]
    k5r_ms, k6_ms = time_ms(k5r, 3), time_ms(k6, 3)
    k6_walk_ms.append(time_ms(lambda: k6(walk=True), 2))
    it_build_ms = time_ms(lambda: grid_for(tab_it, 2.0), 3)
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
    it_pf_ms, it_pb_ms = time_ms(it_plain_fwd, 1), time_ms(it_plain_bwd, 1)
    it_profile = run_profile("--profile-instanced-train")
    print(f"[16] instanced:10000 clamp 2 envelope {MAIN_W}x{MAIN_H} on {card}: fwd+bwd step "
          f"{it_step_ms:.3f} ms with one cell grid built (peak {it_peak / 2**20:.0f} MiB "
          f"allocated); over a built grid lol_instanced_fwd {k5r_ms:.3f} ms, lol_instanced_bwd "
          f"{k6_ms:.3f} ms (its walk twin {k6_walk_ms[0]:.3f} / {k6_walk_ms[1]:.3f} ms before / "
          f"after); the grid build {it_build_ms:.3f} ms; plain fwd {it_pf_ms:.1f} ms, plain bwd "
          f"{it_pb_ms:.1f} ms for one {BAND}-row band")
    print(f"[16] lol_instanced_bwd's grid searches (the counting twin, bitwise the kernel): "
          f"{k6_stats[2]:.2f} searches a pixel, {k6_stats[0]:.4%} fell back to the walk, "
          f"{k6_stats[1]:.2f} list entries read a search; records per sphere-table row: "
          f"max {int(row_recs.max())}, mean {float(row_recs.float().mean()):.1f} (the sum's "
          f"longest chain); ptxas (clamp 2): "
          + " | ".join(l for l in ptxas_lines(inst_train_built[0].log)
                       if "instanced_bwd" in l or "rec_" in l))
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
    k5r_bound = bound(inst_bytes + 4 * n_res_i * px_main, inst_ops + px_main * (e_inst + 15), ceiling)
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
                                 ceiling)
    regroup_entries = regroup_phases(dev, card, inst, inst_cfgs, regroup_built, t0, e_inst,
                                     m_inst / band_px, ceiling)
    objects_entry, hit_pts = objects_phases(dev, card, inst, eval_built, t0, ceiling)
    grid_phase(dev, card, inst, hit_pts)

    print(json.dumps({"kernels": [
        entry("lol_render_fused", "loltracer_tpu_torch/csrc/fused_fwd.cuh",
              "loltracer_tpu/render/pallas_train.py:346", main_launches, main_err,
              k_ms, p_ms, k1_bound),
        entry("lol_train_fwd", "loltracer_tpu_torch/csrc/fused_fwd.cuh",
              "loltracer_tpu/render/pallas_train.py:346", fwd_launches, fwd_err,
              k1r_ms, pf_ms, k1r_bound),
        entry("lol_train_bwd", "loltracer_tpu_torch/csrc/fused_bwd.cuh",
              "loltracer_tpu/render/pallas_train.py:469", bwd_launches, bwd_err,
              k2_ms, pb_ms, k2_bound),
        dict(entry("lol_instanced_render", "loltracer_tpu_torch/csrc/grid_scene.cuh",
                   "loltracer_tpu/render/pallas_train.py:840", inst_launches, inst_err,
                   inst_ms, inst_plain_ms, k5_bound),
             plain_ms_rows=BAND, uhd_ms=uhd_ms, walk_ms=walk_ms, walk_uhd_ms=walk_uhd_ms,
             grid_build_ms=build_ms, fallback_share={k: v[0] for k, v in inst_stats.items()}),
        dict(entry("lol_instanced_fwd", "loltracer_tpu_torch/csrc/grid_scene.cuh",
                   "loltracer_tpu/render/pallas_train.py:840", it_fwd_launches, it_fwd_err,
                   k5r_ms, it_pf_ms, k5r_bound),
             plain_ms_rows=BAND, step_ms=it_step_ms, grid_build_ms=it_build_ms),
        dict(entry("lol_instanced_bwd", "loltracer_tpu_torch/csrc/instanced_bwd.cuh",
                   "loltracer_tpu/render/pallas_train.py:1314", it_bwd_launches, it_bwd_err,
                   k6_ms, it_pb_ms, k6_bound),
             plain_ms_rows=BAND, walk_ms=k6_walk_ms, grid_build_ms=it_build_ms,
             fallback_share=k6_stats[0], entries_per_search=k6_stats[1]),
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
    if sys.argv[1:] == ["--profile-regroup"]:
        sys.exit(profile_regroup())
    if sys.argv[1:2] == ["--profile-peak"]:
        sys.exit(profile_peak(sys.argv[2:]))
    if sys.argv[1:] == ["--profile-objects"]:
        sys.exit(profile_objects())
    if sys.argv[1:2] == ["--objects-rank"]:
        sys.exit(objects_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    sys.exit(main())
