"""Closed-loop forward frames for one viewer: each frame moves the camera by
that frame's keys (the viewer's move rule), submits it to the renderer
built once at the cell's size, and ends when its image is on the host;
then the next frame is submitted.

The keys repeat in cycles of `cycle` frames that press every key equally
often, ordered by the seed, each cycle starting from the scene's camera.
After the window, `check_frames` frames drawn from the seed among those
completed are compared with the reference on `check_pixels` pixels drawn
from the seed (the same pixels of every frame, kept from each frame's host
image as it arrives). In a traced run, frames [trace_from, trace_from +
trace_frames) run under one profiler session.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, port, viewer
from benchmark.harness.trace import Session
from benchmark.reference.render import Settings, render_pixels


def pixel_sample(seed: int, height: int, width: int, n: int):
    """(ys, xs) of n distinct pixels drawn from the seed."""
    flat = np.random.default_rng(seed).choice(height * width, size=n, replace=False)
    return flat // width, flat % width


def reference_pixels(ctx, settings, cams, ys, xs, height, width, dtype=torch.float32):
    """The reference's pixels [N, 3] of each camera (point, direction)."""
    P = {k: torch.as_tensor(v).to(device=ctx.device, dtype=dtype)
         for k, v in ctx.scene.arrays.items()}
    yy = torch.as_tensor(ys, device=ctx.device)
    xx = torch.as_tensor(xs, device=ctx.device)
    out = []
    with torch.no_grad():
        for point, direction in cams:
            P["cam_point"] = torch.as_tensor(point).to(device=ctx.device, dtype=dtype)
            P["cam_direction"] = torch.as_tensor(direction).to(device=ctx.device, dtype=dtype)
            px = render_pixels(ctx.scene.structure, P, yy, xx, height, width, Settings(**settings))
            out.append(px.float().cpu().numpy())
    return out


def run(ctx) -> dict:
    t = ctx.traffic
    H, W = t["height"], t["width"]
    settings = dict(ctx.config["render"], antialias=t["antialias"], shadow_grad="envelope")
    device = ctx.device
    arrays = ctx.scene.arrays
    path = viewer.camera_path(arrays["cam_point"], arrays["cam_direction"],
                              viewer.key_cycle(ctx.seed, t["cycle"], t["turn_every"]))
    ys, xs = pixel_sample(ctx.seed, H, W, t["check_pixels"])

    structure, params = port.scene(ctx.scene, device)
    renderer = port.frame_renderer(structure, H, W, port.render_config(settings), device)
    for point, direction in path[:t["warm_frames"]]:
        renderer(port.with_camera(params, point, direction)).cpu()
    setup_s = ctx.ready()

    session = Session(device) if ctx.trace else None
    f0, k = t["trace_from"], t["trace_frames"]
    latencies, pixels, failed = [], [], 0
    counts = port.launch_counts()
    t0 = time.perf_counter()
    deadline, t_end, i = t0 + ctx.seconds, t0, 0
    while t_end < deadline:
        if session is not None and i == f0:
            session.start()
        point, direction = path[i % len(path)]
        t_sub = time.perf_counter()
        img = renderer(port.with_camera(params, point, direction)).cpu().numpy()
        t_end = time.perf_counter()
        if session is not None and i == f0 + k - 1:
            session.stop()
        latencies.append(t_end - t_sub)
        px = img[ys, xs]
        failed += int(not np.all(np.isfinite(px)))
        pixels.append(px)
        del img
        i += 1
    launches = port.launches_since(counts, device)
    memory = ctx.memory_peak()
    trace = session.summary(k) if session is not None and session.prof is not None else None
    del renderer, params
    ctx.free()

    rng = np.random.default_rng(ctx.seed)
    checked = sorted(rng.choice(i, size=min(t["check_frames"], i), replace=False).tolist())
    ref = reference_pixels(ctx, settings, [path[j % len(path)] for j in checked], ys, xs, H, W)
    numbers = compare.frame_numbers([pixels[j] for j in checked], ref)
    return {
        "unit": "frame",
        "setup_s": setup_s,
        "attempted": i,
        "failed": failed,
        "window": {"rays": H * W * i, "seconds": t_end - t0, "frames": i,
                   "latencies_s": latencies, "durations_s": latencies},
        "launches": launches,
        "trace": trace,
        "memory_peak_bytes": memory,
        "numbers": numbers,
        "readings": {"checked_frames": checked},
    }
