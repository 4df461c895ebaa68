"""Closed-loop fitting jobs of an instanced scene: fit_jobs' jobs (one
client submits a job of `steps` Adam steps through `opt.fit_scene`, waits
for it and submits the next; set-up warms the shapes with a short job; the
job in flight at the close runs to its end and counts), with two changes:

- the reference follows the checked job's first steps through a cell grid
  of its own (`reference/instanced_grid.py`), as a brute force over every
  sphere at each distance cannot follow a 1920x1080 step;
- a traced run's record also holds the program's spans and counters over
  the profiler session's sub-window (`harness/spans.py`), bounded by the
  same optimizer hooks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, port
from benchmark.harness.spans import Window
from benchmark.harness.trace import Session
from benchmark.kinds.fit_jobs import ADAM_BETA1, _StepHooks, make_target
from benchmark.reference import fit as ref_fit
from benchmark.reference import instanced_grid
from benchmark.reference.render import Settings
from benchmark.scenes.data import FIELDS


def reference(ctx, leaves, dtype=torch.float32, step_fn=instanced_grid.frame_loss_and_grads
              ) -> dict:
    """The reference's first `check_steps` steps of the cell's first job."""
    t = ctx.traffic
    settings = Settings(**dict(ctx.config["render"], antialias=t["antialias"],
                               shadow_grad=t["shadow_grad"]))
    target = make_target(ctx.seed, 0, t["height"], t["width"], t["target_grid"], ctx.device)
    return ref_fit.follow(ctx.scene.structure, ctx.scene.arrays, leaves, target, settings,
                          t["lr"], t["check_steps"], ctx.device, dtype=dtype,
                          band_rows=t["reference_band_rows"], step_fn=step_fn)


def run(ctx) -> dict:
    t = ctx.traffic
    H, W = t["height"], t["width"]
    settings = dict(ctx.config["render"], antialias=t["antialias"], shadow_grad=t["shadow_grad"])
    trainable = [f for f in FIELDS if f in t["trainable"]]
    leaves = [f for f in trainable if ctx.scene.arrays[f].size]
    device = ctx.device

    cfg = port.render_config(settings)
    structure, params = port.scene(ctx.scene, device)
    port.start_world(device)
    try:
        warm = make_target(ctx.seed, -1, H, W, t["target_grid"], device)
        port.fit(structure, params, warm, t["warm_steps"], t["lr"], trainable, cfg, device)
        setup_s = ctx.ready()

        # the checked job's readings, taken by its optimizer's hooks
        got = {}

        def first_grad(opt):
            got["grad1"] = {f: float((opt.state[p]["exp_avg"].double() / (1 - ADAM_BETA1)).norm())
                            if "exp_avg" in opt.state.get(p, {}) else 0.0
                            for f, p in zip(trainable, opt.param_groups[0]["params"])}

        def after(opt):
            got["after"] = {f: p.detach().double().clone()
                            for f, p in zip(trainable, opt.param_groups[0]["params"])}

        session = Session(device) if ctx.trace else None
        window = Window() if ctx.trace else None
        k0, k = t["trace_from"], t["trace_steps"]

        def open_window(_):
            session.start()
            window.start()

        def close_window(_):
            got["spans"] = window.stop(k)
            session.stop()

        losses0, failed, steps, jobs, durations = None, 0, 0, 0, []
        counts = port.launch_counts()
        t0 = time.perf_counter()
        deadline, t_end = t0 + ctx.seconds, t0
        while t_end < deadline:
            target = make_target(ctx.seed, jobs, H, W, t["target_grid"], device)
            hooks = None
            if jobs == 0:
                at = [(2, first_grad), (t["check_steps"] + 1, after)]
                if session is not None:
                    at += [(k0, open_window), (k0 + k, close_window)]
                hooks = _StepHooks(at)
            try:
                losses, _ = port.fit(structure, params, target, t["steps"], t["lr"], trainable,
                                     cfg, device)
            finally:
                if hooks is not None:
                    hooks.remove()
            now = time.perf_counter()
            durations.append(now - t_end)
            t_end = now
            if jobs == 0:
                losses0 = [float(v) for v in losses]
            failed += int(not np.all(np.isfinite(losses)))
            steps += len(losses)
            jobs += 1
        launches = port.launches_since(counts, device)
        memory = ctx.memory_peak()
        trace = session.summary(k) if session is not None and session.prof is not None else None
        del params
        ctx.free()

        start = {f: torch.as_tensor(ctx.scene.arrays[f]).to(device).double() for f in leaves}
        prog = {"losses": losses0, "grad1": {f: got["grad1"][f] for f in leaves},
                "change": {f: float((got["after"][f] - start[f]).norm()) for f in leaves},
                "moves": {f: (got["after"][f] - start[f]).flatten().tolist() for f in leaves}}
        t_ref = time.perf_counter()
        ref = reference(ctx, leaves)
        ref_s = time.perf_counter() - t_ref
        numbers = compare.fit_numbers(prog, ref)
    finally:
        port.stop_world()
    return {
        "unit": "step",
        "setup_s": setup_s,
        "attempted": jobs,
        "failed": failed,
        "window": {"rays": H * W * steps, "seconds": t_end - t0, "jobs": jobs, "steps": steps,
                   "durations_s": durations},
        "launches": launches,
        "trace": trace,
        "spans": got.get("spans"),
        "memory_peak_bytes": memory,
        "numbers": numbers,
        "readings": {"program": prog, "reference": ref, "reference_s": ref_s},
    }
