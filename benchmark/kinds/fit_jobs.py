"""Closed-loop fitting jobs: one client submits a job of `steps` Adam steps
through `opt.fit_scene`, from the configuration's parameters toward a
target image made from the seed, waits for it, and submits the next.

Set-up starts a world of one rank (every job reuses it) and warms the
cell's shapes with a short job. The window runs jobs until `seconds` have
passed; the job in flight at the close runs to its end and counts.

The first job of the window is the one checked: optimizer hooks read its
first gradient (from Adam's state after one step) and its parameters as
step `check_steps + 1` finds them, and the reference follows the same
first steps once the window has closed. In a traced run, its steps
[trace_from, trace_from + trace_steps) run under one profiler session,
bounded by the same hooks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, port
from benchmark.harness.trace import Session
from benchmark.reference import fit as ref_fit
from benchmark.reference.render import Settings
from benchmark.scenes.data import FIELDS

ADAM_BETA1 = 0.9  # torch.optim.Adam's default, which fit_scene takes


def make_target(seed: int, job: int, height: int, width: int, grid, device) -> torch.Tensor:
    """A smooth target image [H, W, 3] in [0.05, 0.6]: a coarse grid of
    uniform draws (a generator on the device, seeded by the run's seed and
    the job) bilinearly upsampled to the frame."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + job) % (1 << 63))
    coarse = torch.rand((1, 3, grid[0], grid[1]), generator=g, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(height, width), mode="bilinear",
                                          align_corners=False)
    return (0.05 + 0.55 * img)[0].permute(1, 2, 0).contiguous()


class _StepHooks:
    """Optimizer pre-step hooks over one job: each (n, fn) of `at` calls
    fn(optimizer) before the n-th update (1-based), in the order given."""

    def __init__(self, at):
        from torch.optim.optimizer import register_optimizer_step_pre_hook

        self.at, self.n = at, 0
        self.handle = register_optimizer_step_pre_hook(self)

    def __call__(self, optimizer, args, kwargs):
        self.n += 1
        for n, fn in self.at:
            if n == self.n:
                fn(optimizer)

    def remove(self):
        self.handle.remove()


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
            # a leaf without a gradient has no state: its gradient was none
            got["grad1"] = {f: float((opt.state[p]["exp_avg"].double() / (1 - ADAM_BETA1)).norm())
                            if "exp_avg" in opt.state.get(p, {}) else 0.0
                            for f, p in zip(trainable, opt.param_groups[0]["params"])}

        def after(opt):
            got["after"] = {f: p.detach().double().clone()
                            for f, p in zip(trainable, opt.param_groups[0]["params"])}

        session = Session(device) if ctx.trace else None
        k0, k = t["trace_from"], t["trace_steps"]
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
                    at += [(k0, lambda _: session.start()), (k0 + k, lambda _: session.stop())]
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
        ref = ref_fit.follow(ctx.scene.structure, ctx.scene.arrays, leaves,
                             make_target(ctx.seed, 0, H, W, t["target_grid"], device),
                             Settings(**settings), t["lr"], t["check_steps"], device,
                             band_rows=t["reference_band_rows"])
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
        "memory_peak_bytes": memory,
        "numbers": numbers,
        "readings": {"program": prog, "reference": ref},
    }
