"""Readings that an instanced fitting cell's comparison limits are set from,
on the card (the cells of the `instanced_fit_jobs` kind, whose reference
goes through a cell grid of its own):

    python3 benchmark/calibrate_instanced_fit.py --workload <name> --seeds 1,2,... \
        [--controls 7,8,9] [--witness] [--out cal.jsonl]

For each of `--seeds`, one run of the cell (a short window) gives the
program's sound readings. For each of `--controls`, the gridded reference
put in the program's place gives the readings of the control (the gridded
reference in bfloat16, the precision below the configuration's float32)
and of the planted faults "half of the frame's rows left out, the mean
taken over the rest" and "the state left unchanged" (worked out from the
reference). With `--witness`, each control seed also holds the gridded
reference's first step against the brute force's (`reference/render.py`,
every sphere at every distance) on WITNESS_ROWS rows spread over the
frame: the loss, and each leaf's gradient gap over its norm ("witness").
Every reading is one JSON line; each reference's seconds are in it. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.harness import compare  # noqa: E402
from benchmark.harness.main import Cell, Context, run_cell  # noqa: E402
from benchmark.kinds import instanced_fit_jobs  # noqa: E402
from benchmark.kinds.fit_jobs import make_target  # noqa: E402
from benchmark.reference import fit as ref_fit  # noqa: E402
from benchmark.reference import instanced_grid  # noqa: E402
from benchmark.reference.render import Settings  # noqa: E402
from benchmark.scenes.data import FIELDS  # noqa: E402


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def controls(ctx, readings: dict) -> dict:
    """The control's and the faults' numbers against the float32 gridded
    reference on the cell's first job; `readings` gets each side and the
    seconds each reference took."""
    t = ctx.traffic
    leaves = [f for f in FIELDS if f in t["trainable"] and ctx.scene.arrays[f].size]
    ref, seconds = _timed(instanced_fit_jobs.reference, ctx, leaves)
    half = functools.partial(instanced_grid.frame_loss_and_grads, rows=range(t["height"] // 2))
    low, low_s = _timed(instanced_fit_jobs.reference, ctx, leaves, dtype=torch.bfloat16)
    sides = {"control": low, "half_rows": instanced_fit_jobs.reference(ctx, leaves, step_fn=half),
             "state_unchanged": {"losses": [ref["losses"][0]] * len(ref["losses"]),
                                 "grad1": dict(ref["grad1"]),
                                 "change": dict.fromkeys(ref["change"], 0.0)}}
    readings.update(sides, reference=ref, seconds={"reference": seconds, "control": low_s})
    return {what: compare.fit_numbers(side, ref) for what, side in sides.items()}


WITNESS_ROWS = 24
# the brute force's band: its autograd keeps [4 x rays, 2048] per sphere
# chunk at each normal's taps, ~10 GB at four 1920-pixel rows
WITNESS_BAND = 4


def witness(ctx) -> dict:
    """The gridded reference's first step against the brute force's on
    WITNESS_ROWS rows spread over the frame."""
    t = ctx.traffic
    H, W = t["height"], t["width"]
    leaves = [f for f in FIELDS if f in t["trainable"] and ctx.scene.arrays[f].size]
    s = Settings(**dict(ctx.config["render"], antialias=t["antialias"],
                        shadow_grad=t["shadow_grad"]))
    target = make_target(ctx.seed, 0, H, W, t["target_grid"], ctx.device)
    rows = list(range(0, H, max(1, H // WITNESS_ROWS)))[:WITNESS_ROWS]
    out = {}
    for what, fn in (("brute", ref_fit.frame_loss_and_grads),
                     ("grid", instanced_grid.frame_loss_and_grads)):
        P = {k: torch.tensor(v, device=ctx.device) for k, v in ctx.scene.arrays.items()}
        for f in leaves:
            P[f].requires_grad_(True)
        out[what], out[what + "_s"] = _timed(fn, ctx.scene.structure, P, leaves, target, s,
                                             WITNESS_BAND, rows=rows)
    (lb, gb), (lg, gg) = out["brute"], out["grid"]
    gaps = {f: float((gg[f].double() - gb[f].double()).norm() / max(gb[f].double().norm(), 1e-30))
            for f in leaves}
    return {"rows": rows, "loss": [lb, lg], "loss_bitwise": lb == lg,
            "grad_bitwise": [f for f in leaves if torch.equal(gg[f], gb[f])], "grad_gap": gaps,
            "seconds": {"brute": out["brute_s"], "grid": out["grid_s"]}}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--witness", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    out = open(args.out, "a") if args.out else None

    def emit(line: dict) -> None:
        s = json.dumps(line)
        print(s, flush=True)
        if out:
            out.write(s + "\n")
            out.flush()

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        r = run_cell(root, args.workload, seed, args.seconds, False, "cuda:0", t0,
                     readings=True)
        emit({"workload": args.workload, "seed": seed, "what": "program",
              "checks": r["checks"], "correct": r["correct"], "attempted": r["attempted"],
              "readings": r["readings"], "seconds": time.perf_counter() - t0})
    cell = Cell(root, args.workload)
    for seed in [int(s) for s in args.controls.split(",") if s]:
        t0 = time.perf_counter()
        ctx = Context(cell, seed, args.seconds, False, "cuda:0", t0)
        sides = {}
        for what, numbers in controls(ctx, sides).items():
            emit({"workload": args.workload, "seed": seed, "what": what, "numbers": numbers,
                  "readings": sides.get(what), "reference": sides["reference"],
                  "reference_s": sides["seconds"], "seconds": time.perf_counter() - t0})
        if args.witness:
            emit({"workload": args.workload, "seed": seed, "what": "witness",
                  **witness(ctx), "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
