"""Readings that a cell's comparison limits are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--controls 7,8,9] [--witness] [--seconds 2] [--out chiprun_out/cal.jsonl]

For each of `--seeds`, one run of the cell (a short window) gives the
program's sound readings. For each of `--controls`, the reference put in
the program's place gives the readings of the control (the reference in
bfloat16, the precision below the configuration's float32) and, for a
fitting cell, of the planted faults "half of the frame's rows left out, the
mean taken over the rest" and "the state left unchanged" (worked out from
the reference: no step moves anything). With `--witness`, a fitting
cell's control seeds also give the float32 reference against itself in
bands of half the rows ("ref_bands": the round-off of another order of
summation) and against the float64 reference ("ref64"). Every reading is
one JSON line, with the per-leaf readings the numbers were worked out
from. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark.harness import compare  # noqa: E402
from benchmark.harness.main import Cell, Context, run_cell  # noqa: E402
from benchmark.kinds import camera_frames, fit_jobs  # noqa: E402
from benchmark.reference import fit as ref_fit  # noqa: E402
from benchmark.reference.render import Settings  # noqa: E402
from benchmark.scenes.data import FIELDS  # noqa: E402


def fit_controls(ctx, witness: bool = False, readings: Optional[dict] = None) -> dict:
    """The control's and the faults' numbers against the float32 reference,
    on the cell's first job (with `witness`, the references' own too);
    `readings`, if given, gets each side's per-leaf readings."""
    t = ctx.traffic
    H, W = t["height"], t["width"]
    settings = Settings(**dict(ctx.config["render"], antialias=t["antialias"],
                               shadow_grad=t["shadow_grad"]))
    leaves = [f for f in FIELDS if f in t["trainable"] and ctx.scene.arrays[f].size]
    target = fit_jobs.make_target(ctx.seed, 0, H, W, t["target_grid"], ctx.device)
    follow = functools.partial(ref_fit.follow, ctx.scene.structure, ctx.scene.arrays, leaves,
                               target, settings, t["lr"], t["check_steps"], ctx.device,
                               band_rows=t["reference_band_rows"])
    ref = follow()
    half = functools.partial(ref_fit.frame_loss_and_grads, rows=range(H // 2))
    sides = {"control": follow(dtype=torch.bfloat16), "half_rows": follow(step_fn=half),
             "state_unchanged": {"losses": [ref["losses"][0]] * len(ref["losses"]),
                                 "grad1": dict(ref["grad1"]),
                                 "change": dict.fromkeys(ref["change"], 0.0)}}
    if witness:
        sides["ref_bands"] = follow(band_rows=max(1, t["reference_band_rows"] // 2))
        sides["ref64"] = follow(dtype=torch.float64)
    if readings is not None:
        readings.update(sides, reference=ref)
    return {what: compare.fit_numbers(side, ref) for what, side in sides.items()}


def frame_controls(ctx) -> dict:
    """The control's numbers on the frames a run of this seed checks."""
    t = ctx.traffic
    H, W = t["height"], t["width"]
    settings = dict(ctx.config["render"], antialias=t["antialias"], shadow_grad="envelope")
    arrays = ctx.scene.arrays
    path = camera_frames.viewer.camera_path(
        arrays["cam_point"], arrays["cam_direction"],
        camera_frames.viewer.key_cycle(ctx.seed, t["cycle"], t["turn_every"]))
    ys, xs = camera_frames.pixel_sample(ctx.seed, H, W, t["check_pixels"])
    cams = [path[j] for j in range(0, t["cycle"], t["cycle"] // t["check_frames"])]
    ref = camera_frames.reference_pixels(ctx, settings, cams, ys, xs, H, W)
    low = camera_frames.reference_pixels(ctx, settings, cams, ys, xs, H, W,
                                         dtype=torch.bfloat16)
    return {"control": compare.frame_numbers(low, ref)}


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
        if cell.traffic["kind"] == "fit_jobs":
            got = fit_controls(ctx, witness=args.witness, readings=sides)
        else:
            got = frame_controls(ctx)
        for what, numbers in got.items():
            emit({"workload": args.workload, "seed": seed, "what": what, "numbers": numbers,
                  "readings": sides.get(what), "reference": sides.get("reference"),
                  "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
