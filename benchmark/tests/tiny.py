"""A checkout of the benchmark's data in a temporary directory, with cells
of the real traffic kinds cut to a few pixels for the CPU: only data files
are added, as a later change adds a cell. The reference renders a tiny
frame in one band, as the program's plain renderer does: at a few hundred
pixels one pixel's near-tie, flipped by another order of summation, moves
the second step's Adam update visibly."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# name -> (config, traffic of the repo, changes, the repo's cell whose limits it takes)
TINY = {
    "tiny-fit": ("scene4", "fit_1080p_envelope",
                 dict(height=12, width=16, steps=4, trace_from=1, trace_steps=1,
                      reference_band_rows=12), "scene4-fit-1080p"),
    "tiny-exact": ("scene4", "fit_540p_exact",
                   dict(height=8, width=12, steps=4, trace_from=1, trace_steps=1,
                        reference_band_rows=8), "scene4-fit-exact-540p"),
    "tiny-frames": ("instanced10k", "frames_4k",
                    dict(height=12, width=16, check_frames=2, check_pixels=40),
                    "instanced10k-frames-4k"),
    # a configuration the benchmark has under a traffic kind it has, paired
    # by data alone (PERF.md's first open cell, scene4's viewer frames)
    "tiny-scene4-frames": ("scene4", "frames_4k",
                           dict(height=12, width=16, check_frames=2, check_pixels=40),
                           "instanced10k-frames-4k"),
}


def make_root(tmp: Path, names=tuple(TINY)) -> Path:
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for sub in ("configs", "metrics", "limits"):
        shutil.copytree(REPO / "benchmark" / sub, tmp / "benchmark" / sub, dirs_exist_ok=True)
    (tmp / "benchmark" / "traffic").mkdir(parents=True, exist_ok=True)
    for name in names:
        config, traffic, changes, like = TINY[name]
        t = json.loads((REPO / "benchmark" / "traffic" / f"{traffic}.json").read_text())
        t.update(changes)
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(t))
        bench["workloads"].append({"name": name, "config": config, "traffic": name,
                                   "chips": 1, "why": "a CPU rehearsal"})
        limits = REPO / "benchmark" / "limits" / f"{like}.json"
        if limits.exists():
            shutil.copy(limits, tmp / "benchmark" / "limits" / f"{name}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
