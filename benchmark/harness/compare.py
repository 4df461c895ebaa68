"""The numbers that decide `correct`, each held against its limit.

A fitting job's first steps (the program's against the reference's):
- `loss_gap`: the largest relative gap of a step's loss;
- `grad_gap`: by the worst leaf, the gap between the norms of the first
  gradient, over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- `step_gap`: the same for the norm of each leaf's change after the steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
- `step_gap_median`: the median over those leaves of the same gap. Adam's
  first update is lr * sign(g) in every element, so an element whose
  gradient is a near-tie (its sign decided by the order of summation)
  moves the other way on one side, and the worst leaf's gap swings from
  seed to seed; the median leaf's does not.

Frames (the program's pixels against the reference's on a sample):
- `px_off_share`: the share of sampled pixels whose largest channel gap
  exceeds PX_TOL.

Limits live in `benchmark/limits/<workload>.json`, each set from the
readings written beside it. A cell compares the numbers its limits file
names, and only those.
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

PX_TOL = 1e-3  # a pixel channel further than this from the reference is off
NULL_GRAD = 1e-3  # a leaf whose reference gradient is under this share of the median's
NO_READING = 1e30  # the number printed where a reading is not finite


def _rel(p: float, r: float, scale: float) -> float:
    return abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)


def fit_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog, ref: {"losses": [...], "grad1": {leaf: norm}, "change":
    {leaf: norm}} over the same leaves and steps (a "moves" key, each
    element's change, is for the eye: nothing here reads it)."""
    n = len(ref["losses"])
    if len(prog["losses"]) < n or not all(map(math.isfinite, prog["losses"][:n])):
        return dict.fromkeys(("loss_gap", "grad_gap", "step_gap", "step_gap_median"), math.inf)
    loss_gap = max(_rel(p, r, abs(r)) for p, r in zip(prog["losses"][:n], ref["losses"]))
    g_med = statistics.median(ref["grad1"].values())
    grad_gap = max(_rel(prog["grad1"][f], g, max(g, g_med)) for f, g in ref["grad1"].items())
    moved = [f for f, g in ref["grad1"].items() if g >= NULL_GRAD * g_med]
    c_med = statistics.median(ref["change"][f] for f in moved)
    gaps = [_rel(prog["change"][f], ref["change"][f], max(ref["change"][f], c_med))
            for f in moved]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "step_gap": max(gaps),
            "step_gap_median": statistics.median(gaps)}


def frame_numbers(prog_px: List[np.ndarray], ref_px: List[np.ndarray]) -> Dict[str, float]:
    """prog_px, ref_px: per checked frame, the sampled pixels [N, 3]."""
    p = np.concatenate(prog_px).astype(np.float64)
    r = np.concatenate(ref_px).astype(np.float64)
    gap = np.abs(p - r).max(axis=1)
    off = ~(gap <= PX_TOL)  # a NaN is off
    return {"px_off_share": float(off.mean())}


def load_limits(root: Path, workload: str) -> Optional[Dict[str, float]]:
    path = root / "benchmark" / "limits" / f"{workload}.json"
    if not path.exists():
        return None
    return {k: v["limit"] for k, v in json.loads(path.read_text())["limits"].items()}


def checks(numbers: Dict[str, float], limits: Optional[Dict[str, float]]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of each number the limits name (a number
    they name and the run lacks reads NO_READING); without limits, every
    number with limit None."""
    if limits is None:
        limits = dict.fromkeys(numbers)
    out = {}
    for k, lim in limits.items():
        v = numbers.get(k, math.inf)
        out[k] = {"value": v if math.isfinite(v) else NO_READING, "limit": lim}
    return out


def passed(result: Dict[str, dict]) -> bool:
    return bool(result) and all(c["limit"] is not None and c["value"] <= c["limit"]
                                for c in result.values())
