"""Speed-of-light accounting for the fused kernels
(`loltracer_tpu/utils/roofline.py`).

The JAX package's operation model, copied: the per-pixel cost (march
steps + shadow steps + fixed per-pixel work, each step one full scene-SDF
evaluation) times a per-structure operation count, aggregated over the
per-tile step distribution (a tile pays for its worst lane), divided by
the measured wall clock, reported as a fraction of the device's peak f32
rate. sqrt / div count TRANSCENDENTAL_WEIGHT add/mul slots each, so the
number is an estimate, not a measurement: it tells the order (whether a
kernel sits at ~5 % or ~50 % of its roofline, march or shadow first).

Two TPU concepts are replaced by the card's:
- the tile is the card's warp, 8 x 4 pixels (8 wide, 4 tall; K1 and K5,
  csrc/fused_fwd.cuh), where the JAX package takes its Pallas tile
  (`pallas_scene.resolve_tile`); `tile=` overrides it;
- the peak is the card's measured fused-FMA rate (`utils/peak.py`,
  artifacts/gpu_peak.json, written on the card by `cli peak`), else the
  H100 SXM's modelled FP32 ceiling, 132 SMs x 128 lanes x 2 flops x
  1.98 GHz.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.scene import SceneParams, SceneStructure

# 132 SMs x 128 FP32 lanes x 2 flops (an FMA) x 1.98 GHz, one H100 SXM
H100_FP32_PEAK = 132 * 128 * 2 * 1.98e9

# a warp of 32 rays over an 8 x 4 pixel tile: (rows, columns)
WARP_TILE = (4, 8)

# weight of sqrt/rsqrt/div/exp/log relative to an add/mul slot
TRANSCENDENTAL_WEIGHT = 4.0


def node_op_cost(node) -> float:
    """Approximate op count (weighted) for one evaluation of a compiled
    object-expression node, per lane."""
    kind = node[0]
    if kind == "sphere":
        # 3 sub, 3 mul, 2 add, sqrt, sub
        return 9 + TRANSCENDENTAL_WEIGHT
    if kind == "box":
        # 3 sub, 3 abs, 3 sub, 3 max, 3 mul+2 add, sqrt, max-tree(2), min,
        # add, sub
        return 21 + TRANSCENDENTAL_WEIGHT
    if kind == "plane":
        return 1
    if kind == "smin":
        # sub, div, mul-add, clamp(2), lerp(3), mul(2), sub -> ~10 + div
        return (
            9
            + TRANSCENDENTAL_WEIGHT
            + node_op_cost(node[2])
            + node_op_cost(node[3])
        )
    raise ValueError(node)


def sdf_eval_cost(structure: SceneStructure) -> float:
    """Weighted ops per lane for ONE full scene-SDF evaluation."""
    if structure.instanced:
        # per sphere: 3 sub, 3 mul, 2 add, sqrt, sub + running min
        per_sphere = 10 + TRANSCENDENTAL_WEIGHT
        return structure.num_spheres * per_sphere + structure.num_planes * 2
    cost = sum(node_op_cost(n) for n in structure.objects)
    return cost + len(structure.objects)  # the argmin/min combine


def _tile_max(counts: np.ndarray, tile=(8, 128)) -> np.ndarray:
    th, tw = tile
    H, W = counts.shape
    ph, pw = -(-H // th) * th, -(-W // tw) * tw
    padded = np.zeros((ph, pw), counts.dtype)
    padded[:H, :W] = counts
    # padded lanes replicate edge behavior; zero is a safe lower bound here
    t = padded.reshape(ph // th, th, pw // tw, tw)
    return t.max(axis=(1, 3))


def roofline_estimate(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    measured_seconds: float,
    cfg: RenderConfig = DEFAULT_CONFIG,
    peak_flops: Optional[float] = None,
    mode: str = "fwd",
    tile: Optional[Tuple[int, int]] = None,
) -> Dict[str, object]:
    """Estimate the fused kernel's achieved fraction of the peak.

    Counts the march steps per pixel (utils/profiling.march_step_counts,
    on the params' device), adds the fixed per-pixel work (normal taps,
    material select, shading), and compares weighted-op throughput with
    `peak_flops`. `measured_seconds` is the measured wall time of one
    forward (mode="fwd") or one forward+backward (mode="fwdbwd") at this
    size. `tile` (rows, columns) is the lane group that pays for its
    worst lane: WARP_TILE by default.

    `peak_flops=None` takes the card's measured rate
    (`utils/peak.load_measured_peak`) and only without one the modelled
    H100_FP32_PEAK. The record says which was used (`peak_source`), and
    the tile (`tile`)."""
    from loltracer_tpu_torch.utils.peak import load_measured_peak
    from loltracer_tpu_torch.utils.profiling import march_step_counts

    peak_source = "explicit"
    if peak_flops is None:
        peak_flops = load_measured_peak()
        peak_source = "measured_artifact"
        if peak_flops is None:
            peak_flops = H100_FP32_PEAK
            peak_source = "modeled_constant"

    eval_cost = sdf_eval_cost(structure)
    tile = tuple(tile or WARP_TILE)
    lanes_per_tile = tile[0] * tile[1]

    # march: each tile pays its worst lane's step count
    steps = march_step_counts(structure, params, height, width, cfg)
    march_evals = float(_tile_max(steps, tile).sum()) * lanes_per_tile

    # shadows: bounded by shadow_steps per light; approximate the tile-max
    # distribution with the march's shape scaled to the shadow cap (the
    # shadow march early-outs are at least as aggressive as the primary's)
    shadow_cap = min(cfg.shadow_steps, cfg.max_steps)
    shadow_evals = (
        structure.num_lights
        * float(np.minimum(_tile_max(steps, tile), shadow_cap).sum())
        * lanes_per_tile
    )

    # fixed per-pixel work: 4 normal taps + ~3 extra scene evals (hit-id,
    # IFT value + denominator jvp) + shading/ray math (~150 weighted ops)
    pixels = height * width
    fixed_evals = 7.0 * pixels
    shading_ops = 150.0 * pixels

    total_ops = (march_evals + shadow_evals + fixed_evals) * eval_cost
    total_ops += shading_ops
    if mode == "fwdbwd":
        # backward kernel: the re-attachment (~7 evals) forward + reverse
        # (~2x), plus shading math both ways
        total_ops += (2.0 * 7.0 * pixels) * eval_cost + 2.0 * shading_ops

    achieved = total_ops / measured_seconds
    return {
        "sdf_eval_cost_weighted_ops": eval_cost,
        "march_evals": march_evals,
        "shadow_evals": shadow_evals,
        "total_weighted_ops": total_ops,
        "achieved_ops_per_s": achieved,
        "peak_ops_per_s": peak_flops,
        "peak_source": peak_source,
        "fraction_of_peak": achieved / peak_flops,
        "tile": list(tile),
    }
