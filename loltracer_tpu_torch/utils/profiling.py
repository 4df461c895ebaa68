"""Profiling and the row-sharding cost model (`loltracer_tpu/utils/profiling.py`).

- `trace(logdir)`: a torch.profiler context whose trace (Chrome JSON, for
  tensorboard or Perfetto) goes to `logdir` (`cli render` / `cli fit
  --trace DIR`); while it runs the spans of utils/tracing.py are on, so the
  trace shows them over the kernels: the differentiable renderer's stages
  under the JAX package's scope names (lol_march, lol_normal, lol_shade,
  lol_shadow_march), fit_scene's set-up and step phases, the frame's pack,
  grid build, host syncs and launch;
- `march_step_counts` / `shadow_step_counts`: per-pixel march and, at the
  primary hit, per-light shadow-march iteration counts, integer planes
  [H, W] and [L, H, W] (int32);
- `march_step_stats`: the step distribution and the worst-lane waste of
  (8, 128) and (64, 128) tiles, with the JAX package's keys;
- `band_balance`, `block_row_costs`, `shard_balance`: the deterministic
  cost model of row sharding (a tile costs its worst lane's march steps
  plus each light's worst shadow steps) that drives the LPT deal of
  parallel/sharded.py.

The counts run the plain loops with their own `counts=` hooks
(render/march.py `march`, render/shading.py `shadow_march`, without the
segment cull), on the params' device, over the scene's distance without a
step clamp whatever cfg.step_clamp is, as the JAX package's counters do
(`make_scene_sdf(structure)`). That distance is the plain SDF
(render/sdf.py) everywhere but for an instanced structure on CUDA tensors
under a march backend that resolves to the kernels
(render/backend.resolve_march_backend): there every evaluation is one
launch of K7 without a clamp (`march_kernels.make_instanced_eval`, over
a cell grid built once a count), so that a 1080p count of 10 000 spheres
costs a few hundred launches instead of the plain SDF's walk over every
sphere. K7 and its plain version agree bitwise on the card; the counts
are those of the plain SDF wherever the two distances agree.

The cost model's tile is JAX's (8, 128) by default: it defines which
blocks `parallel.sharded.assign_blocks` deals. One fault of the reference
is not copied: its `shard_balance` reshapes the tile rows into equal
contiguous bands when the rows cannot be dealt and raises when they do
not split (1080 rows over 2 shards); here each shard costs the tile rows
its own rows fall in, as the dealt assignments are costed.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_march_backend
from loltracer_tpu_torch.render.camera import camera_rays
from loltracer_tpu_torch.render.march import march
from loltracer_tpu_torch.render.sdf import make_scene_sdf
from loltracer_tpu_torch.render.shading import shadow_march
from loltracer_tpu_torch.scene import SceneParams, SceneStructure


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the block (the CPU, and the card when there is
    one); the trace is written under `logdir` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof


def _count_sdf(structure: SceneStructure, params: SceneParams, cfg: RenderConfig) -> Callable:
    """The unclamped distance of the counts (module docstring)."""
    if structure.instanced and resolve_march_backend(cfg.march_backend,
                                                     params.cam_point) == "pallas":
        from loltracer_tpu_torch.render.cell_grid import grid_for
        from loltracer_tpu_torch.render.march_kernels import make_instanced_eval, pack_eval_tables

        eval_fn = make_instanced_eval(structure, RenderConfig(step_clamp=None))
        tables = pack_eval_tables(params)
        grid = grid_for(tables, None)
        plane_y = params.plane_y.detach().to(torch.float32).contiguous()
        return lambda _params, p: eval_fn(tables, plane_y, p, grid)
    return make_scene_sdf(structure)


def _primary(structure, params, height, width, cfg):
    """(sdf, ro, rd, steps [H, W] int32 zeros) of a count."""
    sdf = _count_sdf(structure, params, cfg)
    ro, rd = camera_rays(params, height, width, cfg)
    return sdf, ro, rd, torch.zeros((height, width), dtype=torch.int32, device=rd.device)


def march_step_counts(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Per-pixel number of march iterations until convergence or miss,
    [H, W] int32."""
    with torch.no_grad():
        sdf, ro, rd, steps = _primary(structure, params, height, width, cfg)
        march(sdf, params, ro, rd, cfg, counts=steps)
    return steps.cpu().numpy()


def shadow_step_counts(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Per-pixel, per-light shadow-march iteration counts from the primary
    march's final point, [L, H, W] int32."""
    with torch.no_grad():
        sdf, ro, rd, _ = _primary(structure, params, height, width, cfg)
        p = ro + march(sdf, params, ro, rd, cfg).t[..., None] * rd
        planes = []
        for li in range(structure.num_lights):
            to_light = params.light_point[li] - p
            light_dist = torch.sqrt((to_light * to_light).sum(-1))
            ld = to_light / torch.clamp_min(light_dist[..., None], 1e-30)
            steps = torch.zeros((height, width), dtype=torch.int32, device=p.device)
            shadow_march(sdf, params, p + ld * cfg.shadow_offset, ld, light_dist, cfg,
                         counts=steps)
            planes.append(steps)
        if not planes:
            return np.zeros((0, height, width), np.int32)
        return torch.stack(planes).cpu().numpy()


def march_step_stats(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = (8, 128),
) -> Dict[str, Optional[float]]:
    """The step distribution and the masked-work overhead of tiling: a
    tile's mean worst ray over the mean step count (None where the image
    is smaller than the tile)."""
    steps = march_step_counts(structure, params, height, width, cfg)

    def waste(th, tw):
        hh = height - height % th
        ww = width - width % tw
        if not hh or not ww:
            return None
        tiles = steps[:hh, :ww].reshape(hh // th, th, ww // tw, tw)
        return float(tiles.max(axis=(1, 3)).mean())

    mean = float(steps.mean())

    def ratio(w):
        return None if w is None else float(w / max(mean, 1e-9))

    return {
        "mean_steps": mean,
        "p50_steps": float(np.percentile(steps, 50)),
        "p99_steps": float(np.percentile(steps, 99)),
        "max_steps": float(steps.max()),
        "tile_waste": ratio(waste(*tile)),
        "tile_waste_64x128": ratio(waste(64, 128)),
    }


def _tile_row_costs(structure, params, height, width, cfg, tile) -> np.ndarray:
    """Worst-lane cost per tile row, [height // th] float64: each tile's
    worst march steps plus each light's worst shadow steps, summed over the
    row's tiles."""
    march_steps = march_step_counts(structure, params, height, width, cfg)
    shadow = shadow_step_counts(structure, params, height, width, cfg)
    th, tw = tile
    ww = width - width % tw

    def row_cost(plane):
        tiles = plane[:, :ww].reshape(height // th, th, ww // tw, tw)
        return tiles.max(axis=(1, 3)).sum(axis=1).astype(np.float64)

    per_row = row_cost(march_steps)
    for li in range(shadow.shape[0]):
        per_row = per_row + row_cost(shadow[li])
    return per_row


def band_balance(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    n_bands: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = (8, 128),
) -> Dict[str, object]:
    """Per-band cost of `n_bands` contiguous bands on the worst-lane tile
    model, and the balance sum / (n * max)."""
    if height % (n_bands * tile[0]):
        raise ValueError(
            f"height {height} must tile into {n_bands} bands of {tile[0]}-row tiles"
        )
    if width < tile[1]:
        raise ValueError(f"width {width} smaller than tile width {tile[1]}")
    per_row = _tile_row_costs(structure, params, height, width, cfg, tile)
    costs = per_row.reshape(n_bands, -1).sum(axis=1)
    return {
        "n_bands": n_bands,
        "band_costs": [float(c) for c in costs],
        "efficiency_balance": float(costs.sum() / (n_bands * costs.max())),
    }


def block_row_costs(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    G: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = (8, 128),
) -> np.ndarray:
    """Estimated cost per G-row block, [height // G] float64, on the
    worst-lane tile model: what parallel/sharded.assign_blocks deals."""
    per_row = _tile_row_costs(structure, params, height, width, cfg, tile)
    return per_row.reshape(height // G, G // tile[0]).sum(axis=1)


def shard_balance(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    n_shards: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    tile: Tuple[int, int] = (8, 128),
    cost_aware: bool = True,
) -> Dict[str, object]:
    """The balance of the row assignment parallel/sharded.py makes over
    `n_shards` (the LPT deal with `cost_aware`, the snake deal without,
    contiguous bands when the rows cannot be dealt) on the worst-lane
    tile model: each shard costs the tile rows its rows fall in."""
    from loltracer_tpu_torch.parallel.sharded import interleave_rows, row_granularity

    if height % n_shards:
        raise ValueError(f"image height {height} must divide evenly over {n_shards} shards")
    per_row = _tile_row_costs(structure, params, height, width, cfg, tile)
    th = tile[0]
    G = row_granularity(structure)
    bc = None
    if cost_aware and height % G == 0:
        bc = per_row.reshape(height // G, G // th).sum(axis=1)
    pi = interleave_rows(height, n_shards, G, block_costs=bc)
    if pi is None:
        assignment, perm = "contiguous", np.arange(height)
    else:
        assignment, perm = ("lpt" if bc is not None else "interleaved-snake"), pi[0]
    rows_per = height // n_shards
    costs = np.array([per_row[np.unique(perm[i * rows_per:(i + 1) * rows_per] // th)].sum()
                      for i in range(n_shards)])
    return {
        "n_shards": n_shards,
        "assignment": assignment,
        "granularity": G,
        "shard_costs": [float(c) for c in costs],
        "efficiency_balance": float(costs.sum() / (n_shards * costs.max())),
    }

