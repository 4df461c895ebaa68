"""The fused forward render of instanced scenes: the hand-written CUDA
kernel and its plain PyTorch version (`loltracer_tpu/render/pallas_train.py`
`_instanced_fwd_kernel`, residuals off).

`instanced_forward(structure, cfg, cam, fields, tables, height, width)`
renders [H, W, 3] f32 from the camera pack (`camera.camera_pack`), the
packed small fields (`cuda_scene.pack_fields`: materials, lights, ambient,
planes) and the sphere tables (`instanced_pack.pack_instanced`). With
`full_height`, it renders a band: the `height` rows from the pack's row0
on, of an image `full_height` rows tall.

- CUDA tensors launch `lol_instanced_render` (csrc/fused_fwd.cuh's pixel
  body over csrc/grid_scene.cuh's exact search: a cell grid of candidate
  spheres, render/cell_grid.py, built from the tables at each call, with
  csrc/instanced_scene.cuh's run walk where the grid cannot certify; one
  thread per ray), built at first use for the config; the source does not
  depend on the sphere count. `walk=True` launches the run walk alone
  (`lol_instanced_render_walk`, the check of the grid: the same image
  bitwise), `stats=` the grid entry that counts its searches
  (`lol_instanced_render_stats`). A failed build or launch raises; nothing
  falls back.
- CPU tensors go to `instanced_forward_reference`, the plain version: the
  torch renderer (render/torch_renderer.py) on the spheres read back out of
  the tables in SoA order.

`launches` counts kernel launches; the plain version never adds to it.
`grid_counts(device, rays)` is the accumulator of the counting twin's
launches that make_instanced_renderer makes on the first recorded frame
of a recording (utils/tracing.py): int64 [3] on the card, read only by
`tracing.snapshot()` (`instanced_render.*`), with the rays they covered.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.backend import resolve_backend
from loltracer_tpu_torch.render.camera import CAM_SIZE, rays_from_pack
from loltracer_tpu_torch.render.cell_grid import CellGrid, check_grid, grid_args, grid_for
from loltracer_tpu_torch.render.cuda_scene import (
    GRID_ARGTYPES,
    INSTANCED_ENTRY,
    INSTANCED_STATS,
    INSTANCED_WALK,
    generate_instanced_source,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.fused_fwd import _check
from loltracer_tpu_torch.render.instanced_pack import GROUP, InstancedTables, soa_spheres
from loltracer_tpu_torch.render.torch_renderer import render_rays
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, require_instanced
from loltracer_tpu_torch.utils import tracing

__all__ = [
    "instanced_forward",
    "instanced_forward_reference",
    "launches",
    "library",
]

launches = 0

# the counting twin's searches, fallbacks and entries read per device, and
# the rays of the launches that added to them (grid_counts)
_counts: Dict[torch.device, torch.Tensor] = {}
_count_rays = 0


def grid_counts(device: torch.device, rays: int) -> torch.Tensor:
    """The accumulator that a counting launch of `rays` rays on `device`
    adds to (the `stats` of instanced_forward)."""
    global _count_rays
    if device not in _counts:
        _counts[device] = torch.zeros(3, dtype=torch.int64, device=device)
    _count_rays += rays
    return _counts[device]


def _read_counts() -> Dict[str, float]:
    if not _counts:
        return {}
    searches, fallbacks, read = (sum(v) for v in zip(*(c.tolist() for c in _counts.values())))
    return {
        "instanced_render.rays": _count_rays,
        "instanced_render.searches": searches,
        "instanced_render.fallbacks": fallbacks,
        "instanced_render.entries_read": read,
        "instanced_render.searches_per_ray": searches / max(_count_rays, 1),
        "instanced_render.entries_per_search": read / max(searches, 1),
        "instanced_render.fallback_share": fallbacks / max(searches, 1),
    }


def _reset_counts() -> None:
    global _count_rays
    _counts.clear()
    _count_rays = 0


tracing.register_counters("instanced_render", _read_counts, _reset_counts)


def instanced_forward_reference(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    tables: InstancedTables,
    height: int,
    width: int,
    full_height: Optional[int] = None,
    live: Optional[Dict] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on the tensors' device:
    `torch_renderer.render_rays` over the rays of rows cam[15] +
    0..height-1 of an image of `full_height` rows (default `height`), and
    the spheres of the tables put back in SoA order, its marches pinned
    to the plain loops (march_backend "jnp": no kernel runs in it).
    Returns [height, W, 3] f32. `live` is handed to render_rays (its
    loops' live-ray counts)."""
    unpacked = unpack_fields(structure, fields)
    pos, rad = soa_spheres(structure, tables)
    unpacked.update(sphere_point=pos, sphere_radius=rad)
    params = SceneParams(
        **unpacked,
        cam_point=cam[0:3],
        cam_direction=cam[9:12],
        cam_fov=cam.new_zeros(()),  # unused: the rays come from the pack
    )
    ro, rd = rays_from_pack(cam, torch.arange(height), full_height or height, width)
    with torch.no_grad():
        return render_rays(
            structure, params, ro, rd, cfg.replace(march_backend="jnp"),
            pixel_rad=cam[14] if cfg.antialias else None, live=live,
        )


@functools.lru_cache(maxsize=None)
def library(cfg: RenderConfig, structure: SceneStructure) -> _build.Library:
    """The built kernel for this config and structure (compiled at first
    use, then loaded from the build cache). Structures that differ only in
    their sphere count or material ids share one source, hence one build."""
    built = _build.build(generate_instanced_source(structure, cfg), "instanced_fwd")
    head = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 3
    for name, grid in ((INSTANCED_ENTRY, True), (INSTANCED_WALK, False),
                       (INSTANCED_STATS, True)):
        fn = getattr(built.lib, name)
        fn.argtypes = head + (GRID_ARGTYPES if grid else []) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def _check_tables(structure: SceneStructure, tables: InstancedTables, device) -> None:
    ns, ng = structure.num_spheres, -(-structure.num_spheres // GROUP)
    want = {
        "spheres": ((ns, 4), torch.float32),
        "ids": ((ns + structure.num_planes, 2), torch.int32),
        "groups": ((ng, 8), torch.float32),
        "bbox": ((6,), torch.float32),
    }
    for name, (shape, dtype) in want.items():
        t = getattr(tables, name)
        if t.device != device or t.dtype != dtype or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(
                f"tables.{name}: want contiguous {dtype} {shape} on {device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )


def instanced_forward(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    tables: InstancedTables,
    height: int,
    width: int,
    full_height: Optional[int] = None,
    grid: Optional[CellGrid] = None,
    walk: bool = False,
    stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render [height, W, 3] f32: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (render/backend.py). On CUDA the kernel
    searches `grid` (default: `cell_grid.grid_for(tables, cfg.step_clamp)`,
    built now), or with
    `walk` the run walk alone; `stats` (int64 [3] on the device) takes the
    grid search's counts: searches, fallbacks, list entries read."""
    require_instanced(structure)
    full_height = full_height or height
    if resolve_backend(cam, fields, *tables) == "torch":
        return instanced_forward_reference(
            structure, cfg, cam, fields, tables, height, width, full_height
        )
    _check("cam", cam, (CAM_SIZE,))
    _check("fields", fields, (packed_size(structure),))
    _check_tables(structure, tables, cam.device)
    if cam.device != fields.device:
        raise ValueError(f"cam on {cam.device}, fields on {fields.device}")
    if height <= 0 or width <= 0 or full_height < height:
        raise ValueError(f"bad image size {height}x{width} of {full_height} rows")
    if walk:
        name, index = INSTANCED_WALK, ()
    else:
        grid = grid_for(tables, cfg.step_clamp) if grid is None else grid
        check_grid(grid, cam.device, stats)
        name, index = (INSTANCED_ENTRY if stats is None else INSTANCED_STATS), grid_args(grid,
                                                                                         stats)
    fn = getattr(library(cfg, structure).lib, name)
    img = torch.empty((height, width, 3), dtype=torch.float32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cam.data_ptr(), fields.data_ptr(), tables.spheres.data_ptr(),
                tables.ids.data_ptr(), tables.groups.data_ptr(), tables.bbox.data_ptr(),
                tables.spheres.shape[0], tables.groups.shape[0], img.data_ptr(),
                height, full_height, width, *index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    global launches
    launches += 1
    return img
