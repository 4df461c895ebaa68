"""The regrouped instanced forward render K9: hand-written CUDA kernels and
their plain PyTorch versions (`loltracer_tpu/render/pallas_regroup.py`).

The fused instanced kernel K5 marches each pixel's shadow rays from that
pixel's hit point, so a warp's shadow rays start wherever its 8x4 pixel
tile's hit points lie. Here the forward render is split into three kernels
with a sort in between (csrc/regroup.cuh):

- the cell grid of candidate spheres (`cell_grid.grid_for`), built once
  per frame and searched by the march and by every light's shadow launch,
  as K5 searches it (the run walk its fallback);
- `march_track` (lol_rg_march, per pixel): the march half of K5's pixel
  body -> track [3, H, W] (t_sh, hit, material), the shading points hitp
  [3, H, W], and per light the shadow records rec [L, 7, H, W] (origin,
  unit direction, distance to the light);
- glue, per frame: the box [lo, hi] of the shading points; per light: the
  30-bit Morton keys of the record origins in that box (`morton_keys`,
  bitwise the JAX package's) and a stable argsort, the permutation;
- `shadow_sorted` (lol_rg_shadow, per record, per light): thread i marches
  record perm[i] and writes (res, t*) back to pixel perm[i] -> shadow [L,
  2, H, W]; no gather of records and no inverse permutation;
- `shade_planes` (lol_rg_shade, per pixel): the shade half of K5's body
  over the frozen planes -> the image [H, W, 3], its normal taps (and,
  under AA, a miss's material lookup) over the same grid.

`march_track(..., walk=True)`, `shadow_sorted(..., walk=True)` and
`shade_planes(..., walk=True)` launch the run-walk twins
(`lol_rg_march_walk`, `lol_rg_shadow_walk`, `lol_rg_shade_walk`): the check
of the grid kernels, bitwise equal; nothing on the main path calls them.
`shade_planes(..., stats=)` launches `lol_rg_shade_stats`, which counts the
shade's grid searches.

Each value depends only on its own pixel's ray, so the image is bitwise
K5's (`lol_instanced_render`); the sort buys only locality.

`make_instanced_renderer_regrouped` is the entry point, with the contract
of `cuda_renderer.make_instanced_renderer`. On CPU tensors every piece
takes its plain version (`march_track_reference`, `shadow_sorted_reference`,
`shade_planes_reference`, `regrouped_forward_reference`), built from the
plain instanced SDF and loops with the expressions of render_rays, so the
plain pipeline is bitwise `instanced_fwd.instanced_forward_reference`.

`shadow_gather_stats` measures what the sort does to one light's shadow
rays, counted in a stats launch on the card: over the grid (searches,
fallbacks, list entries, distinct lists per warp step) or, with
`walk=True`, over the run walk (runs reached per evaluation).

`launches` counts kernel launches per entry; the plain versions never add
to it. A failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_backend, resolve_device
from loltracer_tpu_torch.render.camera import CAM_SIZE, camera_pack, rays_from_pack
from loltracer_tpu_torch.render.cell_grid import CellGrid, check_grid, grid_args, grid_for
from loltracer_tpu_torch.render.cuda_scene import (
    GRID_ARGTYPES,
    RG_MARCH,
    RG_MARCH_WALK,
    RG_SHADE,
    RG_SHADE_STATS,
    RG_SHADE_WALK,
    RG_SHADOW,
    RG_SHADOW_GRID_STATS,
    RG_SHADOW_STATS,
    RG_SHADOW_WALK,
    generate_regroup_source,
    pack_fields,
    packed_size,
)
from loltracer_tpu_torch.render.fused_fwd import _check
from loltracer_tpu_torch.render.instanced_fwd import _check_tables
from loltracer_tpu_torch.render.instanced_pack import InstancedTables, pack_instanced
from loltracer_tpu_torch.render.instanced_train import _params_of
from loltracer_tpu_torch.render.march import march
from loltracer_tpu_torch.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu_torch.render.shading import get_normal, phong, shadow_march
from loltracer_tpu_torch.render.torch_renderer import gamma_encode
from loltracer_tpu_torch.render.vecmath import clip, dot, maximum, normalize
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, params_to, require_instanced

__all__ = [
    "Track",
    "grid_warp_stats",
    "launches",
    "library",
    "make_instanced_renderer_regrouped",
    "march_track",
    "march_track_reference",
    "morton_keys",
    "regrouped_forward",
    "regrouped_forward_reference",
    "shade_planes",
    "shade_planes_reference",
    "shadow_gather_stats",
    "shadow_order",
    "shadow_sorted",
    "shadow_sorted_reference",
    "warp_stats",
]

launches = {name: 0 for name in (RG_MARCH, RG_MARCH_WALK, RG_SHADOW, RG_SHADOW_WALK, RG_SHADE,
                                 RG_SHADE_WALK, RG_SHADOW_STATS, RG_SHADOW_GRID_STATS,
                                 RG_SHADE_STATS)}

WARP = 32
RECORD = 7  # floats per shadow record: origin (3), unit direction (3), distance


class Track(NamedTuple):
    """lol_rg_march's outputs for a launch of H rows of W pixels."""

    track: torch.Tensor  # [3, H, W] t_sh, hit (1/0), material
    hitp: torch.Tensor  # [3, H, W] the shading points ro + t_sh rd
    rec: torch.Tensor  # [L, 7, H, W] per light: origin, unit direction, distance


# --------------------------------------------------------------------------
# Morton keys: the 3-D locality order of the sort (pallas_regroup.py:310-333)
# --------------------------------------------------------------------------


def _part1by2(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (int64 in place of JAX's uint32:
    every value fits in 30 bits, so the bits are the same)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0xFF0000FF
    v = (v | (v << 8)) & 0x0F00F00F
    v = (v | (v << 4)) & 0xC30C30C3
    v = (v | (v << 2)) & 0x49249249
    return v


def morton_keys(px, py, pz, lo, hi) -> torch.Tensor:
    """30-bit Morton codes (int64) of points quantised to a 1024^3 grid of
    the [lo, hi] box, per-axis spans; out-of-box points clamp to the
    boundary cells. Bitwise `pallas_regroup.morton_keys`."""
    span = torch.clamp_min(hi - lo, 1e-6)

    def q(v, a):
        n = (v - lo[a]) / span[a] * 1024.0
        return torch.clamp(n, 0.0, 1023.0).to(torch.int64)

    return (_part1by2(q(px, 0)) << 2) | (_part1by2(q(py, 1)) << 1) | _part1by2(q(pz, 2))


def hit_box(hitp: torch.Tensor):
    """(lo [3], hi [3]) of the shading points hitp [3, ...]: the Morton box
    of the frame (pallas_regroup.py:457-458)."""
    flat = hitp.reshape(3, -1)
    return flat.amin(dim=1), flat.amax(dim=1)


def shadow_order(rec_l: torch.Tensor, lo, hi, sort: bool = True) -> torch.Tensor:
    """The permutation [n] (int64) of one light's records rec_l [7, ...]: a
    stable argsort of their origins' Morton keys in the box (lo, hi), or
    the identity without `sort`."""
    n = rec_l[0].numel()
    if not sort:
        return torch.arange(n, device=rec_l.device)
    keys = morton_keys(rec_l[0].reshape(-1), rec_l[1].reshape(-1), rec_l[2].reshape(-1), lo, hi)
    return torch.argsort(keys, stable=True)


# --------------------------------------------------------------------------
# the plain versions
# --------------------------------------------------------------------------


def march_track_reference(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    height: int, width: int, full_height: Optional[int] = None,
) -> Track:
    """The plain version of lol_rg_march: the plain march under the step
    clamp and the argmin's material of intersect_aa, and each light's
    shadow record by phong's expressions, for rows cam[15] + 0..height-1
    of an image of `full_height` rows (default `height`)."""
    with torch.no_grad():
        params = _params_of(structure, cam, fields, tables)
        clamp = cfg.step_clamp
        ro, rd = rays_from_pack(cam, torch.arange(height), full_height or height, width)
        m = march(make_scene_sdf(structure, clamp), params, ro, rd, cfg)
        hit = m.t < cfg.max_dist
        if cfg.antialias:
            t_q = torch.where(hit, m.t_query, m.t_close)
            t_sh = torch.where(hit, m.t, t_q)
            _, oid = make_scene_sdf_with_id(structure, clamp)(params, ro + t_q[..., None] * rd)
        else:
            t_sh = m.t
            _, oid = make_scene_sdf_with_id(structure, clamp)(params,
                                                               ro + m.t_query[..., None] * rd)
            oid = torch.where(hit, oid, 0)
        mat_ids = torch.tensor(structure.material_ids, dtype=torch.long, device=oid.device)
        track = torch.stack([t_sh, hit.to(t_sh.dtype), mat_ids[oid.long()].to(t_sh.dtype)])
        p = ro + t_sh[..., None] * rd
        recs = []
        for li in range(structure.num_lights):
            to_light = params.light_point[li] - p
            light_dist = torch.sqrt(dot(to_light, to_light))
            light_dir = normalize(to_light)
            so = p + light_dir * cfg.shadow_offset
            recs.append(torch.cat([so.movedim(-1, 0), light_dir.movedim(-1, 0),
                                   light_dist[None]]))
        rec = (torch.stack(recs) if recs
               else p.new_zeros((0, RECORD, height, width)))
        return Track(track, p.movedim(-1, 0).contiguous(), rec)


def shadow_sorted_reference(
    structure: SceneStructure, cfg: RenderConfig, fields, tables: InstancedTables,
    rec_l: torch.Tensor, perm: torch.Tensor,
) -> torch.Tensor:
    """The plain version of lol_rg_shadow for one light: the records rec_l
    [7, ...] marched in the order perm by the plain shadow loop under the
    shadow clamp, each (res, t*) put back at its record -> [2, ...]."""
    with torch.no_grad():
        # the shadow march reads no camera number
        params = _params_of(structure, fields.new_zeros(CAM_SIZE), fields, tables)
        flat = rec_l.reshape(RECORD, -1)[:, perm]
        so, ld, dist = flat[0:3].T.contiguous(), flat[3:6].T.contiguous(), flat[6]
        res, t_star = shadow_march(make_scene_sdf(structure, cfg.effective_shadow_clamp()),
                                   params, so, ld, dist, cfg)
        out = torch.empty((2, flat.shape[1]), dtype=res.dtype, device=res.device)
        out[0, perm] = res
        out[1, perm] = t_star
        return out.reshape((2,) + tuple(rec_l.shape[1:]))


def shade_planes_reference(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    track: torch.Tensor, shadow: torch.Tensor, height: int, width: int,
    full_height: Optional[int] = None,
) -> torch.Tensor:
    """The plain version of lol_rg_shade: render_rays' normals, Phong, AA
    blend and gamma over the frozen planes track [3, H, W] and shadow [L,
    2, H, W] -> [H, W, 3]; an AA miss's coverage from the argmin SDF at its
    closest approach t_sh, as intersect_aa takes it."""
    with torch.no_grad():
        params = _params_of(structure, cam, fields, tables)
        clamp = cfg.step_clamp
        sdf = make_scene_sdf(structure, clamp)
        ro, rd = rays_from_pack(cam, torch.arange(height), full_height or height, width)
        t_sh, hit, mat = track[0], track[1] > 0.5, track[2].to(torch.long)
        p = ro + t_sh[..., None] * rd
        n = get_normal(sdf, params, p, t_sh, cfg)
        color = phong(structure, params, p, n, mat,
                      lambda li, *ray: maximum(shadow[li, 0], 0.0), cfg)
        if cfg.antialias:
            f_close, _ = make_scene_sdf_with_id(structure, clamp)(params, p)
            s = f_close / torch.where(t_sh > 0, t_sh, 1.0)
            edge = torch.where(t_sh > 0, clip(1.0 - s / cam[14], 0.0, 1.0), 0.0)
            alpha = torch.where(hit, 1.0, edge)
            bg = clip(params.ambient_color * params.mat_ambient[0], 0.0, 1.0)
            color = alpha[..., None] * color + (1.0 - alpha[..., None]) * bg
        return gamma_encode(color, cfg.gamma)


def regrouped_forward_reference(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    height: int, width: int, full_height: Optional[int] = None,
) -> torch.Tensor:
    """The plain regrouped pipeline: march_track_reference, per light the
    Morton order and shadow_sorted_reference, shade_planes_reference ->
    [height, W, 3]; bitwise instanced_forward_reference."""
    tr = march_track_reference(structure, cfg, cam, fields, tables, height, width, full_height)
    lo, hi = hit_box(tr.hitp)
    shadow = [shadow_sorted_reference(structure, cfg, fields, tables, r,
                                      shadow_order(r, lo, hi)) for r in tr.rec]
    shadow = (torch.stack(shadow) if shadow
              else tr.track.new_zeros((0, 2, height, width)))
    return shade_planes_reference(structure, cfg, cam, fields, tables, tr.track, shadow,
                                  height, width, full_height)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def library(cfg: RenderConfig, structure: SceneStructure) -> _build.Library:
    """The built K9 library for this config and structure (compiled at
    first use, then loaded from the build cache); structures that differ
    only in their sphere count or material ids share one source."""
    built = _build.build(generate_regroup_source(structure, cfg), "regroup")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tables = [ptr] * 4 + [i32] * 2
    march = [ptr, ptr] + tables + [ptr] * 3 + [i32] * 3
    shadow = [ptr] + tables + [ptr] * 3  # fields, tables, rec, perm, out
    shade = [ptr, ptr] + tables + [ptr] * 3 + [i32] * 3
    argtypes = {
        RG_MARCH: march + GRID_ARGTYPES + [ptr],
        RG_MARCH_WALK: march + [ptr],
        RG_SHADOW: shadow + [i64] + GRID_ARGTYPES + [ptr],
        RG_SHADOW_WALK: shadow + [i64, ptr],
        RG_SHADOW_STATS: shadow + [ptr, i64, ptr],
        RG_SHADOW_GRID_STATS: shadow + [ptr, i64] + GRID_ARGTYPES + [ptr],
        RG_SHADE: shade + GRID_ARGTYPES + [ptr],
        RG_SHADE_WALK: shade + [ptr],
        RG_SHADE_STATS: shade + GRID_ARGTYPES + [ptr],
    }
    for name, args in argtypes.items():
        fn = getattr(built.lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return built


def _table_args(tables: InstancedTables):
    return [tables.spheres.data_ptr(), tables.ids.data_ptr(), tables.groups.data_ptr(),
            tables.bbox.data_ptr(), tables.spheres.shape[0], tables.groups.shape[0]]


def _launch(cfg, structure, name, device, *args):
    fn = getattr(library(cfg, structure).lib, name)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1


def _check_frame(structure, cam, fields, tables, height, width, full_height):
    _check("cam", cam, (CAM_SIZE,))
    _check("fields", fields, (packed_size(structure),))
    _check_tables(structure, tables, cam.device)
    if cam.device != fields.device:
        raise ValueError(f"cam on {cam.device}, fields on {fields.device}")
    if height <= 0 or width <= 0 or full_height < height:
        raise ValueError(f"bad image size {height}x{width} of {full_height} rows")


def _search(name: str, walk_name: str, cfg: RenderConfig, tables: InstancedTables,
            grid: Optional[CellGrid], walk: bool, device, stats=None,
            stats_name: Optional[str] = None) -> tuple:
    """(entry, its grid arguments) of a launch on `device`: the grid entry
    over `grid` (built now from the tables when None), its counting twin
    `stats_name` when `stats` (int64 [3]) is given, or with `walk` its
    run-walk twin."""
    if walk:
        return walk_name, ()
    grid = grid_for(tables, cfg.step_clamp) if grid is None else grid
    check_grid(grid, device, stats)
    return (name if stats is None else stats_name), grid_args(grid, stats)


def march_track(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    height: int, width: int, full_height: Optional[int] = None,
    grid: Optional[CellGrid] = None, walk: bool = False,
) -> Track:
    """lol_rg_march for CUDA tensors, searching `grid` (default:
    `cell_grid.grid_for(tables, cfg.step_clamp)`, built now) or with `walk`
    the run walk alone (lol_rg_march_walk); march_track_reference for CPU
    ones. A grid on another device than the tensors raises."""
    require_instanced(structure)
    full_height = full_height or height
    if grid is not None:
        check_grid(grid, cam.device)
    if resolve_backend(cam, fields, *tables) == "torch":
        return march_track_reference(structure, cfg, cam, fields, tables, height, width,
                                     full_height)
    _check_frame(structure, cam, fields, tables, height, width, full_height)
    name, index = _search(RG_MARCH, RG_MARCH_WALK, cfg, tables, grid, walk, cam.device)
    kw = dict(dtype=torch.float32, device=cam.device)
    out = Track(torch.empty((3, height, width), **kw), torch.empty((3, height, width), **kw),
                torch.empty((structure.num_lights, RECORD, height, width), **kw))
    _launch(cfg, structure, name, cam.device, cam.data_ptr(), fields.data_ptr(),
            *_table_args(tables), *(t.data_ptr() for t in out), height, full_height, width,
            *index)
    return out


def _check_shadow(structure, fields, tables, rec_l, perm) -> int:
    """Checks lol_rg_shadow's inputs; returns the record count n."""
    n = rec_l[0].numel()
    _check("rec", rec_l, (RECORD,) + tuple(rec_l.shape[1:]))
    _check_tables(structure, tables, rec_l.device)
    _check("fields", fields, (packed_size(structure),))
    if perm.dtype != torch.int64 or tuple(perm.shape) != (n,) or not perm.is_contiguous() \
            or perm.device != rec_l.device:
        raise ValueError(f"perm: want contiguous int64 ({n},) on {rec_l.device}, got "
                         f"{perm.dtype} {tuple(perm.shape)} on {perm.device}")
    return n


def shadow_sorted(
    structure: SceneStructure, cfg: RenderConfig, fields, tables: InstancedTables,
    rec_l: torch.Tensor, perm: torch.Tensor, out: Optional[torch.Tensor] = None,
    grid: Optional[CellGrid] = None, walk: bool = False,
) -> torch.Tensor:
    """lol_rg_shadow for CUDA tensors (into `out` [2, ...] when given), one
    light's records rec_l [7, ...] in the order perm [n] (int64), searching
    `grid` (default: built now, as march_track's) or with `walk` the run
    walk alone (lol_rg_shadow_walk); shadow_sorted_reference for CPU ones.
    A grid on another device than the records raises."""
    require_instanced(structure)
    if grid is not None:
        check_grid(grid, rec_l.device)
    if resolve_backend(fields, rec_l, perm, *tables) == "torch":
        res = shadow_sorted_reference(structure, cfg, fields, tables, rec_l, perm)
        return res if out is None else out.copy_(res)
    n = _check_shadow(structure, fields, tables, rec_l, perm)
    name, index = _search(RG_SHADOW, RG_SHADOW_WALK, cfg, tables, grid, walk, rec_l.device)
    if out is None:
        out = torch.empty((2,) + tuple(rec_l.shape[1:]), dtype=torch.float32,
                          device=rec_l.device)
    _check("out", out, (2,) + tuple(rec_l.shape[1:]))
    _launch(cfg, structure, name, rec_l.device, fields.data_ptr(),
            *_table_args(tables), rec_l.data_ptr(), perm.data_ptr(), out.data_ptr(), n, *index)
    return out


def shade_planes(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    track: torch.Tensor, shadow: torch.Tensor, height: int, width: int,
    full_height: Optional[int] = None, grid: Optional[CellGrid] = None,
    walk: bool = False, stats: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """lol_rg_shade for CUDA tensors, shade_planes_reference for CPU ones:
    the image [height, W, 3] from the frozen planes. On CUDA it searches
    `grid` (default: built now, as march_track's), or with `walk` the run
    walk alone (lol_rg_shade_walk); `stats` (int64 [3] on the device)
    takes the grid search's counts (lol_rg_shade_stats): searches,
    fallbacks, list entries read. A grid on another device than the
    tensors raises."""
    require_instanced(structure)
    full_height = full_height or height
    if grid is not None:
        check_grid(grid, cam.device)
    if resolve_backend(cam, fields, track, shadow, *tables) == "torch":
        return shade_planes_reference(structure, cfg, cam, fields, tables, track, shadow,
                                      height, width, full_height)
    _check_frame(structure, cam, fields, tables, height, width, full_height)
    _check("track", track, (3, height, width))
    _check("shadow", shadow, (structure.num_lights, 2, height, width))
    name, index = _search(RG_SHADE, RG_SHADE_WALK, cfg, tables, grid, walk, cam.device, stats,
                          RG_SHADE_STATS)
    img = torch.empty((height, width, 3), dtype=torch.float32, device=cam.device)
    _launch(cfg, structure, name, cam.device, cam.data_ptr(), fields.data_ptr(),
            *_table_args(tables), track.data_ptr(), shadow.data_ptr(), img.data_ptr(),
            height, full_height, width, *index)
    return img


def regrouped_forward(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    height: int, width: int, full_height: Optional[int] = None,
) -> torch.Tensor:
    """The regrouped frame [height, W, 3] (module docstring): the cell grid,
    lol_rg_march over it, per light the Morton sort and lol_rg_shadow over
    the same grid, and lol_rg_shade over it too, for CUDA tensors;
    regrouped_forward_reference for CPU ones."""
    require_instanced(structure)
    full_height = full_height or height
    if resolve_backend(cam, fields, *tables) == "torch":
        return regrouped_forward_reference(structure, cfg, cam, fields, tables, height, width,
                                           full_height)
    grid = grid_for(tables, cfg.step_clamp)  # one grid a frame, for K9a, every K9b and K9c
    tr = march_track(structure, cfg, cam, fields, tables, height, width, full_height, grid=grid)
    lo, hi = hit_box(tr.hitp)
    shadow = torch.empty((structure.num_lights, 2, height, width), dtype=torch.float32,
                         device=cam.device)
    for li in range(structure.num_lights):
        shadow_sorted(structure, cfg, fields, tables, tr.rec[li],
                      shadow_order(tr.rec[li], lo, hi), out=shadow[li], grid=grid)
    return shade_planes(structure, cfg, cam, fields, tables, tr.track, shadow, height, width,
                        full_height, grid=grid)


def make_instanced_renderer_regrouped(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device="cuda",
    full_height: Optional[int] = None,
    with_row_offset: bool = False,
):
    """`params -> [H, W, 3] f32` through the regrouped pipeline, with the
    contract of `cuda_renderer.make_instanced_renderer`: the tables packed
    once per call, the kernels on a CUDA device (the plain versions on the
    CPU). With `with_row_offset`, `(params, row0) -> [H, W, 3]` renders
    rows row0.. of an image `full_height` rows tall (the JAX package's).
    Raises for a non-instanced structure and for CUDA without CUDA."""
    require_instanced(structure)
    device = resolve_device(device, "make_instanced_renderer_regrouped")
    fh = full_height or height

    def render(params: SceneParams, row0) -> torch.Tensor:
        params = params_to(params, device=device, dtype=torch.float32)
        cam = camera_pack(params, fh, width, cfg, row0)
        fields = pack_fields(structure, params)
        tables = pack_instanced(structure, params)
        return regrouped_forward(structure, cfg, cam, fields, tables, height, width, fh)

    if with_row_offset:
        return render
    return lambda params: render(params, 0.0)


# --------------------------------------------------------------------------
# the measurement of the sort
# --------------------------------------------------------------------------


def _by_warp(x: torch.Tensor) -> torch.Tensor:
    """[n] per-thread values -> [warps, 32], the last warp padded with 0."""
    return torch.cat([x, x.new_zeros(-x.numel() % WARP)]).reshape(-1, WARP)


def warp_stats(stats: torch.Tensor) -> Dict[str, float]:
    """The sort's numbers from a walk stats launch's per-thread counts
    stats [3, n] (threads in record order, a warp = 32 consecutive threads;
    the last warp may be short): per ray the mean shadow evaluations; per
    warp the worst lane's count, whose mean over the mean per ray is the
    warp's lock-step cost (1 = no waste); per evaluation the runs of
    spheres a ray reaches, against the distinct runs its warp reaches per
    warp step."""
    evals, lane, warp = (s.double() for s in stats)
    ev, wr = _by_warp(evals), _by_warp(warp)
    worst, lead = ev.max(dim=1)
    # the worst lane is active at every step of its warp, so its warp count
    # sums the warp's distinct runs over all the warp's steps
    warp_runs = wr.gather(1, lead[:, None])[:, 0]
    return {
        "rays": evals.numel(),
        "warps": ev.shape[0],
        "evals_per_ray": float(evals.mean()),
        "worst_lane_evals_per_warp": float(worst.mean()),
        "warp_efficiency": float(evals.mean() / worst.mean()),
        "runs_per_ray_eval": float(lane.sum() / evals.sum()),
        "runs_per_warp_step": float(warp_runs.sum() / worst.sum()),
    }


def grid_warp_stats(stats: torch.Tensor) -> Dict[str, float]:
    """The grid search's numbers from a grid stats launch's per-thread
    counts stats [5, n] (searches, fallbacks, list entries read, distinct
    lists of the warp summed over its steps, steps in one list; threads in
    record order as warp_stats'): per ray the searches (the shadow
    evaluations); the share that fell back to the run walk; entries read
    per search; the worst lane's searches per warp and the lock-step cost;
    per warp step the distinct lists over the active lanes and the share of
    steps whose lanes all searched one list (read at the worst lane, which
    is active at every step of its warp)."""
    search, fall, read, lists, one = (s.double() for s in stats)
    sw = _by_warp(search)
    worst, lead = sw.max(dim=1)

    def at_lead(x):
        return _by_warp(x).gather(1, lead[:, None])[:, 0].sum()

    return {
        "rays": search.numel(),
        "warps": sw.shape[0],
        "searches_per_ray": float(search.mean()),
        "fallback_share": float(fall.sum() / search.sum()),
        "entries_per_search": float(read.sum() / search.sum()),
        "worst_lane_searches_per_warp": float(worst.mean()),
        "warp_efficiency": float(search.mean() / worst.mean()),
        "lists_per_warp_step": float(at_lead(lists) / worst.sum()),
        "one_list_share": float(at_lead(one) / worst.sum()),
    }


def _shadow_stats(structure, cfg, fields, tables, rec_l, perm, grid=None) -> torch.Tensor:
    """A stats launch over CUDA tensors: lol_rg_shadow with per-thread
    counts in record order, f32: over the run walk (grid None,
    lol_rg_shadow_stats; csrc/regroup.cuh CountingScene) [3, n]:
    evaluations, runs within reach summed over them, distinct such runs of
    the warp summed over them; over `grid` (lol_rg_shadow_grid_stats,
    GridCountingScene) [5, n], as grid_warp_stats reads them."""
    n = _check_shadow(structure, fields, tables, rec_l, perm)
    res = torch.empty((2,) + tuple(rec_l.shape[1:]), dtype=torch.float32, device=rec_l.device)
    stats = torch.empty((3 if grid is None else 5, n), dtype=torch.float32,
                        device=rec_l.device)
    if grid is not None:
        check_grid(grid, rec_l.device)
    name, index = ((RG_SHADOW_STATS, ()) if grid is None
                   else (RG_SHADOW_GRID_STATS, grid_args(grid)))
    _launch(cfg, structure, name, rec_l.device, fields.data_ptr(), *_table_args(tables),
            rec_l.data_ptr(), perm.data_ptr(), res.data_ptr(), stats.data_ptr(), n, *index)
    return stats


def shadow_gather_stats(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    light: int = 0,
    sort: bool = True,
    device="cuda",
    walk: bool = False,
) -> Dict:
    """What the Morton sort does to light `light`'s shadow rays at this
    size: the frame's records from lol_rg_march, ordered by the sort (or
    in pixel order without it), marched by a stats launch of lol_rg_shadow
    over the frame's cell grid (`grid_warp_stats`' keys) or, with `walk`,
    over the run walk (`warp_stats`' keys). The JAX package's keys (scratch
    rows gathered, overflow, pre-lit fraction: its scratch gather and
    segment cull) do not exist on this card, whose kernels have neither;
    "sorted" and "tiles" (here: warps) keep their meaning. The counts run
    on the card only: `device` must be a CUDA device."""
    require_instanced(structure)
    device = resolve_device(device, "shadow_gather_stats")
    if device.type != "cuda":
        raise ValueError("shadow_gather_stats counts in a launch of lol_rg_shadow on the card: "
                         "pass a CUDA device")
    params = params_to(params, device=device, dtype=torch.float32)
    cam = camera_pack(params, height, width, cfg)
    fields, tables = pack_fields(structure, params), pack_instanced(structure, params)
    grid = grid_for(tables, cfg.step_clamp)
    tr = march_track(structure, cfg, cam, fields, tables, height, width, grid=grid)
    lo, hi = hit_box(tr.hitp)
    perm = shadow_order(tr.rec[light], lo, hi, sort)
    if walk:
        out = warp_stats(_shadow_stats(structure, cfg, fields, tables, tr.rec[light], perm))
    else:
        out = grid_warp_stats(_shadow_stats(structure, cfg, fields, tables, tr.rec[light],
                                            perm, grid))
    out.update(sorted=sort, tiles=out["warps"], light=light, search="walk" if walk else "grid")
    return out
