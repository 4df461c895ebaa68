"""The regrouped instanced forward render K9: hand-written CUDA kernels and
their plain PyTorch versions (`loltracer_tpu/render/pallas_regroup.py`).

The fused instanced kernel K5 marches each pixel's shadow rays from that
pixel's hit point, so a warp's shadow rays start wherever its 8x4 pixel
tile's hit points lie. Here the forward render is split into three kernels
with a sort in between (csrc/regroup.cuh):

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
  over the frozen planes -> the image [H, W, 3].

Each value depends only on its own pixel's ray, so the image is bitwise
K5's (`lol_instanced_render`); the sort buys only locality.

`make_instanced_renderer_regrouped` is the entry point, with the contract
of `cuda_renderer.make_instanced_renderer`. On CPU tensors every piece
takes its plain version (`march_track_reference`, `shadow_sorted_reference`,
`shade_planes_reference`, `regrouped_forward_reference`), built from the
plain instanced SDF and loops with the expressions of render_rays, so the
plain pipeline is bitwise `instanced_fwd.instanced_forward_reference`.

`shadow_gather_stats` measures what the sort does to one light's shadow
rays, counted in a stats launch of lol_rg_shadow on the card.

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
from loltracer_tpu_torch.render.cuda_scene import (
    RG_MARCH,
    RG_SHADE,
    RG_SHADOW,
    RG_SHADOW_STATS,
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

launches = {RG_MARCH: 0, RG_SHADOW: 0, RG_SHADE: 0, RG_SHADOW_STATS: 0}

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
    argtypes = {
        RG_MARCH: [ptr, ptr] + tables + [ptr] * 3 + [i32] * 3 + [ptr],
        RG_SHADOW: [ptr] + tables + [ptr] * 3 + [i64, ptr],
        RG_SHADOW_STATS: [ptr] + tables + [ptr] * 4 + [i64, ptr],
        RG_SHADE: [ptr, ptr] + tables + [ptr] * 3 + [i32] * 3 + [ptr],
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


def march_track(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    height: int, width: int, full_height: Optional[int] = None,
) -> Track:
    """lol_rg_march for CUDA tensors, march_track_reference for CPU ones."""
    require_instanced(structure)
    full_height = full_height or height
    if resolve_backend(cam, fields, *tables) == "torch":
        return march_track_reference(structure, cfg, cam, fields, tables, height, width,
                                     full_height)
    _check_frame(structure, cam, fields, tables, height, width, full_height)
    kw = dict(dtype=torch.float32, device=cam.device)
    out = Track(torch.empty((3, height, width), **kw), torch.empty((3, height, width), **kw),
                torch.empty((structure.num_lights, RECORD, height, width), **kw))
    _launch(cfg, structure, RG_MARCH, cam.device, cam.data_ptr(), fields.data_ptr(),
            *_table_args(tables), *(t.data_ptr() for t in out), height, full_height, width)
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
) -> torch.Tensor:
    """lol_rg_shadow for CUDA tensors (into `out` [2, ...] when given), one
    light's records rec_l [7, ...] in the order perm [n] (int64);
    shadow_sorted_reference for CPU ones."""
    require_instanced(structure)
    if resolve_backend(fields, rec_l, perm, *tables) == "torch":
        res = shadow_sorted_reference(structure, cfg, fields, tables, rec_l, perm)
        return res if out is None else out.copy_(res)
    n = _check_shadow(structure, fields, tables, rec_l, perm)
    if out is None:
        out = torch.empty((2,) + tuple(rec_l.shape[1:]), dtype=torch.float32,
                          device=rec_l.device)
    _check("out", out, (2,) + tuple(rec_l.shape[1:]))
    _launch(cfg, structure, RG_SHADOW, rec_l.device, fields.data_ptr(),
            *_table_args(tables), rec_l.data_ptr(), perm.data_ptr(), out.data_ptr(), n)
    return out


def shade_planes(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    track: torch.Tensor, shadow: torch.Tensor, height: int, width: int,
    full_height: Optional[int] = None,
) -> torch.Tensor:
    """lol_rg_shade for CUDA tensors, shade_planes_reference for CPU ones:
    the image [height, W, 3] from the frozen planes."""
    require_instanced(structure)
    full_height = full_height or height
    if resolve_backend(cam, fields, track, shadow, *tables) == "torch":
        return shade_planes_reference(structure, cfg, cam, fields, tables, track, shadow,
                                      height, width, full_height)
    _check_frame(structure, cam, fields, tables, height, width, full_height)
    _check("track", track, (3, height, width))
    _check("shadow", shadow, (structure.num_lights, 2, height, width))
    img = torch.empty((height, width, 3), dtype=torch.float32, device=cam.device)
    _launch(cfg, structure, RG_SHADE, cam.device, cam.data_ptr(), fields.data_ptr(),
            *_table_args(tables), track.data_ptr(), shadow.data_ptr(), img.data_ptr(),
            height, full_height, width)
    return img


def regrouped_forward(
    structure: SceneStructure, cfg: RenderConfig, cam, fields, tables: InstancedTables,
    height: int, width: int, full_height: Optional[int] = None,
) -> torch.Tensor:
    """The regrouped frame [height, W, 3] (module docstring): lol_rg_march,
    per light the Morton sort and lol_rg_shadow, lol_rg_shade for CUDA
    tensors; regrouped_forward_reference for CPU ones."""
    require_instanced(structure)
    full_height = full_height or height
    if resolve_backend(cam, fields, *tables) == "torch":
        return regrouped_forward_reference(structure, cfg, cam, fields, tables, height, width,
                                           full_height)
    tr = march_track(structure, cfg, cam, fields, tables, height, width, full_height)
    lo, hi = hit_box(tr.hitp)
    shadow = torch.empty((structure.num_lights, 2, height, width), dtype=torch.float32,
                         device=cam.device)
    for li in range(structure.num_lights):
        shadow_sorted(structure, cfg, fields, tables, tr.rec[li],
                      shadow_order(tr.rec[li], lo, hi), out=shadow[li])
    return shade_planes(structure, cfg, cam, fields, tables, tr.track, shadow, height, width,
                        full_height)


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


def warp_stats(stats: torch.Tensor) -> Dict[str, float]:
    """The sort's numbers from a stats launch's per-thread counts stats [3,
    n] (threads in record order, a warp = 32 consecutive threads; the last
    warp may be short): per ray the mean shadow evaluations; per warp the
    worst lane's count, whose mean over the mean per ray is the warp's
    lock-step cost (1 = no waste); per evaluation the runs of spheres a ray
    reaches, against the distinct runs its warp reaches per warp step."""
    evals, lane, warp = (s.double() for s in stats)
    n = evals.numel()
    pad = -n % WARP
    ev = torch.cat([evals, evals.new_zeros(pad)]).reshape(-1, WARP)
    wr = torch.cat([warp, warp.new_zeros(pad)]).reshape(-1, WARP)
    worst, lead = ev.max(dim=1)
    # the worst lane is active at every step of its warp, so its warp count
    # sums the warp's distinct runs over all the warp's steps
    warp_runs = wr.gather(1, lead[:, None])[:, 0]
    return {
        "rays": n,
        "warps": ev.shape[0],
        "evals_per_ray": float(evals.mean()),
        "worst_lane_evals_per_warp": float(worst.mean()),
        "warp_efficiency": float(evals.mean() / worst.mean()),
        "runs_per_ray_eval": float(lane.sum() / evals.sum()),
        "runs_per_warp_step": float(warp_runs.sum() / worst.sum()),
    }


def _shadow_stats(structure, cfg, fields, tables, rec_l, perm) -> torch.Tensor:
    """The stats launch lol_rg_shadow_stats over CUDA tensors: lol_rg_shadow
    with per-thread counts [3, n] f32 in record order: evaluations, runs
    within reach summed over them, distinct such runs of the warp summed
    over them (csrc/regroup.cuh CountingScene)."""
    n = _check_shadow(structure, fields, tables, rec_l, perm)
    res = torch.empty((2,) + tuple(rec_l.shape[1:]), dtype=torch.float32, device=rec_l.device)
    stats = torch.empty((3, n), dtype=torch.float32, device=rec_l.device)
    _launch(cfg, structure, RG_SHADOW_STATS, rec_l.device, fields.data_ptr(),
            *_table_args(tables), rec_l.data_ptr(), perm.data_ptr(), res.data_ptr(),
            stats.data_ptr(), n)
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
) -> Dict:
    """What the Morton sort does to light `light`'s shadow rays at this
    size: the frame's records from lol_rg_march, ordered by the sort (or
    in pixel order without it), marched by a stats launch of lol_rg_shadow
    (`warp_stats`' keys). The JAX package's keys (scratch rows gathered,
    overflow, pre-lit fraction: its scratch gather and segment cull) do
    not exist on this card, whose kernels have neither; "sorted" and
    "tiles" (here: warps) keep their meaning. The counts run on the card
    only: `device` must be a CUDA device."""
    require_instanced(structure)
    device = resolve_device(device, "shadow_gather_stats")
    if device.type != "cuda":
        raise ValueError("shadow_gather_stats counts in a launch of lol_rg_shadow on the card: "
                         "pass a CUDA device")
    params = params_to(params, device=device, dtype=torch.float32)
    cam = camera_pack(params, height, width, cfg)
    fields, tables = pack_fields(structure, params), pack_instanced(structure, params)
    tr = march_track(structure, cfg, cam, fields, tables, height, width)
    lo, hi = hit_box(tr.hitp)
    perm = shadow_order(tr.rec[light], lo, hi, sort)
    out = warp_stats(_shadow_stats(structure, cfg, fields, tables, tr.rec[light], perm))
    out.update(sorted=sort, tiles=out["warps"], light=light)
    return out
