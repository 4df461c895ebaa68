"""The value march kernels K3 and K4: hand-written CUDA kernels and their
plain PyTorch versions (`loltracer_tpu/render/pallas_march.py`).

The differentiable renderer freezes its march and, for envelope shadows,
its shadow marches, and re-attaches every gradient outside them
(render/march.py `intersect_aa`, render/shading.py `envelope_reattach`).
So the two loops are value functions, and on CUDA tensors they run here:

- `march_values(structure, cfg, ro, rd, scene)` -> `MarchResult` of
  [...] planes (t, t_query, s_min, t_close): `lol_march` on the compiled
  `Scene`, `lol_march_instanced` on the `InstancedScene` (K3, csrc/march.cuh;
  the closest approach is always tracked, as the Pallas kernel does);
- `shadow_values(structure, cfg, ro, rd, max_dist, scene)` -> (res, t*):
  `lol_shadow_march` / `lol_shadow_march_instanced` (K4); on a compiled
  structure under cfg.shadow_cull it skips the march of a ray that the
  segment bound proves lit (res = 1, t* = 0, as the Pallas kernel's
  init_done lanes), and `shadow_cull=False` launches its twin without the
  cull (a library of its own: the bitwise check);
- the compiled pair runs each warp over an 8 x 4 tile of the caller's
  [rows, width] batch;
- the instanced pair marches each ray with a group of `lanes_for(n,
  SMs, shadow)` lanes of a warp (csrc/coop_march.cuh; 1 is one thread a
  ray), a width chosen per launch from the kernel, its ray count and the
  card's SM count;
  `lanes=` of march_values / shadow_values names one of
  cuda_scene.MARCH_LANES instead (to sweep and check the widths);
- `make_cuda_march` / `make_cuda_shadow_march` return the `march_fn` /
  `shadow_fn` that render/torch_renderer.py hands to the renderer (the
  counterparts of `make_pallas_march` / `make_pallas_shadow_march`);
- `make_cuda_exact_shadow(structure, cfg)` returns the `shadow_fn` of the
  "exact" estimator on a compiled structure, differentiable: `ExactShadow`,
  whose forward is K4x (`lol_exact_shadow`: K4's march and cull, res alone,
  bitwise the plain loop's) and whose backward is K4xb
  (`lol_exact_shadow_bwd`: the march again and the reverse sweep, with K2's
  fixed-order reduce of the geometry's gradient), csrc/exact_shadow.cuh, a
  library of its own (`exact_library`) built at the first exact call on
  CUDA. Its plain versions: `shadow_values_reference`'s res, and
  `exact_shadow_reference`, the same reverse sweep in torch ops.

- `make_instanced_eval(structure, cfg)` -> `eval_fn(tables, plane_y, p,
  grid=None)`: K7, `lol_instanced_eval` (csrc/march.cuh), the instanced
  distance under cfg.step_clamp at points p [..., 3] over the value-only
  tables of `pack_eval_tables` (whose AABB the caller may replace: the
  object-sharded renderer, parallel/objects.py, passes the one combined
  over its object axis) and their cell grid (render/cell_grid.py; built
  per call unless given: the renderer builds one per frame); its plain
  version is `instanced_eval_reference`.

ro is one origin [3] or one per ray [..., 3]; rd [..., 3]; any batch shape,
flattened for the kernel (its last dimension is the kernel's tile width).
`scene` is the `MarchScene` of `pack_march_scene`: the packed buffer and,
for instanced structures, the sphere tables (render/instanced_pack.py),
built once per render and shared by every march of it.

A wrapper given CUDA tensors checks them (CUDA, float32, contiguous,
shape, one device) in one pass, launches its kernel or raises; nothing
falls back. The library entry and the packed size it checks against are
resolved once per structure and config (`_entry`; `make_cuda_march` and
`make_cuda_shadow_march` hold theirs), not per call. CPU tensors take the
plain versions, `march_values_reference`, `shadow_values_reference` and
`exact_shadow_reference`:
render/march.py `march` and render/shading.py `shadow_march` (started
done where shading.segment_lit culls, as the kernel skips) under
`no_grad`; `instanced_eval_reference` for K7. `launches` counts kernel
launches per entry point; the plain versions never add to it. K3 and K4
share one library per structure and march config, built at first use; K7
has one per step clamp and plane count.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.backend import resolve_backend
from loltracer_tpu_torch.render.cell_grid import CellGrid, check_grid, grid_args, grid_for
from loltracer_tpu_torch.render.cuda_scene import (
    EXACT_SHADOW,
    EXACT_SHADOW_BLOCKS,
    EXACT_SHADOW_BWD,
    EXACT_SHADOW_SCRATCH,
    GRID_ARGTYPES,
    INSTANCED_EVAL,
    INSTANCED_EVAL_STATS,
    INSTANCED_EVAL_WALK,
    MARCH,
    MARCH_INSTANCED,
    MARCH_LANES,
    SHADOW_MARCH,
    SHADOW_MARCH_INSTANCED,
    generate_eval_source,
    generate_exact_shadow_source,
    generate_march_source,
    geom_size,
    pack_fields,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.fused_fwd import _check
from loltracer_tpu_torch.render.instanced_fwd import _check_tables
from loltracer_tpu_torch.render.instanced_pack import (
    GROUP,
    InstancedTables,
    group_bounds,
    pack_instanced,
    pack_order,
    real_sphere_bbox,
    soa_spheres,
)
from loltracer_tpu_torch.render.march import MarchResult, march
from loltracer_tpu_torch.render.sdf import bbox_cut, make_scene_sdf
from loltracer_tpu_torch.render.shading import segment_lit, shadow_march
from loltracer_tpu_torch.scene import (
    SceneParams,
    SceneStructure,
    require_compiled,
    require_instanced,
)

__all__ = [
    "EvalTables",
    "ExactShadow",
    "MarchScene",
    "eval_library",
    "exact_library",
    "exact_shadow_reference",
    "instanced_eval_reference",
    "lanes_for",
    "launches",
    "library",
    "make_cuda_exact_shadow",
    "make_cuda_march",
    "make_cuda_shadow_march",
    "make_instanced_eval",
    "march_values",
    "march_values_reference",
    "pack_eval_tables",
    "pack_march_scene",
    "shadow_values",
    "shadow_values_reference",
]

launches = {MARCH: 0, SHADOW_MARCH: 0, MARCH_INSTANCED: 0, SHADOW_MARCH_INSTANCED: 0,
            INSTANCED_EVAL: 0, EXACT_SHADOW: 0, EXACT_SHADOW_BWD: 0}

# the most rows of a 2-D launch grid (grid.y < 65536 blocks of up to 16 rows)
_MAX_ROWS = 65535 * 8


class MarchScene(NamedTuple):
    """What the kernels read of the scene: the packed buffer
    (cuda_scene.pack_fields) and, for instanced structures, the sphere
    tables (instanced_pack.pack_instanced); detached."""

    fields: torch.Tensor
    tables: Optional[InstancedTables]


def pack_march_scene(structure: SceneStructure, params: SceneParams) -> MarchScene:
    """The kernels' view of params, detached, f32, on the params' device."""
    with torch.no_grad():
        fields = pack_fields(structure, params)
        tables = pack_instanced(structure, params) if structure.instanced else None
    return MarchScene(fields, tables)


def _scene_params(structure: SceneStructure, scene: MarchScene) -> SceneParams:
    """SceneParams of a MarchScene (the spheres back in SoA order); the
    camera fields, which no march reads, are zeros."""
    fields = unpack_fields(structure, scene.fields)
    if scene.tables is not None:
        pos, rad = soa_spheres(structure, scene.tables)
        fields.update(sphere_point=pos, sphere_radius=rad)
    zero = scene.fields.new_zeros(3)
    return SceneParams(**fields, cam_point=zero, cam_direction=zero, cam_fov=zero[0])


def march_values_reference(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, scene: MarchScene,
    live: Optional[List[int]] = None, counts: Optional[torch.Tensor] = None,
) -> MarchResult:
    """The plain version of K3: march.march over the scene's SDF (under
    cfg.step_clamp for instanced structures), without autograd. `live`,
    if a list, gets the rays still marching at each step: the SDF
    evaluations a thread per ray makes; `counts`, an integer tensor of the
    batch's shape, each ray's evaluations."""
    clamp = cfg.step_clamp if structure.instanced else None
    with torch.no_grad():
        return march(make_scene_sdf(structure, clamp), _scene_params(structure, scene),
                     ro, rd, cfg, live, counts=counts)


def shadow_values_reference(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, max_dist, scene: MarchScene,
    live: Optional[List[int]] = None, counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K4: shading.shadow_march over the scene's SDF
    (under the shadow step clamp for instanced structures), without
    autograd; on a compiled structure under cfg.shadow_cull the rays
    shading.segment_lit marks start done (res = 1, t* = 0), as the kernel
    and the Pallas kernel skip them. Returns (res, t*). `live` and `counts`
    as for march_values_reference."""
    clamp = cfg.effective_shadow_clamp() if structure.instanced else None
    with torch.no_grad():
        params = _scene_params(structure, scene)
        lit = None
        if cfg.shadow_cull and not structure.instanced:
            lit = segment_lit(structure, params, ro, rd, max_dist, cfg.shadow_w)
        return shadow_march(make_scene_sdf(structure, clamp), params, ro, rd, max_dist, cfg,
                            live, init_done=lit, counts=counts)


def exact_shadow_reference(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, max_dist, fields, g_res,
    sum_dtype: Optional[torch.dtype] = None, mass: Optional[list] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K4xb: (g_ro [..., 3], g_rd [..., 3], g_fields
    [packed_size]), the cotangents of the exact shadow's res for g_res
    [...] (rays ro, rd [..., 3] up to max_dist [...], one batch shape,
    through the packed buffer `fields`), by the kernel's reverse sweep in
    torch ops: the march
    again without autograd, keeping each step's live rays, t, running
    minimum and value, then from the last step back to step 0 torch.minimum's
    rule (a tie splits), the quotient's two terms where t > 0, each step's
    SDF adjoint (a vector-Jacobian product of one evaluation, for the rays
    whose distance gets a nonzero cotangent) and the point's cotangent to
    ro, rd and t. Rays with g_res == 0 and, under cfg.shadow_cull, the rays
    shading.segment_lit marks start done and get zeros, as the kernel skips
    them. With `sum_dtype` (torch.float64), g_fields is each ray's term of
    each step, computed alone in the rays' precision (torch.func.vmap of
    the adjoint), summed over rays and steps in sum_dtype: a total to hold
    the kernel's float32 sums against; `mass`, a list, then gets the sum
    of those terms' magnitudes [packed_size], the scale of their float32
    rounding."""
    require_compiled(structure)
    sdf = make_scene_sdf(structure)
    w = cfg.shadow_w
    inf = float("inf")
    with torch.no_grad():
        ro, rd, max_dist, fields, g_res = (x.detach() for x in (ro, rd, max_dist, fields, g_res))
        params = _scene_params(structure, MarchScene(fields, None))
        done = g_res == 0
        if cfg.shadow_cull:
            done = done | segment_lit(structure, params, ro, rd, max_dist, cfg.shadow_w)
        res = torch.ones_like(max_dist)
        t = torch.zeros_like(res)
        steps = []
        for _ in range(cfg.shadow_steps):
            if bool(done.all()):
                break
            d = sdf(params, ro + t[..., None] * rd)
            safe_t = torch.where(t > 0, t, 1.0)
            val = torch.where(t > 0, w * d / safe_t, torch.where(d < 0, -inf, inf))
            steps.append((~done, t, res, val))
            res = torch.where(done, res, torch.minimum(res, val))
            t = torch.where(done, t, t + d)
            done = done | (res < -1) | (t > max_dist)

        g_ro, g_rd = torch.zeros_like(ro), torch.zeros_like(rd)
        g_fields = torch.zeros_like(fields, dtype=sum_dtype)
        g_mass = torch.zeros_like(g_fields)
        g_min, g_t = g_res.clone(), torch.zeros_like(res)

        def adjoint(f, p, gd):  # one evaluation's g_d-weighted distance
            return sdf(_scene_params(structure, MarchScene(f, None)), p) * gd

        for live, t, r, val in reversed(steps):
            half = torch.where(r == val, 0.5 * g_min, 0.0)
            g_prev = torch.where(r < val, g_min, half)
            g_val = torch.where(val < r, g_min, half)
            pos = live & (t > 0)
            safe_t = torch.where(t > 0, t, 1.0)
            g_d = torch.where(live, g_t + torch.where(pos, g_val / safe_t * w, 0.0), 0.0)
            g_tk = g_t + torch.where(pos, -g_val * (val / safe_t), 0.0)
            sel = g_d != 0
            g_p = torch.zeros_like(rd)
            if bool(sel.any()):
                p = (ro + t[..., None] * rd)[sel]
                if sum_dtype is None:
                    with torch.enable_grad():
                        f = fields.clone().requires_grad_(True)
                        p = p.requires_grad_(True)
                        d = sdf(_scene_params(structure, MarchScene(f, None)), p)
                        gp_sel, gf = torch.autograd.grad(d, (p, f), g_d[sel])
                else:
                    gf, gp_sel = torch.func.vmap(torch.func.grad(adjoint, argnums=(0, 1)),
                                                 in_dims=(None, 0, 0))(fields, p, g_d[sel])
                    gf = gf.to(sum_dtype)
                    g_mass += gf.abs().sum(0)
                    gf = gf.sum(0)
                g_p[sel] = gp_sel
                g_fields += gf
            g_ro += g_p
            g_rd += t[..., None] * g_p
            g_tk = g_tk + (g_p * rd).sum(-1)
            g_min = torch.where(live, g_prev, g_min)
            g_t = torch.where(live, g_tk, g_t)
    if mass is not None:
        mass.append(g_mass)
    return g_ro, g_rd, g_fields


def kernel_config(structure: SceneStructure, cfg: RenderConfig) -> RenderConfig:
    """The part of cfg the march kernels compile in (step caps, tolerances,
    shadow sharpness; for compiled structures the shadow segment cull, for
    instanced ones the two step clamps); configs that agree on it share one
    library."""
    if structure.instanced:
        extra = dict(step_clamp=cfg.step_clamp, shadow_step_clamp=cfg.shadow_step_clamp)
    else:
        extra = dict(shadow_cull=cfg.shadow_cull)
    return RenderConfig(max_steps=cfg.max_steps, epsilon=cfg.epsilon, max_dist=cfg.max_dist,
                        shadow_steps=cfg.shadow_steps, shadow_w=cfg.shadow_w, **extra)


@functools.lru_cache(maxsize=None)
def _library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    built = _build.build(generate_march_source(structure, cfg), "march")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if structure.instanced:
        entries = {MARCH_INSTANCED: [ptr, i32] + [ptr] * 6 + [i32] * 2 + [ptr] + [i32] * 3 + [ptr],
                   SHADOW_MARCH_INSTANCED: [ptr, i32] + [ptr] * 7 + [i32] * 2 + [ptr]
                   + [i32] * 3 + [ptr]}
    else:
        entries = {MARCH: [ptr, i32, ptr, ptr, ptr, i32, i32, ptr],
                   SHADOW_MARCH: [ptr, i32] + [ptr] * 4 + [i32] * 2 + [ptr]}
    for name, args in entries.items():
        fn = getattr(built.lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return built


def library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    """The built K3 / K4 library for this structure and config (compiled at
    first use, then loaded from the build cache). Instanced structures
    that differ only in their sphere count share one source."""
    return _library(structure, kernel_config(structure, cfg))


def _layout(batch) -> Tuple[int, int]:
    """(rows, width) of a ray batch for the launch grid: the last batch
    dimension is the width, the rest the rows; one row when that has too
    many rows for the grid."""
    n = math.prod(batch)
    width = batch[-1] if len(batch) >= 2 else n
    rows = n // width
    return (rows, width) if rows <= _MAX_ROWS else (1, n)


# Rays per SM above which one thread a ray marches K4's shadow rays faster
# than a lane group: on the H100 (132 SMs) the two meet near half a 1080p
# frame, and over a full frame's shadow rays one thread a ray is the
# faster; K3's camera rays are faster in lane groups up to a full frame
# (chip_smoke.py phase 21 times both widths on a band, half a frame and a
# frame; PERF.md).
_SHADOW_RAYS_PER_SM = 8192


def lanes_for(n: int, sm_count: int, shadow: bool = False) -> int:
    """The lane-group width of an instanced march launch of n rays (K4's
    shadow rays if `shadow`, else K3's camera rays) on a card of sm_count
    SMs: one thread a ray for shadow launches of more than
    _SHADOW_RAYS_PER_SM rays per SM, else the widest group of
    MARCH_LANES. A 16-row 1080p band (30 720 rays) takes the group in both
    kernels; a full 1080p frame (2.07 M rays) the group in K3 and one thread
    a ray in K4."""
    if shadow and n > _SHADOW_RAYS_PER_SM * sm_count:
        return MARCH_LANES[0]
    return MARCH_LANES[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_options(structure: SceneStructure, lanes: Optional[int]) -> None:
    if lanes is not None:
        if not structure.instanced:
            raise ValueError("lanes= applies to instanced structures only")
        if lanes not in MARCH_LANES:
            raise ValueError(f"lanes={lanes}: the instanced marches are built for {MARCH_LANES}")


class _Entry(NamedTuple):
    """One K3 / K4 entry of a built library: its ctypes function, the
    `launches` key it counts under and the packed buffer's length it
    checks against."""

    fn: Callable
    name: str
    fields: int


@functools.lru_cache(maxsize=None)
def _entry(structure: SceneStructure, cfg: RenderConfig, shadow: bool) -> _Entry:
    """K4's entry (`shadow`) or K3's for this structure and cfg, resolved
    once: from library(structure, cfg), built at first use."""
    if structure.instanced:
        name = SHADOW_MARCH_INSTANCED if shadow else MARCH_INSTANCED
    else:
        name = SHADOW_MARCH if shadow else MARCH
    return _Entry(getattr(library(structure, cfg).lib, name), name, packed_size(structure))


def _check_rays(entry: _Entry, structure: SceneStructure, scene: MarchScene, ro, rd,
                max_dist) -> None:
    """One pass over a launch's tensors: rd, ro, max_dist and the packed
    buffer each float32, contiguous, of its shape and on rd's device, a
    CUDA one (and the instanced tables); raises naming the first that is
    not."""
    batch = rd.shape[:-1]
    dev = rd.device
    named = [("rd", rd, batch + (3,)), ("ro", ro, (3,) if ro.dim() == 1 else batch + (3,)),
             ("fields", scene.fields, (entry.fields,))]
    if max_dist is not None:
        named.append(("max_dist", max_dist, batch))
    for name, t, shape in named:
        if (t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != shape):
            _check(name, t, shape)
            raise ValueError("ro, rd, max_dist and the scene must be on one device")
    if dev.type != "cuda":
        _check("rd", rd, batch + (3,))
    if scene.tables is not None:
        _check_tables(structure, scene.tables, dev)


def _launch(entry: _Entry, structure: SceneStructure, scene: MarchScene, ro, rd, max_dist,
            planes: int, lanes: Optional[int] = None):
    """Checks the inputs, launches `entry` and returns its [planes, ...]
    output over rd's batch; instanced entries at `lanes` lanes a ray, or
    lanes_for's width."""
    _check_rays(entry, structure, scene, ro, rd, max_dist)
    batch = tuple(rd.shape[:-1])
    dev = rd.device
    n = rd.numel() // 3
    out = torch.empty((planes, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out.reshape((planes,) + batch)
    rows, width = _layout(batch)
    args = [ro.data_ptr(), 0 if ro.dim() == 1 else 3, rd.data_ptr()]
    if max_dist is not None:
        args.append(max_dist.data_ptr())
    args.append(scene.fields.data_ptr())
    tab = scene.tables
    if tab is not None:
        args += [tab.spheres.data_ptr(), tab.ids.data_ptr(), tab.groups.data_ptr(),
                 tab.bbox.data_ptr(), tab.spheres.shape[0], tab.groups.shape[0]]
    args += [out.data_ptr(), rows, width]
    if tab is not None:
        args.append(lanes or lanes_for(n, _sm_count(dev.index), max_dist is not None))
    if dev.index == torch.cuda.current_device():
        rc = entry.fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = entry.fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry.name} launch failed: cudaError {rc}")
    launches[entry.name] += 1
    return out.reshape((planes,) + batch)


def march_values(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, scene: MarchScene,
    *, lanes: Optional[int] = None,
) -> MarchResult:
    """K3 for CUDA tensors, march_values_reference for CPU tensors: the
    frozen march of rays ro [3] or [..., 3] along rd [..., 3]. `lanes`
    (instanced only): the kernel's lane-group width, else lanes_for's."""
    _check_options(structure, lanes)
    if resolve_backend(ro, rd, scene.fields) == "torch":
        return march_values_reference(structure, cfg, ro, rd, scene)
    entry = _entry(structure, cfg, False)
    return MarchResult(*_launch(entry, structure, scene, ro, rd, None, 4, lanes).unbind())


def shadow_values(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, max_dist, scene: MarchScene,
    *, lanes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 for CUDA tensors, shadow_values_reference for CPU tensors: (res,
    t*) of the shadow marches from ro [..., 3] along rd [..., 3] up to
    max_dist [...]. `lanes` as for march_values."""
    _check_options(structure, lanes)
    if resolve_backend(ro, rd, max_dist, scene.fields) == "torch":
        return shadow_values_reference(structure, cfg, ro, rd, max_dist, scene)
    entry = _entry(structure, cfg, True)
    return tuple(_launch(entry, structure, scene, ro, rd, max_dist, 2, lanes).unbind())


def _ray_batch(ro, rd, *per_ray):
    """ro kept as one origin [3] or broadcast to rd's batch, every tensor
    detached and contiguous (copies only where needed; a batch whose
    shapes already agree is not broadcast)."""
    batch = rd.shape[:-1]
    if not ((ro.dim() == 1 or ro.shape == rd.shape) and all(t.shape == batch for t in per_ray)):
        batch = torch.broadcast_shapes(ro.shape[:-1], batch, *(t.shape for t in per_ray))
        if ro.dim() != 1:
            ro = ro.expand(batch + (3,))
        rd = rd.expand(batch + (3,))
        per_ray = tuple(t.expand(batch) for t in per_ray)
    return [(t.detach() if t.requires_grad else t).contiguous() for t in (ro, rd, *per_ray)]


def _launcher(structure: SceneStructure, cfg: RenderConfig, shadow: bool) -> Callable:
    """`launch(scene, ro, rd[, max_dist])` over a ray batch of _ray_batch:
    K4 (`shadow`) or K3 on CUDA tensors, with the kernel's entry resolved
    at the first launch and kept; its plain version on CPU tensors."""
    entry: List[_Entry] = []
    reference = shadow_values_reference if shadow else march_values_reference

    def launch(scene: MarchScene, ro, rd, *max_dist):
        if resolve_backend(ro, rd, *max_dist, scene.fields) == "torch":
            return reference(structure, cfg, ro, rd, *max_dist, scene)
        if not entry:
            entry.append(_entry(structure, cfg, shadow))
        if shadow:
            return tuple(_launch(entry[0], structure, scene, ro, rd, max_dist[0], 2).unbind())
        return MarchResult(*_launch(entry[0], structure, scene, ro, rd, None, 4).unbind())

    return launch


def make_cuda_march(structure: SceneStructure, cfg: RenderConfig) -> Callable:
    """`march_fn(params, ro, rd, scene=None) -> MarchResult`: the frozen
    march through K3 (`pallas_march.make_pallas_march`). `scene` is a
    MarchScene of params packed once per render; without it the call
    packs its own. No output carries a gradient."""
    launch = _launcher(structure, cfg, shadow=False)

    def march_fn(params: SceneParams, ro, rd, scene: Optional[MarchScene] = None):
        if scene is None:
            scene = pack_march_scene(structure, params)
        return launch(scene, *_ray_batch(ro, rd))

    return march_fn


def make_cuda_shadow_march(structure: SceneStructure, cfg: RenderConfig) -> Callable:
    """`shadow_fn(params, ro, rd, max_dist, scene=None) -> (res, t*)`: the
    frozen shadow march through K4 (`make_pallas_shadow_march`)."""
    launch = _launcher(structure, cfg, shadow=True)

    def shadow_fn(params: SceneParams, ro, rd, max_dist, scene: Optional[MarchScene] = None):
        if scene is None:
            scene = pack_march_scene(structure, params)
        return launch(scene, *_ray_batch(ro, rd, max_dist))

    return shadow_fn


@functools.lru_cache(maxsize=None)
def _exact_library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    built = _build.build(generate_exact_shadow_source(structure, cfg), "exact_shadow")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args in ((EXACT_SHADOW, [ptr, i32] + [ptr] * 4 + [i32] * 2 + [ptr]),
                       (EXACT_SHADOW_BWD, [ptr] * 10 + [i32] * 2 + [ptr]),
                       (EXACT_SHADOW_BLOCKS, [i32, i32]),
                       (EXACT_SHADOW_SCRATCH, [i32, i32])):
        fn = getattr(built.lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_longlong if name == EXACT_SHADOW_SCRATCH else ctypes.c_int
    return built


def exact_library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    """The built K4x / K4xb library for this compiled structure and config
    (compiled at first use, then loaded from the build cache), keyed as
    K3 / K4's (kernel_config) but a library of its own."""
    return _exact_library(structure, kernel_config(structure, cfg))


@functools.lru_cache(maxsize=None)
def _exact_entry(structure: SceneStructure, cfg: RenderConfig) -> _Entry:
    """K4x's entry for this structure and cfg, resolved once."""
    return _Entry(getattr(exact_library(structure, cfg).lib, EXACT_SHADOW), EXACT_SHADOW,
                  packed_size(structure))


def _launch_exact_bwd(lib, structure: SceneStructure, ro, rd, max_dist, fields, g_res):
    """K4xb and its reduce over the ray batch: (g_ro, g_rd, g_fields), the
    geometry prefix of g_fields the reduce's, the rest zeros. Its
    accumulators take shared memory, or, for a geometry prefix too long
    for it, a scratch buffer of the size the library gives."""
    _check("g_res", g_res, tuple(rd.shape[:-1]))
    if g_res.device != rd.device:
        raise ValueError("g_res must be on the rays' device")
    dev = rd.device
    g_ro, g_rd = torch.empty_like(rd), torch.empty_like(rd)
    g_fields = torch.zeros_like(fields)
    n = rd.numel() // 3
    if n == 0:
        return g_ro, g_rd, g_fields
    rows, width = _layout(tuple(rd.shape[:-1]))
    blocks = getattr(lib, EXACT_SHADOW_BLOCKS)(rows, width)
    partials = torch.empty((blocks, geom_size(structure)), dtype=torch.float32, device=dev)
    scratch = torch.empty(getattr(lib, EXACT_SHADOW_SCRATCH)(rows, width), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, EXACT_SHADOW_BWD)(
            ro.data_ptr(), rd.data_ptr(), max_dist.data_ptr(), fields.data_ptr(),
            g_res.data_ptr(), g_ro.data_ptr(), g_rd.data_ptr(), scratch.data_ptr(),
            partials.data_ptr(), g_fields.data_ptr(), rows, width,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{EXACT_SHADOW_BWD} launch failed: cudaError {rc}")
    launches[EXACT_SHADOW_BWD] += 1
    return g_ro, g_rd, g_fields


class ExactShadow(torch.autograd.Function):
    """res = the exact shadow march of rays ro, rd [..., 3] (contiguous,
    one shape) up to max_dist [...] through the packed buffer `fields`:
    K4x in forward and K4xb in backward on CUDA tensors,
    shadow_values_reference's res and exact_shadow_reference on CPU
    tensors. The cotangents reach ro, rd and fields (max_dist only ends the
    loop); `fields` keeps its graph, so they reach the SceneParams leaves
    through pack_fields' cat."""

    @staticmethod
    def forward(ctx, ro, rd, max_dist, fields, structure, cfg):
        scene = MarchScene(fields.detach(), None)
        if resolve_backend(ro, rd, max_dist, fields) == "torch":
            res = shadow_values_reference(structure, cfg, ro, rd, max_dist, scene)[0]
        else:
            res = _launch(_exact_entry(structure, cfg), structure, scene, ro, rd, max_dist,
                          1)[0]
        ctx.save_for_backward(ro, rd, max_dist, fields)
        ctx.structure, ctx.cfg = structure, cfg
        return res

    @staticmethod
    def backward(ctx, g_res):
        ro, rd, max_dist, fields = ctx.saved_tensors
        structure, cfg = ctx.structure, ctx.cfg
        g_res = g_res.contiguous()
        if resolve_backend(ro, rd, max_dist, fields, g_res) == "torch":
            g_ro, g_rd, g_fields = exact_shadow_reference(structure, cfg, ro, rd, max_dist,
                                                          fields, g_res)
        else:
            g_ro, g_rd, g_fields = _launch_exact_bwd(exact_library(structure, cfg).lib,
                                                     structure, ro, rd, max_dist, fields, g_res)
        return g_ro, g_rd, None, g_fields, None, None


def make_cuda_exact_shadow(structure: SceneStructure, cfg: RenderConfig) -> Callable:
    """`shadow_fn(params, ro, rd, max_dist, fields=None) -> (res, None)`: the
    "exact" estimator's shadow march through K4x / K4xb (`ExactShadow`) on
    a compiled structure, differentiable in ro, rd and the params (through
    `fields`, pack_fields(structure, params) with its graph: packed here
    when None). The batch is broadcast and made contiguous first."""
    require_compiled(structure)

    def shadow_fn(params: SceneParams, ro, rd, max_dist, fields=None):
        if fields is None:
            fields = pack_fields(structure, params)
        batch = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1], max_dist.shape)
        ro, rd = (t.expand(batch + (3,)).contiguous() for t in (ro, rd))
        max_dist = max_dist.detach().expand(batch).contiguous()
        return ExactShadow.apply(ro, rd, max_dist, fields.contiguous(), structure, cfg), None

    return shadow_fn


class EvalTables(NamedTuple):
    """K7's view of one sphere set, value-only (detached, f32, contiguous):

    spheres [Ns, 4]  x y z r, Morton-sorted; sentinel spheres (radius
                     -1e30, the padding of parallel/objects.py) included
    groups  [Ng, 8]  the run balls of instanced_pack.group_bounds
    bbox    [6]      lo, hi of the real spheres' surfaces, or the AABB the
                     caller puts in its place (the object axis' combined one)
    """

    spheres: torch.Tensor
    groups: torch.Tensor
    bbox: torch.Tensor


def pack_eval_tables(params: SceneParams) -> EvalTables:
    """The tables of K7 for params' spheres (`pallas_scene.pack_instanced_spheres`
    without the material column): no ids and no material table, so a
    shard's sphere set packs as it is; the AABB leaves sentinels out."""
    with torch.no_grad():
        pos = params.sphere_point.detach().to(torch.float32)
        rad = params.sphere_radius.detach().to(torch.float32)
        if pos.dim() != 2 or pos.shape[1] != 3 or tuple(rad.shape) != (pos.shape[0],):
            raise ValueError(f"sphere_point {tuple(pos.shape)} / sphere_radius "
                             f"{tuple(rad.shape)} are not an [N, 3] / [N] sphere set")
        if pos.shape[0] == 0:
            raise ValueError("an instanced scene needs at least one sphere")
        order = pack_order(pos)
        pos, rad = pos[order], rad[order]
        lo, hi = real_sphere_bbox(pos, rad)
        return EvalTables(torch.cat([pos, rad[:, None]], dim=1).contiguous(),
                          group_bounds(pos, rad).contiguous(), torch.cat([lo, hi]).contiguous())


def instanced_eval_reference(tables: EvalTables, plane_y, p, step_clamp: Optional[float] = None,
                             block: int = 512, chunk: int = 1 << 16) -> torch.Tensor:
    """The plain version of K7 at points p [..., 3] (f32): the min over the
    tables' real spheres of |p - c| - r (+inf where there is none), under
    a step clamp min'd with max(clamp, distance to tables.bbox), then the
    planes by a strict `<`; sums written ((x+y)+z) as the kernel's. Blocks
    of `block` spheres over chunks of `chunk` points bound the
    temporaries. Without autograd."""
    batch = p.shape[:-1]
    flat = p.detach().reshape(-1, 3)
    out = torch.empty(flat.shape[0], dtype=flat.dtype, device=flat.device)
    spheres = tables.spheres
    lo, hi = tables.bbox[:3], tables.bbox[3:]
    with torch.no_grad():
        for start in range(0, flat.shape[0], chunk):
            q = flat[start:start + chunk]
            px, py, pz = q[:, 0, None], q[:, 1, None], q[:, 2, None]
            dmin = torch.full((q.shape[0],), float("inf"), dtype=q.dtype, device=q.device)
            for s0 in range(0, spheres.shape[0], block):
                c = spheres[s0:s0 + block]
                dx, dy, dz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
                d = torch.sqrt((dx * dx + dy * dy) + dz * dz) - c[:, 3]
                d = torch.where(c[:, 3] > -1e29, d, float("inf"))
                dmin = torch.minimum(dmin, d.amin(dim=-1))
            if step_clamp is not None:
                dmin = torch.minimum(dmin, bbox_cut(lo, hi, q, step_clamp))
            for k in range(plane_y.shape[0]):
                dp = q[:, 1] - plane_y[k]
                dmin = torch.where(dp < dmin, dp, dmin)
            out[start:start + chunk] = dmin
    return out.reshape(batch)


@functools.lru_cache(maxsize=None)
def _eval_library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    built = _build.build(generate_eval_source(structure, cfg), "instanced_eval")
    head = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
    for name, grid in ((INSTANCED_EVAL, True), (INSTANCED_EVAL_WALK, False),
                       (INSTANCED_EVAL_STATS, True)):
        fn = getattr(built.lib, name)
        fn.argtypes = head + (GRID_ARGTYPES if grid else []) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return built


def eval_library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    """The built K7 for this structure and cfg.step_clamp (compiled at first
    use, then loaded from the build cache); structures with as many planes
    share one source."""
    return _eval_library(structure, RenderConfig(step_clamp=cfg.step_clamp))


def _check_eval(structure: SceneStructure, tables: EvalTables, plane_y, p) -> None:
    ns = structure.num_spheres
    want = {"spheres": (ns, 4), "groups": (-(-ns // GROUP), 8), "bbox": (6,)}
    for name, shape in want.items():
        _check(f"tables.{name}", getattr(tables, name), shape)
    _check("plane_y", plane_y, (structure.num_planes,))
    if p.dtype != torch.float32 or p.shape[-1:] != (3,):
        raise ValueError(f"p: want float32 [..., 3], got {p.dtype} {tuple(p.shape)}")
    if any(t.device != p.device for t in (*tables, plane_y)):
        raise ValueError("p, plane_y and the tables must be on one device")


def make_instanced_eval(structure: SceneStructure, cfg: RenderConfig) -> Callable:
    """`eval_fn(tables, plane_y, p[..., 3], grid=None) -> dist[...]`: one
    evaluation of the instanced distance under cfg.step_clamp at arbitrary
    points (`pallas_march.make_instanced_eval`), over the EvalTables of
    `structure.num_spheres` spheres and the planes' heights plane_y
    [num_planes]. CUDA tensors launch K7 (one thread per point, no
    padding) over `grid` (default: `cell_grid.grid_for(tables,
    cfg.step_clamp)`, built now), or
    with `walk=True` the run walk alone (`lol_instanced_eval_walk`, the
    check of the grid); `stats` (int64 [3] on the device) takes the grid
    search's counts (searches, fallbacks, list entries read). CPU tensors
    take `instanced_eval_reference`. Value-only: the caller attaches
    gradients (parallel/objects.py)."""
    require_instanced(structure)

    def eval_fn(tables: EvalTables, plane_y, p, grid: Optional[CellGrid] = None,
                walk: bool = False, stats: Optional[torch.Tensor] = None):
        if resolve_backend(p, plane_y, *tables) == "torch":
            return instanced_eval_reference(tables, plane_y, p, cfg.step_clamp)
        _check_eval(structure, tables, plane_y, p)
        batch = tuple(p.shape[:-1])
        flat = p.detach().reshape(-1, 3).contiguous()
        out = torch.empty(flat.shape[0], dtype=torch.float32, device=p.device)
        if flat.shape[0] == 0:
            return out.reshape(batch)
        if walk:
            name, index = INSTANCED_EVAL_WALK, ()
        else:
            grid = grid_for(tables, cfg.step_clamp) if grid is None else grid
            check_grid(grid, p.device, stats)
            name = INSTANCED_EVAL if stats is None else INSTANCED_EVAL_STATS
            index = grid_args(grid, stats)
        fn = getattr(eval_library(structure, cfg).lib, name)
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(plane_y.data_ptr(), tables.spheres.data_ptr(), tables.groups.data_ptr(),
                    tables.bbox.data_ptr(), tables.spheres.shape[0], tables.groups.shape[0],
                    flat.data_ptr(), out.data_ptr(), flat.shape[0], *index, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        launches[INSTANCED_EVAL] += 1
        return out.reshape(batch)

    return eval_fn
