"""Object-axis sharding of instanced scenes over torch.distributed
(`loltracer_tpu/parallel/objects.py`).

For 10k+ sphere scenes the distance is a min over the sphere set. This
module shards that set over the object axis of a DeviceMesh
(parallel/mesh.py), as tensor parallelism shards a contraction: every rank
holds the whole SceneParams, pads the spheres to a multiple of the axis
(`pad_spheres_for_sharding`, bitwise the JAX package's) and keeps its own
slice, the counterpart of shard_map's P(obj_axis). Each distance evaluation
takes the min over the rank's shard and the ranks all-reduce the minimum
over the axis' group (JAX's lax.pmin); the hit id takes the lowest global
id among the ranks whose unclamped distance is the minimum, so first-wins
ties survive. Rows may shard over a second axis of the mesh (a (rows,
objects) mesh); the image is all-gathered over it, so every rank returns
the full [H, W, 3].

Lockstep: the ranks of an object group march together. Every loop exit
derives from all-reduced values (the march's `done.all()`), every rank
runs the same launches and collectives in the same order, and no rank
skips one on its own data.

Two tiers, by cfg.march_backend (render/backend.resolve_march_backend):
"jnp" evaluates the shard with the plain blockwise SDF (`_sharded_sdfs`);
the kernel tier ("pallas", or "auto" on CUDA tensors) evaluates every
`sdf` / `shadow_sdf` call with K7, `lol_instanced_eval`
(render/march_kernels.make_instanced_eval, csrc/march.cuh), over the
shard's tables packed once per render with the axis-combined AABB, and
their cell grid (render/cell_grid.py), built once per render over the
shard's own spheres for both (`_make_kernel_pmin_sdf`). The hit-id lookup stays the plain `sdf_id`, as
in the JAX package. Both render through render_rays' SDF overrides, hence
the plain march loops. Gradients: the all-reduced distance passes its
gradient to the rank(s) attaining the minimum (the JAX package's
subgradient), so a rank's gradient in the sphere fields covers its own
shard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_device, resolve_march_backend
from loltracer_tpu_torch.render.camera import camera_rays_for_rows
from loltracer_tpu_torch.render.instanced_pack import real_sphere_bbox
from loltracer_tpu_torch.render.cell_grid import CellGrid, grid_for
from loltracer_tpu_torch.render.march_kernels import make_instanced_eval, pack_eval_tables
from loltracer_tpu_torch.render.sdf import bbox_cut, make_scene_sdf_with_id
from loltracer_tpu_torch.render.torch_renderer import pixel_radius, render_rays
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, params_to, require_instanced

OBJ_AXIS = "objects"

_NO_ID = 2**30  # the id of a rank that holds no winner


class ObjectAxis(NamedTuple):
    """What a rank knows of its object axis: the group that carries its
    collectives, the number of shards, and this rank's shard."""

    group: dist.ProcessGroup
    size: int
    index: int


def _all_reduce(x: torch.Tensor, op, axis: ObjectAxis) -> torch.Tensor:
    """A detached copy of x, reduced by `op` over the axis."""
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def pad_spheres_for_sharding(params: SceneParams, n_shards: int) -> SceneParams:
    """The sphere SoA padded to a multiple of n_shards: pad spheres sit at
    the origin with radius -1e30, so they never win a min (the sentinel of
    the instanced SDF's own padding)."""
    ns = params.sphere_radius.shape[0]
    pad = (-ns) % n_shards
    if pad == 0:
        return params
    pos, rad = params.sphere_point, params.sphere_radius
    return dataclasses.replace(
        params,
        sphere_point=torch.cat([pos, pos.new_zeros((pad, 3))]),
        sphere_radius=torch.cat([rad, rad.new_full((pad,), -1e30)]),
    )


def shard_spheres(padded: SceneParams, axis: ObjectAxis) -> SceneParams:
    """This rank's slice of the padded sphere set (shard_map's P(obj_axis));
    every other field whole."""
    n = padded.sphere_radius.shape[0] // axis.size
    cut = slice(axis.index * n, (axis.index + 1) * n)
    return dataclasses.replace(padded, sphere_point=padded.sphere_point[cut],
                               sphere_radius=padded.sphere_radius[cut])


def combined_bbox(local: SceneParams, axis: ObjectAxis) -> torch.Tensor:
    """[6] lo, hi of the whole sphere set's surfaces, sentinels left out:
    each shard's own box, all-reduced MIN / MAX over the axis; detached,
    as the step clamp's cut is a frozen search bound."""
    lo, hi = real_sphere_bbox(local.sphere_point.detach(), local.sphere_radius.detach())
    return torch.cat([_all_reduce(lo, dist.ReduceOp.MIN, axis),
                      _all_reduce(hi, dist.ReduceOp.MAX, axis)])


def _sharded_sdfs(structure_local: SceneStructure, cfg: RenderConfig, axis: ObjectAxis,
                  bbox: torch.Tensor):
    """(sdf, sdf_id, local) over this rank's sphere shard (and the planes,
    which every rank holds), combined over the axis: the distance by an
    all-reduced MIN, the id by the lowest global id among the ranks whose
    UNCLAMPED distance is the minimum (the unclamped argmin, as the
    unsharded SDF's id is). Under cfg.step_clamp the local distance is
    min'd with max(clamp, distance to `bbox`), the whole set's AABB: min
    is associative, so this is the unsharded clamped distance. `local`
    is the rank's uncombined distance (the kernel tier's gradient)."""
    local_with_id = make_scene_sdf_with_id(structure_local, None)
    clamp = cfg.step_clamp
    ns_loc = structure_local.num_spheres

    def _local(params, p):
        d_unc, id_loc = local_with_id(params, p)
        d_loc = d_unc
        if clamp is not None:
            d_loc = torch.minimum(d_loc, bbox_cut(bbox[:3], bbox[3:], p, clamp))
        return d_loc, id_loc, d_unc

    def _combine(d_loc):
        """The all-reduced minimum with a subgradient: the value is the
        minimum over the axis, the gradient flows through the local value
        on the rank(s) attaining it."""
        m = _all_reduce(d_loc, dist.ReduceOp.MIN, axis)
        if not d_loc.requires_grad:
            return m
        dd = d_loc.detach()
        return m + torch.where(dd <= m, d_loc - dd, 0.0)

    def sdf_id(params, p):
        d_loc, id_loc, d_unc = _local(params, p)
        # local sphere i of shard s is global sphere s * ns_loc + i (ids are
        # 1-based); the planes' ids sit after every padded sphere
        is_sphere = (id_loc >= 1) & (id_loc <= ns_loc)
        gid = torch.where(
            is_sphere, id_loc + axis.index * ns_loc,
            torch.where(id_loc > ns_loc, id_loc + ns_loc * (axis.size - 1), id_loc))
        d = _combine(d_loc)
        d_unc_glob = _all_reduce(d_unc, dist.ReduceOp.MIN, axis)
        gid_win = torch.where(d_unc.detach() <= d_unc_glob, gid, _NO_ID).to(torch.int32)
        gid = _all_reduce(gid_win, dist.ReduceOp.MIN, axis)
        return d, torch.where(gid == _NO_ID, 0, gid)

    def sdf(params, p):
        return _combine(_local(params, p)[0])

    def local(params, p):
        return _local(params, p)[0]

    return sdf, sdf_id, local


class _Evaluation(NamedTuple):
    """What one kernel-tier distance needs besides its inputs."""

    eval_fn: Callable
    tables: tuple
    grid: CellGrid
    axis: ObjectAxis
    local: Callable
    params: SceneParams


class _KernelPmin(torch.autograd.Function):
    """The all-reduced K7 distance (the JAX package's custom_jvp around the
    Pallas evaluation). Forward: the evaluator on this rank's tables, then
    the MIN over the axis. Backward: the VJP of the plain sharded distance,
    `where(d_loc <= min, local(params, p), 0)` with the plain local
    distance re-evaluated under autograd and the forward's own values as
    the combine: the backward holds no collective, so the ranks' backward
    passes need no lockstep."""

    @staticmethod
    def forward(ctx, p, sphere_point, sphere_radius, plane_y, ev: _Evaluation):
        plane = plane_y.detach().to(torch.float32).contiguous()
        d_loc = ev.eval_fn(ev.tables, plane, p.detach(), ev.grid)
        m = _all_reduce(d_loc, dist.ReduceOp.MIN, ev.axis)
        ctx.ev = ev
        ctx.save_for_backward(p, sphere_point, sphere_radius, plane_y, d_loc, m)
        return m

    @staticmethod
    def backward(ctx, grad):
        p, sphere_point, sphere_radius, plane_y, d_loc, m = ctx.saved_tensors
        ev = ctx.ev
        needs = ctx.needs_input_grad[:4]
        leaves = [t.detach().requires_grad_(n) for t, n in
                  zip((p, sphere_point, sphere_radius, plane_y), needs)]
        with torch.enable_grad():
            params = dataclasses.replace(ev.params, sphere_point=leaves[1],
                                         sphere_radius=leaves[2], plane_y=leaves[3])
            sel = torch.where(d_loc <= m, ev.local(params, leaves[0]), 0.0)
            got = iter(torch.autograd.grad(sel, [t for t, n in zip(leaves, needs) if n], grad,
                                           allow_unused=True))
        return (*[next(got) if n else None for n in needs], None)


def _shard_tables(local: SceneParams, bbox: torch.Tensor, cfg: RenderConfig):
    """(K7's tables of this rank's shard with the axis-combined AABB `bbox`,
    their cell grid for cfg's primary clamp): packed once a render, since
    the spheres do not move within a frame. The grid serves the shadow
    clamp's K7 too: its reach is the primary clamp's, and a shadow search
    beyond it falls back to the run walk."""
    tables = pack_eval_tables(local)._replace(bbox=bbox.detach().to(torch.float32).contiguous())
    return tables, grid_for(tables, cfg.step_clamp)


def _make_kernel_pmin_sdf(axis: ObjectAxis, eval_fn: Callable, tables, grid,
                          local: Callable) -> Callable:
    """The object-sharded distance through an evaluator (`_make_pallas_pmin_sdf`):
    every call evaluates `eval_fn(tables, plane_y, p, grid)`
    (make_instanced_eval's: K7 on CUDA tensors, its plain version on CPU
    ones) over this rank's shard, packed into K7's tables once a render
    (the AABB replaced by the axis-combined one, so the step clamp's cut
    is the unsharded one) and their cell grid, and all-reduces the
    minimum, with the gradient of `local`, the plain sharded distance
    (_KernelPmin)."""

    def sdf(params_: SceneParams, p):
        ev = _Evaluation(eval_fn, tables, grid, axis, local, params_)
        return _KernelPmin.apply(p, params_.sphere_point, params_.sphere_radius,
                                 params_.plane_y, ev)

    return sdf


def make_object_sharded_renderer(
    structure: SceneStructure,
    mesh: DeviceMesh,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    row_axis: Optional[str] = None,
    obj_axis: str = OBJ_AXIS,
    device=None,
) -> Callable[[SceneParams], torch.Tensor]:
    """`params -> [H, W, 3]` with the instanced sphere set sharded over the
    mesh dimension `obj_axis` and, optionally, rows over `row_axis`; every
    rank of the mesh calls it with the same params and gets the whole
    image (row blocks all-gathered over `row_axis`). The image does not
    depend on the number of object shards.

    cfg.march_backend picks the tier (module docstring): "pallas" (and
    "auto" on CUDA tensors) evaluates every distance with K7, "jnp" with
    the plain sharded SDF; "pallas-interpret" raises. `device` defaults to
    the mesh's device type; params go there as float32. Differentiable
    (a rank's sphere-field gradient covers its shard); wrap a `no_grad`
    to render only."""
    require_instanced(structure)
    names = tuple(mesh.mesh_dim_names or ())
    for name in (obj_axis,) + ((row_axis,) if row_axis is not None else ()):
        if name not in names:
            raise ValueError(f"mesh has no dimension {name!r} (it has {names})")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    axis = ObjectAxis(mesh.get_group(obj_axis), mesh.size(names.index(obj_axis)),
                      mesh.get_local_rank(obj_axis))
    device = resolve_device(device if device is not None else mesh.device_type,
                            "make_object_sharded_renderer")
    use_kernel = resolve_march_backend(
        cfg.march_backend, torch.empty(0, device=device)) == "pallas"
    cfg = cfg.replace(march_backend="jnp")  # overridden SDFs -> the plain march loops

    # the spheres pad to a multiple of the axis (sentinels at the tail, so
    # real spheres keep ids 1..ns); plane ids shift past the padded count,
    # and the material table follows that numbering
    n_obj = axis.size
    ns = structure.num_spheres
    ns_pad = ns + (-ns) % n_obj
    mat_ids = structure.material_ids
    structure_global = dataclasses.replace(
        structure, num_spheres=ns_pad,
        material_ids=mat_ids[: 1 + ns] + (0,) * (ns_pad - ns) + mat_ids[1 + ns:])
    structure_local = dataclasses.replace(structure, num_spheres=ns_pad // n_obj,
                                          material_ids=())
    shadow_cfg = cfg.replace(step_clamp=cfg.effective_shadow_clamp(), shadow_step_clamp=None)
    own_shadow = shadow_cfg.step_clamp != cfg.step_clamp

    rows = torch.arange(height)
    row_group = None
    if row_axis is not None:
        n_rows = mesh.size(names.index(row_axis))
        if height % n_rows:
            raise ValueError(f"height {height} must divide over {n_rows} row shards")
        per = height // n_rows
        r = mesh.get_local_rank(row_axis)
        rows, row_group = torch.arange(r * per, (r + 1) * per), mesh.get_group(row_axis)

    def renderer(params: SceneParams) -> torch.Tensor:
        params = params_to(params, device=device, dtype=torch.float32)
        local = shard_spheres(pad_spheres_for_sharding(params, n_obj), axis)
        bbox = combined_bbox(local, axis)
        sdf, sdf_id, plain_local = _sharded_sdfs(structure_local, cfg, axis, bbox)
        shadow_sdf = shadow_local = None
        if own_shadow:
            shadow_sdf, _, shadow_local = _sharded_sdfs(structure_local, shadow_cfg, axis, bbox)
        if use_kernel:
            tables, grid = _shard_tables(local, bbox, cfg)
            sdf = _make_kernel_pmin_sdf(axis, make_instanced_eval(structure_local, cfg), tables,
                                        grid, plain_local)
            if own_shadow:
                shadow_sdf = _make_kernel_pmin_sdf(
                    axis, make_instanced_eval(structure_local, shadow_cfg), tables, grid,
                    shadow_local)
        ro, rd = camera_rays_for_rows(local, rows, height, width, cfg)
        pr = pixel_radius(local, height, cfg) if cfg.antialias else None
        img = render_rays(structure_global, local, ro, rd, cfg, pixel_rad=pr,
                          sdf=sdf, sdf_id=sdf_id, shadow_sdf=shadow_sdf)
        if row_group is None:
            return img
        parts = [torch.empty_like(img) for _ in range(dist.get_world_size(row_group))]
        dist.all_gather(parts, img.contiguous(), group=row_group)
        return torch.cat(parts, dim=0)

    return renderer
