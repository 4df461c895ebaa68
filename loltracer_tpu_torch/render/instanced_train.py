"""The instanced training render: two hand-written CUDA kernels under a
`torch.autograd.Function`, and their plain PyTorch versions
(`loltracer_tpu/render/pallas_train.py`, the instanced training tier,
`:1208-1653`). The twin of render/fused_train.py for instanced scenes.

- `instanced_train_forward(structure, cfg, cam, fields, tables, H, W) ->
  (img [H, W, 3], res [R, H, W])`: the image and the residual planes of
  fused_train (t_sh, hit, material, IFT denominator, per light res and t*).
  CUDA tensors launch `lol_instanced_fwd` (csrc/instanced_scene.cuh with
  Cfg::with_residuals, the port of `_instanced_fwd_kernel` with residuals
  on; it searches the cell grid `grid`, csrc/grid_scene.cuh, as
  lol_instanced_render does, built from the tables when none is given);
  CPU tensors take `instanced_train_forward_reference`.
- `instanced_train_backward(structure, cfg, cam, fields, tables, res, ct)
  -> (dcam [16], dfields [packed_size], dsph [Ns, 4])`: the vector-Jacobian
  product of `instanced_shade_from_frozen` at the residuals, dsph per
  Morton-sorted row of the sphere table (x y z r). CUDA tensors launch
  `lol_instanced_bwd` with its reduce and its deterministic scatter
  (csrc/instanced_bwd.cuh, the port of `_instanced_bwd_kernel`), over the
  same kind of grid; `walk=True` launches its run-walk twin
  (`lol_instanced_bwd_walk`, the check), `stats=` its counting twin; CPU
  tensors take `instanced_train_backward_reference`.
- `make_instanced_training_renderer(structure, H, W, cfg, device) ->
  params -> img`, differentiable in every SceneParams field: the camera
  pack, the packed buffer and the sphere table (a gather through the Morton
  order, render/instanced_pack.py) are plain differentiable torch, so
  autograd chains dcam, dfields and dsph back to the fields. Its
  `InstancedTrainRender` builds one cell grid a step, searched by the
  forward and by the backward.

Both take a band of an image through `full_height` and the pack's row0,
or a shard of the row-sharded training step (parallel/sharded.py) through
`full_height` and `rowtab` (f32 [ceil(H / 16)]: the absolute image row of
each 16-row patch row of the launch, `camera.launch_rows`); so do the
plain versions, and `make_instanced_training_renderer(...,
full_height=, with_row_table=True)` returns `(params, rowtab) -> img`.
`launches_table` counts the launches of either kernel that read a table.
The gradient is K6's: at every SDF site the instanced distance under the
primary step clamp, its gradient through the winning sphere only, the cut
max(clamp, distance to the AABB) a constant (`_RecordingDist`), a plane
winning by a strict `<`. A wrapper given CUDA tensors launches its kernel
or raises; nothing falls back. `launches_fwd` and `launches_bwd` count
kernel launches (the reduce and scatter are part of the backward's count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_backend, resolve_device
from loltracer_tpu_torch.render.camera import CAM_SIZE, camera_pack, launch_rows, rays_from_rows
from loltracer_tpu_torch.render.cell_grid import CellGrid, check_grid, grid_args, grid_for
from loltracer_tpu_torch.render.cuda_scene import (
    GRID_ARGTYPES,
    INSTANCED_BLOCKS,
    INSTANCED_BWD,
    INSTANCED_BWD_STATS,
    INSTANCED_BWD_WALK,
    INSTANCED_FWD,
    INSTANCED_HIST_ROWS,
    PATCH_ROW_BLOCK,
    generate_instanced_source,
    pack_fields,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.fused_fwd import _check
from loltracer_tpu_torch.render.fused_train import (
    _opt,
    check_row_table,
    num_residuals,
    reattach,
    residual_planes,
    table_renderer,
)
from loltracer_tpu_torch.render.instanced_fwd import _check_tables
from loltracer_tpu_torch.render.instanced_pack import (
    InstancedTables,
    pack_instanced,
    soa_spheres,
    sphere_bbox,
)
from loltracer_tpu_torch.render.sdf import (
    bbox_cut,
    make_scene_sdf,
    make_scene_sdf_with_id,
    sphere_argmin,
)
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, params_to, require_instanced
from loltracer_tpu_torch.utils import tracing

__all__ = [
    "InstancedTrainRender",
    "instanced_shade_from_frozen",
    "instanced_train_backward",
    "instanced_train_backward_reference",
    "instanced_train_forward",
    "instanced_train_forward_reference",
    "launches_bwd",
    "launches_fwd",
    "launches_table",
    "make_instanced_training_renderer",
    "make_train_sdf",
    "num_sites",
]

launches_fwd = 0
launches_bwd = 0
launches_table = 0


def num_sites(structure: SceneStructure) -> int:
    """SDF adjoint sites per pixel, each one record slot of the backward:
    the coverage / IFT numerator, four normal taps, one per light."""
    return 1 + 4 + structure.num_lights


def make_train_sdf(structure: SceneStructure, step_clamp: Optional[float]) -> Callable:
    """`sdf(params, p) -> dist`: the value of make_scene_sdf(structure,
    step_clamp), differentiated as lol_instanced_bwd does. The gradient
    flows through the winning sphere only (the first-wins argmin of
    sdf.sphere_argmin, re-evaluated by the same expression, so the value
    is bitwise the min); the cut is a constant and wins only at raw > cut;
    a plane wins by a strict `<`."""
    require_instanced(structure)

    def sdf(params: SceneParams, p):
        with torch.no_grad():
            _, imin = sphere_argmin(structure, params, p.detach())
        idx = (imin - 1).long()
        c, r = params.sphere_point[idx], params.sphere_radius[idx]
        dx, dy, dz = p[..., 0] - c[..., 0], p[..., 1] - c[..., 1], p[..., 2] - c[..., 2]
        d = torch.sqrt((dx * dx + dy * dy) + dz * dz) - r
        if step_clamp is not None:
            with torch.no_grad():
                lo, hi = sphere_bbox(params.sphere_point, params.sphere_radius)
                cut = bbox_cut(lo, hi, p, step_clamp)
            d = torch.where(d > cut, cut, d)
        if structure.num_planes:
            bd, _ = torch.min(p[..., 1, None] - params.plane_y, dim=-1)
            d = torch.where(bd < d, bd, d)
        return d

    return sdf


def _params_of(structure, cam, fields, tables) -> SceneParams:
    """SceneParams of the packed buffer and the tables' spheres in SoA order
    (both differentiable); the camera position is cam[0:3]."""
    pos, rad = soa_spheres(structure, tables)
    return SceneParams(
        **{**unpack_fields(structure, fields), "sphere_point": pos, "sphere_radius": rad},
        cam_point=cam[0:3],
        cam_direction=cam[9:12],
        cam_fov=cam.new_zeros(()),
    )


def instanced_shade_from_frozen(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    tables: InstancedTables,
    res: torch.Tensor,
    full_height: Optional[int] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain K6 semantics: fused_train's re-attachment pipeline with the
    instanced SDF under the primary step clamp at every site (make_train_sdf),
    for the launch rows 0..R-1 (image rows cam[15] + y, or `rowtab`'s) of an
    image of `full_height` rows (default R) and residual planes res [N, R,
    W]. Differentiable in cam, fields and tables.spheres; its value is the
    forward image [R, W, 3]."""
    params = _params_of(structure, cam, fields, tables)
    sdf = make_train_sdf(structure, cfg.step_clamp)
    return reattach(structure, cfg, cam, params, sdf, res, full_height or res.shape[1],
                    rowtab, PATCH_ROW_BLOCK)


def instanced_train_forward_reference(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    tables: InstancedTables,
    height: int,
    width: int,
    full_height: Optional[int] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of lol_instanced_fwd on the tensors' device:
    fused_train.residual_planes with the march under the step clamp, the
    shadow marches under the shadow clamp, the material of the clamped
    SDF's argmin and the denominator by autograd of make_train_sdf; the
    image from instanced_shade_from_frozen. Returns (img [H, W, 3], res
    [R, H, W])."""
    require_instanced(structure)
    with torch.no_grad():
        cam, fields = cam.detach(), fields.detach()
        tables = tables._replace(spheres=tables.spheres.detach())
        params = _params_of(structure, cam, fields, tables)
        clamp = cfg.step_clamp
        ro, rd = rays_from_rows(cam, launch_rows(cam, height, rowtab, PATCH_ROW_BLOCK),
                                full_height or height, width)
        res = residual_planes(structure, cfg, params, ro, rd, make_scene_sdf(structure, clamp),
                              make_scene_sdf(structure, cfg.effective_shadow_clamp()),
                              make_train_sdf(structure, clamp),
                              make_scene_sdf_with_id(structure, clamp))
        img = instanced_shade_from_frozen(structure, cfg, cam, fields, tables, res, full_height,
                                          rowtab)
    return img, res


def instanced_train_backward_reference(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    tables: InstancedTables,
    res: torch.Tensor,
    ct: torch.Tensor,
    full_height: Optional[int] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of lol_instanced_bwd: torch.autograd.grad of
    (instanced_shade_from_frozen(...) * ct).sum() in (cam, fields,
    tables.spheres). Returns (dcam [16], dfields, dsph [Ns, 4])."""
    with torch.enable_grad():
        cam = cam.detach().requires_grad_(True)
        fields = fields.detach().requires_grad_(True)
        spheres = tables.spheres.detach().requires_grad_(True)
        img = instanced_shade_from_frozen(structure, cfg, cam, fields,
                                          tables._replace(spheres=spheres), res.detach(),
                                          full_height, rowtab)
        grads = torch.autograd.grad((img * ct.detach()).sum(), (cam, fields, spheres),
                                    allow_unused=True)
    return tuple(
        torch.zeros_like(x) if g is None else g.detach()
        for g, x in zip(grads, (cam, fields, spheres))
    )


@functools.lru_cache(maxsize=None)
def library(cfg: RenderConfig, structure: SceneStructure) -> _build.Library:
    """The built instanced training kernels for this config and structure
    (compiled at first use, then loaded from the build cache); one source
    for every sphere count."""
    built = _build.build(generate_instanced_source(structure, cfg, residuals=True),
                         "instanced_train")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    bwd = [ptr] * 6 + [i32] * 2 + [ptr] * 11 + [i32] * 3 + [ptr]
    for name, args in (
        (INSTANCED_FWD, [ptr] * 6 + [i32] * 2 + [ptr] * 2 + [i32] * 3 + [ptr] + GRID_ARGTYPES
         + [ptr]),
        (INSTANCED_BWD, bwd + GRID_ARGTYPES + [ptr]),
        (INSTANCED_BWD_WALK, bwd + [ptr]),
        (INSTANCED_BWD_STATS, bwd + GRID_ARGTYPES + [ptr]),
        (INSTANCED_BLOCKS, [i32, i32]),
        (INSTANCED_HIST_ROWS, [ctypes.c_longlong]),
    ):
        fn = getattr(built.lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return built


def _check_cuda_inputs(structure, cam, fields, tables):
    _check("cam", cam, (CAM_SIZE,))
    _check("fields", fields, (packed_size(structure),))
    _check_tables(structure, tables, cam.device)
    if cam.device != fields.device:
        raise ValueError(f"cam on {cam.device}, fields on {fields.device}")


def _table_args(tables: InstancedTables):
    return (tables.spheres.data_ptr(), tables.ids.data_ptr(), tables.groups.data_ptr(),
            tables.bbox.data_ptr(), tables.spheres.shape[0], tables.groups.shape[0])


def instanced_train_forward(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    tables: InstancedTables,
    height: int,
    width: int,
    full_height: Optional[int] = None,
    grid: Optional[CellGrid] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(img [H, W, 3], res [R, H, W]): lol_instanced_fwd for CUDA tensors,
    searching `grid` (default: `cell_grid.grid_for(tables,
    cfg.step_clamp)`, built now from the tables, whose spheres may have
    moved since the last step), the plain version for CPU tensors; at the
    image rows of `rowtab` (module docstring)."""
    require_instanced(structure)
    full_height = full_height or height
    if resolve_backend(cam, fields, *tables, *_opt(rowtab)) == "torch":
        return instanced_train_forward_reference(structure, cfg, cam, fields, tables,
                                                 height, width, full_height, rowtab)
    _check_cuda_inputs(structure, cam, fields, tables)
    if height <= 0 or width <= 0 or full_height < height:
        raise ValueError(f"bad image size {height}x{width} of {full_height} rows")
    tab = check_row_table(rowtab, height, full_height, PATCH_ROW_BLOCK, cam.device)
    lib = library(cfg, structure).lib
    grid = grid_for(tables, cfg.step_clamp) if grid is None else grid
    check_grid(grid, cam.device)
    img = torch.empty((height, width, 3), dtype=torch.float32, device=cam.device)
    res = torch.empty((num_residuals(structure), height, width), dtype=torch.float32,
                      device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, INSTANCED_FWD)(
            cam.data_ptr(), fields.data_ptr(), *_table_args(tables), img.data_ptr(),
            res.data_ptr(), height, full_height, width, tab, *grid_args(grid), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{INSTANCED_FWD} launch failed: cudaError {rc}")
    global launches_fwd, launches_table
    launches_fwd += 1
    launches_table += rowtab is not None
    return img, res


def instanced_train_backward(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    tables: InstancedTables,
    res: torch.Tensor,
    ct: torch.Tensor,
    full_height: Optional[int] = None,
    grid: Optional[CellGrid] = None,
    walk: bool = False,
    stats: Optional[torch.Tensor] = None,
    records: bool = False,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """(dcam [16], dfields [packed_size], dsph [Ns, 4]) at the residuals for
    the image cotangent ct [H, W, 3]: lol_instanced_bwd (with its reduce and
    scatter) for CUDA tensors, the plain version for CPU tensors. On CUDA
    the kernel searches `grid` (default: built now, as
    instanced_train_forward's; InstancedTrainRender passes its forward's),
    or with `walk` the run walk alone; `stats` (int64 [3] on the device)
    takes the grid search's counts: searches, fallbacks, list entries read.
    With `records`, the record buffer follows: rows [sites, H, W] int32
    (-1 for none) and vals [sites, H, W, 4], what dsph sums per row in
    increasing record index. `rowtab`: the image rows (module docstring)."""
    require_instanced(structure)
    if resolve_backend(cam, fields, *tables, res, ct, *_opt(rowtab)) == "torch":
        return instanced_train_backward_reference(structure, cfg, cam, fields, tables, res,
                                                  ct, full_height, rowtab)
    _check_cuda_inputs(structure, cam, fields, tables)
    if ct.dim() != 3 or ct.shape[2] != 3 or min(ct.shape[:2]) <= 0:
        raise ValueError(f"ct must be [H, W, 3], got {tuple(ct.shape)}")
    height, width = ct.shape[0], ct.shape[1]
    full_height = full_height or height
    tab = check_row_table(rowtab, height, full_height, PATCH_ROW_BLOCK, cam.device)
    _check("ct", ct, (height, width, 3))
    _check("res", res, (num_residuals(structure), height, width))
    if not cam.device == res.device == ct.device:
        raise ValueError("cam, res and ct must be on one device")
    if walk:
        name, index = INSTANCED_BWD_WALK, ()
    else:
        grid = grid_for(tables, cfg.step_clamp) if grid is None else grid
        check_grid(grid, cam.device, stats)
        name, index = (INSTANCED_BWD if stats is None else INSTANCED_BWD_STATS,
                       grid_args(grid, stats))
    lib = library(cfg, structure).lib
    ns, dev, sites = structure.num_spheres, cam.device, num_sites(structure)
    n_rec = sites * height * width
    if n_rec >= 2**31:
        raise ValueError(f"{n_rec} records: the scatter indexes them with int32")
    hist_rows = getattr(lib, INSTANCED_HIST_ROWS)(n_rec)
    blocks = getattr(lib, INSTANCED_BLOCKS)(height, width)
    n = CAM_SIZE + packed_size(structure)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    partials, grads, dsph = f32(blocks, n), f32(n), f32(ns, 4)
    work = (i32(n_rec), f32(n_rec, 4), i32(hist_rows, ns), i32(ns), i32(ns), i32(n_rec))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(
            cam.data_ptr(), fields.data_ptr(), *_table_args(tables), res.data_ptr(),
            ct.data_ptr(), partials.data_ptr(), grads.data_ptr(),
            *(w.data_ptr() for w in work), dsph.data_ptr(), height, full_height, width, tab,
            *index, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    global launches_bwd, launches_table
    launches_bwd += 1
    launches_table += rowtab is not None
    out = grads[:CAM_SIZE], grads[CAM_SIZE:], dsph
    if records:
        out += (work[0].view(sites, height, width), work[1].view(sites, height, width, 4))
    return out


class InstancedTrainRender(torch.autograd.Function):
    """img = render(cam, fields, spheres): instanced_train_forward in
    forward, instanced_train_backward in backward (the custom_vjp of
    pallas_train.make_instanced_training_renderer), both over the one cell
    grid that forward builds from the step's tables (the plain versions,
    on CPU tensors, ignore it). ids, groups and bbox are the tables'
    search structures, and rowtab the row table: not differentiated (a
    zero cotangent). Its forward is the span `instanced_train.forward`
    (the grid's build and K5r's launch), its backward
    `instanced_train.backward` (K6's launch; utils/tracing.py)."""

    @staticmethod
    def forward(ctx, cam, fields, spheres, ids, groups, bbox, structure, cfg, height, width,
                full_height=None, rowtab=None):
        with tracing.span("instanced_train.forward"):
            tables = InstancedTables(spheres, ids, groups, bbox)
            grid = grid_for(tables, cfg.step_clamp)  # one grid a step, for K5r and K6
            img, res = instanced_train_forward(structure, cfg, cam, fields, tables, height,
                                               width, full_height, grid=grid, rowtab=rowtab)
        ctx.save_for_backward(cam, fields, spheres, ids, groups, bbox, res, *_opt(rowtab))
        ctx.structure, ctx.cfg, ctx.grid, ctx.full_height = structure, cfg, grid, full_height
        return img

    @staticmethod
    def backward(ctx, ct):
        cam, fields, spheres, ids, groups, bbox, res, *rowtab = ctx.saved_tensors
        with tracing.span("instanced_train.backward"):
            dcam, dfields, dsph = instanced_train_backward(
                ctx.structure, ctx.cfg, cam, fields, InstancedTables(spheres, ids, groups, bbox),
                res, ct.contiguous(), ctx.full_height, grid=ctx.grid,
                rowtab=rowtab[0] if rowtab else None,
            )
        ctx.grid = None  # the step's grid goes with its backward
        return (dcam, dfields, dsph) + (None,) * 9


def make_instanced_training_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device="cuda",
    full_height: Optional[int] = None,
    with_row_table: bool = False,
) -> Callable[..., torch.Tensor]:
    """`params -> [H, W, 3] f32` through the instanced training kernels,
    differentiable in every SceneParams field, sphere positions and radii
    included. Requires an instanced structure and the envelope shadow
    estimator, as the JAX package does (`pallas_train.py:1519-1525`).
    Raises if `device` is a CUDA device and CUDA is not available: it
    never falls back to the CPU. With `full_height` and `with_row_table`,
    `(params, rowtab) -> img` of a shard (fused_train.make_training_renderer;
    one table entry per 16-row patch row, `pallas_train.py:1641-1648`)."""
    require_instanced(structure)
    if cfg.shadow_grad != "envelope":
        raise ValueError(
            "fused instanced training kernels implement the envelope shadow "
            f"estimator; got shadow_grad={cfg.shadow_grad!r}"
        )
    device = resolve_device(device, "make_instanced_training_renderer")
    fh = full_height or height

    def renderer(params: SceneParams, rowtab: Optional[torch.Tensor] = None) -> torch.Tensor:
        params = params_to(params, device=device, dtype=torch.float32)
        cam = camera_pack(params, fh, width, cfg)
        fields = pack_fields(structure, params)
        tab = pack_instanced(structure, params)
        return InstancedTrainRender.apply(cam, fields, tab.spheres, tab.ids, tab.groups,
                                          tab.bbox, structure, cfg, height, width, fh, rowtab)

    if not with_row_table:
        return lambda params: renderer(params)
    return table_renderer(renderer, height, PATCH_ROW_BLOCK, "patch row", device)
