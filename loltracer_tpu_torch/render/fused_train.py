"""The fused training render: two hand-written CUDA kernels under a
`torch.autograd.Function`, and their plain PyTorch versions
(`loltracer_tpu/render/pallas_train.py`, the training half, `:75-775`).

- `train_forward(structure, cfg, cam, fields, H, W) -> (img [H, W, 3],
  res [R, H, W])`: the image and the frozen residual planes (t_sh, hit,
  material, IFT denominator, then per light the penumbra minimum res and
  its argmin t*; R = num_residuals). CUDA tensors launch `lol_train_fwd`
  (csrc/fused_fwd.cuh with Cfg::with_residuals, the port of
  `_train_fwd_kernel` with residuals on); CPU tensors take
  `train_forward_reference`.
- `train_backward(structure, cfg, cam, fields, res, ct [H, W, 3]) ->
  (dcam [16], dfields [packed_size])`: the vector-Jacobian product of
  `shade_from_frozen` at the residuals. CUDA tensors launch
  `lol_train_bwd` and its fixed-order reduce (csrc/fused_bwd.cuh, the port
  of `_train_bwd_kernel`); CPU tensors take `train_backward_reference`.
- `make_training_renderer(structure, H, W, cfg, device) -> params -> img`,
  differentiable in every SceneParams field: the camera pack and the packed
  buffer are plain differentiable torch, so autograd chains dcam and
  dfields back to the fields, as JAX's `render_bwd` chains through
  `camera_pack`. With `full_height` and `with_row_table` it renders a
  shard of the row-sharded training step (parallel/sharded.py): `(params,
  rowtab) -> img`, the launch's H rows the image rows the table gives,
  one per 8-row block (`camera.launch_rows`), of an image full_height tall.

Both wrappers and their plain versions take the shard through
`full_height` and `rowtab` (f32 [ceil(H / 8)], on the tensors' device;
None: launch row y is image row cam[15] + y). `launches_table` counts the
launches of either kernel that read a row table.

A wrapper given CUDA tensors launches its kernel or raises; nothing falls
back to the plain version or to the CPU. `launches_fwd` and `launches_bwd`
count kernel launches (the reduce is part of the backward's one count). A
call inside a CUDA graph's capture launches nothing and is not counted; the
graph's replays launch the captured kernels without a wrapper call, and
parallel/sharded.py counts them as `train_step.replays`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_backend, resolve_device
from loltracer_tpu_torch.render.camera import CAM_SIZE, camera_pack, launch_rows, rays_from_rows
from loltracer_tpu_torch.render.cuda_scene import (
    TRAIN_BLOCKS,
    TRAIN_BLOCKS_PER_SM,
    TRAIN_BWD,
    TRAIN_FWD,
    TRAIN_REDUCE,
    TRAIN_ROW_BLOCK,
    generate_source,
    pack_fields,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.fused_fwd import _check
from loltracer_tpu_torch.render.march import march, ray_derivative
from loltracer_tpu_torch.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu_torch.render.shading import (
    envelope_reattach,
    get_normal,
    phong,
    segment_lit,
    shadow_march,
)
from loltracer_tpu_torch.render.torch_renderer import gamma_encode
from loltracer_tpu_torch.render.vecmath import clip, dot, maximum, normalize
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, params_to

__all__ = [
    "FusedTrainRender",
    "check_row_table",
    "launches_bwd",
    "launches_fwd",
    "launches_table",
    "make_training_renderer",
    "num_residuals",
    "shade_from_frozen",
    "train_backward",
    "train_backward_reference",
    "train_forward",
    "train_forward_reference",
]

launches_fwd = 0
launches_bwd = 0
launches_table = 0


def num_residuals(structure: SceneStructure) -> int:
    """Residual planes: t_sh, hit, mat, den + (res, t*) per light."""
    return 4 + 2 * structure.num_lights


def _params_of(structure: SceneStructure, cam: torch.Tensor, fields: torch.Tensor):
    """SceneParams views of the packed buffer; the camera position is
    cam[0:3] (the rays come from the pack, so fov and direction are unused)."""
    return SceneParams(
        **unpack_fields(structure, fields),
        cam_point=cam[0:3],
        cam_direction=cam[9:12],
        cam_fov=cam.new_zeros(()),
    )


def shade_from_frozen(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    res: torch.Tensor,
    height: int,
    width: int,
    rowtab: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The differentiable re-attachment (`pallas_train._shade_from_frozen`):
    the pipeline downstream of the frozen march and shadow marches, from the
    camera pack, the packed buffer and the residual planes res [R, r, W]
    of launch rows r of an image `height` rows tall (`rowtab`: their
    image rows, as the kernels'). Its value is the forward image [r, W, 3];
    its gradient in (cam, fields) is the IFT + Danskin + coverage estimator
    of the JAX package."""
    params = _params_of(structure, cam, fields)
    return reattach(structure, cfg, cam, params, make_scene_sdf(structure), res, height,
                    rowtab, TRAIN_ROW_BLOCK)


def reattach(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    params: SceneParams,
    sdf: Callable,
    res: torch.Tensor,
    full_height: int,
    rowtab: Optional[torch.Tensor] = None,
    block: int = TRAIN_ROW_BLOCK,
) -> torch.Tensor:
    """shade_from_frozen's pipeline over the SDF `sdf` at every site, for
    the launch rows 0..R-1 of an image of `full_height` rows (res [N, R,
    W]), image rows `camera.launch_rows(cam, R, rowtab, block)`;
    params.cam_point is the camera position. Returns [R, W, 3]."""
    height, width = res.shape[1], res.shape[2]
    t_sh, hit, den = res[0], res[1] > 0.5, res[3]
    mat = res[2].to(torch.long)
    mat = torch.where((mat >= 1) & (mat < structure.num_materials), mat, 0)
    ro, rd = rays_from_rows(cam, launch_rows(cam, height, rowtab, block), full_height, width)

    # one SDF evaluation at the frozen shading distance: the IFT numerator
    # on hits (point differentiable), the coverage numerator on AA misses
    # (point frozen)
    p_h = ro + t_sh[..., None] * rd
    f_at = sdf(params, torch.where(hit[..., None], p_h, p_h.detach()))
    corr = torch.where(hit, -f_at / den, 0.0)
    t_diff = t_sh + (corr - corr.detach())
    alpha = None
    t_shade = t_diff
    if cfg.antialias:
        safe_tc = torch.where(t_sh > 0, t_sh, 1.0)
        s = f_at / safe_tc
        edge = torch.where(t_sh > 0, clip(1.0 - s / cam[14], 0.0, 1.0), 0.0)
        alpha = torch.where(hit, 1.0, edge)
        t_shade = torch.where(hit, t_diff, t_sh)

    p = ro + t_shade[..., None] * rd
    n = get_normal(sdf, params, p, t_shade, cfg)

    def shadow_of(li, shadow_ro, light_dir, light_dist):
        res0, t_star = res[4 + 2 * li], res[5 + 2 * li]
        r = envelope_reattach(sdf, params, shadow_ro, light_dir, res0, t_star, cfg)
        return maximum(r, 0.0)

    color = phong(structure, params, p, n, mat, shadow_of, cfg)
    if alpha is not None:
        bg = clip(params.ambient_color * params.mat_ambient[0], 0.0, 1.0)
        color = alpha[..., None] * color + (1.0 - alpha[..., None]) * bg
    return gamma_encode(color, cfg.gamma)


def train_forward_reference(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    height: int,
    width: int,
    live: Optional[Dict] = None,
    full_height: Optional[int] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of lol_train_fwd on the tensors' device: the plain
    march and shadow marches (with t*; under cfg.shadow_cull the rays
    shading.segment_lit marks start done, as the kernel skips them), the
    denominator by autograd, the image from shade_from_frozen. Returns
    (img [H, W, 3], res [R, H, W]) of the launch's H rows of an image
    `full_height` (default H) rows tall, at the image rows of `rowtab`
    (module docstring). With `live` = {"march": [], "shadow": []}, the
    loops append their live-ray counts per step there (march.march's
    `live`); with "rays", an integer tensor [H, W], they add up each ray's
    SDF evaluations in it."""
    full_height = full_height or height
    with torch.no_grad():
        cam, fields = cam.detach(), fields.detach()
        params = _params_of(structure, cam, fields)
        sdf = make_scene_sdf(structure)
        ro, rd = rays_from_rows(cam, launch_rows(cam, height, rowtab, TRAIN_ROW_BLOCK),
                                full_height, width)
        res = residual_planes(structure, cfg, params, ro, rd, sdf, sdf, sdf,
                              make_scene_sdf_with_id(structure), live, cull=cfg.shadow_cull)
        img = shade_from_frozen(structure, cfg, cam, fields, res, full_height, width, rowtab)
    return img, res


def residual_planes(
    structure: SceneStructure,
    cfg: RenderConfig,
    params: SceneParams,
    ro: torch.Tensor,
    rd: torch.Tensor,
    sdf: Callable,
    shadow_sdf: Callable,
    den_sdf: Callable,
    sdf_id: Callable,
    live: Optional[Dict] = None,
    cull: bool = False,
) -> torch.Tensor:
    """The residual planes [R, H, W] of the rays (ro, rd [H, W, 3]): the
    march over `sdf`, the material of `sdf_id`'s argmin at the query point,
    the IFT denominator by autograd of `den_sdf`, and per light the shadow
    march over `shadow_sdf` (res, t*), started done where `cull` is set and
    shading.segment_lit marks the ray (a compiled structure's). With `live`
    = {"march": [], "shadow": []}, the loops append their live-ray counts
    per step there; with "rays", an integer tensor [H, W], they add up each
    ray's SDF evaluations in it."""
    live = live or {}
    rays = live.get("rays")
    m = march(sdf, params, ro, rd, cfg, live.get("march"), counts=rays)
    hit = m.t < cfg.max_dist
    if cfg.antialias:
        t_q = torch.where(hit, m.t_query, m.t_close)
        t_sh = torch.where(hit, m.t, t_q)
        _, oid = sdf_id(params, ro + t_q[..., None] * rd)
    else:
        t_sh = m.t
        _, oid = sdf_id(params, ro + m.t_query[..., None] * rd)
        oid = torch.where(hit, oid, 0)
    mat_ids = torch.tensor(structure.material_ids, device=oid.device)
    planes = [t_sh, hit.to(t_sh.dtype), mat_ids[oid.long()].to(t_sh.dtype)]
    planes.append(ray_derivative(den_sdf, params, ro, rd, m.t))
    p = ro + t_sh[..., None] * rd
    for li in range(structure.num_lights):
        to_light = params.light_point[li] - p
        light_dist = torch.sqrt(dot(to_light, to_light))
        light_dir = normalize(to_light)
        shadow_ro = p + light_dir * cfg.shadow_offset
        lit = (segment_lit(structure, params, shadow_ro, light_dir, light_dist, cfg.shadow_w)
               if cull else None)
        planes += list(shadow_march(shadow_sdf, params, shadow_ro, light_dir, light_dist, cfg,
                                    live.get("shadow"), init_done=lit, counts=rays))
    return torch.stack(planes)


def train_backward_reference(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    res: torch.Tensor,
    ct: torch.Tensor,
    full_height: Optional[int] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of lol_train_bwd: torch.autograd.grad of
    (shade_from_frozen(...) * ct).sum() in (cam, fields)."""
    height, width = ct.shape[0], ct.shape[1]
    with torch.enable_grad():
        cam = cam.detach().requires_grad_(True)
        fields = fields.detach().requires_grad_(True)
        img = shade_from_frozen(structure, cfg, cam, fields, res.detach(),
                                full_height or height, width, rowtab)
        dcam, dfields = torch.autograd.grad(
            (img * ct.detach()).sum(), (cam, fields), allow_unused=True
        )
    dcam = torch.zeros_like(cam) if dcam is None else dcam
    dfields = torch.zeros_like(fields) if dfields is None else dfields
    return dcam.detach(), dfields.detach()


@functools.lru_cache(maxsize=None)
def library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    """The built training kernels for this structure and config (compiled
    at first use, then loaded from the build cache)."""
    built = _build.build(generate_source(structure, cfg, residuals=True), "fused_train")
    lib, ptr, i32 = built.lib, ctypes.c_void_p, ctypes.c_int
    for name, args in (
        (TRAIN_FWD, [ptr] * 4 + [i32] * 3 + [ptr] * 2),
        (TRAIN_BWD, [ptr] * 5 + [i32] * 3 + [ptr] * 2),
        (TRAIN_REDUCE, [ptr, i32, ptr, ptr]),
        (TRAIN_BLOCKS, [i32, i32]),
        (TRAIN_BLOCKS_PER_SM, []),
    ):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return built


def bwd_blocks_per_sm(structure: SceneStructure, cfg: RenderConfig) -> int:
    """lol_train_bwd's resident blocks a SM at its shared memory, from the
    CUDA occupancy calculator (the card's; a block is 4 warps)."""
    n = getattr(library(structure, cfg).lib, TRAIN_BLOCKS_PER_SM)()
    if n < 0:
        raise RuntimeError(f"{TRAIN_BLOCKS_PER_SM} failed")
    return n


def _check_cuda_inputs(structure, cam, fields):
    _check("cam", cam, (CAM_SIZE,))
    _check("fields", fields, (packed_size(structure),))
    if cam.device != fields.device:
        raise ValueError(f"cam on {cam.device}, fields on {fields.device}")


def check_row_table(rowtab: Optional[torch.Tensor], height: int, full_height: int,
                    block: int, device) -> int:
    """The row table's pointer for a launch of `height` rows of an image
    `full_height` tall (0 for none): f32 [ceil(height / block)],
    contiguous, on `device`. Raises otherwise."""
    if height <= 0 or full_height < height:
        raise ValueError(f"{height} rows of a {full_height}-row image")
    if rowtab is None:
        return 0
    _check("rowtab", rowtab, (-(-height // block),))
    if rowtab.device != device:
        raise ValueError(f"rowtab on {rowtab.device}, the launch on {device}")
    return rowtab.data_ptr()


def train_forward(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    height: int,
    width: int,
    full_height: Optional[int] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(img [H, W, 3], res [R, H, W]): lol_train_fwd for CUDA tensors, the
    plain version for CPU tensors; H rows of an image `full_height`
    (default H) tall, at the image rows of `rowtab` (module docstring)."""
    full_height = full_height or height
    if resolve_backend(cam, fields, *_opt(rowtab)) == "torch":
        return train_forward_reference(structure, cfg, cam, fields, height, width,
                                       full_height=full_height, rowtab=rowtab)
    _check_cuda_inputs(structure, cam, fields)
    if height <= 0 or width <= 0:
        raise ValueError(f"bad image size {height}x{width}")
    lib = library(structure, cfg).lib
    tab = check_row_table(rowtab, height, full_height, TRAIN_ROW_BLOCK, cam.device)
    img = torch.empty((height, width, 3), dtype=torch.float32, device=cam.device)
    res = torch.empty(
        (num_residuals(structure), height, width), dtype=torch.float32, device=cam.device
    )
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, TRAIN_FWD)(
            cam.data_ptr(), fields.data_ptr(), img.data_ptr(), res.data_ptr(),
            height, full_height, width, tab, stream,
        )
        captured = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        raise RuntimeError(f"{TRAIN_FWD} launch failed: cudaError {rc}")
    if not captured:
        global launches_fwd, launches_table
        launches_fwd += 1
        launches_table += rowtab is not None
    return img, res


def train_backward(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    res: torch.Tensor,
    ct: torch.Tensor,
    full_height: Optional[int] = None,
    rowtab: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dcam [16], dfields [packed_size]) at the residuals for the image
    cotangent ct [H, W, 3]: lol_train_bwd + its reduce for CUDA tensors,
    the plain version for CPU tensors; H rows of an image `full_height`
    (default H) tall, at the image rows of `rowtab` (module docstring)."""
    if resolve_backend(cam, fields, res, ct, *_opt(rowtab)) == "torch":
        return train_backward_reference(structure, cfg, cam, fields, res, ct, full_height,
                                        rowtab)
    _check_cuda_inputs(structure, cam, fields)
    if ct.dim() != 3 or ct.shape[2] != 3 or min(ct.shape[:2]) <= 0:
        raise ValueError(f"ct must be [H, W, 3], got {tuple(ct.shape)}")
    height, width = ct.shape[0], ct.shape[1]
    _check("ct", ct, (height, width, 3))
    _check("res", res, (num_residuals(structure), height, width))
    if not cam.device == fields.device == res.device == ct.device:
        raise ValueError("cam, fields, res and ct must be on one device")
    lib = library(structure, cfg).lib
    tab = check_row_table(rowtab, height, full_height or height, TRAIN_ROW_BLOCK, cam.device)
    n = CAM_SIZE + packed_size(structure)
    blocks = getattr(lib, TRAIN_BLOCKS)(height, width)
    partials = torch.empty((blocks, n), dtype=torch.float32, device=cam.device)
    grads = torch.empty((n,), dtype=torch.float32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, TRAIN_BWD)(
            cam.data_ptr(), fields.data_ptr(), res.data_ptr(), ct.data_ptr(),
            partials.data_ptr(), height, full_height or height, width, tab, stream,
        )
        if rc != 0:
            raise RuntimeError(f"{TRAIN_BWD} launch failed: cudaError {rc}")
        rc = getattr(lib, TRAIN_REDUCE)(partials.data_ptr(), blocks, grads.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{TRAIN_REDUCE} launch failed: cudaError {rc}")
        captured = torch.cuda.is_current_stream_capturing()
    if not captured:
        global launches_bwd, launches_table
        launches_bwd += 1
        launches_table += rowtab is not None
    return grads[:CAM_SIZE], grads[CAM_SIZE:]


def _opt(t: Optional[torch.Tensor]) -> tuple:
    return () if t is None else (t,)


class FusedTrainRender(torch.autograd.Function):
    """img = render(cam, fields): train_forward in forward, train_backward
    in backward (the custom_vjp of pallas_train.make_training_renderer).
    The row table, when there is one, gets no cotangent (a zero)."""

    @staticmethod
    def forward(ctx, cam, fields, structure, cfg, height, width, full_height=None, rowtab=None):
        img, res = train_forward(structure, cfg, cam, fields, height, width, full_height, rowtab)
        ctx.save_for_backward(cam, fields, res, *_opt(rowtab))
        ctx.structure, ctx.cfg, ctx.full_height = structure, cfg, full_height
        return img

    @staticmethod
    def backward(ctx, ct):
        cam, fields, res, *rowtab = ctx.saved_tensors
        dcam, dfields = train_backward(
            ctx.structure, ctx.cfg, cam, fields, res, ct.contiguous(), ctx.full_height,
            rowtab[0] if rowtab else None,
        )
        return dcam, dfields, None, None, None, None, None, None


def make_training_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device="cuda",
    full_height: Optional[int] = None,
    with_row_table: bool = False,
) -> Callable[..., torch.Tensor]:
    """`params -> [H, W, 3] f32` through the fused training kernels,
    differentiable in every SceneParams field. Requires a compiled
    (non-instanced) structure and the envelope shadow estimator, as the JAX
    package does. Raises if `device` is a CUDA device and CUDA is not
    available: it never falls back to the CPU.

    Row-sharded use (parallel/sharded.py, `pallas_train.py:640-761`):
    `height` = this shard's rows, `full_height` = the image's, and
    `with_row_table=True`: the renderer takes `(params, rowtab)`, rowtab
    f32 [ceil(height / 8)] the absolute image row of each 8-row block of
    the launch (cam[15] stays 0). The launch holds exactly the shard's
    rows: a last block may be partial."""
    if structure.instanced:
        raise ValueError(
            "fused training kernels require a compiled (non-instanced) scene; instanced "
            "scenes train through instanced_train.make_instanced_training_renderer"
        )
    if cfg.shadow_grad != "envelope":
        raise ValueError(
            "fused training kernels implement the envelope shadow estimator; "
            f"got shadow_grad={cfg.shadow_grad!r}"
        )
    device = resolve_device(device, "make_training_renderer")
    fh = full_height or height

    def renderer(params: SceneParams, rowtab: Optional[torch.Tensor] = None) -> torch.Tensor:
        params = params_to(params, device=device, dtype=torch.float32)
        cam = camera_pack(params, fh, width, cfg)
        fields = pack_fields(structure, params)
        return FusedTrainRender.apply(cam, fields, structure, cfg, height, width, fh, rowtab)

    if not with_row_table:
        return lambda params: renderer(params)
    return table_renderer(renderer, height, TRAIN_ROW_BLOCK, "8-row group", device)


def table_renderer(renderer: Callable, height: int, block: int, what: str, device) -> Callable:
    """`(params, rowtab) -> img` over renderer(params, rowtab), the table
    checked (JAX's message) and moved to `device` as float32."""

    def renderer_tab(params: SceneParams, rowtab) -> torch.Tensor:
        rowtab = torch.as_tensor(rowtab).to(device=device, dtype=torch.float32).contiguous()
        have = -(-height // block)
        if tuple(rowtab.shape) != (have,):
            raise ValueError(f"row table must have one entry per {what} ({have}); "
                             f"got {tuple(rowtab.shape)}")
        return renderer(params, rowtab)

    return renderer_tab
