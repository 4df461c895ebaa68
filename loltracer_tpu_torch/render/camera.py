"""Pinhole camera (`loltracer_tpu/render/camera.py` and
`pallas_train.camera_pack`).

Reproduces the reference's projection including its atan quirk: the view
plane half-height is atan(fov/2), not tan(fov/2) (RenderConfig.atan_fov).
The camera direction is renormalized here, as in the JAX package.

All rays come from the 16-scalar camera pack, the kernel's camera input, so
the plain version and the CUDA kernel build their rays from the same
numbers with the same operations.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.vecmath import cross, normalize, true_div
from loltracer_tpu_torch.scene import SceneParams

CAM_SIZE = 16  # ro(3) right(3) up(3) fwd(3) half_w half_h pixel_rad row0


def camera_pack(
    params: SceneParams, height: int, width: int, cfg: RenderConfig, row0=0.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[16] `dtype` (the kernels' f32 by default) on the params' device: the
    camera-derived scalars the kernel consumes. `row0` is the first image
    row the call renders."""
    d = normalize(params.cam_direction.to(dtype))
    rt = normalize(_cross_world_up(d))
    up = cross(rt, d)
    half = params.cam_fov.to(dtype) / 2.0
    hh = torch.atan(half) if cfg.atan_fov else torch.tan(half)
    hw = (width / height) * hh
    pixel_rad = true_div(cfg.aa_width * hh, height)
    tail = torch.stack([hw, hh, pixel_rad, torch.full_like(hh, float(row0))])
    return torch.cat([params.cam_point.to(dtype), rt, up, d, tail]).contiguous()


def _cross_world_up(d: torch.Tensor) -> torch.Tensor:
    """cross(d, (0, 1, 0)): vecmath.cross's terms with the up vector's
    entries as Python numbers, so the same products and differences,
    bitwise, with no tensor copied from the host (which a CUDA graph
    cannot capture)."""
    return torch.stack([
        d[..., 1] * 0.0 - d[..., 2] * 1.0,
        d[..., 2] * 0.0 - d[..., 0] * 0.0,
        d[..., 0] * 1.0 - d[..., 1] * 0.0,
    ], dim=-1)


def launch_rows(
    cam: torch.Tensor, n: int, rowtab: Optional[torch.Tensor] = None, block: int = 1
) -> torch.Tensor:
    """The image rows [n] (cam's dtype) of a launch's rows y = 0..n-1:
    cam[15] + y, or under a row table (one absolute image row per `block`
    launch rows, parallel/sharded.py) rowtab[y // block] + y % block, as
    the kernels' `image_row` and JAX's `_rays_from_cam` build them. Every
    term is a small exact integer, so a table row0 + block * k gives the
    rows of cam[15] = row0 bitwise."""
    y = torch.arange(n, device=cam.device)
    if rowtab is None:
        return cam[15] + y.to(cam.dtype)
    return rowtab.to(dtype=cam.dtype)[y // block] + (y % block).to(cam.dtype)


def rays_from_pack(
    cam: torch.Tensor, rows: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ro [3], rd [R, W, 3]) for image rows cam[15] + rows."""
    return rays_from_rows(cam, cam[15] + rows.to(dtype=cam.dtype, device=cam.device),
                          height, width)


def rays_from_rows(
    cam: torch.Tensor, y: torch.Tensor, height: int, width: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ro [3], rd [R, W, 3]) for the image rows y [R] (cam's dtype) of an
    image `height` rows tall. Pixel centers map to NDC as ((x+.5)/W*2-1,
    1-(y+.5)/H*2); the kernel computes the same expressions per pixel."""
    ro, rt, up, fw = cam[0:3], cam[3:6], cam[6:9], cam[9:12]
    x = torch.arange(width, dtype=cam.dtype, device=cam.device)
    vx = true_div(x + 0.5, width) * 2.0 - 1.0
    vy = 1.0 - true_div(y + 0.5, height) * 2.0
    rd = (
        rt * (vx * cam[12])[None, :, None]
        + up * (vy * cam[13])[:, None, None]
        + fw
    )
    return ro, normalize(rd)


def camera_rays_for_rows(
    params: SceneParams, rows: torch.Tensor, height_px: int, width_px: int,
    cfg: RenderConfig, dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ray grid for a subset of image rows. rows: [R] row indices. Returns
    (ro [3], rd [R, W, 3]) in `dtype`."""
    cam = camera_pack(params, height_px, width_px, cfg, dtype=dtype)
    return rays_from_pack(cam, rows, height_px, width_px)


def camera_rays(
    params: SceneParams, height_px: int, width_px: int, cfg: RenderConfig,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-image ray grid. Returns (ro [3], rd [H, W, 3]) in `dtype`;
    aspect = W/H."""
    rows = torch.arange(height_px)
    return camera_rays_for_rows(params, rows, height_px, width_px, cfg, dtype)
