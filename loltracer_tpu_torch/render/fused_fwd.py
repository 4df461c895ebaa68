"""The fused forward render: the hand-written CUDA kernel and its plain
PyTorch version (`loltracer_tpu/render/pallas_train.py`, forward half).

`fused_forward(structure, cfg, cam, fields, height, width)` renders
[H, W, 3] f32 from the 16-scalar camera pack (`camera.camera_pack`, plain
torch on both paths) and the packed scene buffer (`cuda_scene.pack_fields`):

- CUDA tensors launch `lol_render_fused` (csrc/fused_fwd.cuh, one thread
  per ray; the port of `pallas_train._train_fwd_kernel` with residuals off),
  built for this structure at first use. A failed build or launch raises;
  nothing falls back.
- CPU tensors go to `fused_forward_reference`, the plain version: the
  torch renderer (render/torch_renderer.py) fed from the same camera pack
  and buffer.

`launches` counts kernel launches; the plain version never adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.backend import resolve_backend
# camera_pack lives in camera.py, which builds every ray from it; it is
# exported here too, beside the kernel that consumes it.
from loltracer_tpu_torch.render.camera import CAM_SIZE, camera_pack, rays_from_pack
from loltracer_tpu_torch.render.cuda_scene import (
    ENTRY,
    generate_source,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.torch_renderer import render_rays
from loltracer_tpu_torch.scene import SceneParams, SceneStructure

__all__ = [
    "CAM_SIZE",
    "camera_pack",
    "fused_forward",
    "fused_forward_reference",
    "launches",
    "library",
]

launches = 0


def fused_forward_reference(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    height: int,
    width: int,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on the tensors' device:
    `torch_renderer.render_rays` over the camera pack's rays and the
    buffer's numbers, its marches pinned to the plain loops
    (march_backend "jnp": no kernel runs in it). Returns [H, W, 3] f32."""
    unpacked = unpack_fields(structure, fields)
    params = SceneParams(
        **unpacked,
        cam_point=cam[0:3],
        cam_direction=cam[9:12],
        cam_fov=cam.new_zeros(()),  # unused: the rays come from the pack
    )
    ro, rd = rays_from_pack(cam, torch.arange(height), height, width)
    with torch.no_grad():
        return render_rays(
            structure, params, ro, rd, cfg.replace(march_backend="jnp"),
            pixel_rad=cam[14] if cfg.antialias else None,
        )


@functools.lru_cache(maxsize=None)
def library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    """The built kernel for this structure and config (compiled at first
    use, then loaded from the build cache)."""
    built = _build.build(generate_source(structure, cfg), "fused_fwd")
    fn = getattr(built.lib, ENTRY)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return built


def _check(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def fused_forward(
    structure: SceneStructure,
    cfg: RenderConfig,
    cam: torch.Tensor,
    fields: torch.Tensor,
    height: int,
    width: int,
) -> torch.Tensor:
    """Render [H, W, 3] f32: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (render/backend.py)."""
    if resolve_backend(cam, fields) == "torch":
        return fused_forward_reference(structure, cfg, cam, fields, height, width)
    _check("cam", cam, (CAM_SIZE,))
    _check("fields", fields, (packed_size(structure),))
    if cam.device != fields.device:
        raise ValueError(f"cam on {cam.device}, fields on {fields.device}")
    if height <= 0 or width <= 0:
        raise ValueError(f"bad image size {height}x{width}")
    lib = library(structure, cfg).lib
    img = torch.empty((height, width, 3), dtype=torch.float32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, ENTRY)(cam.data_ptr(), fields.data_ptr(), img.data_ptr(), height,
                                 width, stream)
    if rc != 0:
        raise RuntimeError(f"{ENTRY} launch failed: cudaError {rc}")
    global launches
    launches += 1
    return img
