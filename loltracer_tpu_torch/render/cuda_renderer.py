"""The fused forward renderer (`loltracer_tpu/render/pallas_renderer.py`).

`make_cuda_renderer(structure, height, width, cfg, device)` returns
`params -> [H, W, 3] f32`: the camera pack and the packed scene buffer are
built in torch on `device`, then one call of `fused_forward` renders the
whole image — the CUDA kernel on a CUDA device, its plain version on the
CPU. There is no tile padding or crop: the kernel masks the ragged edge.

Instanced structures go to `make_instanced_renderer`: per call the sphere
tables are packed once (render/instanced_pack.py) and `instanced_forward`
renders the whole image in one launch (`pallas_train.make_instanced_renderer`).
"""

from __future__ import annotations

from typing import Callable

import torch

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_device
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.fused_fwd import fused_forward
from loltracer_tpu_torch.render.instanced_fwd import instanced_forward
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, params_to, require_instanced


def make_cuda_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device="cuda",
) -> Callable[[SceneParams], torch.Tensor]:
    """Compile-once renderer; instanced structures go to
    make_instanced_renderer. Raises if `device` is a CUDA device and CUDA
    is not available: it never falls back to the CPU."""
    if structure.instanced:
        return make_instanced_renderer(structure, height, width, cfg, device)
    device = resolve_device(device, "make_cuda_renderer")

    def renderer(params: SceneParams) -> torch.Tensor:
        params = params_to(params, device=device, dtype=torch.float32)
        cam = camera_pack(params, height, width, cfg)
        fields = pack_fields(structure, params)
        return fused_forward(structure, cfg, cam, fields, height, width)

    return renderer


def make_instanced_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device="cuda",
) -> Callable[[SceneParams], torch.Tensor]:
    """`params -> [H, W, 3] f32` for an instanced structure: the tables are
    packed once per call, then one launch of lol_instanced_render on a
    CUDA device (its plain version on the CPU). Raises for CUDA without
    CUDA."""
    require_instanced(structure)
    device = resolve_device(device, "make_instanced_renderer")

    def renderer(params: SceneParams) -> torch.Tensor:
        params = params_to(params, device=device, dtype=torch.float32)
        cam = camera_pack(params, height, width, cfg)
        fields = pack_fields(structure, params)
        tables = pack_instanced(structure, params)
        return instanced_forward(structure, cfg, cam, fields, tables, height, width)

    return renderer
