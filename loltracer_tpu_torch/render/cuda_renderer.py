"""The fused forward renderer (`loltracer_tpu/render/pallas_renderer.py`).

`make_cuda_renderer(structure, height, width, cfg, device)` returns
`params -> [H, W, 3] f32`: the camera pack and the packed scene buffer are
built in torch on `device`, then one call of `fused_forward` renders the
whole image — the CUDA kernel on a CUDA device, its plain version on the
CPU. There is no tile padding or crop: the kernel masks the ragged edge.
"""

from __future__ import annotations

from typing import Callable

import torch

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.fused_fwd import fused_forward
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, params_to, require_compiled


def make_cuda_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device="cuda",
) -> Callable[[SceneParams], torch.Tensor]:
    """Compile-once renderer for compiled (non-instanced) scenes. Raises if
    `device` is a CUDA device and CUDA is not available: it never falls
    back to the CPU."""
    require_compiled(structure)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_cuda_renderer: device 'cuda' requested but "
            "torch.cuda.is_available() is false"
        )

    def renderer(params: SceneParams) -> torch.Tensor:
        params = params_to(params, device=device, dtype=torch.float32)
        cam = camera_pack(params, height, width, cfg)
        fields = pack_fields(structure, params)
        return fused_forward(structure, cfg, cam, fields, height, width)

    return renderer
