"""The fused forward renderer (`loltracer_tpu/render/pallas_renderer.py`).

`make_cuda_renderer(structure, height, width, cfg, device)` returns
`params -> [H, W, 3] f32`: the camera pack and the packed scene buffer are
built in torch on `device`, then one call of `fused_forward` renders the
whole image — the CUDA kernel on a CUDA device, its plain version on the
CPU. There is no tile padding or crop: the kernel masks the ragged edge.

Instanced structures go to `make_instanced_renderer`: per call the sphere
tables are packed once (render/instanced_pack.py), the cell grid is built
(render/cell_grid.py, on a CUDA device) and `instanced_forward` renders the
whole image in one launch (`pallas_train.make_instanced_renderer`).

Each call is the span `render.frame` (utils/tracing.py, its unit the
renderer's frame number), over `render.pack`, `cell_grid.build` and
`render.launch`. On the first frame that spans record after one they did
not (the first recorded frame of a recording), the instanced renderer
launches K5's counting twin (lol_instanced_render_stats, the same image
bitwise; 4.6 % slower than K5 at 4K, so not on every recorded frame),
whose grid counts `instanced_fwd.grid_counts` keeps on the card.
"""

from __future__ import annotations

import itertools
from typing import Callable

import torch

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_device
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cell_grid import grid_for
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.fused_fwd import fused_forward
from loltracer_tpu_torch.render.instanced_fwd import grid_counts, instanced_forward
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.scene import SceneParams, SceneStructure, params_to, require_instanced
from loltracer_tpu_torch.utils import tracing


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
    frames = itertools.count()

    def renderer(params: SceneParams) -> torch.Tensor:
        with tracing.span("render.frame", next(frames)):
            with tracing.span("render.pack"):
                params = params_to(params, device=device, dtype=torch.float32)
                cam = camera_pack(params, height, width, cfg)
                fields = pack_fields(structure, params)
            with tracing.span("render.launch"):
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
    frames = itertools.count()
    was_on = False  # whether spans recorded the previous frame

    def renderer(params: SceneParams) -> torch.Tensor:
        nonlocal was_on
        with tracing.span("render.frame", next(frames)):
            with tracing.span("render.pack"):
                params = params_to(params, device=device, dtype=torch.float32)
                cam = camera_pack(params, height, width, cfg)
                fields = pack_fields(structure, params)
                tables = pack_instanced(structure, params)
            grid = stats = None
            if device.type == "cuda":
                grid = grid_for(tables, cfg.step_clamp)
                on = tracing.on()
                if on and not was_on:
                    stats = grid_counts(device, height * width)
                was_on = on
            with tracing.span("render.launch"):
                return instanced_forward(structure, cfg, cam, fields, tables, height, width,
                                         grid=grid, stats=stats)

    return renderer
