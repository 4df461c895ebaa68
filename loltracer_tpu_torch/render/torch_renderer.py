"""The plain PyTorch renderer (`loltracer_tpu/render/jnp_renderer.py`).

Renders a whole [H, W] ray batch through the full pipeline — camera rays,
march, tetrahedron normals, per-light soft shadows, Phong, optional
soft-coverage AA, gamma — in batched torch ops. It runs on any device; it
is the plain version that the fused CUDA kernel is held against
(render/fused_fwd.py) and what CPU tensors render through.

`render_image` is differentiable with the JAX package's estimators (the
IFT at the frozen march, the coverage alpha, the shadow gradient of
cfg.shadow_grad): autograd through it is the twin of `jax.grad` through
the jnp renderer. `make_renderer` renders without autograd;
`render_image_banded` renders in sequential row bands, the same image with
one band's temporaries at a time (instanced scenes evaluate [rays, 512]
blocks at every SDF call).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.camera import camera_rays, camera_rays_for_rows
from loltracer_tpu_torch.render.march import intersect_aa
from loltracer_tpu_torch.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu_torch.render.shading import get_normal, shade
from loltracer_tpu_torch.render.vecmath import clip, true_div
from loltracer_tpu_torch.scene import SceneParams, SceneStructure


def pixel_radius(params: SceneParams, height: int, cfg: RenderConfig):
    """Angular half-size of a pixel at the view center: the view half-height
    (atan(fov/2), the reference's projection quirk) spans height/2 pixels."""
    half = params.cam_fov / 2.0
    half = torch.atan(half) if cfg.atan_fov else torch.tan(half)
    return true_div(cfg.aa_width * half, height)


def gamma_encode(color, gamma: float):
    """color ** gamma, 0 where color <= 0."""
    positive = color > 0
    return torch.where(positive, torch.where(positive, color, 1.0) ** gamma, 0.0)


def render_rays(
    structure: SceneStructure,
    params: SceneParams,
    ro,
    rd,
    cfg: RenderConfig = DEFAULT_CONFIG,
    pixel_rad=None,
    live: Optional[Dict] = None,
):
    """Render ray batches: ro [3] or [..., 3], rd [..., 3] -> gamma-encoded
    RGB [..., 3]. With cfg.antialias and a pixel_rad (see pixel_radius),
    silhouettes get soft coverage.

    Instanced structures march, look up materials and take normal taps
    under cfg.step_clamp, and march shadows under
    cfg.effective_shadow_clamp() (the JAX package's render_rays). With
    `live` = {"march": [], "shadow": []} (and optionally "probe", a
    callable), the loops report their live rays per step (march.march)."""
    clamp = cfg.step_clamp if structure.instanced else None
    shadow_clamp = cfg.effective_shadow_clamp() if structure.instanced else None
    sdf = make_scene_sdf(structure, clamp)
    sdf_id = make_scene_sdf_with_id(structure, clamp)
    shadow_sdf = sdf if shadow_clamp == clamp else make_scene_sdf(structure, shadow_clamp)
    use_aa = cfg.antialias and pixel_rad is not None
    t, obj_id, alpha, _ = intersect_aa(
        sdf, sdf_id, params, ro, rd, cfg, pixel_rad if use_aa else None, live
    )
    p = ro + t[..., None] * rd
    n = get_normal(sdf, params, p, t, cfg)
    color = shade(structure, params, shadow_sdf, p, n, obj_id, cfg, live)
    if use_aa:
        # blend toward the background (material 0 ambient) in linear space
        bg = clip(params.ambient_color * params.mat_ambient[0], 0.0, 1.0)
        color = alpha[..., None] * color + (1.0 - alpha[..., None]) * bg
    return gamma_encode(color, cfg.gamma)


def render_image(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
):
    """Render the full image: [H, W, 3] float32 in [0, 1], differentiable
    in params."""
    ro, rd = camera_rays(params, height, width, cfg)
    pr = pixel_radius(params, height, cfg) if cfg.antialias else None
    return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr)


def render_image_banded(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    band_rows: int = 64,
):
    """`render_image` in sequential bands of `band_rows` full-width rows
    (the last band may be shorter): the same image, bitwise, with the
    temporaries of one band alive at a time (the JAX package's
    render_image_banded, which maps over bands with lax.map)."""
    pr = pixel_radius(params, height, cfg) if cfg.antialias else None
    bands = []
    for r0 in range(0, height, band_rows):
        rows = torch.arange(r0, min(r0 + band_rows, height))
        ro, rd = camera_rays_for_rows(params, rows, height, width, cfg)
        bands.append(render_rays(structure, params, ro, rd, cfg, pixel_rad=pr))
    return torch.cat(bands, dim=0)


def make_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> Callable[[SceneParams], torch.Tensor]:
    """`params -> [H, W, 3]` for this structure, size and config."""

    @torch.no_grad()
    def renderer(params: SceneParams) -> torch.Tensor:
        return render_image(structure, params, height, width, cfg)

    return renderer
