"""The plain PyTorch renderer (`loltracer_tpu/render/jnp_renderer.py`).

Renders a whole [H, W] ray batch through the full pipeline — camera rays,
march, tetrahedron normals, per-light soft shadows, Phong, optional
soft-coverage AA, gamma — in batched torch ops. It runs on any device; it
is the plain version that the fused CUDA kernel is held against
(render/fused_fwd.py) and what CPU tensors render through.

`render_image` is differentiable with the JAX package's estimators (the
IFT at the frozen march, the coverage alpha, the shadow gradient of
cfg.shadow_grad): autograd through it is the twin of `jax.grad` through
the jnp renderer; `make_renderer` wraps it, differentiable too, as JAX's,
and `render_scene` is its one-shot call on a `Scene`.
`dtype` (f32 by default) is the rays' type: float64 rays over float64
params render in float64, as the JAX package's `dtype` argument does.
`render_image_banded` renders in sequential row bands, the same image with
one band's temporaries at a time (instanced scenes evaluate [rays, 512]
blocks at every SDF call).

The frozen marches run where cfg.march_backend resolves them
(render/backend.py `resolve_march_backend`), as the JAX package's
`_select_march` / `_select_shadow_march` do: on CUDA tensors under "auto"
the march kernel K3 for any estimator, the shadow march kernel K4 for
"envelope" and, on compiled structures, K4x / K4xb for "exact" (the
march and its adjoint, render/march_kernels.py `make_cuda_exact_shadow`);
the plain loops on CPU tensors or under "jnp", and for instanced
structures' exact shadows. The plain versions of the earlier kernels pin
"jnp".
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_device, resolve_march_backend
from loltracer_tpu_torch.render.camera import camera_rays, camera_rays_for_rows
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.march import intersect_aa
from loltracer_tpu_torch.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu_torch.render.shading import get_normal, shade
from loltracer_tpu_torch.render.vecmath import clip, true_div
from loltracer_tpu_torch.scene import Scene, SceneParams, SceneStructure, params_to
from loltracer_tpu_torch.utils import tracing


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


def _march_kernels(structure: SceneStructure, params: SceneParams, rd, cfg: RenderConfig,
                   live: Optional[Dict], scene) -> Tuple[Optional[Callable], Optional[Callable]]:
    """(march_fn, shadow_march_fn) of this call: None each for the plain
    loops, or, where cfg.march_backend resolves to the kernels for rd, K3
    for any estimator over `scene` (the MarchScene of params, packed here
    when None), K4 for "envelope" shadows and, on a compiled structure,
    K4x / K4xb for "exact" ones over the packed buffer with its graph (the
    plain loop for an instanced structure's)."""
    if resolve_march_backend(cfg.march_backend, rd) == "jnp":
        return None, None
    if live is not None:
        raise ValueError(
            "live-ray counting runs the plain loops: pass march_backend='jnp' with `live`"
        )
    from loltracer_tpu_torch.render import march_kernels

    fields = None
    if cfg.shadow_grad == "exact" and not structure.instanced:
        fields = pack_fields(structure, params)
        if scene is None:
            scene = march_kernels.MarchScene(fields.detach(), None)
    if scene is None:
        scene = march_kernels.pack_march_scene(structure, params)
    march_fn = functools.partial(march_kernels.make_cuda_march(structure, cfg), scene=scene)
    shadow_fn = None
    if cfg.shadow_grad == "envelope":
        shadow_fn = functools.partial(
            march_kernels.make_cuda_shadow_march(structure, cfg), scene=scene)
    elif fields is not None:
        shadow_fn = functools.partial(
            march_kernels.make_cuda_exact_shadow(structure, cfg), fields=fields)
    return march_fn, shadow_fn


def render_rays(
    structure: SceneStructure,
    params: SceneParams,
    ro,
    rd,
    cfg: RenderConfig = DEFAULT_CONFIG,
    pixel_rad=None,
    live: Optional[Dict] = None,
    march_scene=None,
    sdf: Optional[Callable] = None,
    sdf_id: Optional[Callable] = None,
    shadow_sdf: Optional[Callable] = None,
):
    """Render ray batches: ro [3] or [..., 3], rd [..., 3] -> gamma-encoded
    RGB [..., 3]. With cfg.antialias and a pixel_rad (see pixel_radius),
    silhouettes get soft coverage.

    Instanced structures march, look up materials and take normal taps
    under cfg.step_clamp, and march shadows under
    cfg.effective_shadow_clamp() (the JAX package's render_rays). With
    `live` = {"march": [], "shadow": []} (and optionally "probe", a
    callable), the loops report their live rays per step (march.march);
    that needs the plain loops. `march_scene` is the kernels' packed view
    of params (march_kernels.pack_march_scene), when the caller has one.

    `sdf` / `sdf_id` / `shadow_sdf` override the scene's distance (the
    object-sharded renderer, parallel/objects.py, passes its all-reduced
    ones), as in the JAX package: an `sdf` override runs the plain march
    loops (the march kernels compile the structure's own distance), and
    with a shadow clamp other than the step clamp it needs a `shadow_sdf`
    of its own, else ValueError."""
    clamp = cfg.step_clamp if structure.instanced else None
    shadow_clamp = cfg.effective_shadow_clamp() if structure.instanced else None
    override = sdf is not None
    if sdf is None:
        sdf = make_scene_sdf(structure, clamp)
    if sdf_id is None:
        sdf_id = make_scene_sdf_with_id(structure, clamp)
    if shadow_sdf is None:
        if shadow_clamp == clamp:
            shadow_sdf = sdf
        elif override:
            raise ValueError(
                "shadow_step_clamp differs from step_clamp but the sdf override "
                "supplies no shadow_sdf"
            )
        else:
            shadow_sdf = make_scene_sdf(structure, shadow_clamp)
    march_fn = shadow_fn = None
    if not override:
        march_fn, shadow_fn = _march_kernels(structure, params, rd, cfg, live, march_scene)
    use_aa = cfg.antialias and pixel_rad is not None
    # the stages' spans (utils/tracing.py), named as the JAX package's
    # jax.named_scope
    with tracing.span("lol_march"):
        t, obj_id, alpha, _ = intersect_aa(
            sdf, sdf_id, params, ro, rd, cfg, pixel_rad if use_aa else None, live, march_fn
        )
    p = ro + t[..., None] * rd
    with tracing.span("lol_normal"):
        n = get_normal(sdf, params, p, t, cfg)
    with tracing.span("lol_shade"):
        color = shade(structure, params, shadow_sdf, p, n, obj_id, cfg, live, shadow_fn)
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
    dtype: torch.dtype = torch.float32,
):
    """Render the full image: [H, W, 3] in [0, 1], differentiable in
    params; rays in `dtype`."""
    ro, rd = camera_rays(params, height, width, cfg, dtype)
    pr = pixel_radius(params, height, cfg) if cfg.antialias else None
    return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr)


def render_image_banded(
    structure: SceneStructure,
    params: SceneParams,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    band_rows: int = 64,
    dtype: torch.dtype = torch.float32,
):
    """`render_image` in sequential bands of `band_rows` full-width rows
    (the last band may be shorter): the same image, bitwise, with the
    temporaries of one band alive at a time (the JAX package's
    render_image_banded, which maps over bands with lax.map). Under
    autograd each band is checkpointed, as there: its forward runs again
    in the backward, so one band's intermediates are alive at a time. The
    march kernels' view of params is packed once for all bands."""
    pr = pixel_radius(params, height, cfg) if cfg.antialias else None
    scene = None
    if resolve_march_backend(cfg.march_backend, params.cam_point) == "pallas":
        from loltracer_tpu_torch.render.march_kernels import pack_march_scene

        scene = pack_march_scene(structure, params)

    def band(r0: int):
        rows = torch.arange(r0, min(r0 + band_rows, height))
        ro, rd = camera_rays_for_rows(params, rows, height, width, cfg, dtype)
        return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr, march_scene=scene)

    remat = torch.is_grad_enabled()
    bands = [checkpoint(band, r0, use_reentrant=False, preserve_rng_state=False) if remat
             else band(r0) for r0 in range(0, height, band_rows)]
    return torch.cat(bands, dim=0)


def make_renderer(
    structure: SceneStructure,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device=None,
    dtype: torch.dtype = torch.float32,
) -> Callable[[SceneParams], torch.Tensor]:
    """`params -> [H, W, 3]` for this structure, size and config; it is
    differentiable (callers that only render wrap their own `no_grad`).
    With `device`, params go there as `dtype` first (raises for CUDA
    without CUDA); else they render where they are. Rays in `dtype`."""
    if device is not None:
        device = resolve_device(device, "make_renderer")

    def renderer(params: SceneParams) -> torch.Tensor:
        if device is not None:
            params = params_to(params, device=device, dtype=dtype)
        return render_image(structure, params, height, width, cfg, dtype)

    return renderer


def render_scene(
    scene: Scene,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    device=None,
) -> torch.Tensor:
    """One-shot render of a compiled scene (differentiable, as
    `make_renderer`); with `device`, its params go there first."""
    return make_renderer(scene.structure, height, width, cfg, device=device)(scene.params)
