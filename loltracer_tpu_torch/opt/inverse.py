"""Inverse rendering by gradient descent on the scene parameters
(`loltracer_tpu/opt/inverse.py`), on `torch.optim.Adam`.

`fit_scene` renders through the fused training kernels when
cfg.shadow_grad is "envelope", as the JAX package does (parallel/sharded.py
`_fused_row_renderer`): render/fused_train.make_training_renderer for
compiled structures, render/instanced_train.make_instanced_training_renderer
for instanced ones. Any other estimator takes the JAX package's jnp path
(`_jnp_row_renderer`): the differentiable renderer
render/torch_renderer.py, `render_image` for compiled structures and
`render_image_banded` in 16-row bands for instanced ones, whose frozen
march runs the march kernel K3 on CUDA (render/march_kernels.py) and the
plain loop on the CPU.
`optax.adam` and `torch.optim.Adam` share their defaults (betas 0.9 /
0.999, eps 1e-8) and their update rule.

Not ported yet (ROADMAP.md Queue 1): sharding over a mesh (waits for
`parallel/`) and checkpoints (optax and torch Adam states are different
formats); both raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_device
from loltracer_tpu_torch.render.fused_train import make_training_renderer
from loltracer_tpu_torch.render.instanced_train import make_instanced_training_renderer
from loltracer_tpu_torch.render.torch_renderer import render_image, render_image_banded
from loltracer_tpu_torch.scene import FIELDS, SceneParams, SceneStructure, params_to

# Parameter families it usually makes sense to optimize; the camera is
# excluded (optimizing it against a fixed-camera target is degenerate).
GEOMETRY_FIELDS = (
    "sphere_point",
    "sphere_radius",
    "box_point",
    "box_half",
    "box_radius",
    "plane_y",
    "smooth_k",
)
APPEARANCE_FIELDS = (
    "mat_shininess",
    "mat_diffuse",
    "mat_specular",
    "mat_ambient",
    "ambient_color",
    "light_point",
    "light_diffuse",
    "light_specular",
)
DEFAULT_TRAINABLE = GEOMETRY_FIELDS + APPEARANCE_FIELDS


def trainable_mask(params: SceneParams, fields: Sequence[str]) -> SceneParams:
    """SceneParams of bools marking the fields the optimizer updates."""
    unknown = set(fields) - set(FIELDS)
    if unknown:
        raise KeyError(f"unknown SceneParams fields: {sorted(unknown)}")
    return SceneParams(**{f: f in fields for f in FIELDS})


def trainable_leaves(params: SceneParams, fields: Sequence[str]) -> SceneParams:
    """Fresh copies of params: the listed fields as leaf tensors that
    require grad, every other field detached."""
    mask = trainable_mask(params, fields)
    return SceneParams(**{
        f: getattr(params, f).detach().clone().requires_grad_(getattr(mask, f))
        for f in FIELDS
    })


def masked_optimizer(
    params: SceneParams,
    fields: Sequence[str],
    inner: Callable[..., torch.optim.Optimizer] = torch.optim.Adam,
    **inner_kwargs,
) -> torch.optim.Optimizer:
    """`inner` over the listed fields of params and no other: every other
    field is never written, which is what the JAX package's masked_optimizer
    guarantees by zeroing their updates. The listed fields must be leaves
    that require grad (trainable_leaves makes them)."""
    mask = trainable_mask(params, fields)
    tensors = []
    for f in FIELDS:
        t = getattr(params, f)
        if getattr(mask, f):
            if not (t.is_leaf and t.requires_grad):
                raise ValueError(f"{f} must be a leaf tensor that requires grad")
            tensors.append(t)
        elif t.requires_grad:
            raise ValueError(f"{f} is not trainable but requires grad")
    return inner(tensors, **inner_kwargs)


def default_project(params: SceneParams) -> SceneParams:
    """Keep parameters in their valid domain after each update: radii and
    CSG smoothness positive, material colors and ambient non-negative
    (values in the domain pass bitwise unchanged)."""

    def at_least(t, lo):
        return torch.maximum(t, torch.full_like(t, lo))

    return dataclasses.replace(
        params,
        sphere_radius=at_least(params.sphere_radius, 1e-3),
        box_radius=at_least(params.box_radius, 0.0),
        box_half=at_least(params.box_half, 1e-3),
        smooth_k=at_least(params.smooth_k, 1e-3),
        mat_diffuse=at_least(params.mat_diffuse, 0.0),
        mat_specular=at_least(params.mat_specular, 0.0),
        mat_ambient=at_least(params.mat_ambient, 0.0),
        ambient_color=at_least(params.ambient_color, 0.0),
    )


class FitResult(NamedTuple):
    params: SceneParams
    losses: np.ndarray  # [steps]


def fit_scene(
    structure: SceneStructure,
    params: SceneParams,
    target,
    steps: int = 200,
    learning_rate: float = 1e-2,
    trainable: Sequence[str] = DEFAULT_TRAINABLE,
    cfg: RenderConfig = DEFAULT_CONFIG,
    mesh=None,
    project: Optional[Callable[[SceneParams], SceneParams]] = default_project,
    checkpoint_path: Optional[str] = None,
    device="cuda",
    log_every: int = 0,
) -> FitResult:
    """Adam-fit the scene to a target image [H, W, 3] (gamma-encoded, as
    the renderers output) on one device, loss mean((img - target)**2).
    Returns the fitted params (detached, on `device`) and the loss before
    each step. Raises if `device` is a CUDA device and CUDA is not
    available (it never falls back to the CPU). With `log_every`, prints
    `[fit] step i loss l` every that many steps and at the last, as the
    JAX package's fit_scene."""
    if mesh is not None:
        raise NotImplementedError(
            "fit_scene: sharding over a mesh is not ported yet (ROADMAP.md, "
            "Queue 1 item 6: parallel/)"
        )
    if checkpoint_path is not None:
        raise NotImplementedError(
            "fit_scene: checkpoints are not ported yet (ROADMAP.md, Queue 1 "
            "item 2)"
        )
    device = resolve_device(device, "fit_scene")
    target = torch.as_tensor(target).to(device=device, dtype=torch.float32)
    height, width = int(target.shape[0]), int(target.shape[1])
    if cfg.shadow_grad == "envelope":
        make = make_instanced_training_renderer if structure.instanced else make_training_renderer
        render = make(structure, height, width, cfg, device=device)
    elif structure.instanced:
        def render(p):
            return render_image_banded(structure, p, height, width, cfg, band_rows=16)
    else:
        def render(p):
            return render_image(structure, p, height, width, cfg)

    params = trainable_leaves(params_to(params, device=device, dtype=torch.float32), trainable)
    optimizer = masked_optimizer(params, trainable, lr=learning_rate)
    losses = []
    for i in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = ((render(params) - target) ** 2).mean()
        loss.backward()
        optimizer.step()
        if project is not None:
            with torch.no_grad():
                projected = project(params)
                for f in FIELDS:
                    getattr(params, f).copy_(getattr(projected, f))
        losses.append(loss.item())
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"[fit] step {i} loss {losses[-1]:.6g}")
    fitted = SceneParams(**{f: getattr(params, f).detach() for f in FIELDS})
    return FitResult(params=fitted, losses=np.asarray(losses))
