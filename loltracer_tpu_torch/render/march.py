"""Sphere-trace march (`loltracer_tpu/render/march.py`), differentiable.

Up to `max_steps` iterations, each evaluating the scene SDF at
p = ro + t*rd and accumulating t += d, stopping when d < epsilon or
t > max_dist; the hit id is the argmin id at the last query point (the
pre-accumulation t), and id 0 (miss) when the final t >= max_dist.

The loop is masked over the whole batch: done rays freeze, and the loop
ends once every ray is done. It runs without autograd; `intersect_aa`
re-attaches the gradient as the JAX package does: the implicit-function
theorem at hits, t + (corr - corr.detach()) with corr = -f(p_hit)/den and
den the SDF's derivative along the ray (computed without grad, clamped
away from zero by MIN_DEN), and the soft-coverage alpha differentiable at
the frozen closest approach. Values do not change.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.vecmath import clip

MIN_DEN = 1e-2  # grazing-hit guard of the IFT denominator (JAX march.py _MIN_DEN)


class MarchResult(NamedTuple):
    """Raw march outputs, per ray."""

    t: torch.Tensor  # final accumulated distance
    t_query: torch.Tensor  # t of the last SDF evaluation (for hit-id lookup)
    s_min: torch.Tensor  # min over steps of d/t: angular closest approach
    t_close: torch.Tensor  # t at which s_min was attained


def march(
    sdf: Callable, params, ro, rd, cfg: RenderConfig, live: Optional[List[int]] = None,
    probe: Optional[Callable] = None, counts: Optional[torch.Tensor] = None,
) -> MarchResult:
    """Masked march of rays ro [..., 3] (broadcastable) along unit rd
    [..., 3]; also tracks the angular closest approach min_i d_i/t_i for
    soft-coverage antialiasing. If `live` is a list, the number of rays
    still marching at each step (the SDF evaluations a thread-per-ray
    kernel makes) is appended to it; `probe`, if given, is called at each
    step with the points [n, 3] of those rays; `counts`, an integer tensor
    of the batch's shape, gets one added for each ray at each step it
    evaluates."""
    batch = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1])
    kw = dict(dtype=rd.dtype, device=rd.device)
    t = torch.zeros(batch, **kw)
    t_query = torch.zeros(batch, **kw)
    s_min = torch.full(batch, float("inf"), **kw)
    t_close = torch.zeros(batch, **kw)
    done = torch.zeros(batch, dtype=torch.bool, device=rd.device)
    for _ in range(cfg.max_steps):
        if bool(done.all()):
            break
        if live is not None:
            live.append(int((~done).sum()))
        if counts is not None:
            counts += ~done
        p = ro + t[..., None] * rd
        if probe is not None:
            probe(p[~done])
        d = sdf(params, p)
        new_t = t + d
        track = ~done & (t > 0)
        s = d / torch.where(t > 0, t, 1.0)
        better = track & (s < s_min)
        s_min = torch.where(better, s, s_min)
        t_close = torch.where(better, t, t_close)
        t_query = torch.where(done, t_query, t)
        t = torch.where(done, t, new_t)
        done = done | (d < cfg.epsilon) | (new_t > cfg.max_dist)
    return MarchResult(t, t_query, s_min, t_close)


def ray_derivative(sdf: Callable, params, ro, rd, t):
    """d/dt sdf(ro + t rd) at t, without grad to anything, clamped away from
    zero to +/-MIN_DEN (the IFT denominator)."""
    frozen = type(params)(**{f: v.detach() for f, v in vars(params).items()})
    # its own graph, consumed here: under a checkpoint (a band of
    # render_image_banded) its saved tensors stay out of the checkpoint, so
    # this grad does not set off the band's recomputation
    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(lambda x: x, lambda x: x):
        tt = t.detach().requires_grad_(True)
        f = sdf(frozen, ro.detach() + tt[..., None] * rd.detach())
        (den,) = torch.autograd.grad(f.sum(), tt)
    return torch.where(
        den.abs() < MIN_DEN, torch.where(den < 0, -MIN_DEN, MIN_DEN), den
    )


def intersect(
    sdf: Callable,
    sdf_with_id: Callable,
    params,
    ro,
    rd,
    cfg: RenderConfig,
    march_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable intersection: (t [...], id [...]), as the JAX
    package's `intersect`. The value of t is the marched distance; its
    gradient the IFT hit-point derivative (zero for miss rays). id is the
    argmin id at the last march query point, 0 where t >= max_dist."""
    t, obj_id, _, _ = intersect_aa(
        sdf, sdf_with_id, params, ro, rd, cfg, pixel_rad=None, march_fn=march_fn
    )
    return t, obj_id


def intersect_aa(
    sdf: Callable,
    sdf_with_id: Callable,
    params,
    ro,
    rd,
    cfg: RenderConfig,
    pixel_rad=None,
    live: Optional[Dict] = None,
    march_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable intersection with optional soft coverage; returns
    (t_shade, id_shade, alpha, hit), as the JAX package's `intersect_aa`.
    `march_fn(params, ro, rd) -> MarchResult`, when given, replaces the
    plain march for the frozen values (the march kernel K3,
    render/march_kernels.py); the gradient is re-attached the same way.

    With pixel_rad=None: the marched t and the argmin id at the last query
    point (0 on a miss), alpha == 1. With pixel_rad (the pixel's angular
    half-size): miss rays shade at their closest approach with that
    point's id, and blend by alpha = clamp(1 - s/pixel_rad, 0, 1) where
    s = f(closest approach) / t, differentiable in the scene at the frozen
    point. Under torch.no_grad the re-attachment is skipped: its value is
    the marched t. `live` ({"march": list, "probe": callable}, both
    optional) is handed to the march.
    """
    live = live or {}
    with torch.no_grad():
        if march_fn is not None:
            res = march_fn(params, ro, rd)
        else:
            res = march(sdf, params, ro, rd, cfg, live.get("march"), live.get("probe"))
    t0 = res.t
    hit = t0 < cfg.max_dist

    t_diff = t0
    if torch.is_grad_enabled():
        den = ray_derivative(sdf, params, ro, rd, t0)
        fval = sdf(params, ro + t0[..., None] * rd)
        corr = torch.where(hit, -fval / den, 0.0)
        t_diff = t0 + (corr - corr.detach())

    if pixel_rad is None:
        with torch.no_grad():
            _, obj_id = sdf_with_id(params, ro + res.t_query[..., None] * rd)
        obj_id = torch.where(hit, obj_id, 0)
        return t_diff, obj_id, torch.ones_like(t0), hit

    t_close = torch.where(hit, res.t_query, res.t_close)
    safe_tc = torch.where(t_close > 0, t_close, 1.0)
    f_close, id_close = sdf_with_id(
        params, ro.detach() + t_close[..., None] * rd.detach()
    )
    s = f_close / safe_tc
    # rays that never tracked a closest approach (t_close == 0) stay alpha 0
    edge_alpha = torch.where(
        t_close > 0, clip(1.0 - s / pixel_rad, 0.0, 1.0), 0.0
    )
    alpha = torch.where(hit, 1.0, edge_alpha)
    t_shade = torch.where(hit, t_diff, t_close)
    return t_shade, id_close.detach(), alpha, hit
