"""Sphere-trace march (`loltracer_tpu/render/march.py`), forward values.

Up to `max_steps` iterations, each evaluating the scene SDF at
p = ro + t*rd and accumulating t += d, stopping when d < epsilon or
t > max_dist; the hit id is the argmin id at the last query point (the
pre-accumulation t), and id 0 (miss) when the final t >= max_dist.

The loop is masked over the whole batch: done rays freeze, and the loop
ends once every ray is done. The implicit-function-theorem re-attachment of
the JAX package's `intersect_aa` changes gradients only, not values; it
comes with the training renderer as a `torch.autograd.Function`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from loltracer_tpu_torch.config import RenderConfig


class MarchResult(NamedTuple):
    """Raw march outputs, per ray."""

    t: torch.Tensor  # final accumulated distance
    t_query: torch.Tensor  # t of the last SDF evaluation (for hit-id lookup)
    s_min: torch.Tensor  # min over steps of d/t: angular closest approach
    t_close: torch.Tensor  # t at which s_min was attained


def march(sdf: Callable, params, ro, rd, cfg: RenderConfig) -> MarchResult:
    """Masked march of rays ro [..., 3] (broadcastable) along unit rd
    [..., 3]; also tracks the angular closest approach min_i d_i/t_i for
    soft-coverage antialiasing."""
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
        d = sdf(params, ro + t[..., None] * rd)
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


def intersect_aa(
    sdf: Callable,
    sdf_with_id: Callable,
    params,
    ro,
    rd,
    cfg: RenderConfig,
    pixel_rad=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intersection with optional soft coverage; returns (t_shade, id_shade,
    alpha, hit), the values of the JAX package's `intersect_aa`.

    With pixel_rad=None: the marched t and the argmin id at the last query
    point (0 on a miss), alpha == 1. With pixel_rad (the pixel's angular
    half-size): miss rays shade at their closest approach with that
    point's id, and blend by alpha = clamp(1 - s/pixel_rad, 0, 1) where
    s = f(closest approach) / t.
    """
    res = march(sdf, params, ro, rd, cfg)
    t0 = res.t
    hit = t0 < cfg.max_dist

    if pixel_rad is None:
        _, obj_id = sdf_with_id(params, ro + res.t_query[..., None] * rd)
        obj_id = torch.where(hit, obj_id, 0)
        return t0, obj_id, torch.ones_like(t0), hit

    t_close = torch.where(hit, res.t_query, res.t_close)
    safe_tc = torch.where(t_close > 0, t_close, 1.0)
    f_close, id_close = sdf_with_id(params, ro + t_close[..., None] * rd)
    s = f_close / safe_tc
    # rays that never tracked a closest approach (t_close == 0) stay alpha 0
    edge_alpha = torch.where(
        t_close > 0, torch.clamp(1.0 - s / pixel_rad, 0.0, 1.0), 0.0
    )
    alpha = torch.where(hit, 1.0, edge_alpha)
    t_shade = torch.where(hit, t0, t_close)
    return t_shade, id_close, alpha, hit
