"""Soft shadows, normals and Phong shading (`loltracer_tpu/render/shading.py`),
forward values.

Soft shadows are iq-style with the reference's quirks kept: the shadow ray
starts a full `shadow_offset` unit from the surface toward the light, the
first iteration divides by t = 0 giving +/-inf (min(1, +inf) = 1, and -inf
trips the res < -1 early-out into a hard 0), and the loop caps at
`shadow_steps` with sharpness `shadow_w`. The "exact" and "envelope"
shadow-gradient estimators of the JAX package give the same values.
"""

from __future__ import annotations

from typing import Callable

import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.vecmath import dot, normalize
from loltracer_tpu_torch.scene import SceneParams, SceneStructure

_NORMAL_KS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


def soft_shadow(sdf: Callable, params, ro, rd, max_dist, cfg: RenderConfig):
    """Penumbra factor max(res, 0) of the shadow march from the (already
    offset) origin ro along rd, up to `max_dist` (the distance to the
    light). The loop freezes done rays and ends once every ray is done."""
    if cfg.shadow_grad not in ("exact", "envelope"):
        raise ValueError(f"unknown shadow_grad {cfg.shadow_grad!r}")
    batch = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1], max_dist.shape)
    kw = dict(dtype=rd.dtype, device=rd.device)
    inf = float("inf")
    res = torch.ones(batch, **kw)
    t = torch.zeros(batch, **kw)
    done = torch.zeros(batch, dtype=torch.bool, device=rd.device)
    for _ in range(cfg.shadow_steps):
        if bool(done.all()):
            break
        d = sdf(params, ro + t[..., None] * rd)
        safe_t = torch.where(t > 0, t, 1.0)
        # first iteration: w*d/0 -> +/-inf (d == 0 maps to +inf)
        val = torch.where(
            t > 0, cfg.shadow_w * d / safe_t, torch.where(d < 0, -inf, inf)
        )
        res = torch.where(done, res, torch.minimum(res, val))
        t = torch.where(done, t, t + d)
        done = done | (res < -1) | (t > max_dist)
    return torch.clamp_min(res, 0.0)


def get_normal(sdf: Callable, params, p, dist, cfg: RenderConfig):
    """Tetrahedron-offset normal with h = dist * normal_h_scale; the four
    taps are one batched SDF call, summed tap by tap in a fixed order."""
    ks = torch.tensor(_NORMAL_KS, dtype=p.dtype, device=p.device)  # [4, 3]
    h = (dist * cfg.normal_h_scale)[..., None]
    ks_b = ks.reshape((4,) + (1,) * (p.ndim - 1) + (3,))
    d = sdf(params, p[None] + ks_b * h[None])  # [4, ...]
    n = torch.zeros_like(p)
    for k in range(4):
        n = n + ks[k] * d[k][..., None]
    return normalize(n)


def _safe_pow(base, exponent):
    """base ** exponent for base in [0, 1] with C powf's powf(0, 0) == 1."""
    positive = base > 0
    powv = torch.pow(torch.where(positive, base, 1.0), exponent)
    return torch.where(positive, powv, torch.where(exponent == 0.0, 1.0, 0.0))


def shade(
    structure: SceneStructure,
    params: SceneParams,
    sdf: Callable,
    p,
    n,
    obj_id,
    cfg: RenderConfig,
):
    """Phong shading with per-light soft shadows. p: points [..., 3]; n:
    unit normals [..., 3]; obj_id: [...] (0 = miss -> material 0, the
    background material). Returns clamped linear RGB [..., 3]."""
    mat_ids = torch.tensor(structure.material_ids, dtype=torch.long, device=p.device)
    mat = mat_ids[obj_id.long()]
    shininess = params.mat_shininess[mat]
    diffuse = params.mat_diffuse[mat]
    specular = params.mat_specular[mat]
    ambient = params.mat_ambient[mat]

    total = torch.zeros_like(p)
    camera_dir = normalize(params.cam_point - p)
    for li in range(structure.num_lights):
        to_light = params.light_point[li] - p
        light_dist = torch.sqrt(dot(to_light, to_light))
        light_dir = normalize(to_light)

        shadow_ro = p + light_dir * cfg.shadow_offset
        shadow = soft_shadow(sdf, params, shadow_ro, light_dir, light_dist, cfg)

        diffuse_incidence = torch.clamp(dot(n, light_dir), 0.0, 1.0)
        total = total + (
            params.light_diffuse[li] * (shadow * diffuse_incidence)[..., None] * diffuse
        )

        reflected = n * (2.0 * dot(light_dir, n))[..., None] - light_dir
        base = torch.clamp(dot(reflected, camera_dir), 0.0, 1.0)
        specular_incidence = diffuse_incidence * _safe_pow(base, shininess)
        total = total + (
            params.light_specular[li] * (shadow * specular_incidence)[..., None] * specular
        )

    total = total + params.ambient_color * ambient
    return torch.clamp(total, 0.0, 1.0)
