"""Soft shadows, normals and Phong shading (`loltracer_tpu/render/shading.py`),
differentiable.

Soft shadows are iq-style with the reference's quirks kept: the shadow ray
starts a full `shadow_offset` unit from the surface toward the light, the
first iteration divides by t = 0 giving +/-inf (min(1, +inf) = 1, and -inf
trips the res < -1 early-out into a hard 0), and the loop caps at
`shadow_steps` with sharpness `shadow_w`.

The two shadow-gradient estimators of the JAX package give the same values:
"exact" differentiates through the loop, each step checkpointed (the JAX
package's `@jax.checkpoint` scan body: backward memory is one carry per
step, and each step's SDF is recomputed in the backward); "envelope" runs
the loop frozen, records the first-wins argmin t* of the running minimum,
and re-attaches the gradient with one differentiable SDF evaluation at t*
(Danskin's theorem), only where t* > 0 and 0 < res < 1. The frozen loop may
come from `shadow_march_fn` (the shadow march kernel K4,
render/march_kernels.py); for "exact" a `shadow_march_fn` is the loop and
its adjoint in two kernels (K4x / K4xb, `make_cuda_exact_shadow`), the
plain loop under autograd everywhere else. The counters
`shading.exact_kernel` and `shading.exact_loop` count the exact shadow
marches of each route (always on).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.vecmath import clip, dot, maximum, normalize
from loltracer_tpu_torch.scene import SceneParams, SceneStructure
from loltracer_tpu_torch.utils import tracing

_NORMAL_KS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))

# the exact shadow marches of each route since the process started
exact_marches = {"kernel": 0, "loop": 0}

tracing.register_counters(
    "shading", lambda: {f"shading.exact_{k}": v for k, v in exact_marches.items()})


def _shadow_step(sdf: Callable, params, ro, rd, max_dist, cfg: RenderConfig,
                 res, t, t_star, done):
    """One step of the shadow march: the carry (res, t, t*, done) after one
    more SDF evaluation; done rays keep theirs."""
    d = sdf(params, ro + t[..., None] * rd)
    safe_t = torch.where(t > 0, t, 1.0)
    # first iteration: w*d/0 -> +/-inf (d == 0 maps to +inf)
    inf = float("inf")
    val = torch.where(
        t > 0, cfg.shadow_w * d / safe_t, torch.where(d < 0, -inf, inf)
    )
    better = ~done & (val < res)
    res = torch.where(done, res, torch.minimum(res, val))
    t_star = torch.where(better, t.detach(), t_star)
    t = torch.where(done, t, t + d)
    done = done | (res < -1) | (t > max_dist)
    return res, t, t_star, done


def shadow_march(
    sdf: Callable, params, ro, rd, max_dist, cfg: RenderConfig,
    live: Optional[List[int]] = None, probe: Optional[Callable] = None,
    init_done: Optional[torch.Tensor] = None, counts: Optional[torch.Tensor] = None,
):
    """(res, t*) of the shadow march from the (already offset) origin ro
    along rd, up to `max_dist` (the distance to the light): the running
    minimum res of w*d/t and the t of its first-wins argmin (`val < res`,
    so NaN never wins). The loop freezes done rays and ends once every ray
    is done; run under autograd it is the "exact" estimator, each step
    checkpointed (the values and the gradients are those of the loop
    differentiated straight). If `live` is a list, the number of
    rays still marching at each step is appended; `probe`, if given, is
    called at each step with those rays' points; `counts`, an integer
    tensor of the batch's shape, gets one added for each ray at each step
    it evaluates. Rays set in `init_done` (the segment cull's flags) start
    done with res = 1 and t* = 0, what the march gives them when the cull
    is sound."""
    batch = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1], max_dist.shape)
    kw = dict(dtype=rd.dtype, device=rd.device)
    done0 = torch.zeros(batch, dtype=torch.bool, device=rd.device)
    if init_done is not None:
        done0 = done0 | init_done
    carry = (
        torch.ones(batch, **kw),  # res
        torch.zeros(batch, **kw),  # t
        torch.zeros(batch, **kw),  # t*
        done0,  # done
    )
    step = functools.partial(_shadow_step, sdf, params, ro, rd, max_dist, cfg)
    remat = torch.is_grad_enabled()
    for _ in range(cfg.shadow_steps):
        done = carry[3]
        with tracing.span("shading.sync"):  # the exit test waits for the card
            finished = bool(done.all())
        if finished:
            break
        if live is not None:
            live.append(int((~done).sum()))
        if counts is not None:
            counts += ~done
        if probe is not None:
            probe((ro + carry[1][..., None] * rd)[~done])
        if remat:
            carry = checkpoint(step, *carry, use_reentrant=False, preserve_rng_state=False)
        else:
            carry = step(*carry)
    return carry[0], carry[2]


# Slack of the segment bound (`loltracer_tpu/render/pallas_scene.py`
# BOUND_MARGIN): it absorbs the float32 rounding of the bound's short chains.
BOUND_MARGIN = 0.0625


def _node_seg_bound(node, params: SceneParams, so, ld, seg_len):
    """A lower bound, per ray, of the object's distance over the segment
    so + t ld, t in [0, seg_len] (`ScalarScene._node_seg_bound`, op for op):
    a sphere's exact segment-to-centre distance minus its radius, a box's
    circumscribed sphere, a smooth-min the min of its children's bounds
    less k / 4. None for a plane and for a smooth-min over one."""
    kind = node[0]
    if kind == "plane":
        return None

    def segdist(c):
        dx, dy, dz = c[0] - so[..., 0], c[1] - so[..., 1], c[2] - so[..., 2]
        proj = dx * ld[..., 0] + dy * ld[..., 1] + dz * ld[..., 2]
        tcl = torch.minimum(maximum(proj, 0.0), seg_len)
        ex = dx - tcl * ld[..., 0]
        ey = dy - tcl * ld[..., 1]
        ez = dz - tcl * ld[..., 2]
        return torch.sqrt(ex * ex + ey * ey + ez * ez)

    if kind == "sphere":
        return segdist(params.sphere_point[node[1]]) - params.sphere_radius[node[1]]
    if kind == "box":
        b = params.box_half[node[1]]
        hb = torch.sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2])
        return segdist(params.box_point[node[1]]) - hb - params.box_radius[node[1]]
    if kind == "smin":
        _, k, a, b = node
        ba = _node_seg_bound(a, params, so, ld, seg_len)
        bb = _node_seg_bound(b, params, so, ld, seg_len)
        if ba is None or bb is None:
            return None
        return torch.minimum(ba, bb) - params.smooth_k[k] / 4.0
    raise ValueError(f"unknown node {node!r}")


def segment_allowed(structure: SceneStructure) -> bool:
    """Whether segment_lit can mark any ray of this compiled structure: not
    when a smooth-min has a plane under it (its bound gives up)."""

    def ok(node):
        if node[0] == "smin":
            return all(n[0] != "plane" and ok(n) for n in node[2:])
        return True

    return all(ok(n) for n in structure.objects)


def segment_lit(structure: SceneStructure, params: SceneParams, so, ld, seg_len,
                shadow_w: float):
    """The shadow segment cull of a compiled structure
    (`ScalarScene.segment_lit`, op for op): bool per ray, set where the
    shadow ray from so [..., 3] along unit ld [..., 3] over [0, seg_len]
    provably keeps every penumbra value w d / t above 1, so that its march
    gives res = 1 and t* = 0. Per object, a bounded one needs
    w (bound - BOUND_MARGIN) > seg_len; a plane the monotone rule
    a >= BOUND_MARGIN and w (a + ld_y seg_len) > seg_len + w BOUND_MARGIN,
    a the origin's height above it. A smooth-min over a plane culls no ray."""
    lit = torch.ones(seg_len.shape, dtype=torch.bool, device=seg_len.device)
    for node in structure.objects:
        bound = _node_seg_bound(node, params, so, ld, seg_len)
        if bound is None:
            if node[0] != "plane":
                return torch.zeros_like(lit)
            a = so[..., 1] - params.plane_y[node[1]]
            lit = lit & (a >= BOUND_MARGIN) & (
                shadow_w * (a + ld[..., 1] * seg_len) > seg_len + shadow_w * BOUND_MARGIN)
        else:
            lit = lit & (shadow_w * (bound - BOUND_MARGIN) > seg_len)
    return lit


def envelope_reattach(sdf: Callable, params, ro, rd, res0, t_star, cfg: RenderConfig):
    """res0 with the envelope gradient attached: one differentiable SDF
    evaluation at the frozen argmin t*, only for interior minima (t* > 0,
    0 < res0 < 1). The value stays res0."""
    valid = (t_star > 0) & (res0 > 0) & (res0 < 1)
    safe_ts = torch.where(t_star > 0, t_star, 1.0)
    d_star = sdf(params, ro + t_star[..., None] * rd)
    val = cfg.shadow_w * d_star / safe_ts
    return torch.where(valid, res0 + (val - val.detach()), res0)


def soft_shadow(
    sdf: Callable, params, ro, rd, max_dist, cfg: RenderConfig, live: Optional[Dict] = None,
    shadow_march_fn: Optional[Callable] = None,
):
    """Penumbra factor max(res, 0) of the shadow march (shadow_march), with
    the gradient of cfg.shadow_grad. `live` ({"shadow": list, "probe":
    callable}, both optional) is handed to the march.
    `shadow_march_fn(params, ro, rd, max_dist) -> (res, t*)`, when given,
    replaces the frozen march of "envelope" (the JAX package's
    soft_shadow); for "exact" it is the differentiable march (its res
    carries the gradient, t* is None), else "exact" differentiates through
    the plain loop."""
    live = live or {}
    counts = (live.get("shadow"), live.get("probe"))
    if cfg.shadow_grad == "exact":
        route = "loop" if shadow_march_fn is None else "kernel"
        exact_marches[route] += 1
        with tracing.span("lol_shadow_march"):
            if shadow_march_fn is None:
                res, _ = shadow_march(sdf, params, ro, rd, max_dist, cfg, *counts)
            else:
                res, _ = shadow_march_fn(params, ro, rd, max_dist)
        return maximum(res, 0.0)
    if cfg.shadow_grad != "envelope":
        raise ValueError(f"unknown shadow_grad {cfg.shadow_grad!r}")
    with torch.no_grad(), tracing.span("lol_shadow_march"):
        if shadow_march_fn is not None:
            res, t_star = shadow_march_fn(params, ro, rd, max_dist)
        else:
            res, t_star = shadow_march(sdf, params, ro, rd, max_dist, cfg, *counts)
    if torch.is_grad_enabled():
        res = envelope_reattach(sdf, params, ro, rd, res, t_star, cfg)
    return maximum(res, 0.0)


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
    live: Optional[Dict] = None,
    shadow_march_fn: Optional[Callable] = None,
):
    """Phong shading with per-light soft shadows. p: points [..., 3]; n:
    unit normals [..., 3]; obj_id: [...] (0 = miss -> material 0, the
    background material). Returns clamped linear RGB [..., 3]. `live` and
    `shadow_march_fn` are handed to each light's soft_shadow."""
    mat_ids = torch.tensor(structure.material_ids, dtype=torch.long, device=p.device)

    def shadow_of(li, shadow_ro, light_dir, light_dist):
        return soft_shadow(sdf, params, shadow_ro, light_dir, light_dist, cfg, live,
                           shadow_march_fn)

    return phong(structure, params, p, n, mat_ids[obj_id.long()], shadow_of, cfg)


def phong(
    structure: SceneStructure,
    params: SceneParams,
    p,
    n,
    mat,
    shadow_of: Callable,
    cfg: RenderConfig,
):
    """The Phong sum of `shade` for material indices mat [...], with the
    shadow factor of light li from `shadow_of(li, shadow_ro, light_dir,
    light_dist)`. The camera position is params.cam_point."""
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
        shadow = shadow_of(li, shadow_ro, light_dir, light_dist)

        diffuse_incidence = clip(dot(n, light_dir), 0.0, 1.0)
        total = total + (
            params.light_diffuse[li] * (shadow * diffuse_incidence)[..., None] * diffuse
        )

        reflected = n * (2.0 * dot(light_dir, n))[..., None] - light_dir
        base = clip(dot(reflected, camera_dir), 0.0, 1.0)
        specular_incidence = diffuse_incidence * _safe_pow(base, shininess)
        total = total + (
            params.light_specular[li] * (shadow * specular_incidence)[..., None] * specular
        )

    total = total + params.ambient_color * ambient
    return clip(total, 0.0, 1.0)
