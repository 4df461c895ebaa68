"""The plain reference renderer: sphere tracing with tetrahedron normals,
Phong shading, soft shadows, optional soft-coverage antialiasing and gamma,
in plain PyTorch, differentiable in the scene's parameters.

It follows the semantics of the reference tracer (naive_renderer.c) as the
program states them, with the program's gradient estimators: the
implicit-function theorem at the frozen march's hits, the coverage alpha at
the frozen closest approach, and for soft shadows either the envelope
estimator (one differentiable distance at the frozen argmin of the
penumbra minimum) or the exact gradient through the whole shadow loop.
It imports nothing of the program and takes its scene as raw arrays.

Two departures from the program's own plain loops, both value-exact: the
shadow segment cull is not run (it only starts rays done with the values
the march gives them), and a material property is picked by a sum over
materials of `where(id == m, value[m], 0)` rather than an index gather,
whose backward serialises on a few indices.

Instanced scenes evaluate every sphere at every distance call, in chunks,
with the program's documented step-clamp cut: the sphere set's distance is
min(d, max(clamp, distance to the spheres' bounding box)); the hit id is
the unclamped argmin.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

MIN_DEN = 1e-2  # grazing-hit guard of the IFT denominator
EPS2 = 1e-30  # squared-norm floor of normalize
NORMAL_KS = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0), (1.0, 1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class Settings:
    """The render constants (the configuration's `render` entry) and the
    traffic's estimator choices."""

    max_steps: int = 256
    epsilon: float = 1e-3
    max_dist: float = 100.0
    shadow_steps: int = 128
    shadow_w: float = 50.0
    shadow_offset: float = 1.0
    normal_h_scale: float = 0.01
    gamma: float = 1.0 / 2.2
    aa_width: float = 1.0
    atan_fov: bool = True
    step_clamp: Optional[float] = None
    antialias: bool = False
    shadow_grad: str = "envelope"


# --- vector helpers: sums written out component by component --------------


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    return v / torch.sqrt(torch.clamp_min(dot(v, v)[..., None], EPS2))


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def maximum(x, lo: float):
    """max(x, lo); a tie passes half the cotangent."""
    return torch.maximum(x, torch.full_like(x, lo))


def minimum(x, hi: float):
    return torch.minimum(x, torch.full_like(x, hi))


def clip(x, lo: float, hi: float):
    return minimum(maximum(x, lo), hi)


def true_div(x, n):
    """x / n for a Python number n, correctly rounded on every device."""
    return x / torch.full_like(x, n)


# --- scene distance --------------------------------------------------------


def smooth_min(a, b, k):
    """Polynomial smooth-min; a hard min where k == 0."""
    zero_k = k == 0.0
    safe_k = torch.where(zero_k, 1.0, k)
    h = clip(0.5 + 0.5 * (b - a) / safe_k, 0.0, 1.0)
    h = torch.where(zero_k, torch.where(b > a, 1.0, 0.0), h)
    return (b + (a - b) * h) - k * h * (1.0 - h)


def _node(node, cols: Dict, P: Dict):
    if node[0] == "smin":
        _, k, a, b = node
        return smooth_min(_node(a, cols, P), _node(b, cols, P), P["smooth_k"][k])
    return cols[node[0]][..., node[1]]


def _csg_sdf(structure: dict) -> Callable:
    def sdf_id(P: Dict, p):
        px, py, pz = p[..., 0, None], p[..., 1, None], p[..., 2, None]
        cols = {}
        if structure["num_spheres"]:
            c, r = P["sphere_point"], P["sphere_radius"]
            dx, dy, dz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
            cols["sphere"] = torch.sqrt(dx * dx + dy * dy + dz * dz) - r
        if structure["num_boxes"]:
            c, half = P["box_point"], P["box_half"]
            qx = torch.abs(px - c[:, 0]) - half[:, 0]
            qy = torch.abs(py - c[:, 1]) - half[:, 1]
            qz = torch.abs(pz - c[:, 2]) - half[:, 2]
            ox, oy, oz = (maximum(q, 0.0) for q in (qx, qy, qz))
            inside = minimum(torch.maximum(qx, torch.maximum(qy, qz)), 0.0)
            cols["box"] = torch.sqrt(ox * ox + oy * oy + oz * oz) + inside - P["box_radius"]
        if structure["num_planes"]:
            cols["plane"] = py - P["plane_y"]
        dist = oid = None
        for i, node in enumerate(structure["objects"]):
            d = _node(node, cols, P)
            if dist is None:
                dist, oid = d, torch.ones(d.shape, dtype=torch.int32, device=d.device)
            else:
                closer = d < dist
                dist = torch.where(closer, d, dist)
                oid = torch.where(closer, i + 1, oid)
        return dist, oid

    return sdf_id


def _instanced_sdf(structure: dict, clamp: Optional[float], chunk: int) -> Callable:
    ns = structure["num_spheres"]

    def sdf_id(P: Dict, p):
        pos, rad = P["sphere_point"], P["sphere_radius"]
        batch = p.shape[:-1]
        dmin = torch.full(batch, float("inf"), dtype=p.dtype, device=p.device)
        imin = torch.zeros(batch, dtype=torch.int32, device=p.device)
        px, py, pz = p[..., 0, None], p[..., 1, None], p[..., 2, None]
        for s in range(0, ns, chunk):
            c, r = pos[s:s + chunk], rad[s:s + chunk]
            dx, dy, dz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
            d = torch.sqrt((dx * dx + dy * dy) + dz * dz) - r
            bd, bi = torch.min(d, dim=-1)
            closer = bd < dmin
            dmin = torch.where(closer, bd, dmin)
            imin = torch.where(closer, (bi + (s + 1)).to(torch.int32), imin)
        if ns and clamp is not None:
            lo = (pos - rad[:, None]).amin(dim=0)
            hi = (pos + rad[:, None]).amax(dim=0)
            q = maximum(torch.maximum(lo - p, p - hi), 0.0)
            s2 = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
            d_box = torch.where(s2 > 0, torch.sqrt(torch.where(s2 > 0, s2, 1.0)), 0.0)
            dmin = torch.minimum(dmin, maximum(d_box, clamp))
        if structure["num_planes"]:
            bd, bi = torch.min(p[..., 1, None] - P["plane_y"], dim=-1)
            closer = bd < dmin
            dmin = torch.where(closer, bd, dmin)
            imin = torch.where(closer, (bi + (ns + 1)).to(torch.int32), imin)
        return dmin, imin

    return sdf_id


def scene_sdf(structure: dict, s: Settings, chunk: int = 2048) -> Callable:
    """`sdf_id(P, p [..., 3]) -> (distance [...], object id [...])`, ids
    1-based in scene order, the first minimum winning."""
    if structure["instanced"]:
        return _instanced_sdf(structure, s.step_clamp, chunk)
    return _csg_sdf(structure)


# --- camera ----------------------------------------------------------------


def camera_basis(P: Dict, height: int, width: int, s: Settings):
    """(origin, right, up, forward, half width, half height, pixel radius)
    of the pinhole camera, with the reference's atan(fov / 2) half-height."""
    d = normalize(P["cam_direction"])
    upg = torch.tensor([0.0, 1.0, 0.0], dtype=d.dtype, device=d.device)
    rt = normalize(cross(d, upg))
    up = cross(rt, d)
    half = P["cam_fov"] / 2.0
    hh = torch.atan(half) if s.atan_fov else torch.tan(half)
    hw = (width / height) * hh
    return P["cam_point"], rt, up, d, hw, hh, true_div(s.aa_width * hh, height)


def pixel_rays(P: Dict, ys, xs, height: int, width: int, s: Settings):
    """Unit ray directions [N, 3] of the pixels (ys[N], xs[N]) of an image
    height x width; pixel centres map to ((x + .5) / W * 2 - 1,
    1 - (y + .5) / H * 2)."""
    ro, rt, up, fw, hw, hh, _ = camera_basis(P, height, width, s)
    vx = true_div(xs.to(ro.dtype) + 0.5, width) * 2.0 - 1.0
    vy = 1.0 - true_div(ys.to(ro.dtype) + 0.5, height) * 2.0
    rd = rt * (vx * hw)[:, None] + up * (vy * hh)[:, None] + fw
    return normalize(rd)


# --- marches ---------------------------------------------------------------


def march(sdf_id: Callable, P: Dict, ro, rd, s: Settings):
    """The masked sphere-trace march, without autograd: (t, t of the last
    evaluation, closest angular approach d / t, t there)."""
    batch = rd.shape[:-1]
    kw = dict(dtype=rd.dtype, device=rd.device)
    t = torch.zeros(batch, **kw)
    t_query = torch.zeros(batch, **kw)
    s_min = torch.full(batch, float("inf"), **kw)
    t_close = torch.zeros(batch, **kw)
    done = torch.zeros(batch, dtype=torch.bool, device=rd.device)
    for _ in range(s.max_steps):
        if bool(done.all()):
            break
        d, _ = sdf_id(P, ro + t[..., None] * rd)
        new_t = t + d
        track = ~done & (t > 0)
        ratio = d / torch.where(t > 0, t, 1.0)
        better = track & (ratio < s_min)
        s_min = torch.where(better, ratio, s_min)
        t_close = torch.where(better, t, t_close)
        t_query = torch.where(done, t_query, t)
        t = torch.where(done, t, new_t)
        done = done | (d < s.epsilon) | (new_t > s.max_dist)
    return t, t_query, s_min, t_close


def _shadow_step(sdf_id, P, ro, rd, max_dist, s: Settings, res, t, t_star, done):
    d, _ = sdf_id(P, ro + t[..., None] * rd)
    inf = float("inf")
    val = torch.where(t > 0, s.shadow_w * d / torch.where(t > 0, t, 1.0),
                      torch.where(d < 0, -inf, inf))
    better = ~done & (val < res)
    res = torch.where(done, res, torch.minimum(res, val))
    t_star = torch.where(better, t.detach(), t_star)
    t = torch.where(done, t, t + d)
    done = done | (res < -1) | (t > max_dist)
    return res, t, t_star, done


def shadow_march(sdf_id, P, ro, rd, max_dist, s: Settings):
    """(res, t*) of the soft-shadow march from the offset origin ro along
    rd up to the light: the running minimum of w d / t (the first step's
    division by t = 0 gives +/-inf) and the t of its first-wins argmin.
    Under autograd each step is checkpointed (the exact estimator)."""
    batch = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1], max_dist.shape)
    kw = dict(dtype=rd.dtype, device=rd.device)
    carry = (torch.ones(batch, **kw), torch.zeros(batch, **kw), torch.zeros(batch, **kw),
             torch.zeros(batch, dtype=torch.bool, device=rd.device))
    remat = torch.is_grad_enabled()
    for _ in range(s.shadow_steps):
        if bool(carry[3].all()):
            break
        if remat:
            carry = checkpoint(_shadow_step, sdf_id, P, ro, rd, max_dist, s, *carry,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            carry = _shadow_step(sdf_id, P, ro, rd, max_dist, s, *carry)
    return carry[0], carry[2]


def ray_derivative(sdf_id, P, ro, rd, t):
    """d/dt of the distance along the ray at t, without grad to the scene,
    clamped away from zero to +/-MIN_DEN."""
    frozen = {k: v.detach() for k, v in P.items()}
    with torch.enable_grad():
        tt = t.detach().requires_grad_(True)
        f, _ = sdf_id(frozen, ro.detach() + tt[..., None] * rd.detach())
        (den,) = torch.autograd.grad(f.sum(), tt)
    return torch.where(den.abs() < MIN_DEN, torch.where(den < 0, -MIN_DEN, MIN_DEN), den)


def soft_shadow(sdf_id, P, ro, rd, max_dist, s: Settings):
    if s.shadow_grad == "exact":
        res, _ = shadow_march(sdf_id, P, ro, rd, max_dist, s)
        return maximum(res, 0.0)
    with torch.no_grad():
        res, t_star = shadow_march(sdf_id, P, ro, rd, max_dist, s)
    if torch.is_grad_enabled():
        valid = (t_star > 0) & (res > 0) & (res < 1)
        d_star, _ = sdf_id(P, ro + t_star[..., None] * rd)
        val = s.shadow_w * d_star / torch.where(t_star > 0, t_star, 1.0)
        res = torch.where(valid, res + (val - val.detach()), res)
    return maximum(res, 0.0)


# --- shading ---------------------------------------------------------------


def _material(values, mat, num_materials: int):
    """values[mat] as a sum over materials of where(mat == m, values[m], 0)."""
    out = None
    for m in range(num_materials):
        sel = mat == m
        v = values[m]
        term = torch.where(sel[..., None], v, torch.zeros_like(v)) if v.ndim else \
            torch.where(sel, v, torch.zeros_like(v))
        out = term if out is None else out + term
    return out


def _safe_pow(base, exponent):
    """base ** exponent for base in [0, 1], with powf(0, 0) == 1."""
    positive = base > 0
    powv = torch.pow(torch.where(positive, base, 1.0), exponent)
    return torch.where(positive, powv, torch.where(exponent == 0.0, 1.0, 0.0))


def normal(sdf_id, P, p, dist, s: Settings):
    """Tetrahedron-tap normal with h = dist * normal_h_scale."""
    ks = torch.tensor(NORMAL_KS, dtype=p.dtype, device=p.device)
    h = (dist * s.normal_h_scale)[..., None]
    ks_b = ks.reshape((4,) + (1,) * (p.ndim - 1) + (3,))
    d, _ = sdf_id(P, p[None] + ks_b * h[None])
    n = torch.zeros_like(p)
    for k in range(4):
        n = n + ks[k] * d[k][..., None]
    return normalize(n)


def phong(structure: dict, sdf_id, P: Dict, p, n, mat, s: Settings):
    """Phong shading with per-light soft shadows, clipped to [0, 1]."""
    nm = structure["num_materials"]
    shininess = _material(P["mat_shininess"], mat, nm)
    diffuse = _material(P["mat_diffuse"], mat, nm)
    specular = _material(P["mat_specular"], mat, nm)
    ambient = _material(P["mat_ambient"], mat, nm)
    total = torch.zeros_like(p)
    camera_dir = normalize(P["cam_point"] - p)
    for li in range(structure["num_lights"]):
        to_light = P["light_point"][li] - p
        light_dist = torch.sqrt(dot(to_light, to_light))
        light_dir = normalize(to_light)
        shadow = soft_shadow(sdf_id, P, p + light_dir * s.shadow_offset, light_dir,
                             light_dist, s)
        diffuse_inc = clip(dot(n, light_dir), 0.0, 1.0)
        total = total + P["light_diffuse"][li] * (shadow * diffuse_inc)[..., None] * diffuse
        reflected = n * (2.0 * dot(light_dir, n))[..., None] - light_dir
        base = clip(dot(reflected, camera_dir), 0.0, 1.0)
        spec_inc = diffuse_inc * _safe_pow(base, shininess)
        total = total + P["light_specular"][li] * (shadow * spec_inc)[..., None] * specular
    total = total + P["ambient_color"] * ambient
    return clip(total, 0.0, 1.0)


def gamma_encode(color, gamma: float):
    positive = color > 0
    return torch.where(positive, torch.where(positive, color, 1.0) ** gamma, 0.0)


def render_rays(structure: dict, P: Dict, ro, rd, s: Settings, pixel_rad=None,
                sdf_id: Optional[Callable] = None):
    """Gamma-encoded RGB [..., 3] of the rays (ro [3], rd [..., 3]),
    differentiable in P where autograd is on."""
    sdf_id = sdf_id or scene_sdf(structure, s)
    mat_ids = torch.tensor(structure["material_ids"], dtype=torch.long, device=rd.device)
    with torch.no_grad():
        t0, t_query, _, t_close = march(sdf_id, P, ro, rd, s)
    hit = t0 < s.max_dist
    t_diff = t0
    if torch.is_grad_enabled():
        den = ray_derivative(sdf_id, P, ro, rd, t0)
        fval, _ = sdf_id(P, ro + t0[..., None] * rd)
        corr = torch.where(hit, -fval / den, 0.0)
        t_diff = t0 + (corr - corr.detach())
    if pixel_rad is None:
        with torch.no_grad():
            _, oid = sdf_id(P, ro + t_query[..., None] * rd)
        oid = torch.where(hit, oid, 0)
        alpha, t_shade = None, t_diff
    else:
        tc = torch.where(hit, t_query, t_close)
        f_close, oid = sdf_id(P, ro.detach() + tc[..., None] * rd.detach())
        oid = oid.detach()
        edge = torch.where(tc > 0, clip(1.0 - (f_close / torch.where(tc > 0, tc, 1.0))
                                        / pixel_rad, 0.0, 1.0), 0.0)
        alpha = torch.where(hit, 1.0, edge)
        t_shade = torch.where(hit, t_diff, tc)
    p = ro + t_shade[..., None] * rd
    n = normal(sdf_id, P, p, t_shade, s)
    color = phong(structure, sdf_id, P, p, n, mat_ids[oid.long()], s)
    if alpha is not None:
        bg = clip(P["ambient_color"] * P["mat_ambient"][0], 0.0, 1.0)
        color = alpha[..., None] * color + (1.0 - alpha[..., None]) * bg
    return gamma_encode(color, s.gamma)


def render_pixels(structure: dict, P: Dict, ys, xs, height: int, width: int, s: Settings,
                  sdf_id: Optional[Callable] = None):
    """RGB [N, 3] of the pixels (ys, xs) of an image height x width."""
    rd = pixel_rays(P, ys, xs, height, width, s)
    pr = camera_basis(P, height, width, s)[6] if s.antialias else None
    return render_rays(structure, P, P["cam_point"], rd, s, pr, sdf_id)
