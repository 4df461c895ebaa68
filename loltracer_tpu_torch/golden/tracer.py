"""Float64 NumPy golden reference tracer (`loltracer_tpu/golden/tracer.py`).

A deliberately scalar, per-pixel transliteration of the *semantics* of the
reference's naive backend (naive_renderer.c), used as the allclose oracle
for the port's renderers and kernels. It reproduces the reference's
behavioral quirks on purpose (SURVEY.md §2.1):

- pinhole half-height is atan(fov/2), not tan (naive_renderer.c:183),
- march constants 256 steps / eps 1e-3 / max dist 100 (naive_renderer.c:49-51),
- soft shadows: origin offset a full 1.0 unit toward the light
  (naive_renderer.c:97), 128 steps, w=50, first-iteration division by
  dist=0 yielding +/-inf (naive_renderer.c:83), early-out on res < -1
  (naive_renderer.c:85),
- SSE min/max semantics: minf/maxf return the second operand when either
  input is NaN (float.h:6-14),
- tetrahedron normals with h = dist/100 (naive_renderer.c:114-125),
- first-wins object selection on distance ties (strict <,
  naive_renderer.c:39),
- id 0 = miss -> material 0 (naive_renderer.c:102-112), with normals and
  full Phong shading still evaluated for miss pixels,
- gamma 1/2.2 applied to the clamped color (naive_renderer.c:231).

Documented divergence: boxes are implemented (sdRoundBox) exactly as the
naive backend does; the reference's JIT backend leaves boxes unimplemented
(tracing_jit_renderer.dasc:168-174) — we reproduce the capability, not that
bug.

Everything runs in numpy float64 scalars; divisions by zero follow IEEE
(inf/nan), matching the C float behavior at the quirky spots.

The code is the JAX package's, line for line: a copy, because that module
imports the JAX package's scene module, which imports jax. The entry points
(`render_golden`, `render_golden_scalar`, `trace_pixel`) take the port's
`Scene` and turn its torch params into float64 NumPy arrays once
(`host_scene`, through `scene.params_to_numpy`); with float64 params the
images are bitwise the JAX package's golden.
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Tuple

import numpy as np

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.scene import Node, Scene, params_to_numpy

_INF = float("inf")


class HostParams(SimpleNamespace):
    """SceneParams' fields as float64 NumPy arrays."""


def host_scene(scene: Scene) -> Scene:
    """`scene` with its params as float64 NumPy arrays (HostParams); a scene
    whose params already are is returned as it is."""
    if isinstance(scene.params, HostParams):
        return scene
    arrays = params_to_numpy(scene.params)
    return Scene(
        structure=scene.structure,
        params=HostParams(**{f: a.astype(np.float64) for f, a in arrays.items()}),
    )


# --- SSE-semantics scalar helpers (float.h:6-33) ---------------------------


def minf(a: float, b: float) -> float:
    """_mm_min_ss: min, returning b when either operand is NaN."""
    return a if a < b else b


def maxf(a: float, b: float) -> float:
    """_mm_max_ss: max, returning b when either operand is NaN."""
    return a if a > b else b


def clamp(v: float, lo: float, hi: float) -> float:
    return minf(maxf(v, lo), hi)


def lerp(from_: float, to: float, ratio: float) -> float:
    return from_ + (to - from_) * ratio


def sminf(a: float, b: float, k: float) -> float:
    """Polynomial smooth-min (float.h:29-33). k=0 follows IEEE division."""
    with np.errstate(divide="ignore", invalid="ignore"):
        h = clamp(0.5 + 0.5 * np.float64(b - a) / np.float64(k), 0.0, 1.0)
    return lerp(b, a, float(h)) - k * float(h) * (1.0 - float(h))


# --- v3 helpers ------------------------------------------------------------


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.sqrt(v @ v)


# --- SDF primitives (sdf.h) ------------------------------------------------


def sd_sphere(p: np.ndarray, r: float) -> float:
    return float(np.sqrt(p @ p)) - r


def sd_round_box(p: np.ndarray, b: np.ndarray, r: float) -> float:
    q = np.abs(p) - b
    cq = np.maximum(q, 0.0)
    return (
        float(np.sqrt(cq @ cq))
        + minf(maxf(q[0], maxf(q[1], q[2])), 0.0)
        - r
    )


# --- Scene SDF (naive_renderer.c:10-44) ------------------------------------


def _obj_dist(
    node: Node, params: HostParams, p: np.ndarray
) -> float:
    kind = node[0]
    if kind == "sphere":
        i = node[1]
        return sd_sphere(p - params.sphere_point[i], float(params.sphere_radius[i]))
    if kind == "box":
        i = node[1]
        return sd_round_box(
            p - params.box_point[i],
            params.box_half[i],
            float(params.box_radius[i]),
        )
    if kind == "plane":
        i = node[1]
        return float(p[1]) - float(params.plane_y[i])
    if kind == "smin":
        _, k, a, b = node
        # children are evaluated at the untranslated point
        # (naive_renderer.c:21-24)
        return sminf(
            _obj_dist(a, params, p),
            _obj_dist(b, params, p),
            float(params.smooth_k[k]),
        )
    raise ValueError(f"unknown node {node!r}")


def scene_sdf(scene: Scene, p: np.ndarray) -> Tuple[float, int]:
    """Argmin over top-level objects; first-wins on ties (strict <,
    naive_renderer.c:30-44). Returns (dist, 1-based id; 0 = none)."""
    best_d = _INF
    best_id = 0
    for i, node in enumerate(scene.structure.objects):
        d = _obj_dist(node, scene.params, p)
        if d < best_d:
            best_d = d
            best_id = i + 1
    return best_d, best_id


# --- March / shadow / normal / shade (naive_renderer.c:46-175) -------------


def get_intersection(
    scene: Scene, ro: np.ndarray, rd: np.ndarray, cfg: RenderConfig
) -> Tuple[float, int]:
    obj_id = 0
    dist = 0.0
    for _ in range(cfg.max_steps):
        p = ro + rd * dist
        d, obj_id = scene_sdf(scene, p)
        dist += d
        if d < cfg.epsilon or dist > cfg.max_dist:
            break
    if dist >= cfg.max_dist:
        obj_id = 0
    return dist, obj_id


def softshadow(
    scene: Scene,
    ro: np.ndarray,
    rd: np.ndarray,
    max_steps: int,
    max_dist: float,
    w: float,
) -> float:
    res = 1.0
    dist = 0.0
    for _ in range(max_steps):
        p = ro + rd * dist
        d, _ = scene_sdf(scene, p)
        with np.errstate(divide="ignore", invalid="ignore"):
            res = minf(res, float(np.float64(w * d) / np.float64(dist)))
        dist += d
        if res < -1 or dist > max_dist:
            break
    return maxf(res, 0.0)


def in_shadow(
    scene: Scene, light_point: np.ndarray, p: np.ndarray, cfg: RenderConfig
) -> float:
    light_dist = float(np.linalg.norm(light_point - p))
    direction = _normalize(light_point - p)
    p = p + direction * cfg.shadow_offset  # full-unit bias, naive_renderer.c:97
    return softshadow(
        scene, p, direction, cfg.shadow_steps, light_dist, cfg.shadow_w
    )


def get_normal(
    scene: Scene, p: np.ndarray, dist: float, cfg: RenderConfig
) -> np.ndarray:
    ks = np.array(
        [[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], dtype=np.float64
    )
    h = dist * cfg.normal_h_scale
    n = np.zeros(3)
    for k in ks:
        n = n + k * scene_sdf(scene, p + k * h)[0]
    return _normalize(n)


def get_light(
    scene: Scene,
    p: np.ndarray,
    n: np.ndarray,
    obj_id: int,
    cfg: RenderConfig,
) -> np.ndarray:
    params = scene.params
    mat = scene.structure.material_ids[obj_id]
    shininess = float(params.mat_shininess[mat])
    diffuse = params.mat_diffuse[mat].astype(np.float64)
    specular = params.mat_specular[mat].astype(np.float64)
    ambient = params.mat_ambient[mat].astype(np.float64)

    total = np.zeros(3)
    cam_pos = params.cam_point.astype(np.float64)

    for li in range(scene.structure.num_lights):
        lp = params.light_point[li].astype(np.float64)
        shadow = in_shadow(scene, lp, p, cfg)

        light_dir = _normalize(lp - p)
        reflected = n * (2.0 * float(light_dir @ n)) - light_dir
        camera_dir = _normalize(cam_pos - p)

        diffuse_incidence = clamp(float(n @ light_dir), 0.0, 1.0)
        total = total + (
            params.light_diffuse[li].astype(np.float64)
            * (shadow * diffuse_incidence)
            * diffuse
        )

        # powf(0, 0) == 1, matching C powf (naive_renderer.c:158-161)
        base = clamp(float(reflected @ camera_dir), 0.0, 1.0)
        specular_incidence = diffuse_incidence * float(
            np.float64(base) ** np.float64(shininess)
        )
        total = total + (
            params.light_specular[li].astype(np.float64)
            * (shadow * specular_incidence)
            * specular
        )

    total = total + params.ambient_color.astype(np.float64) * ambient
    return np.clip(total, 0.0, 1.0)


def get_camera_ray(
    params: HostParams, view_x: float, view_y: float, aspect: float,
    cfg: RenderConfig,
) -> np.ndarray:
    up_guide = np.array([0.0, 1.0, 0.0])
    direction = params.cam_direction.astype(np.float64)
    half_fov = float(params.cam_fov) / 2.0
    height = math.atan(half_fov) if cfg.atan_fov else math.tan(half_fov)
    width = aspect * height
    right_dir = _normalize(np.cross(direction, up_guide))
    up_dir = np.cross(right_dir, direction)
    rval = right_dir * (view_x * width) + up_dir * (view_y * height)
    return _normalize(rval + direction)


# --- Full pixel + image ----------------------------------------------------


def trace_pixel(
    scene: Scene,
    x: int,
    y: int,
    width: int,
    height: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Render one pixel to linear-then-gamma float64 RGB in [0,1]
    (the body of the worker loop, naive_renderer.c:217-235)."""
    scene = host_scene(scene)
    view_x = (x + 0.5) / width * 2.0 - 1.0
    view_y = 1.0 - (y + 0.5) / height * 2.0
    aspect = width / height

    ro = scene.params.cam_point.astype(np.float64)
    rd = get_camera_ray(scene.params, view_x, view_y, aspect, cfg)
    dist, obj_id = get_intersection(scene, ro, rd, cfg)
    p = ro + rd * dist
    n = get_normal(scene, p, dist, cfg)
    color = get_light(scene, p, n, obj_id, cfg)
    return color ** cfg.gamma


def render_golden_scalar(
    scene: Scene,
    width: int,
    height: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Per-pixel scalar render: float64 [H, W, 3] in [0, 1]. The most literal
    transliteration of the reference; slow — use for spot checks and as the
    anchor for the vectorized golden below."""
    scene = host_scene(scene)
    img = np.zeros((height, width, 3), dtype=np.float64)
    for y in range(height):
        for x in range(width):
            img[y, x] = trace_pixel(scene, x, y, width, height, cfg)
    return img


# --- Vectorized float64 golden ---------------------------------------------
#
# Same semantics as the scalar path (verified against it in
# tests/test_golden.py) but batched over pixels with numpy masks so full
# scenes render in seconds. SSE min/max semantics are preserved by
# `np.where(a < b, a, b)` (returns the second operand when the comparison is
# false, including on NaN — exactly _mm_min_ss, float.h:6-14), and IEEE
# division produces the same inf/NaN values the C float math does.


def _vminf(a, b):
    return np.where(a < b, a, b)


def _vmaxf(a, b):
    return np.where(a > b, a, b)


def _vclamp(v, lo, hi):
    return _vminf(_vmaxf(v, lo), hi)


def _vsmin(a, b, k):
    with np.errstate(divide="ignore", invalid="ignore"):
        h = _vclamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
    return (b + (a - b) * h) - k * h * (1.0 - h)


def _vnormalize(v):
    return v / np.sqrt(np.sum(v * v, axis=-1, keepdims=True))


def _scene_sdf_vec(scene: Scene, p: np.ndarray):
    """(dist[...], id[...]) batched; first-wins argmin (np.argmin keeps the
    first minimum, matching naive_renderer.c:39)."""
    params = scene.params

    if scene.structure.instanced:
        # instanced scenes: all spheres (SoA order) then planes
        d = p[..., None, :] - params.sphere_point
        dist = np.sqrt(np.sum(d * d, axis=-1)) - params.sphere_radius
        if scene.structure.num_planes:
            dpl = p[..., 1:2] - params.plane_y
            dist = np.concatenate([dist, dpl], axis=-1)
        return np.min(dist, axis=-1), np.argmin(dist, axis=-1) + 1

    def node_dist(node: Node):
        kind = node[0]
        if kind == "sphere":
            i = node[1]
            d = p - params.sphere_point[i]
            return np.sqrt(np.sum(d * d, axis=-1)) - params.sphere_radius[i]
        if kind == "box":
            i = node[1]
            q = np.abs(p - params.box_point[i]) - params.box_half[i]
            cq = np.maximum(q, 0.0)
            return (
                np.sqrt(np.sum(cq * cq, axis=-1))
                + _vminf(np.max(q, axis=-1), 0.0)
                - params.box_radius[i]
            )
        if kind == "plane":
            return p[..., 1] - params.plane_y[node[1]]
        if kind == "smin":
            _, k, a, b = node
            return _vsmin(node_dist(a), node_dist(b), params.smooth_k[k])
        raise ValueError(node)

    dists = np.stack(
        [node_dist(n) for n in scene.structure.objects], axis=-1
    )
    return np.min(dists, axis=-1), np.argmin(dists, axis=-1) + 1


def _march_vec(scene: Scene, ro, rd, cfg: RenderConfig):
    batch = rd.shape[:-1]
    t = np.zeros(batch)
    obj_id = np.zeros(batch, dtype=np.int64)
    done = np.zeros(batch, dtype=bool)
    for _ in range(cfg.max_steps):
        p = ro + t[..., None] * rd
        d, step_id = _scene_sdf_vec(scene, p)
        new_t = t + d
        obj_id = np.where(done, obj_id, step_id)
        t = np.where(done, t, new_t)
        done = done | (d < cfg.epsilon) | (new_t > cfg.max_dist)
        if done.all():
            break
    obj_id = np.where(t >= cfg.max_dist, 0, obj_id)
    return t, obj_id


def _soft_shadow_vec(scene: Scene, ro, rd, max_dist, cfg: RenderConfig):
    batch = rd.shape[:-1]
    res = np.ones(batch)
    t = np.zeros(batch)
    done = np.zeros(batch, dtype=bool)
    for _ in range(cfg.shadow_steps):
        p = ro + t[..., None] * rd
        d, _ = _scene_sdf_vec(scene, p)
        with np.errstate(divide="ignore", invalid="ignore"):
            val = cfg.shadow_w * d / t
        new_res = _vminf(res, val)
        new_t = t + d
        res = np.where(done, res, new_res)
        t = np.where(done, t, new_t)
        done = done | (res < -1) | (t > max_dist)
        if done.all():
            break
    return _vmaxf(res, 0.0)


def _normal_vec(scene: Scene, p, dist, cfg: RenderConfig):
    ks = np.array(
        [[1, -1, -1], [-1, -1, 1], [-1, 1, -1], [1, 1, 1]], dtype=np.float64
    )
    h = (dist * cfg.normal_h_scale)[..., None]
    n = np.zeros_like(p)
    for k in ks:
        n = n + k * _scene_sdf_vec(scene, p + k * h)[0][..., None]
    return _vnormalize(n)


def _shade_vec(scene: Scene, p, n, obj_id, cfg: RenderConfig):
    params = scene.params
    mat_ids = np.asarray(scene.structure.material_ids)
    mat = mat_ids[obj_id]
    shininess = params.mat_shininess[mat]
    diffuse = params.mat_diffuse[mat]
    specular = params.mat_specular[mat]
    ambient = params.mat_ambient[mat]

    total = np.zeros_like(p)
    cam_pos = params.cam_point

    for li in range(scene.structure.num_lights):
        lp = params.light_point[li]
        to_light = lp - p
        light_dist = np.sqrt(np.sum(to_light * to_light, axis=-1))
        light_dir = _vnormalize(to_light)
        shadow_ro = p + light_dir * cfg.shadow_offset
        shadow = _soft_shadow_vec(scene, shadow_ro, light_dir, light_dist, cfg)

        diffuse_incidence = _vclamp(np.sum(n * light_dir, axis=-1), 0.0, 1.0)
        total = total + (
            params.light_diffuse[li]
            * (shadow * diffuse_incidence)[..., None]
            * diffuse
        )

        reflected = (
            n * (2.0 * np.sum(light_dir * n, axis=-1))[..., None] - light_dir
        )
        camera_dir = _vnormalize(cam_pos - p)
        base = _vclamp(np.sum(reflected * camera_dir, axis=-1), 0.0, 1.0)
        specular_incidence = diffuse_incidence * np.power(base, shininess)
        total = total + (
            params.light_specular[li]
            * (shadow * specular_incidence)[..., None]
            * specular
        )

    total = total + params.ambient_color * ambient
    return np.clip(total, 0.0, 1.0)


def render_golden(
    scene: Scene,
    width: int,
    height: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Render the full image (vectorized float64): [H, W, 3] in [0, 1]."""
    scene = host_scene(scene)
    params = scene.params
    vx = ((np.arange(width) + 0.5) / width * 2.0 - 1.0)[None, :]
    vy = (1.0 - (np.arange(height) + 0.5) / height * 2.0)[:, None]
    aspect = width / height

    up_guide = np.array([0.0, 1.0, 0.0])
    direction = params.cam_direction.astype(np.float64)
    half_fov = float(params.cam_fov) / 2.0
    h = math.atan(half_fov) if cfg.atan_fov else math.tan(half_fov)
    w = aspect * h
    right_dir = _normalize(np.cross(direction, up_guide))
    up_dir = np.cross(right_dir, direction)

    rd = (
        right_dir * (vx * w)[..., None]
        + up_dir * (vy * h)[..., None]
        + direction
    )
    rd = _vnormalize(rd)
    ro = params.cam_point.astype(np.float64)

    t, obj_id = _march_vec(scene, ro, rd, cfg)
    p = ro + t[..., None] * rd
    n = _normal_vec(scene, p, t, cfg)
    color = _shade_vec(scene, p, n, obj_id, cfg)
    return color**cfg.gamma
