"""Batched scene-SDF evaluation in torch (`loltracer_tpu/render/sdf.py`).

`make_scene_sdf(structure)` walks the static structure once in Python and
returns a closure over it. Evaluation is struct-of-arrays: one batched
distance column per primitive *type*, then per-object expressions assemble
their distances from the columns, then a first-wins argmin picks the hit
object (strict `<`, the reference's naive-backend tie rule).

Every distance is written out component by component in the order the CUDA
kernel's generated code uses (render/cuda_scene.py), so the two round alike.

Instanced structures (10k+ spheres) take `_make_instanced_sdf`, the twin of
the JAX package's: a running min and first-wins argmin over blocks of
`structure.instanced_block` spheres, so the memory peak is [..., block]
rather than [..., Ns]; under a step clamp the sphere set's distance is cut
at max(clamp, distance to the sphere set's AABB); then the planes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from loltracer_tpu_torch.render.instanced_pack import sphere_bbox
from loltracer_tpu_torch.render.vecmath import clip, maximum, minimum
from loltracer_tpu_torch.scene import Node, SceneParams, SceneStructure, require_instanced


def smooth_min(a, b, k):
    """Polynomial smooth-min, guarded at k == 0 where it degenerates to a
    hard min (the JAX package's jnp form; identical for k != 0)."""
    zero_k = k == 0.0
    safe_k = torch.where(zero_k, 1.0, k)
    h = clip(0.5 + 0.5 * (b - a) / safe_k, 0.0, 1.0)
    h = torch.where(zero_k, torch.where(b > a, 1.0, 0.0), h)
    return (b + (a - b) * h) - k * h * (1.0 - h)


def _columns(structure: SceneStructure, params: SceneParams, p) -> Dict:
    """Per-type distance columns [..., N_type] at points p [..., 3]."""
    px, py, pz = p[..., 0, None], p[..., 1, None], p[..., 2, None]
    cols = {}
    if structure.num_spheres:
        c, r = params.sphere_point, params.sphere_radius
        dx, dy, dz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
        cols["sphere"] = torch.sqrt(dx * dx + dy * dy + dz * dz) - r
    if structure.num_boxes:
        c, half = params.box_point, params.box_half
        qx = torch.abs(px - c[:, 0]) - half[:, 0]
        qy = torch.abs(py - c[:, 1]) - half[:, 1]
        qz = torch.abs(pz - c[:, 2]) - half[:, 2]
        ox, oy, oz = (maximum(q, 0.0) for q in (qx, qy, qz))
        outside = torch.sqrt(ox * ox + oy * oy + oz * oz)
        inside = minimum(torch.maximum(qx, torch.maximum(qy, qz)), 0.0)
        cols["box"] = outside + inside - params.box_radius
    if structure.num_planes:
        cols["plane"] = py - params.plane_y
    return cols


def _eval_node(node: Node, cols: Dict, params: SceneParams):
    """One object's distance from the columns. A module-level function: a
    nested recursive closure is a reference cycle, which would keep every
    call's columns and their autograd graph alive until the garbage
    collector runs."""
    if node[0] == "smin":
        _, k, a, b = node
        return smooth_min(_eval_node(a, cols, params), _eval_node(b, cols, params),
                          params.smooth_k[k])
    return cols[node[0]][..., node[1]]


def _object_dists(structure: SceneStructure, params: SceneParams, p) -> List:
    """Per-top-level-object distances, each [...], in file order."""
    cols = _columns(structure, params, p)
    return [_eval_node(node, cols, params) for node in structure.objects]


def make_scene_sdf(
    structure: SceneStructure, step_clamp: Optional[float] = None
) -> Callable:
    """`sdf(params, p[..., 3]) -> dist[...]`: the min over objects, NaN
    propagating like jnp.min. `step_clamp` applies to instanced structures
    only (config.py step_clamp) and is ignored for compiled ones."""
    if structure.instanced:
        inner = _make_instanced_sdf(structure, step_clamp)
        return lambda params, p: inner(params, p)[0]

    def sdf(params: SceneParams, p):
        dists = _object_dists(structure, params, p)
        dist = dists[0]
        for d in dists[1:]:
            dist = torch.minimum(dist, d)
        return dist

    return sdf


def make_scene_sdf_with_id(
    structure: SceneStructure, step_clamp: Optional[float] = None
) -> Callable:
    """`sdf(params, p[..., 3]) -> (dist[...], id[...] int32)`: ids are
    1-based file-order object positions, first-wins on ties (strict <). For
    instanced structures the id is the UNCLAMPED argmin even under
    `step_clamp`, while the distance is clamped."""
    if structure.instanced:
        return _make_instanced_sdf(structure, step_clamp)

    def sdf(params: SceneParams, p):
        dists = _object_dists(structure, params, p)
        dist = torch.full_like(dists[0], float("inf"))
        oid = torch.zeros(dist.shape, dtype=torch.int32, device=dist.device)
        for i, d in enumerate(dists):
            closer = d < dist
            dist = torch.where(closer, d, dist)
            oid = torch.where(closer, i + 1, oid)
        return dist, oid

    return sdf


def bbox_cut(lo, hi, p, step_clamp: float):
    """max(step_clamp, distance from p [..., 3] to the box [lo, hi]): a
    lower bound of every sphere distance outside the box, so clamped
    marching escapes empty space at full stride. The square root is taken
    only where the distance is not 0 (the JAX package's NaN-safe form)."""
    q = maximum(torch.maximum(lo - p, p - hi), 0.0)
    s = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
    d_bbox = torch.where(s > 0, torch.sqrt(torch.where(s > 0, s, 1.0)), 0.0)
    return maximum(d_bbox, step_clamp)


def sphere_argmin(structure: SceneStructure, params: SceneParams, p):
    """(dist, id) over the spheres of an instanced structure only: a
    running min and argmin over blocks of `structure.instanced_block`
    spheres, the last block short (the JAX package pads it with sentinel
    spheres of radius -1e30, which never win: the same values); within a
    block the first minimum wins and across blocks a strict `<`, so ties
    go to the smaller SoA index. id is 1-based."""
    block = structure.instanced_block
    ns = structure.num_spheres
    batch = p.shape[:-1]
    dmin = torch.full(batch, float("inf"), dtype=p.dtype, device=p.device)
    imin = torch.zeros(batch, dtype=torch.int32, device=p.device)
    px, py, pz = p[..., 0, None], p[..., 1, None], p[..., 2, None]
    pos, rad = params.sphere_point, params.sphere_radius
    for start in range(0, ns, block):
        c, r = pos[start : start + block], rad[start : start + block]
        dx, dy, dz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
        dist = torch.sqrt((dx * dx + dy * dy) + dz * dz) - r
        bd, bi = torch.min(dist, dim=-1)
        closer = bd < dmin
        dmin = torch.where(closer, bd, dmin)
        imin = torch.where(closer, (bi + (start + 1)).to(torch.int32), imin)
    return dmin, imin


def _make_instanced_sdf(
    structure: SceneStructure, step_clamp: Optional[float] = None
) -> Callable:
    """`sdf(params, p[..., 3]) -> (dist, id)` for an instanced structure
    (`loltracer_tpu/render/sdf.py` `_make_instanced_sdf`): sphere_argmin,
    then under a step clamp the cut, which applies to the sphere set only,
    before the plane merge, and leaves the id alone; then the planes."""
    require_instanced(structure)
    ns = structure.num_spheres

    def sdf(params: SceneParams, p):
        dmin, imin = sphere_argmin(structure, params, p)
        if ns and step_clamp is not None:
            lo, hi = sphere_bbox(params.sphere_point, params.sphere_radius)
            dmin = torch.minimum(dmin, bbox_cut(lo, hi, p, step_clamp))
        if structure.num_planes:
            bd, bi = torch.min(p[..., 1, None] - params.plane_y, dim=-1)
            closer = bd < dmin
            dmin = torch.where(closer, bd, dmin)
            imin = torch.where(closer, (bi + (ns + 1)).to(torch.int32), imin)
        return dmin, imin

    return sdf
