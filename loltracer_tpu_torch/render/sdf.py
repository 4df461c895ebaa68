"""Batched scene-SDF evaluation in torch (`loltracer_tpu/render/sdf.py`).

`make_scene_sdf(structure)` walks the static structure once in Python and
returns a closure over it. Evaluation is struct-of-arrays: one batched
distance column per primitive *type*, then per-object expressions assemble
their distances from the columns, then a first-wins argmin picks the hit
object (strict `<`, the reference's naive-backend tie rule).

Every distance is written out component by component in the order the CUDA
kernel's generated code uses (render/cuda_scene.py), so the two round alike.
Only compiled (non-instanced) structures are ported so far.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from loltracer_tpu_torch.render.vecmath import clip, maximum, minimum
from loltracer_tpu_torch.scene import Node, SceneParams, SceneStructure, require_compiled


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


def _object_dists(structure: SceneStructure, params: SceneParams, p) -> List:
    """Per-top-level-object distances, each [...], in file order."""
    cols = _columns(structure, params, p)

    def eval_node(node: Node):
        if node[0] == "smin":
            _, k, a, b = node
            return smooth_min(eval_node(a), eval_node(b), params.smooth_k[k])
        return cols[node[0]][..., node[1]]

    return [eval_node(node) for node in structure.objects]


def make_scene_sdf(structure: SceneStructure) -> Callable:
    """`sdf(params, p[..., 3]) -> dist[...]`: the min over objects, NaN
    propagating like jnp.min."""
    require_compiled(structure)

    def sdf(params: SceneParams, p):
        dists = _object_dists(structure, params, p)
        dist = dists[0]
        for d in dists[1:]:
            dist = torch.minimum(dist, d)
        return dist

    return sdf


def make_scene_sdf_with_id(structure: SceneStructure) -> Callable:
    """`sdf(params, p[..., 3]) -> (dist[...], id[...] int32)`: ids are
    1-based file-order object positions, first-wins on ties (strict <)."""
    require_compiled(structure)

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
