"""A procedural field of spheres over a ground plane lit by two point
lights: a copy of the numpy generator of `scenes.instanced_spheres`, the
same draws in the same order, so the arrays are bitwise the port's for the
same arguments."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.data import SceneData


def generate(n: int = 10_000, seed: int = 0, num_materials: int = 6,
             extent: float = 40.0) -> SceneData:
    dtype = np.float32
    rng = np.random.default_rng(seed)
    pos = np.empty((n, 3), dtype)
    pos[:, 0] = rng.uniform(-extent, extent, n)
    pos[:, 1] = rng.uniform(-0.5, extent / 4, n)
    pos[:, 2] = rng.uniform(-2.0 * extent, -4.0, n)
    radius = rng.uniform(0.2, 0.6, n).astype(dtype)

    mats = [dict(shininess=0.0, diffuse=(0, 0, 0), specular=(0, 0, 0), ambient=(0, 0, 0))]
    palette = rng.uniform(0.05, 0.3, size=(num_materials, 3))
    for i in range(num_materials):
        c = tuple(palette[i])
        mats.append(dict(shininess=float(2 + 6 * i), diffuse=c, specular=(0.05, 0.05, 0.05),
                         ambient=c))
    mats.append(dict(shininess=25.0, diffuse=(0.04, 0.03, 0.02), specular=(0.05, 0.05, 0.05),
                     ambient=(0.04, 0.03, 0.02)))
    floor_mat = len(mats) - 1
    material_ids = [0] + [1 + (i % num_materials) for i in range(n)] + [floor_mat]

    structure = dict(num_materials=len(mats), num_lights=2, num_spheres=n, num_boxes=0,
                     num_planes=1, num_unions=0, objects=[], material_ids=material_ids,
                     instanced=True)
    direction = np.asarray([0, -0.15, -1], np.float64)
    arrays = dict(
        mat_shininess=np.asarray([m["shininess"] for m in mats], dtype),
        mat_diffuse=np.asarray([m["diffuse"] for m in mats], dtype),
        mat_specular=np.asarray([m["specular"] for m in mats], dtype),
        mat_ambient=np.asarray([m["ambient"] for m in mats], dtype),
        ambient_color=np.asarray([0.05, 0.05, 0.06], dtype),
        light_point=np.asarray([[-20, 30, -10], [25, 15, -30]], dtype),
        light_diffuse=np.asarray([[3.5, 3.3, 3.0], [1.0, 1.2, 1.8]], dtype),
        light_specular=np.asarray([[3.5, 3.3, 3.0], [1.0, 1.2, 1.8]], dtype),
        cam_point=np.asarray([0, 4, 6], dtype),
        cam_direction=(direction / np.linalg.norm(direction)).astype(dtype),
        cam_fov=np.asarray(np.deg2rad(90.0), dtype),
        sphere_point=pos,
        sphere_radius=radius,
        box_point=np.zeros((0, 3), dtype),
        box_half=np.zeros((0, 3), dtype),
        box_radius=np.zeros((0,), dtype),
        plane_y=np.asarray([-1.0], dtype),
        smooth_k=np.zeros((0,), dtype),
    )
    return SceneData(structure, arrays)


def build(entry: dict) -> SceneData:
    return generate(**entry["generator"])
