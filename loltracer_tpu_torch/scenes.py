"""Procedural scene generation (`loltracer_tpu/scenes.py`): the instanced
10k+ primitive configuration (BASELINE config 5).

A copy rather than an import, because `loltracer_tpu/scenes.py` imports the
JAX package's scene module, which imports jax. The numbers come from the
same numpy generator in the same order, so the parameters are bitwise the
JAX package's (tests/test_torch_instanced.py).
"""

from __future__ import annotations

import numpy as np

from loltracer_tpu_torch.render.backend import resolve_device
from loltracer_tpu_torch.scene import Scene, SceneStructure, params_from_numpy


def instanced_spheres(
    n: int = 10_000,
    seed: int = 0,
    num_materials: int = 6,
    extent: float = 40.0,
    dtype=np.float32,
    device="cuda",
) -> Scene:
    """A field of n spheres over a ground plane, lit by two point lights.

    Spheres scatter in a slab in front of the camera with radii 0.2-0.6;
    materials cycle through a small palette (id 0 stays the black
    background material). The parameters are torch tensors on `device`:
    the card by default (raises without CUDA; pass device="cpu" for the
    plain versions)."""
    device = resolve_device(device, "instanced_spheres")
    rng = np.random.default_rng(seed)

    pos = np.empty((n, 3), dtype)
    pos[:, 0] = rng.uniform(-extent, extent, n)  # x
    pos[:, 1] = rng.uniform(-0.5, extent / 4, n)  # y (above the floor)
    pos[:, 2] = rng.uniform(-2.0 * extent, -4.0, n)  # z (in front)
    radius = rng.uniform(0.2, 0.6, n).astype(dtype)

    mats = [
        # background
        dict(shininess=0.0, diffuse=(0, 0, 0), specular=(0, 0, 0), ambient=(0, 0, 0)),
    ]
    palette = rng.uniform(0.05, 0.3, size=(num_materials, 3))
    for i in range(num_materials):
        c = tuple(palette[i])
        mats.append(
            dict(
                shininess=float(2 + 6 * i),
                diffuse=c,
                specular=(0.05, 0.05, 0.05),
                ambient=c,
            )
        )
    # floor material
    mats.append(
        dict(shininess=25.0, diffuse=(0.04, 0.03, 0.02),
             specular=(0.05, 0.05, 0.05), ambient=(0.04, 0.03, 0.02))
    )
    floor_mat = len(mats) - 1

    m = len(mats)
    sphere_mats = tuple(1 + (i % num_materials) for i in range(n))
    material_ids = (0,) + sphere_mats + (floor_mat,)

    structure = SceneStructure(
        num_materials=m,
        num_lights=2,
        num_spheres=n,
        num_boxes=0,
        num_planes=1,
        num_unions=0,
        objects=(),
        material_ids=material_ids,
        instanced=True,
    )

    arrays = dict(
        mat_shininess=np.asarray([mm["shininess"] for mm in mats], dtype),
        mat_diffuse=np.asarray([mm["diffuse"] for mm in mats], dtype),
        mat_specular=np.asarray([mm["specular"] for mm in mats], dtype),
        mat_ambient=np.asarray([mm["ambient"] for mm in mats], dtype),
        ambient_color=np.asarray([0.05, 0.05, 0.06], dtype),
        light_point=np.asarray([[-20, 30, -10], [25, 15, -30]], dtype),
        light_diffuse=np.asarray([[3.5, 3.3, 3.0], [1.0, 1.2, 1.8]], dtype),
        light_specular=np.asarray([[3.5, 3.3, 3.0], [1.0, 1.2, 1.8]], dtype),
        cam_point=np.asarray([0, 4, 6], dtype),
        cam_direction=(lambda v: v / np.linalg.norm(v))(
            np.asarray([0, -0.15, -1], np.float64)
        ).astype(dtype),
        cam_fov=np.asarray(np.deg2rad(90.0), dtype),
        sphere_point=pos,
        sphere_radius=radius,
        box_point=np.zeros((0, 3), dtype),
        box_half=np.zeros((0, 3), dtype),
        box_radius=np.zeros((0,), dtype),
        plane_y=np.asarray([-1.0], dtype),
        smooth_k=np.zeros((0,), dtype),
    )
    return Scene(structure=structure, params=params_from_numpy(arrays, device))
