"""The raw scene inputs both sides take."""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

# SceneParams' fields, in the order of its dataclass
FIELDS = (
    "mat_shininess", "mat_diffuse", "mat_specular", "mat_ambient", "ambient_color",
    "light_point", "light_diffuse", "light_specular", "cam_point", "cam_direction", "cam_fov",
    "sphere_point", "sphere_radius", "box_point", "box_half", "box_radius", "plane_y",
    "smooth_k",
)


class SceneData(NamedTuple):
    """structure: num_materials, num_lights, num_spheres, num_boxes,
    num_planes, num_unions, objects (nested lists: ["sphere", i],
    ["box", i], ["plane", i], ["smin", k, a, b]), material_ids, instanced.
    arrays: one float32 array per FIELDS entry."""

    structure: dict
    arrays: Dict[str, np.ndarray]
