"""Typed AST for the `.lol` scene DSL.

A copy of `loltracer_tpu/lol/ast.py`: importing anything from `loltracer_tpu` runs its
package `__init__`, which imports jax. tests/test_torch_frontend.py holds
the two equal.

Mirrors the reference's semantic model (scene.h:44-96) as immutable
dataclasses. Values are stored *after* the reference's semantic passes:

- camera direction is normalized and fov converted degrees->radians
  (scene.c:173-174),
- a plane's anchor point is (0, y, 0) (scene.c:215),
- unspecified properties default to zero (the reference memsets each struct,
  scene.c:118/123) — except the scene-level camera default, which is
  point=(0,0,0), direction=(0,0,1), fov=pi/2 radians (scene.c:51-55) and is
  only used when no `camera { }` block appears at all.

Object ids are implicit: the i-th top-level object has id i+1; id 0 means
"ray missed" and maps to material 0 (naive_renderer.c:102-112), so the first
material in the file acts as the background material and `#1` is the second
entry. Smooth-union children are not scene objects: they carry no id and no
material of their own; the whole CSG tree shades with the union's material
(scene.h:76-80).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

Vec3 = Tuple[float, float, float]

_ZERO3: Vec3 = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class Material:
    """Phong material (scene.h:44-49)."""

    shininess: float = 0.0
    diffuse: Vec3 = _ZERO3
    specular: Vec3 = _ZERO3
    ambient: Vec3 = _ZERO3


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera (scene.h:84-88); direction unit-length, fov radians."""

    point: Vec3 = _ZERO3
    direction: Vec3 = (0.0, 0.0, 1.0)
    fov: float = math.pi / 2


@dataclasses.dataclass(frozen=True)
class Light:
    """Point light (scene.h:52-56)."""

    point: Vec3 = _ZERO3
    diffuse_intensity: Vec3 = _ZERO3
    specular_intensity: Vec3 = _ZERO3


@dataclasses.dataclass(frozen=True)
class Sphere:
    point: Vec3 = _ZERO3
    radius: float = 0.0
    material: int = 0


@dataclasses.dataclass(frozen=True)
class Box:
    """Rounded box: half-extents `point2`, corner radius `radius`.

    The reference evaluates every box through sdRoundBox (naive_renderer.c:18,
    sdf.h:18-22); radius 0 degenerates to a sharp box.
    """

    point: Vec3 = _ZERO3
    point2: Vec3 = _ZERO3
    radius: float = 0.0
    material: int = 0


@dataclasses.dataclass(frozen=True)
class Plane:
    """Horizontal plane y = const (scene.c:207-216)."""

    y: float = 0.0
    material: int = 0


@dataclasses.dataclass(frozen=True)
class SmoothUnion:
    """Polynomial smooth-min CSG union of two child objects (scene.h:76-80).

    The children are evaluated at the *untranslated* query point — the
    reference computes `p - obj->point` but then recurses with the original
    `p` (naive_renderer.c:21-24), so a smooth-union's own `point` has no
    effect. We do not model a `point` here at all. Children may themselves be
    smooth unions (recursive CSG, examples/scene4.lol).
    """

    smoothness: float = 0.0
    a: "ObjectAst" = None  # type: ignore[assignment]
    b: "ObjectAst" = None  # type: ignore[assignment]
    material: int = 0


ObjectAst = Union[Sphere, Box, Plane, SmoothUnion]


@dataclasses.dataclass(frozen=True)
class SceneAst:
    """A parsed scene (scene.h:90-96)."""

    materials: Tuple[Material, ...]
    ambient_color: Vec3
    lights: Tuple[Light, ...]
    objects: Tuple[ObjectAst, ...]
    camera: Camera

    def validate_materials(self) -> bool:
        """Material-index validation (scene.c:284-292), extended to CSG
        children for strictness (children's materials are unused but the
        reference grammar allows writing them)."""
        n = len(self.materials)

        def ok(obj: ObjectAst) -> bool:
            if obj.material >= n:
                return False
            if isinstance(obj, SmoothUnion):
                return ok(obj.a) and ok(obj.b)
            return True

        return all(ok(o) for o in self.objects)

    def num_lights(self) -> int:
        return len(self.lights)

    def num_objects(self) -> int:
        return len(self.objects)
