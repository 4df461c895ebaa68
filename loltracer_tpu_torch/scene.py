"""Scene compilation: AST -> (static structure, scene parameters as tensors).

The same split as `loltracer_tpu/scene.py`: the *structure* (object types,
CSG tree shapes, material wiring) is a frozen, hashable `SceneStructure`
that the CUDA source generator unrolls into one kernel per structure
(render/cuda_scene.py), while every number in the scene lives in a
struct-of-arrays `SceneParams` of torch tensors that stays a runtime input.

`SceneStructure` is equal field by field to the JAX package's, and
`build_scene` produces bitwise the same numbers (tests/test_torch_frontend.py).
The module is a copy rather than an import because `loltracer_tpu/scene.py`
imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from loltracer_tpu_torch.lol.ast import (
    Box,
    ObjectAst,
    Plane,
    SceneAst,
    SmoothUnion,
    Sphere,
)
from loltracer_tpu_torch.render.backend import resolve_device

# --- Static structure ------------------------------------------------------

# A node of a compiled object expression. Leaves index into the SoA primitive
# arrays; 'smin' nodes index into smooth_k and hold child nodes.
#   ('sphere', i) | ('box', i) | ('plane', i) | ('smin', k, a, b)
Node = Union[Tuple[str, int], Tuple[str, int, "Node", "Node"]]


@dataclasses.dataclass(frozen=True)
class SceneStructure:
    """Everything about a scene that is compiled into the kernel rather than
    passed as data. Hashable; equal structures share one built kernel."""

    num_materials: int
    num_lights: int
    num_spheres: int
    num_boxes: int
    num_planes: int
    num_unions: int
    # One compiled expression per top-level object, in file order. Object ids
    # are 1-based positions in this tuple; id 0 = ray miss.
    objects: Tuple[Node, ...]
    # material_ids[id] = material index for hit id; material_ids[0] = 0, the
    # background material.
    material_ids: Tuple[int, ...]
    # Instanced mode (10k+ spheres, scenes.instanced_spheres): `objects` is
    # empty and the scene is every sphere followed by every plane; object ids
    # are 1 + the sphere's SoA index, then ns + 1 + the plane's. The plain
    # SDF walks the spheres in blocks of `instanced_block`.
    instanced: bool = False
    instanced_block: int = 512

    @property
    def num_objects(self) -> int:
        if self.instanced:
            return self.num_spheres + self.num_planes
        return len(self.objects)


def require_compiled(structure: SceneStructure) -> None:
    """Raise for instanced structures where a path has only the compiled
    tier (the per-structure generated SDF, the training kernels)."""
    if structure.instanced:
        raise NotImplementedError(
            "this path takes compiled structures only; instanced structures "
            "render through render/instanced_fwd.py"
        )


def require_instanced(structure: SceneStructure) -> None:
    """Raise unless `structure` is an instanced scene of spheres and planes.
    The instanced tier evaluates only those two primitive types; a box or a
    smooth union in an instanced structure would be dropped without a word
    (as the JAX package's instanced SDF drops it), so it is refused here."""
    if not structure.instanced:
        raise ValueError("expected an instanced structure")
    if structure.num_boxes or structure.num_unions:
        raise ValueError(
            f"instanced structures hold spheres and planes only; this one has "
            f"{structure.num_boxes} boxes and {structure.num_unions} smooth unions"
        )


# --- Scene parameters ------------------------------------------------------


@dataclasses.dataclass
class SceneParams:
    """Struct-of-arrays scene parameters, all torch tensors of one dtype on
    one device. Field shapes:

      mat_shininess [M]      mat_diffuse [M,3]  mat_specular [M,3]
      mat_ambient   [M,3]    ambient_color [3]
      light_point [L,3]      light_diffuse [L,3]  light_specular [L,3]
      cam_point [3]          cam_direction [3]    cam_fov []
      sphere_point [Ns,3]    sphere_radius [Ns]
      box_point [Nb,3]       box_half [Nb,3]      box_radius [Nb]
      plane_y [Np]
      smooth_k [Nu]
    """

    mat_shininess: torch.Tensor
    mat_diffuse: torch.Tensor
    mat_specular: torch.Tensor
    mat_ambient: torch.Tensor
    ambient_color: torch.Tensor
    light_point: torch.Tensor
    light_diffuse: torch.Tensor
    light_specular: torch.Tensor
    cam_point: torch.Tensor
    cam_direction: torch.Tensor
    cam_fov: torch.Tensor
    sphere_point: torch.Tensor
    sphere_radius: torch.Tensor
    box_point: torch.Tensor
    box_half: torch.Tensor
    box_radius: torch.Tensor
    plane_y: torch.Tensor
    smooth_k: torch.Tensor


FIELDS = tuple(f.name for f in dataclasses.fields(SceneParams))


@dataclasses.dataclass
class Scene:
    """A compiled scene: static structure + parameter tensors."""

    structure: SceneStructure
    params: SceneParams


# --- Builder ---------------------------------------------------------------


class _Collector:
    def __init__(self) -> None:
        self.sphere_point: list = []
        self.sphere_radius: list = []
        self.box_point: list = []
        self.box_half: list = []
        self.box_radius: list = []
        self.plane_y: list = []
        self.smooth_k: list = []

    def collect(self, obj: ObjectAst) -> Node:
        if isinstance(obj, Sphere):
            i = len(self.sphere_radius)
            self.sphere_point.append(obj.point)
            self.sphere_radius.append(obj.radius)
            return ("sphere", i)
        if isinstance(obj, Box):
            i = len(self.box_radius)
            self.box_point.append(obj.point)
            self.box_half.append(obj.point2)
            self.box_radius.append(obj.radius)
            return ("box", i)
        if isinstance(obj, Plane):
            i = len(self.plane_y)
            self.plane_y.append(obj.y)
            return ("plane", i)
        if isinstance(obj, SmoothUnion):
            # Children first (depth-first, a then b) so leaf order is
            # deterministic; then allocate the k slot.
            a = self.collect(obj.a)
            b = self.collect(obj.b)
            k = len(self.smooth_k)
            self.smooth_k.append(obj.smoothness)
            return ("smin", k, a, b)
        raise TypeError(f"unknown object {obj!r}")


def build_scene(
    ast: SceneAst, dtype: torch.dtype = torch.float32, device="cuda"
) -> Scene:
    """Compile a parsed scene into structure + SoA parameter tensors on
    `device` (the card by default; raises without CUDA, nothing falls back:
    pass device="cpu" for the plain versions)."""
    device = resolve_device(device, "build_scene")
    col = _Collector()
    nodes = tuple(col.collect(obj) for obj in ast.objects)
    material_ids = (0,) + tuple(obj.material for obj in ast.objects)

    structure = SceneStructure(
        num_materials=len(ast.materials),
        num_lights=len(ast.lights),
        num_spheres=len(col.sphere_radius),
        num_boxes=len(col.box_radius),
        num_planes=len(col.plane_y),
        num_unions=len(col.smooth_k),
        objects=nodes,
        material_ids=material_ids,
    )

    # Round through numpy exactly as the JAX package does, so both packages
    # hold bitwise the same numbers.
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def arr(values, shape_tail=()):
        a = np.asarray(values, dtype=np_dtype)
        if a.size == 0:
            a = a.reshape((0,) + shape_tail)
        return a

    arrays = dict(
        mat_shininess=arr([m.shininess for m in ast.materials]),
        mat_diffuse=arr([m.diffuse for m in ast.materials], (3,)),
        mat_specular=arr([m.specular for m in ast.materials], (3,)),
        mat_ambient=arr([m.ambient for m in ast.materials], (3,)),
        ambient_color=arr(ast.ambient_color),
        light_point=arr([l.point for l in ast.lights], (3,)),
        light_diffuse=arr([l.diffuse_intensity for l in ast.lights], (3,)),
        light_specular=arr([l.specular_intensity for l in ast.lights], (3,)),
        cam_point=arr(ast.camera.point),
        cam_direction=arr(ast.camera.direction),
        cam_fov=arr(ast.camera.fov),
        sphere_point=arr(col.sphere_point, (3,)),
        sphere_radius=arr(col.sphere_radius),
        box_point=arr(col.box_point, (3,)),
        box_half=arr(col.box_half, (3,)),
        box_radius=arr(col.box_radius),
        plane_y=arr(col.plane_y),
        smooth_k=arr(col.smooth_k),
    )
    return Scene(structure=structure, params=params_from_numpy(arrays, device))


def params_from_numpy(d: Dict[str, np.ndarray], device="cuda") -> SceneParams:
    """SceneParams on `device` (the card by default; raises without CUDA)
    from numpy arrays keyed by field name — the carrier of numbers between
    the JAX package and the port, e.g.
    `{f: np.asarray(getattr(jax_params, f)) for f in FIELDS}`. Values and
    dtypes are kept exactly."""
    device = resolve_device(device, "params_from_numpy")
    missing = set(FIELDS) - set(d)
    if missing:
        raise KeyError(f"missing SceneParams fields: {sorted(missing)}")
    return SceneParams(
        **{
            f: torch.from_numpy(np.array(d[f], copy=True)).to(device)
            for f in FIELDS
        }
    )


def params_to_numpy(params: SceneParams) -> Dict[str, np.ndarray]:
    """The inverse of params_from_numpy: {field: numpy copy}, detached and
    on the CPU, dtypes kept. It carries gradients and fitted numbers back
    out of the port, e.g. to compare with the JAX package."""
    return {f: getattr(params, f).detach().cpu().numpy().copy() for f in FIELDS}


def params_astype(params: SceneParams, dtype) -> SceneParams:
    """Every field cast to the numpy `dtype` on the CPU, as the JAX
    package's `params_astype` casts its arrays (host-side)."""
    return SceneParams(
        **{
            f: torch.from_numpy(np.asarray(a, dtype=dtype))
            for f, a in params_to_numpy(params).items()
        }
    )


def params_to(
    params: SceneParams, device=None, dtype: torch.dtype = None
) -> SceneParams:
    """Every field moved to `device` and/or cast to `dtype`; fields that
    already match are returned as they are."""
    return SceneParams(
        **{
            f: getattr(params, f).to(device=device, dtype=dtype)
            for f in FIELDS
        }
    )
