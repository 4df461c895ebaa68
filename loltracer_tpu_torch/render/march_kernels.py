"""The value march kernels K3 and K4: hand-written CUDA kernels and their
plain PyTorch versions (`loltracer_tpu/render/pallas_march.py`).

The differentiable renderer freezes its march and, for envelope shadows,
its shadow marches, and re-attaches every gradient outside them
(render/march.py `intersect_aa`, render/shading.py `envelope_reattach`).
So the two loops are value functions, and on CUDA tensors they run here:

- `march_values(structure, cfg, ro, rd, scene)` -> `MarchResult` of
  [...] planes (t, t_query, s_min, t_close): `lol_march` on the compiled
  `Scene`, `lol_march_instanced` on the `InstancedScene` (K3, csrc/march.cuh;
  the closest approach is always tracked, as the Pallas kernel does);
- `shadow_values(structure, cfg, ro, rd, max_dist, scene)` -> (res, t*):
  `lol_shadow_march` / `lol_shadow_march_instanced` (K4);
- `make_cuda_march` / `make_cuda_shadow_march` return the `march_fn` /
  `shadow_fn` that render/torch_renderer.py hands to the renderer (the
  counterparts of `make_pallas_march` / `make_pallas_shadow_march`).

ro is one origin [3] or one per ray [..., 3]; rd [..., 3]; any batch shape,
flattened for the kernel (its last dimension is the kernel's tile width).
`scene` is the `MarchScene` of `pack_march_scene`: the packed buffer and,
for instanced structures, the sphere tables (render/instanced_pack.py),
built once per render and shared by every march of it.

A wrapper given CUDA tensors checks them (CUDA, float32, contiguous,
shape), launches its kernel or raises; nothing falls back. CPU tensors
take the plain versions, `march_values_reference` and
`shadow_values_reference`: render/march.py `march` and render/shading.py
`shadow_march` under `no_grad`. `launches` counts kernel launches per
entry point; the plain versions never add to it. K3 and K4 share one
library per structure and march config, built at first use.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.backend import resolve_backend
from loltracer_tpu_torch.render.cuda_scene import (
    MARCH,
    MARCH_INSTANCED,
    SHADOW_MARCH,
    SHADOW_MARCH_INSTANCED,
    generate_march_source,
    pack_fields,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.fused_fwd import _check
from loltracer_tpu_torch.render.instanced_fwd import _check_tables
from loltracer_tpu_torch.render.instanced_pack import InstancedTables, pack_instanced, soa_spheres
from loltracer_tpu_torch.render.march import MarchResult, march
from loltracer_tpu_torch.render.sdf import make_scene_sdf
from loltracer_tpu_torch.render.shading import shadow_march
from loltracer_tpu_torch.scene import SceneParams, SceneStructure

__all__ = [
    "MarchScene",
    "launches",
    "library",
    "make_cuda_march",
    "make_cuda_shadow_march",
    "march_values",
    "march_values_reference",
    "pack_march_scene",
    "shadow_values",
    "shadow_values_reference",
]

launches = {MARCH: 0, SHADOW_MARCH: 0, MARCH_INSTANCED: 0, SHADOW_MARCH_INSTANCED: 0}

# the most rows of a 2-D launch grid (grid.y < 65536 blocks of up to 16 rows)
_MAX_ROWS = 65535 * 8


class MarchScene(NamedTuple):
    """What the kernels read of the scene: the packed buffer
    (cuda_scene.pack_fields) and, for instanced structures, the sphere
    tables (instanced_pack.pack_instanced); detached."""

    fields: torch.Tensor
    tables: Optional[InstancedTables]


def pack_march_scene(structure: SceneStructure, params: SceneParams) -> MarchScene:
    """The kernels' view of params, detached, f32, on the params' device."""
    with torch.no_grad():
        fields = pack_fields(structure, params)
        tables = pack_instanced(structure, params) if structure.instanced else None
    return MarchScene(fields, tables)


def _scene_params(structure: SceneStructure, scene: MarchScene) -> SceneParams:
    """SceneParams of a MarchScene (the spheres back in SoA order); the
    camera fields, which no march reads, are zeros."""
    fields = unpack_fields(structure, scene.fields)
    if scene.tables is not None:
        pos, rad = soa_spheres(structure, scene.tables)
        fields.update(sphere_point=pos, sphere_radius=rad)
    zero = scene.fields.new_zeros(3)
    return SceneParams(**fields, cam_point=zero, cam_direction=zero, cam_fov=zero[0])


def march_values_reference(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, scene: MarchScene,
    live: Optional[List[int]] = None,
) -> MarchResult:
    """The plain version of K3: march.march over the scene's SDF (under
    cfg.step_clamp for instanced structures), without autograd. `live`,
    if a list, gets the rays still marching at each step: the SDF
    evaluations a thread per ray makes."""
    clamp = cfg.step_clamp if structure.instanced else None
    with torch.no_grad():
        return march(make_scene_sdf(structure, clamp), _scene_params(structure, scene),
                     ro, rd, cfg, live)


def shadow_values_reference(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, max_dist, scene: MarchScene,
    live: Optional[List[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K4: shading.shadow_march over the scene's SDF
    (under the shadow step clamp for instanced structures), without
    autograd. Returns (res, t*). `live` as for march_values_reference."""
    clamp = cfg.effective_shadow_clamp() if structure.instanced else None
    with torch.no_grad():
        return shadow_march(make_scene_sdf(structure, clamp), _scene_params(structure, scene),
                            ro, rd, max_dist, cfg, live)


def kernel_config(structure: SceneStructure, cfg: RenderConfig) -> RenderConfig:
    """The part of cfg the march kernels compile in (step caps, tolerances,
    shadow sharpness and, for instanced structures, the two step clamps);
    configs that agree on it share one library."""
    clamps = {}
    if structure.instanced:
        clamps = dict(step_clamp=cfg.step_clamp, shadow_step_clamp=cfg.shadow_step_clamp)
    return RenderConfig(max_steps=cfg.max_steps, epsilon=cfg.epsilon, max_dist=cfg.max_dist,
                        shadow_steps=cfg.shadow_steps, shadow_w=cfg.shadow_w, **clamps)


@functools.lru_cache(maxsize=None)
def _library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    built = _build.build(generate_march_source(structure, cfg), "march")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    if structure.instanced:
        entries = {MARCH_INSTANCED: [ptr, i32] + [ptr] * 6 + [i32] * 2 + [ptr] + [i32] * 2 + [ptr],
                   SHADOW_MARCH_INSTANCED: [ptr, i32] + [ptr] * 7 + [i32] * 2 + [ptr]
                   + [i32] * 2 + [ptr]}
    else:
        entries = {MARCH: [ptr, i32, ptr, ptr, ptr, i32, i32, ptr],
                   SHADOW_MARCH: [ptr, i32] + [ptr] * 4 + [i32] * 2 + [ptr]}
    for name, args in entries.items():
        fn = getattr(built.lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return built


def library(structure: SceneStructure, cfg: RenderConfig) -> _build.Library:
    """The built K3 / K4 library for this structure and config (compiled at
    first use, then loaded from the build cache). Instanced structures
    that differ only in their sphere count share one source."""
    return _library(structure, kernel_config(structure, cfg))


def _layout(batch) -> Tuple[int, int]:
    """(rows, width) of a ray batch for the launch grid: the last batch
    dimension is the width, the rest the rows; one row when that has too
    many rows for the grid."""
    n = math.prod(batch)
    width = batch[-1] if len(batch) >= 2 else n
    rows = n // width
    return (rows, width) if rows <= _MAX_ROWS else (1, n)


def _launch(structure, cfg, name, scene, ro, rd, max_dist, planes):
    """Checks the inputs, launches entry `name` and returns its [planes,
    ...] output over rd's batch."""
    batch = tuple(rd.shape[:-1])
    n = math.prod(batch)
    _check("rd", rd, batch + (3,))
    ro_stride = 0 if tuple(ro.shape) == (3,) else 3
    _check("ro", ro, (3,) if ro_stride == 0 else batch + (3,))
    if max_dist is not None:
        _check("max_dist", max_dist, batch)
    _check("fields", scene.fields, (packed_size(structure),))
    if scene.tables is not None:
        _check_tables(structure, scene.tables, rd.device)
    tensors = [ro, rd, scene.fields] + ([] if max_dist is None else [max_dist])
    if any(t.device != rd.device for t in tensors):
        raise ValueError("ro, rd, max_dist and the scene must be on one device")
    out = torch.empty((planes, n), dtype=torch.float32, device=rd.device)
    if n == 0:
        return out.reshape((planes,) + batch)
    rows, width = _layout(batch)
    fn = getattr(library(structure, cfg).lib, name)
    args = [ro.data_ptr(), ro_stride, rd.data_ptr()]
    if max_dist is not None:
        args.append(max_dist.data_ptr())
    args.append(scene.fields.data_ptr())
    if scene.tables is not None:
        tab = scene.tables
        args += [tab.spheres.data_ptr(), tab.ids.data_ptr(), tab.groups.data_ptr(),
                 tab.bbox.data_ptr(), tab.spheres.shape[0], tab.groups.shape[0]]
    with torch.cuda.device(rd.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, out.data_ptr(), rows, width, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1
    return out.reshape((planes,) + batch)


def march_values(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, scene: MarchScene
) -> MarchResult:
    """K3 for CUDA tensors, march_values_reference for CPU tensors: the
    frozen march of rays ro [3] or [..., 3] along rd [..., 3]."""
    if resolve_backend(ro, rd, scene.fields) == "torch":
        return march_values_reference(structure, cfg, ro, rd, scene)
    name = MARCH_INSTANCED if structure.instanced else MARCH
    return MarchResult(*_launch(structure, cfg, name, scene, ro, rd, None, 4))


def shadow_values(
    structure: SceneStructure, cfg: RenderConfig, ro, rd, max_dist, scene: MarchScene
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 for CUDA tensors, shadow_values_reference for CPU tensors: (res,
    t*) of the shadow marches from ro [..., 3] along rd [..., 3] up to
    max_dist [...]."""
    if resolve_backend(ro, rd, max_dist, scene.fields) == "torch":
        return shadow_values_reference(structure, cfg, ro, rd, max_dist, scene)
    name = SHADOW_MARCH_INSTANCED if structure.instanced else SHADOW_MARCH
    res, t_star = _launch(structure, cfg, name, scene, ro, rd, max_dist, 2)
    return res, t_star


def _ray_batch(ro, rd, *per_ray):
    """ro kept as one origin [3] or broadcast to rd's batch, every tensor
    detached and contiguous (copies only where needed)."""
    batch = torch.broadcast_shapes(ro.shape[:-1], rd.shape[:-1],
                                   *(t.shape for t in per_ray))
    if ro.dim() != 1:
        ro = ro.expand(batch + (3,))
    rd = rd.expand(batch + (3,))
    return [t.detach().contiguous() for t in
            (ro, rd, *(t.expand(batch) for t in per_ray))]


def make_cuda_march(structure: SceneStructure, cfg: RenderConfig) -> Callable:
    """`march_fn(params, ro, rd, scene=None) -> MarchResult`: the frozen
    march through K3 (`pallas_march.make_pallas_march`). `scene` is a
    MarchScene of params packed once per render; without it the call
    packs its own. No output carries a gradient."""

    def march_fn(params: SceneParams, ro, rd, scene: Optional[MarchScene] = None):
        if scene is None:
            scene = pack_march_scene(structure, params)
        return march_values(structure, cfg, *_ray_batch(ro, rd), scene)

    return march_fn


def make_cuda_shadow_march(structure: SceneStructure, cfg: RenderConfig) -> Callable:
    """`shadow_fn(params, ro, rd, max_dist, scene=None) -> (res, t*)`: the
    frozen shadow march through K4 (`make_pallas_shadow_march`)."""

    def shadow_fn(params: SceneParams, ro, rd, max_dist, scene: Optional[MarchScene] = None):
        if scene is None:
            scene = pack_march_scene(structure, params)
        return shadow_values(structure, cfg, *_ray_batch(ro, rd, max_dist), scene)

    return shadow_fn
