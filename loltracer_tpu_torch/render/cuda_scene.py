"""Scene plumbing for the CUDA kernel (`loltracer_tpu/render/pallas_scene.py`).

The Pallas kernels unroll the static `SceneStructure` at trace time and read
every scene number from SMEM. Here the same split becomes CUDA source text:
`generate_source(structure, cfg)` emits the kernel's per-structure `Scene`
type — one straight-line distance function per top-level object (the
counterpart of `ScalarScene.node_dist`/`dist_only`/`sdf`), reading scene
numbers from ONE packed f32 buffer at generated offsets — and the `Cfg`
constants (march and shadow step caps and tolerances, the counterpart of
`march_loop`/`shadow_loop`'s closure over cfg), followed by the generic
kernel body of `csrc/fused_fwd.cuh`.

The source holds offsets, never scene values: the same structure with other
numbers (a moved camera, an optimiser step) reuses the same built library.
`pack_fields` builds that buffer from `SceneParams`; `unpack_fields` reads it
back for the plain PyTorch version.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.scene import Node, SceneParams, SceneStructure, require_compiled

# All scene-parameter fields the kernel reads, in packing order. Geometry
# comes first, so the SDF's numbers are one contiguous prefix of the buffer.
PARAM_FIELDS = [
    "sphere_point",
    "sphere_radius",
    "box_point",
    "box_half",
    "box_radius",
    "plane_y",
    "smooth_k",
    "mat_shininess",
    "mat_diffuse",
    "mat_specular",
    "mat_ambient",
    "ambient_color",
    "light_point",
    "light_diffuse",
    "light_specular",
]

GEOM_FIELDS = PARAM_FIELDS[:7]

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def active_fields(
    structure: SceneStructure, fields: List[str] = PARAM_FIELDS
) -> List[str]:
    """Param fields with nonzero size for this structure."""
    return [f for f in fields if math.prod(field_shape(structure, f))]


def field_shape(structure: SceneStructure, field: str) -> Tuple[int, ...]:
    """Logical shape of a param field for this structure."""
    s = structure
    return {
        "sphere_point": (s.num_spheres, 3),
        "sphere_radius": (s.num_spheres,),
        "box_point": (s.num_boxes, 3),
        "box_half": (s.num_boxes, 3),
        "box_radius": (s.num_boxes,),
        "plane_y": (s.num_planes,),
        "smooth_k": (s.num_unions,),
        "mat_shininess": (s.num_materials,),
        "mat_diffuse": (s.num_materials, 3),
        "mat_specular": (s.num_materials, 3),
        "mat_ambient": (s.num_materials, 3),
        "ambient_color": (3,),
        "light_point": (s.num_lights, 3),
        "light_diffuse": (s.num_lights, 3),
        "light_specular": (s.num_lights, 3),
    }[field]


def field_offsets(structure: SceneStructure) -> Dict[str, int]:
    """Offset of each active field in the packed buffer."""
    offsets, pos = {}, 0
    for f in active_fields(structure):
        offsets[f] = pos
        pos += math.prod(field_shape(structure, f))
    return offsets


def packed_size(structure: SceneStructure) -> int:
    """Length of the packed buffer."""
    return sum(math.prod(field_shape(structure, f)) for f in active_fields(structure))


def pack_fields(structure: SceneStructure, params: SceneParams) -> torch.Tensor:
    """The kernel's scene buffer: every active field flattened, f32, in
    PARAM_FIELDS order, on the params' device."""
    parts = []
    for f in active_fields(structure):
        v = getattr(params, f)
        if tuple(v.shape) != field_shape(structure, f):
            raise ValueError(
                f"{f}: shape {tuple(v.shape)} != {field_shape(structure, f)}"
            )
        parts.append(v.reshape(-1).to(torch.float32))
    return torch.cat(parts).contiguous()


def unpack_fields(
    structure: SceneStructure, fields: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Inverse of pack_fields: {field: view of the buffer} for every param
    field (inactive ones empty); the camera fields are not in the buffer."""
    offsets = field_offsets(structure)
    out = {}
    for f in PARAM_FIELDS:
        shape = field_shape(structure, f)
        if f in offsets:
            n = math.prod(shape)
            out[f] = fields[offsets[f] : offsets[f] + n].reshape(shape)
        else:
            out[f] = fields.new_zeros(shape)
    return out


# --- CUDA source generation ----------------------------------------------


def _f32(x: float) -> str:
    """Exact C++ literal of x rounded to float32."""
    v = float(np.float32(x))
    if math.isinf(v):
        return "INFINITY" if v > 0 else "-INFINITY"
    return float.hex(v) + "f"


def _cfg_source(cfg: RenderConfig) -> str:
    if cfg.shadow_grad not in ("exact", "envelope"):
        raise ValueError(f"unknown shadow_grad {cfg.shadow_grad!r}")
    ints = {"max_steps": cfg.max_steps, "shadow_steps": cfg.shadow_steps}
    floats = {
        "epsilon": cfg.epsilon,
        "max_dist": cfg.max_dist,
        "shadow_w": cfg.shadow_w,
        "shadow_offset": cfg.shadow_offset,
        "normal_h_scale": cfg.normal_h_scale,
        "gamma": cfg.gamma,
    }
    lines = ["struct Cfg {"]
    lines += [f"  static constexpr int {k} = {int(v)};" for k, v in ints.items()]
    lines += [f"  static constexpr float {k} = {_f32(v)};" for k, v in floats.items()]
    lines.append(
        f"  static constexpr bool antialias = {'true' if cfg.antialias else 'false'};"
    )
    lines.append("};")
    return "\n".join(lines)


class _NodeEmitter:
    """Emits one object's distance as straight-line statements over the
    geometry registers g[], in the operation order of render/sdf.py."""

    def __init__(self, offsets: Dict[str, int]):
        self.off = offsets
        self.lines: List[str] = []
        self.n = 0

    def _tmp(self) -> str:
        self.n += 1
        return f"v{self.n}"

    def emit(self, node: Node) -> str:
        kind, off, out = node[0], self.off, self._tmp()
        if kind == "sphere":
            c, r = off["sphere_point"] + 3 * node[1], off["sphere_radius"] + node[1]
            self.lines += [
                f"const float {out}x = px - g[{c}], {out}y = py - g[{c + 1}], "
                f"{out}z = pz - g[{c + 2}];",
                f"const float {out} = sqrtf({out}x * {out}x + {out}y * {out}y + "
                f"{out}z * {out}z) - g[{r}];",
            ]
        elif kind == "box":
            c, h = off["box_point"] + 3 * node[1], off["box_half"] + 3 * node[1]
            r = off["box_radius"] + node[1]
            q = [f"{out}q{a}" for a in "xyz"]
            o = [f"{out}o{a}" for a in "xyz"]
            for i, a in enumerate("xyz"):
                self.lines.append(
                    f"const float {q[i]} = fabsf(p{a} - g[{c + i}]) - g[{h + i}];"
                )
            self.lines.append(
                "const float " + ", ".join(f"{o[i]} = jmax({q[i]}, 0.f)" for i in range(3)) + ";"
            )
            self.lines.append(
                f"const float {out} = (sqrtf({o[0]} * {o[0]} + {o[1]} * {o[1]} + "
                f"{o[2]} * {o[2]}) + jmin(jmax({q[0]}, jmax({q[1]}, {q[2]})), 0.f))"
                f" - g[{r}];"
            )
        elif kind == "plane":
            self.lines.append(f"const float {out} = py - g[{off['plane_y'] + node[1]}];")
        elif kind == "smin":
            _, k, a, b = node
            va, vb = self.emit(a), self.emit(b)
            self.lines.append(
                f"const float {out} = smooth_min({va}, {vb}, g[{off['smooth_k'] + k}]);"
            )
        else:
            raise ValueError(f"unknown node {node!r}")
        return out


def _scene_source(structure: SceneStructure) -> str:
    require_compiled(structure)
    if not structure.objects:
        raise ValueError("a scene needs at least one object")
    off = field_offsets(structure)
    n_geom = max(
        off[f] + math.prod(field_shape(structure, f))
        for f in GEOM_FIELDS
        if f in off
    )

    def at(field):
        return off.get(field, 0)  # absent fields are never read

    lines = [
        "struct Scene {",
        f"  static constexpr int kNumLights = {structure.num_lights};",
        f"  static constexpr int kMatShininess = {at('mat_shininess')};",
        f"  static constexpr int kMatDiffuse = {at('mat_diffuse')};",
        f"  static constexpr int kMatSpecular = {at('mat_specular')};",
        f"  static constexpr int kMatAmbient = {at('mat_ambient')};",
        f"  static constexpr int kAmbientColor = {at('ambient_color')};",
        f"  static constexpr int kLightPoint = {at('light_point')};",
        f"  static constexpr int kLightDiffuse = {at('light_diffuse')};",
        f"  static constexpr int kLightSpecular = {at('light_specular')};",
        f"  static constexpr int kNumGeom = {n_geom};",
        "  float g[kNumGeom];  // the geometry prefix of the buffer, in registers",
        "",
        "  __device__ __forceinline__ explicit Scene(const float* __restrict__ P) {",
        "#pragma unroll",
        "    for (int i = 0; i < kNumGeom; ++i) g[i] = __ldg(P + i);",
        "  }",
    ]
    for i, node in enumerate(structure.objects):
        em = _NodeEmitter(off)
        result = em.emit(node)
        lines.append("")
        lines.append(f"  // object {i + 1}: {node[0]}")
        lines.append(
            f"  __device__ __forceinline__ float obj{i}(float px, float py, float pz) const {{"
        )
        lines += [f"    {s}" for s in em.lines]
        lines.append(f"    return {result};")
        lines.append("  }")

    n = len(structure.objects)
    lines += [
        "",
        "  // min over objects (torch.minimum order: object 1 first)",
        "  __device__ __forceinline__ float dist(float px, float py, float pz) const {",
        "    float d = obj0(px, py, pz);",
    ]
    lines += [f"    d = jmin(d, obj{i}(px, py, pz));" for i in range(1, n)]
    lines += [
        "    return d;",
        "  }",
        "",
        "  // (material, distance): strict-< first-wins argmin over objects",
        "  __device__ __forceinline__ int sdf_mat(float px, float py, float pz,",
        "                                         float& dmin) const {",
        "    dmin = INFINITY;",
        "    int mat = 0;",
        "    float d;",
    ]
    for i in range(n):
        m = structure.material_ids[i + 1]
        lines.append(
            f"    d = obj{i}(px, py, pz); if (d < dmin) {{ dmin = d; mat = {m}; }}"
        )
    lines += ["    return mat;", "  }", "};"]
    return "\n".join(lines)


ENTRY = "lol_render_fused"


def generate_source(structure: SceneStructure, cfg: RenderConfig) -> str:
    """The complete CUDA translation unit of the fused forward kernel for
    this structure and config. Deterministic; holds no scene numbers."""
    body = (CSRC / "fused_fwd.cuh").read_text()
    return "\n".join(
        [
            "// Generated by loltracer_tpu_torch.render.cuda_scene: the kernel",
            "// body of csrc/fused_fwd.cuh, then this structure's Cfg and Scene.",
            body,
            "namespace lol_gen {",
            "using namespace lol;",
            _cfg_source(cfg),
            "",
            _scene_source(structure),
            "}  // namespace lol_gen",
            "",
            f'extern "C" int {ENTRY}(const void* cam, const void* fields, void* img,',
            "                                int height, int width, void* stream) {",
            "  return lol::launch_fused_fwd<lol_gen::Cfg, lol_gen::Scene>(",
            "      static_cast<const float*>(cam), static_cast<const float*>(fields),",
            "      static_cast<float*>(img), height, width,",
            "      static_cast<cudaStream_t>(stream));",
            "}",
            "",
        ]
    )
