"""Scene plumbing for the CUDA kernels (`loltracer_tpu/render/pallas_scene.py`).

The Pallas kernels unroll the static `SceneStructure` at trace time and read
every scene number from SMEM. Here the same split becomes CUDA source text:
`generate_source(structure, cfg)` emits the kernel's per-structure `Scene`
type — one straight-line distance function per top-level object (the
counterpart of `ScalarScene.node_dist`/`dist_only`/`sdf`), reading scene
numbers from ONE packed f32 buffer at generated offsets — and the `Cfg`
constants (march and shadow step caps and tolerances, the counterpart of
`march_loop`/`shadow_loop`'s closure over cfg), after the generic kernel
body of `csrc/fused_fwd.cuh`.

`generate_source(structure, cfg, residuals=True)` is the training source:
the same forward body with `Cfg::with_residuals` set (`lol_train_fwd`), the
backward body of `csrc/fused_bwd.cuh` (`lol_train_bwd` and its fixed-order
reduce), and `Scene::dist_bwd`, the reverse-mode adjoint of the distance
written object by object in the same straight-line style. The JAX kernels
get that adjoint from `jax.vjp` inside the kernel; CUDA has no AD, so it is
generated here.

The source holds offsets, never scene values: the same structure with other
numbers (a moved camera, an optimiser step) reuses the same built library.
`pack_fields` builds that buffer from `SceneParams`; `unpack_fields` reads it
back for the plain PyTorch version.

`generate_instanced_source(structure, cfg)` is the instanced tier's source
(`lol_instanced_render`): the forward body, the search of
csrc/grid_scene.cuh (a cell grid of candidate spheres over
csrc/instanced_scene.cuh's run walk), and a generated layout and Cfg with
both step clamps; `lol_instanced_render_walk` (the run walk alone) and
`lol_instanced_render_stats` (the grid, counting its fallbacks) are its
check entries. For instanced structures the buffer holds the small fields only
(`pallas_train.instanced_small_fields`): the sphere SoA goes to the kernel
as the tables of render/instanced_pack.py. The source depends on neither
the sphere count nor the material ids, so `instanced:300` and
`instanced:10000` share one library. With `residuals=True` it is the
instanced training source: the forward with residuals (`lol_instanced_fwd`)
and the backward of csrc/instanced_bwd.cuh (`lol_instanced_bwd`, with its
reduce and scatter launches), whose SDF adjoint is the search's own
`InstancedScene::dist_bwd`, not a generated one; both search the cell grid
(the backward the one its step's forward searched), with the run walk
(`lol_instanced_bwd_walk`) and the counting grid (`lol_instanced_bwd_stats`)
as the backward's check entries. K3i / K4i still walk the runs.

`generate_march_source(structure, cfg)` is the source of the value march
kernels K3 and K4 (csrc/march.cuh) on the compiled `Scene` or, for an
instanced structure, on the `InstancedScene`, one thread a ray, or a lane
group a ray (csrc/coop_march.cuh, each width of MARCH_LANES): one library
per structure and config holds both. `generate_regroup_source(structure,
cfg)` is the source of the regrouped instanced forward K9 (csrc/regroup.cuh: lol_rg_march,
lol_rg_shadow and lol_rg_shade over the cell grid, with run-walk twins and
counting entries), one text for every sphere count too.
`generate_eval_source(structure, cfg)` is the source of K7
(`lol_instanced_eval`, csrc/march.cuh): the instanced distance at points
under cfg.step_clamp over the cell grid, its planes' heights read from a
buffer of their own; `_walk` and `_stats` entries as K5's.

The grid entries take the grid by value after the image or output
arguments (`GRID_ARGTYPES`, render/cell_grid.py `grid_args`).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.instanced_pack import GROUP
from loltracer_tpu_torch.scene import (
    Node,
    SceneParams,
    SceneStructure,
    require_compiled,
    require_instanced,
)

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

# The sphere SoA of an instanced structure: not in the packed buffer.
SPHERE_FIELDS = ("sphere_point", "sphere_radius")

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


def packed_fields(structure: SceneStructure) -> List[str]:
    """The fields in the packed buffer, in order: every active field, less
    the sphere SoA for instanced structures."""
    fields = active_fields(structure)
    if structure.instanced:
        fields = [f for f in fields if f not in SPHERE_FIELDS]
    return fields


def field_offsets(structure: SceneStructure) -> Dict[str, int]:
    """Offset of each packed field in the buffer."""
    offsets, pos = {}, 0
    for f in packed_fields(structure):
        offsets[f] = pos
        pos += math.prod(field_shape(structure, f))
    return offsets


def packed_size(structure: SceneStructure) -> int:
    """Length of the packed buffer."""
    return sum(math.prod(field_shape(structure, f)) for f in packed_fields(structure))


def pack_fields(structure: SceneStructure, params: SceneParams) -> torch.Tensor:
    """The kernel's scene buffer: every packed field flattened, f32, in
    PARAM_FIELDS order, on the params' device."""
    parts = []
    for f in packed_fields(structure):
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
    field (the others zeros of their shape); the camera fields are not in
    the buffer."""
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


def _cfg_source(cfg: RenderConfig, residuals: bool, instanced: bool = False) -> str:
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
    lines.append(
        f"  static constexpr bool with_residuals = {'true' if residuals else 'false'};"
    )
    if instanced:
        for name, clamp in (("clamp", cfg.step_clamp),
                            ("shadow_clamp", cfg.effective_shadow_clamp())):
            has = "true" if clamp is not None else "false"
            lines.append(f"  static constexpr bool has_{name} = {has};")
            lines.append(f"  static constexpr float {name} = {_f32(clamp or 0.0)};")
    lines.append("};")
    return "\n".join(lines)


class _NodeEmitter:
    """Emits one object's distance as straight-line statements over the
    geometry registers g[], in the operation order of render/sdf.py."""

    def __init__(self, offsets: Dict[str, int], prefix: str = ""):
        self.off = offsets
        self.prefix = prefix
        self.lines: List[str] = []
        self.n = 0
        self.children: Dict[str, Tuple[str, str]] = {}  # smin out -> (a, b)

    def _tmp(self) -> str:
        self.n += 1
        return f"{self.prefix}v{self.n}"

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
            self.children[out] = (va, vb)
            self.lines.append(
                f"const float {out} = smooth_min({va}, {vb}, g[{off['smooth_k'] + k}]);"
            )
        else:
            raise ValueError(f"unknown node {node!r}")
        return out


class _AdjointEmitter(_NodeEmitter):
    """The forward statements of _NodeEmitter plus, per node, the reverse
    statements that take the cotangent `g_<out>` of its value to the point
    (gx, gy, gz) and, when `kParams`, to the geometry buffer's slots gP[].
    `rev` is a stack: a parent's reverse runs before its children's."""

    def __init__(self, offsets: Dict[str, int], prefix: str):
        super().__init__(offsets, prefix)
        self.rev: List[List[str]] = []

    def emit(self, node: Node) -> str:
        out = super().emit(node)
        kind, off, g = node[0], self.off, f"g_{out}"
        if kind == "sphere":
            c, r = off["sphere_point"] + 3 * node[1], off["sphere_radius"] + node[1]
            rev = [
                f"const float {out}s = {g} / sqrtf({out}x * {out}x + {out}y * {out}y"
                f" + {out}z * {out}z);",
                f"const float {out}gx = {out}s * {out}x, {out}gy = {out}s * {out}y, "
                f"{out}gz = {out}s * {out}z;",
                f"gx += {out}gx; gy += {out}gy; gz += {out}gz;",
                "if constexpr (kParams) {",
                f"  gP[{c}] -= {out}gx; gP[{c + 1}] -= {out}gy; gP[{c + 2}] -= {out}gz;",
                f"  gP[{r}] -= {g};",
                "}",
            ]
        elif kind == "box":
            c, h = off["box_point"] + 3 * node[1], off["box_half"] + 3 * node[1]
            r = off["box_radius"] + node[1]
            q = [f"{out}q{a}" for a in "xyz"]
            o = [f"{out}o{a}" for a in "xyz"]
            rev = [
                f"const float {out}len = sqrtf({o[0]} * {o[0]} + {o[1]} * {o[1]} + "
                f"{o[2]} * {o[2]});",
                f"float {out}gq[3] = {{0.f, 0.f, 0.f}};",
                f"if ({out}len > 0.f) {{",
                f"  {out}gq[0] = {g} * ({o[0]} / {out}len);",
                f"  {out}gq[1] = {g} * ({o[1]} / {out}len);",
                f"  {out}gq[2] = {g} * ({o[2]} / {out}len);",
                "}",
                f"box_inside_bwd({q[0]}, {q[1]}, {q[2]}, {g}, {out}gq);",
            ]
            for i, a in enumerate("xyz"):
                rev.append(
                    f"{{ const float s = sgnf(p{a} - g[{c + i}]) * {out}gq[{i}]; g{a} += s;"
                    f" if constexpr (kParams) {{ gP[{c + i}] -= s; gP[{h + i}] -= {out}gq[{i}]; }} }}"
                )
            rev.append(f"if constexpr (kParams) gP[{r}] -= {g};")
        elif kind == "plane":
            rev = [f"gy += {g};", f"if constexpr (kParams) gP[{off['plane_y'] + node[1]}] -= {g};"]
        else:  # smin
            va, vb = self.children[out]
            k = off["smooth_k"] + node[1]
            rev = [
                f"float g_{va}, g_{vb}, {out}gk;",
                f"smooth_min_bwd({va}, {vb}, g[{k}], {g}, g_{va}, g_{vb}, {out}gk);",
                f"if constexpr (kParams) gP[{k}] += {out}gk;",
            ]
        self.rev.append(rev)
        return out


def _adjoint_source(structure: SceneStructure) -> str:
    """`Scene::dist_bwd`: the distance at p and, for its cotangent gd, the
    point gradient (gx, gy, gz) and, when kParams, the geometry gradient
    added into gP[] (indexed like the packed buffer). The min over objects
    passes gd to the smaller operand (a tie splits it, as torch.minimum
    does); an object that gets no cotangent skips its reverse."""
    off = field_offsets(structure)
    fwd: List[str] = []
    rev: List[str] = []
    outs = []
    for i, node in enumerate(structure.objects):
        em = _AdjointEmitter(off, f"o{i}")
        outs.append(em.emit(node))
        fwd += em.lines
        body = [s for block in reversed(em.rev) for s in block]
        rev += [f"if (g_{outs[-1]} != 0.f) {{  // object {i + 1}: {node[0]}"]
        rev += [f"  {s}" for s in body]
        rev += ["}"]
    mins = [outs[0]] + [f"m{i}" for i in range(1, len(outs))]
    chain = [f"const float m{i} = jmin({mins[i - 1]}, {outs[i]});" for i in range(1, len(outs))]
    back = [f"float g_{mins[-1]} = gd;"]
    for i in range(len(outs) - 1, 0, -1):
        back.append(f"float g_{mins[i - 1]}, g_{outs[i]};")
        back.append(
            f"min_bwd({mins[i - 1]}, {outs[i]}, g_{mins[i]}, g_{mins[i - 1]}, g_{outs[i]});"
        )
    lines = [
        "  // reverse-mode adjoint of dist (generated object by object)",
        "  template <bool kParams>",
        "  __device__ __forceinline__ float dist_bwd(float px, float py, float pz, float gd,",
        "                                            float& gx, float& gy, float& gz,",
        "                                            float* __restrict__ gP) const {",
    ]
    lines += [f"    {s}" for s in fwd + chain]
    lines += ["    gx = 0.f; gy = 0.f; gz = 0.f;"]
    lines += [f"    {s}" for s in back + rev]
    lines += [f"    return {mins[-1]};", "  }"]
    return "\n".join(lines)


def _scene_source(structure: SceneStructure, residuals: bool) -> str:
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
        f"  static constexpr int kNumMaterials = {structure.num_materials};",
        f"  static constexpr int kNumFields = {packed_size(structure)};",
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
        "  // the shadow marches' distance: the same scene (no step clamp here)",
        "  __device__ __forceinline__ float shadow_dist(float px, float py, float pz) const {",
        "    return dist(px, py, pz);",
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
    lines += ["    return mat;", "  }"]
    if residuals:
        lines += ["", _adjoint_source(structure)]
    lines += ["};"]
    return "\n".join(lines)


def _layout_source(structure: SceneStructure) -> str:
    """The instanced Scene's layout: offsets of the small fields in the
    packed buffer and the run length of the sphere tables."""
    off = field_offsets(structure)

    def at(field):
        return off.get(field, 0)  # absent fields are never read

    consts = {
        "kNumLights": structure.num_lights,
        "kNumMaterials": structure.num_materials,
        "kNumFields": packed_size(structure),
        "kNumPlanes": structure.num_planes,
        "kGroup": GROUP,
        "kPlaneY": at("plane_y"),
        "kMatShininess": at("mat_shininess"),
        "kMatDiffuse": at("mat_diffuse"),
        "kMatSpecular": at("mat_specular"),
        "kMatAmbient": at("mat_ambient"),
        "kAmbientColor": at("ambient_color"),
        "kLightPoint": at("light_point"),
        "kLightDiffuse": at("light_diffuse"),
        "kLightSpecular": at("light_specular"),
    }
    lines = ["struct Layout {"]
    lines += [f"  static constexpr int {k} = {v};" for k, v in consts.items()]
    lines += ["};", "using Scene = InstancedScene<Layout, Cfg>;"]
    return "\n".join(lines)


ENTRY = "lol_render_fused"
INSTANCED_ENTRY = "lol_instanced_render"
INSTANCED_WALK = "lol_instanced_render_walk"
INSTANCED_STATS = "lol_instanced_render_stats"
INSTANCED_FWD = "lol_instanced_fwd"
INSTANCED_BWD = "lol_instanced_bwd"
INSTANCED_BWD_WALK = "lol_instanced_bwd_walk"
INSTANCED_BWD_STATS = "lol_instanced_bwd_stats"
INSTANCED_BLOCKS = "lol_instanced_bwd_blocks"
INSTANCED_HIST_ROWS = "lol_instanced_rec_hist_rows"
TRAIN_FWD = "lol_train_fwd"
TRAIN_BWD = "lol_train_bwd"
TRAIN_REDUCE = "lol_train_bwd_reduce"
TRAIN_BLOCKS = "lol_train_bwd_blocks"

_FWD_ENTRY = f"""\
extern "C" int {ENTRY}(const void* cam, const void* fields, void* img,
                                int height, int width, void* stream) {{
  return lol::launch_fused_fwd<lol_gen::Cfg, lol_gen::Scene>(
      static_cast<const float*>(cam), static_cast<const float*>(fields),
      static_cast<float*>(img), nullptr, height, width,
      static_cast<cudaStream_t>(stream));
}}"""

_TRAIN_ENTRIES = f"""\
extern "C" int {TRAIN_FWD}(const void* cam, const void* fields, void* img,
                             void* res, int height, int width, void* stream) {{
  return lol::launch_fused_fwd<lol_gen::Cfg, lol_gen::Scene>(
      static_cast<const float*>(cam), static_cast<const float*>(fields),
      static_cast<float*>(img), static_cast<float*>(res), height, width,
      static_cast<cudaStream_t>(stream));
}}

extern "C" int {TRAIN_BLOCKS}(int height, int width) {{
  return lol::bwd_num_blocks(height, width);
}}

extern "C" int {TRAIN_BWD}(const void* cam, const void* fields, const void* res,
                             const void* ct, void* partials, int height, int width,
                             void* stream) {{
  return lol::launch_fused_bwd<lol_gen::Cfg, lol_gen::Scene>(
      static_cast<const float*>(cam), static_cast<const float*>(fields),
      static_cast<const float*>(res), static_cast<const float*>(ct),
      static_cast<float*>(partials), height, width,
      static_cast<cudaStream_t>(stream));
}}

extern "C" int {TRAIN_REDUCE}(const void* partials, int num_blocks, void* grads,
                                    void* stream) {{
  return lol::launch_bwd_reduce<lol_gen::Scene>(
      static_cast<const float*>(partials), num_blocks, static_cast<float*>(grads),
      static_cast<cudaStream_t>(stream));
}}"""


_TABLES = """\
  const lol::InstancedTables tab{
      static_cast<const float4*>(spheres), static_cast<const int2*>(ids),
      static_cast<const float4*>(groups), static_cast<const float*>(bbox),
      num_spheres, num_groups};"""

# The cell grid's arguments of a grid entry, by value (csrc/grid_scene.cuh
# GridTables), and the aliases of the searches over it.
_GRID_PARAMS = """\
float gox, float goy, float goz, int gnx, int gny, int gnz, float inv_cell, float reach,
    float r_max, float tilt, float coord, const void* cell_start, const void* cell_rows,
    const void* cell_spheres, void* stats"""

GRID_ARGTYPES = ([ctypes.c_float] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 5
                 + [ctypes.c_void_p] * 4)

_GRID = """\
  const lol::GridTables grid{gox, goy, goz, gnx, gny, gnz, inv_cell, reach, r_max, tilt, coord,
                             static_cast<const int*>(cell_start),
                             static_cast<const int*>(cell_rows),
                             static_cast<const float4*>(cell_spheres),
                             static_cast<unsigned long long*>(stats)};"""

_GRID_ALIASES = """\
using SceneOnGrid = GridScene<Layout, Cfg>;
using SceneOnGridStats = GridScene<Layout, Cfg, true>;"""


def _instanced_render_entry(name: str, scene: str) -> str:
    """A K5 entry over the search `scene` (a lol_gen alias): the grid's
    arguments unless it is the run walk."""
    grid = scene != "Scene"
    return f"""\
extern "C" int {name}(const void* cam, const void* fields, const void* spheres,
                      const void* ids, const void* groups, const void* bbox, int num_spheres,
                      int num_groups, void* img, int height, int full_height, int width,
                      {_GRID_PARAMS + ", " if grid else ""}void* stream) {{
{_TABLES}
{_GRID if grid else ""}
  return lol::launch_instanced_fwd<lol_gen::Cfg, lol_gen::{scene}>(
      static_cast<const float*>(cam), static_cast<const float*>(fields), tab,
      static_cast<float*>(img), nullptr, height, full_height, width,
      static_cast<cudaStream_t>(stream){", grid" if grid else ""});
}}"""


_INSTANCED_ENTRY = "\n\n".join([
    _instanced_render_entry(INSTANCED_ENTRY, "SceneOnGrid"),
    _instanced_render_entry(INSTANCED_WALK, "Scene"),
    _instanced_render_entry(INSTANCED_STATS, "SceneOnGridStats"),
])

def _instanced_bwd_entry(name: str, scene: str) -> str:
    """A K6 entry over the search `scene` (a lol_gen alias), as
    _instanced_render_entry."""
    grid = scene != "Scene"
    return f"""\
extern "C" int {name}(const void* cam, const void* fields, const void* spheres,
                      const void* ids, const void* groups, const void* bbox, int num_spheres,
                      int num_groups, const void* res, const void* ct, void* partials,
                      void* grads, void* rec_rows, void* rec_vals, void* hist, void* start,
                      void* count, void* order, void* dsph, int height, int full_height,
                      int width, {_GRID_PARAMS + ", " if grid else ""}void* stream) {{
{_TABLES}
{_GRID if grid else ""}
  return lol::launch_instanced_bwd<lol_gen::Cfg, lol_gen::{scene}>(
      static_cast<const float*>(cam), static_cast<const float*>(fields), tab,
      static_cast<const float*>(res), static_cast<const float*>(ct),
      static_cast<float*>(partials), static_cast<float*>(grads),
      static_cast<int*>(rec_rows), static_cast<float4*>(rec_vals), static_cast<int*>(hist),
      static_cast<int*>(start), static_cast<int*>(count), static_cast<int*>(order),
      static_cast<float4*>(dsph), height, full_height, width,
      static_cast<cudaStream_t>(stream){", grid" if grid else ""});
}}"""


_INSTANCED_TRAIN_ENTRIES = "\n\n".join([f"""\
extern "C" int {INSTANCED_FWD}(const void* cam, const void* fields, const void* spheres,
                                 const void* ids, const void* groups, const void* bbox,
                                 int num_spheres, int num_groups, void* img, void* res,
                                 int height, int full_height, int width, {_GRID_PARAMS},
                                 void* stream) {{
{_TABLES}
{_GRID}
  return lol::launch_instanced_fwd<lol_gen::Cfg, lol_gen::SceneOnGrid>(
      static_cast<const float*>(cam), static_cast<const float*>(fields), tab,
      static_cast<float*>(img), static_cast<float*>(res), height, full_height, width,
      static_cast<cudaStream_t>(stream), grid);
}}

extern "C" int {INSTANCED_BLOCKS}(int height, int width) {{
  return lol::inst_bwd_num_blocks(height, width);
}}

extern "C" int {INSTANCED_HIST_ROWS}(long long records) {{
  return lol::rec_hist_rows(records);
}}""",
    _instanced_bwd_entry(INSTANCED_BWD, "SceneOnGrid"),
    _instanced_bwd_entry(INSTANCED_BWD_WALK, "Scene"),
    _instanced_bwd_entry(INSTANCED_BWD_STATS, "SceneOnGridStats"),
])


def generate_instanced_source(
    structure: SceneStructure, cfg: RenderConfig, residuals: bool = False
) -> str:
    """The CUDA translation unit of `lol_instanced_render` (and its check
    entries, the run walk and the counting grid) for this instanced
    structure and config: csrc/fused_fwd.cuh, then csrc/instanced_scene.cuh
    and csrc/grid_scene.cuh, then the Cfg (both clamps) and the layout.
    With `residuals`, the training pair instead: `lol_instanced_fwd` and
    `lol_instanced_bwd` (csrc/fused_bwd.cuh and csrc/instanced_bwd.cuh
    join the bodies), both over the cell grid, and the backward's check
    entries `lol_instanced_bwd_walk` and `lol_instanced_bwd_stats`. Deterministic; holds
    no scene numbers, no sphere count and no material ids. The device
    functions also compile as host C++."""
    require_instanced(structure)
    if not structure.num_spheres:
        raise ValueError("an instanced scene needs at least one sphere")
    bodies = (["fused_fwd.cuh", "fused_bwd.cuh", "instanced_scene.cuh", "grid_scene.cuh",
               "instanced_bwd.cuh"]
              if residuals else ["fused_fwd.cuh", "instanced_scene.cuh", "grid_scene.cuh"])
    return "\n".join(
        [
            "// Generated by loltracer_tpu_torch.render.cuda_scene: the kernel",
            "// bodies of csrc/, then this instanced structure's Cfg and layout.",
            *[(CSRC / b).read_text() for b in bodies],
            "namespace lol_gen {",
            "using namespace lol;",
            _cfg_source(cfg, residuals=residuals, instanced=True),
            "",
            _layout_source(structure),
            _GRID_ALIASES,
            "}  // namespace lol_gen",
            "",
            "#ifdef __CUDACC__",
            _INSTANCED_TRAIN_ENTRIES if residuals else _INSTANCED_ENTRY,
            "#endif  // __CUDACC__",
            "",
        ]
    )


MARCH = "lol_march"
SHADOW_MARCH = "lol_shadow_march"
MARCH_INSTANCED = "lol_march_instanced"
SHADOW_MARCH_INSTANCED = "lol_shadow_march_instanced"

_MARCH_ARGS = """\
  const lol::MarchArgs a{static_cast<const float*>(ro), ro_stride,
                         static_cast<const float*>(rd), static_cast<const float*>(max_dist),
                         static_cast<float*>(out)};"""

_MARCH_ENTRIES = f"""\
extern "C" int {MARCH}(const void* ro, int ro_stride, const void* rd, const void* fields,
                          void* out, int rows, int width, void* stream) {{
  const void* max_dist = nullptr;
{_MARCH_ARGS}
  return lol::launch_march<false, lol_gen::Cfg, lol_gen::Scene>(
      static_cast<const float*>(fields), a, rows, width, static_cast<cudaStream_t>(stream));
}}

extern "C" int {SHADOW_MARCH}(const void* ro, int ro_stride, const void* rd,
                                 const void* max_dist, const void* fields, void* out, int rows,
                                 int width, void* stream) {{
{_MARCH_ARGS}
  return lol::launch_march<true, lol_gen::Cfg, lol_gen::Scene>(
      static_cast<const float*>(fields), a, rows, width, static_cast<cudaStream_t>(stream));
}}"""

# The lane-group widths the instanced march entries are compiled for: 1 is
# csrc/march.cuh's one thread a ray over InstancedScene, the others
# csrc/coop_march.cuh's group per ray. march_kernels.lanes_for picks one per
# launch among them; another width is refused (cudaErrorInvalidValue).
MARCH_LANES = (1, 32)


def _lanes_switch(shadow: bool) -> str:
    """The instanced entry's dispatch on its `lanes` argument."""
    k = "true" if shadow else "false"
    cases = [f"""\
    case 1:
      return lol::launch_march_instanced<{k}, lol_gen::Cfg, lol_gen::Scene>(
          static_cast<const float*>(fields), tab, a, rows, width,
          static_cast<cudaStream_t>(stream));"""]
    cases += [f"""\
    case {w}:
      return lol::launch_march_coop<{k}, lol_gen::Cfg, lol_gen::CoopScene<{w}>>(
          static_cast<const float*>(fields), tab, a, (long long)rows * width,
          static_cast<cudaStream_t>(stream));""" for w in MARCH_LANES if w != 1]
    return "\n".join(["  switch (lanes) {", *cases, "    default:",
                      "      return (int)cudaErrorInvalidValue;", "  }"])


_MARCH_INSTANCED_ENTRIES = f"""\
namespace lol_gen {{
template <int K>
using CoopScene = lol::CoopInstancedScene<Layout, Cfg, lol::WarpGroup<K>>;
}}  // namespace lol_gen

extern "C" int {MARCH_INSTANCED}(const void* ro, int ro_stride, const void* rd,
                                    const void* fields, const void* spheres, const void* ids,
                                    const void* groups, const void* bbox, int num_spheres,
                                    int num_groups, void* out, int rows, int width, int lanes,
                                    void* stream) {{
  const void* max_dist = nullptr;
{_MARCH_ARGS}
{_TABLES}
{_lanes_switch(False)}
}}

extern "C" int {SHADOW_MARCH_INSTANCED}(const void* ro, int ro_stride, const void* rd,
                                           const void* max_dist, const void* fields,
                                           const void* spheres, const void* ids,
                                           const void* groups, const void* bbox,
                                           int num_spheres, int num_groups, void* out,
                                           int rows, int width, int lanes, void* stream) {{
{_MARCH_ARGS}
{_TABLES}
{_lanes_switch(True)}
}}"""


def generate_march_source(structure: SceneStructure, cfg: RenderConfig) -> str:
    """The CUDA translation unit of the value march kernels K3 and K4 for
    this structure and config: csrc/fused_fwd.cuh (whose `march_ray` and
    `shadow_ray` they run), csrc/instanced_scene.cuh, csrc/march.cuh, then
    the Cfg and the compiled `Scene` (entries `lol_march`,
    `lol_shadow_march`) or, for an instanced structure, the layout of the
    `InstancedScene` (`lol_march_instanced`, `lol_shadow_march_instanced`;
    one text for every sphere count), whose entries take a lane-group
    width of MARCH_LANES (csrc/coop_march.cuh). Deterministic; holds no
    scene numbers. The device functions also compile as host C++."""
    if structure.instanced:
        require_instanced(structure)
        if not structure.num_spheres:
            raise ValueError("an instanced scene needs at least one sphere")
        scene, entries = _layout_source(structure), _MARCH_INSTANCED_ENTRIES
    else:
        scene, entries = _scene_source(structure, residuals=False), _MARCH_ENTRIES
    bodies = ["fused_fwd.cuh", "instanced_scene.cuh", "march.cuh", "coop_march.cuh"]
    return "\n".join(
        [
            "// Generated by loltracer_tpu_torch.render.cuda_scene: the kernel",
            "// bodies of csrc/, then this structure's Cfg and Scene.",
            *[(CSRC / b).read_text() for b in bodies],
            "namespace lol_gen {",
            "using namespace lol;",
            _cfg_source(cfg, residuals=False, instanced=structure.instanced),
            "",
            scene,
            "}  // namespace lol_gen",
            "",
            "#ifdef __CUDACC__",
            entries,
            "#endif  // __CUDACC__",
            "",
        ]
    )


INSTANCED_EVAL = "lol_instanced_eval"
INSTANCED_EVAL_WALK = "lol_instanced_eval_walk"
INSTANCED_EVAL_STATS = "lol_instanced_eval_stats"


def _eval_entry(name: str, scene: str) -> str:
    """A K7 entry over the search `scene` (a lol_gen alias), as
    _instanced_render_entry."""
    grid = scene != "Scene"
    return f"""\
extern "C" int {name}(const void* plane_y, const void* spheres, const void* groups,
                      const void* bbox, int num_spheres, int num_groups, const void* p,
                      void* out, long long n, {_GRID_PARAMS + ", " if grid else ""}void* stream) {{
  const void* ids = nullptr;
{_TABLES}
{_GRID if grid else ""}
  return lol::launch_instanced_eval<lol_gen::{scene}>(
      static_cast<const float*>(plane_y), tab, static_cast<const float*>(p),
      static_cast<float*>(out), n, static_cast<cudaStream_t>(stream){", grid" if grid else ""});
}}"""


_EVAL_ENTRY = "\n\n".join([
    _eval_entry(INSTANCED_EVAL, "SceneOnGrid"),
    _eval_entry(INSTANCED_EVAL_WALK, "Scene"),
    _eval_entry(INSTANCED_EVAL_STATS, "SceneOnGridStats"),
])


def _eval_layout_source(structure: SceneStructure) -> str:
    """K7's layout: the InstancedScene's constants, with the planes'
    heights at offset 0 of the buffer the kernel is given (plane_y itself)
    and no other field: the distance reads nothing else."""
    consts = {
        "kNumLights": 0,
        "kNumMaterials": 0,
        "kNumFields": structure.num_planes,
        "kNumPlanes": structure.num_planes,
        "kGroup": GROUP,
        "kPlaneY": 0,
        **{k: 0 for k in ("kMatShininess", "kMatDiffuse", "kMatSpecular", "kMatAmbient",
                          "kAmbientColor", "kLightPoint", "kLightDiffuse", "kLightSpecular")},
    }
    lines = ["struct Layout {"]
    lines += [f"  static constexpr int {k} = {v};" for k, v in consts.items()]
    lines += ["};", "using Scene = InstancedScene<Layout, Cfg>;"]
    return "\n".join(lines)


def generate_eval_source(structure: SceneStructure, cfg: RenderConfig) -> str:
    """The CUDA translation unit of K7 (`lol_instanced_eval`) for this
    instanced structure and cfg.step_clamp: csrc/fused_fwd.cuh,
    csrc/instanced_scene.cuh, csrc/grid_scene.cuh and csrc/march.cuh, then
    the Cfg and the eval layout (entries over the cell grid, the run walk
    and the counting grid). One text for every structure with as many planes, whatever its
    spheres, lights, materials and shadow clamp; deterministic; holds no scene numbers. The device functions
    also compile as host C++."""
    require_instanced(structure)
    cfg = RenderConfig(step_clamp=cfg.step_clamp)
    bodies = ["fused_fwd.cuh", "instanced_scene.cuh", "grid_scene.cuh", "march.cuh"]
    return "\n".join(
        [
            "// Generated by loltracer_tpu_torch.render.cuda_scene: the kernel",
            "// bodies of csrc/, then this instanced structure's Cfg and eval layout.",
            *[(CSRC / b).read_text() for b in bodies],
            "namespace lol_gen {",
            "using namespace lol;",
            _cfg_source(cfg, residuals=False, instanced=True),
            "",
            _eval_layout_source(structure),
            _GRID_ALIASES,
            "}  // namespace lol_gen",
            "",
            "#ifdef __CUDACC__",
            _EVAL_ENTRY,
            "#endif  // __CUDACC__",
            "",
        ]
    )


RG_MARCH = "lol_rg_march"
RG_MARCH_WALK = "lol_rg_march_walk"
RG_SHADOW = "lol_rg_shadow"
RG_SHADOW_WALK = "lol_rg_shadow_walk"
RG_SHADOW_STATS = "lol_rg_shadow_stats"
RG_SHADOW_GRID_STATS = "lol_rg_shadow_grid_stats"
RG_SHADE = "lol_rg_shade"
RG_SHADE_WALK = "lol_rg_shade_walk"
RG_SHADE_STATS = "lol_rg_shade_stats"

def _rg_march_entry(name: str, scene: str) -> str:
    """A lol_rg_march entry over the search `scene` (a lol_gen alias), as
    _instanced_render_entry."""
    grid = scene != "Scene"
    return f"""\
extern "C" int {name}(const void* cam, const void* fields, const void* spheres,
                      const void* ids, const void* groups, const void* bbox, int num_spheres,
                      int num_groups, void* track, void* hitp, void* rec, int height,
                      int full_height, int width, {_GRID_PARAMS + ", " if grid else ""}void* stream) {{
{_TABLES}
{_GRID if grid else ""}
  return lol::launch_rg_march<lol_gen::Cfg, lol_gen::{scene}>(
      static_cast<const float*>(cam), static_cast<const float*>(fields), tab,
      static_cast<float*>(track), static_cast<float*>(hitp), static_cast<float*>(rec),
      height, full_height, width, static_cast<cudaStream_t>(stream){", grid" if grid else ""});
}}"""


def _rg_shadow_entry(name: str, scene: str, view: str, stats: bool) -> str:
    """A lol_rg_shadow entry over the search `scene` through `view`
    (csrc/regroup.cuh RgShadowView), with the per-thread count planes
    (`counts`) when `stats`."""
    grid = scene != "Scene"
    return f"""\
extern "C" int {name}(const void* fields, const void* spheres, const void* ids,
                      const void* groups, const void* bbox, int num_spheres, int num_groups,
                      const void* rec, const void* perm, void* out,
                      {"void* counts, " if stats else ""}long long n,
                      {_GRID_PARAMS + ", " if grid else ""}void* stream) {{
{_TABLES}
{_GRID if grid else ""}
  return lol::launch_rg_shadow<lol_gen::Cfg, lol_gen::{scene}, lol::{view}>(
      static_cast<const float*>(fields), tab, static_cast<const float*>(rec),
      static_cast<const long long*>(perm), static_cast<float*>(out),
      {"static_cast<float*>(counts)" if stats else "nullptr"}, n,
      static_cast<cudaStream_t>(stream){", grid" if grid else ""});
}}"""


def _rg_shade_entry(name: str, scene: str) -> str:
    """A lol_rg_shade entry over the search `scene` (a lol_gen alias), as
    _instanced_render_entry."""
    grid = scene != "Scene"
    return f"""\
extern "C" int {name}(const void* cam, const void* fields, const void* spheres,
                      const void* ids, const void* groups, const void* bbox, int num_spheres,
                      int num_groups, const void* track, const void* shadow, void* img,
                      int height, int full_height, int width,
                      {_GRID_PARAMS + ", " if grid else ""}void* stream) {{
{_TABLES}
{_GRID if grid else ""}
  return lol::launch_rg_shade<lol_gen::Cfg, lol_gen::{scene}>(
      static_cast<const float*>(cam), static_cast<const float*>(fields), tab,
      static_cast<const float*>(track), static_cast<const float*>(shadow),
      static_cast<float*>(img), height, full_height, width,
      static_cast<cudaStream_t>(stream){", grid" if grid else ""});
}}"""

_RG_ENTRIES = "\n\n".join([
    _rg_march_entry(RG_MARCH, "SceneOnGrid"),
    _rg_march_entry(RG_MARCH_WALK, "Scene"),
    _rg_shadow_entry(RG_SHADOW, "SceneOnGrid", "kRgDirect", False),
    _rg_shadow_entry(RG_SHADOW_WALK, "Scene", "kRgDirect", False),
    _rg_shadow_entry(RG_SHADOW_STATS, "Scene", "kRgWalkCounts", True),
    _rg_shadow_entry(RG_SHADOW_GRID_STATS, "SceneOnGridStats", "kRgGridCounts", True),
    _rg_shade_entry(RG_SHADE, "SceneOnGrid"),
    _rg_shade_entry(RG_SHADE_WALK, "Scene"),
    _rg_shade_entry(RG_SHADE_STATS, "SceneOnGridStats"),
])


def generate_regroup_source(structure: SceneStructure, cfg: RenderConfig) -> str:
    """The CUDA translation unit of the regrouped instanced forward K9 for
    this instanced structure and config: csrc/fused_fwd.cuh (whose march
    and shade halves they run), csrc/instanced_scene.cuh,
    csrc/grid_scene.cuh, csrc/regroup.cuh, then the Cfg (both clamps) and
    the layout. Its entries: `lol_rg_march`, `lol_rg_shadow` and
    `lol_rg_shade` over the cell grid, their run-walk twins (`_walk`), the
    counting launches of the walk (`lol_rg_shadow_stats`) and of the grid
    (`lol_rg_shadow_grid_stats`, `lol_rg_shade_stats`). One text
    for every sphere count; deterministic; holds no scene numbers. The
    device functions also compile as host C++."""
    require_instanced(structure)
    if not structure.num_spheres:
        raise ValueError("an instanced scene needs at least one sphere")
    bodies = ["fused_fwd.cuh", "instanced_scene.cuh", "grid_scene.cuh", "regroup.cuh"]
    return "\n".join(
        [
            "// Generated by loltracer_tpu_torch.render.cuda_scene: the kernel",
            "// bodies of csrc/, then this instanced structure's Cfg and layout.",
            *[(CSRC / b).read_text() for b in bodies],
            "namespace lol_gen {",
            "using namespace lol;",
            _cfg_source(cfg, residuals=False, instanced=True),
            "",
            _layout_source(structure),
            _GRID_ALIASES,
            "}  // namespace lol_gen",
            "",
            "#ifdef __CUDACC__",
            _RG_ENTRIES,
            "#endif  // __CUDACC__",
            "",
        ]
    )


def generate_source(
    structure: SceneStructure, cfg: RenderConfig, residuals: bool = False
) -> str:
    """The complete CUDA translation unit for this structure and config:
    the fused forward (`lol_render_fused`), or with `residuals` the
    training pair (`lol_train_fwd`, `lol_train_bwd` and its reduce).
    Deterministic; holds no scene numbers. The device functions also
    compile as host C++ (the kernels and entry points sit under
    `__CUDACC__`), which the CPU tests use to check the generated SDF
    adjoint."""
    bodies = [(CSRC / "fused_fwd.cuh").read_text()]
    if residuals:
        bodies.append((CSRC / "fused_bwd.cuh").read_text())
    return "\n".join(
        [
            "// Generated by loltracer_tpu_torch.render.cuda_scene: the kernel",
            "// bodies of csrc/, then this structure's Cfg and Scene.",
            *bodies,
            "namespace lol_gen {",
            "using namespace lol;",
            _cfg_source(cfg, residuals),
            "",
            _scene_source(structure, residuals),
            "}  // namespace lol_gen",
            "",
            "#ifdef __CUDACC__",
            _TRAIN_ENTRIES if residuals else _FWD_ENTRY,
            "#endif  // __CUDACC__",
            "",
        ]
    )
