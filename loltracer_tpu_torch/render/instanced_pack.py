"""Host packing of the instanced sphere set for the CUDA kernel
(`loltracer_tpu/render/pallas_scene.py:308-460`, in torch).

The spheres are sorted along a 30-bit Morton (Z-order) curve, so that runs
of GROUP consecutive spheres are compact in space, and each run gets a
bounding ball. The kernel (csrc/instanced_scene.cuh) visits only the runs
whose ball can hold a sphere nearer than its running bound, and evaluates
their spheres exactly; the min over spheres does not depend on the order,
so the sort changes no value. Each sorted row carries its sphere's original
SoA index, so that ties still go to the smaller index, and its material.

`pack_instanced(structure, params)` builds every table on the params'
device in plain torch; the plain SDF (render/sdf.py) takes its AABB from
`sphere_bbox`, the same function, so both versions cut at the same box.
The sphere table is a gather of the SoA through the Morton order, so
autograd takes its gradient (lol_instanced_bwd's, per sorted row) back to
`sphere_point` / `sphere_radius` in SoA order, as JAX's `render_bwd` does
(`pallas_train.py:1612-1623`); the run bounds and the AABB are search
structures, built from detached values.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from loltracer_tpu_torch.scene import SceneParams, SceneStructure

# Spheres per bounding ball: 157 balls at 10 000 spheres, whose table
# (32 B each) the kernel keeps in shared memory.
GROUP = 64

# Slack added to every ball's radii, so that the bounds stay true bounds
# under float32 rounding of |p - ctr| at scene coordinates ~1e2
# (pallas_scene.BOUND_MARGIN).
BOUND_MARGIN = 0.0625


class InstancedTables(NamedTuple):
    """The kernel's view of the sphere set, all contiguous, on one device.

    spheres [Ns, 4] f32  x y z r, Morton-sorted
    ids     [Ns + Np, 2] i32  original SoA index and material id per
                         sorted row, then (object id - 1, material) per plane
    groups  [Ng, 8] f32  cx cy cz R S 0 0 0 per run of GROUP sorted rows:
                         |p - ctr| - R <= every member's distance and
                         |p - ctr| + S >= the least member distance
    bbox    [6] f32      the sphere set's AABB (lo, hi), surfaces included
    """

    spheres: torch.Tensor
    ids: torch.Tensor
    groups: torch.Tensor
    bbox: torch.Tensor


def morton_codes(pos: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of [N, 3] positions, normalised by ONE
    scale for all three axes (`pallas_scene._morton_codes`): per-axis
    scaling would stretch the thin axis of a slab-shaped field and spoil
    the locality of consecutive codes."""
    lo = pos.amin(dim=0)
    hi = pos.amax(dim=0)
    scale = torch.clamp_min((hi - lo).amax(), 1e-9)
    q = (pos - lo) / scale * 1023.0
    q = torch.clamp(q, 0.0, 1023.0).to(torch.int64)

    def part1by2(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return part1by2(q[:, 0]) | (part1by2(q[:, 1]) << 1) | (part1by2(q[:, 2]) << 2)


def pack_order(pos: torch.Tensor) -> torch.Tensor:
    """The Morton permutation: sorted row i holds sphere order[i]. A
    stable sort, as `jnp.argsort`, so equal codes keep SoA order."""
    return torch.argsort(morton_codes(pos.to(torch.float32)), stable=True)


def group_bounds(pos: torch.Tensor, rad: torch.Tensor, group: int = GROUP,
                 margin: float = BOUND_MARGIN) -> torch.Tensor:
    """[ceil(N / group), 8] rows cx cy cz R S 0 0 0 over consecutive runs
    of `group` spheres of (sorted) pos [N, 3], rad [N]: ctr the members'
    mean, R = max(|c - ctr| + r) + margin, S = min(|c - ctr| - r) + margin
    (`pallas_scene._group_bounds`); the last run may be short."""
    n = pos.shape[0]
    ng = -(-n // group)
    pad = ng * group - n
    real = torch.arange(ng * group, device=pos.device).reshape(ng, group) < n
    posg = torch.cat([pos, pos.new_zeros((pad, 3))]).reshape(ng, group, 3)
    radg = torch.cat([rad, rad.new_zeros((pad,))]).reshape(ng, group)
    cnt = real.sum(dim=1, keepdim=True).to(pos.dtype)
    ctr = torch.where(real[..., None], posg, 0.0).sum(dim=1) / cnt
    off = torch.sqrt(((posg - ctr[:, None, :]) ** 2).sum(dim=-1))
    inf = float("inf")
    bound_r = torch.where(real, off + radg, -inf).amax(dim=1) + margin
    bound_s = torch.where(real, off - radg, inf).amin(dim=1) + margin
    table = pos.new_zeros((ng, 8))
    table[:, 0:3] = ctr
    table[:, 3] = bound_r
    table[:, 4] = bound_s
    return table


def sphere_bbox(pos: torch.Tensor, rad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo [3], hi [3]): the AABB of the spheres' surfaces."""
    return (pos - rad[:, None]).amin(dim=0), (pos + rad[:, None]).amax(dim=0)


def real_sphere_bbox(pos: torch.Tensor, rad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`sphere_bbox` over the real spheres only: those of radius > -1e29,
    leaving out the sentinel spheres (radius -1e30) that pad a sphere set
    for sharding (parallel/objects.py). lo is +inf and hi -inf where there
    is no real sphere; on a set without sentinels it is `sphere_bbox`."""
    real = (rad > -1e29)[:, None]
    inf = float("inf")
    return (torch.where(real, pos - rad[:, None], inf).amin(dim=0),
            torch.where(real, pos + rad[:, None], -inf).amax(dim=0))


def pack_instanced(structure: SceneStructure, params: SceneParams) -> InstancedTables:
    """The kernel's tables for this structure's sphere set, in f32 on the
    params' device."""
    ns = structure.num_spheres
    pos = params.sphere_point.to(torch.float32)
    rad = params.sphere_radius.to(torch.float32)
    if tuple(pos.shape) != (ns, 3) or tuple(rad.shape) != (ns,):
        raise ValueError(
            f"sphere_point {tuple(pos.shape)} / sphere_radius {tuple(rad.shape)} "
            f"do not hold {ns} spheres"
        )
    if ns == 0:
        raise ValueError("an instanced scene needs at least one sphere")
    order = pack_order(pos.detach())
    pos, rad = pos[order], rad[order]
    mats = torch.tensor(structure.material_ids[1:], dtype=torch.int32, device=pos.device)
    planes = torch.arange(ns, ns + structure.num_planes, dtype=torch.int32, device=pos.device)
    ids = torch.cat([
        torch.stack([order.to(torch.int32), mats[order]], dim=1),
        torch.stack([planes, mats[ns:]], dim=1),
    ])
    lo, hi = sphere_bbox(pos.detach(), rad.detach())
    return InstancedTables(
        spheres=torch.cat([pos, rad[:, None]], dim=1).contiguous(),
        ids=ids.contiguous(),
        groups=group_bounds(pos.detach(), rad.detach()).contiguous(),
        bbox=torch.cat([lo, hi]).contiguous(),
    )


def soa_spheres(structure: SceneStructure, tables: InstancedTables):
    """(sphere_point [Ns, 3], sphere_radius [Ns]) in SoA order, read back
    out of the tables by a gather through the inverse of the Morton order
    (differentiable in tables.spheres)."""
    order = tables.ids[: structure.num_spheres, 0].long()
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    soa = tables.spheres[inverse]
    return soa[:, :3], soa[:, 3]
