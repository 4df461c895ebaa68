"""Device meshes over torch.distributed (`loltracer_tpu/parallel/mesh.py`).

The JAX package lays a `jax.sharding.Mesh` over the devices of one
program. The port runs one rank per device, so a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over ranks: rank r drives the
device of mesh position r, and each mesh dimension carries a process
group for its collectives (`mesh.get_group(name)`), the counterpart of a
named mesh axis.

Every rank calls these functions, in the same order: a DeviceMesh builds
its groups collectively. They need the default process group; when there
is none, `maybe_initialize()` starts it from the environment
(parallel/distributed.py), and without those variables a process alone
gets a world of one rank, made in-process (`torch.distributed.HashStore`,
no address, no port), with NCCL on a card and gloo on the CPU. So a single
process on the card gets a one-rank mesh without setting anything.
"""

from __future__ import annotations

import socket
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from loltracer_tpu_torch.parallel.distributed import choose_backend, maybe_initialize
from loltracer_tpu_torch.render.backend import resolve_device

AXIS = "devices"
HOSTS_AXIS = "hosts"
CHIPS_AXIS = "chips"


def ensure_world(device="cuda") -> None:
    """The default process group: from the environment
    (`maybe_initialize`), else a world of this one process."""
    device = resolve_device(device, "make_mesh")
    if dist.is_initialized() or maybe_initialize():
        return
    backend = choose_backend(1) if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _device_type(device) -> str:
    return torch.device(device).type


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> DeviceMesh:
    """A 1-D mesh named AXIS over the first `n_devices` ranks (default: the
    whole world). Asking for more ranks than the world has raises, as the
    JAX package's does for devices; nothing falls back to the CPU. Ranks
    past n_devices get a mesh they are not in."""
    ensure_world(device)
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"need {n} devices, have {world} (one rank per device)")
    return DeviceMesh(_device_type(device), torch.arange(n), mesh_dim_names=(AXIS,))


def make_mesh_2d(device="cuda") -> DeviceMesh:
    """A 2-D (HOSTS_AXIS, CHIPS_AXIS) mesh: hosts outer, each host's ranks
    inner, so that rows sharded over both axes, hosts major, give each host
    a contiguous block and a gradient all-reduce combines within a host
    first. Ranks are grouped by host name; an uneven count of ranks per
    host raises."""
    ensure_world(device)
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    by_host: dict = {}
    for rank, host in enumerate(names):
        by_host.setdefault(host, []).append(rank)
    counts = {len(v) for v in by_host.values()}
    if len(counts) != 1:
        raise ValueError(f"uneven ranks per host: { {k: len(v) for k, v in by_host.items()} }")
    rows = [by_host[h] for h in sorted(by_host, key=lambda h: by_host[h][0])]
    return DeviceMesh(_device_type(device), torch.tensor(rows),
                      mesh_dim_names=(HOSTS_AXIS, CHIPS_AXIS))
