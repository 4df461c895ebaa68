"""Multi-process bootstrap over torch.distributed (`loltracer_tpu/parallel/distributed.py`).

The JAX package starts `jax.distributed` so that `jax.devices()` spans
every host. The port runs one process (rank) per device instead, and
`maybe_initialize()` starts the default process group from the same
environment variables, before `make_mesh()`:

- explicit coordinates, for manual and loopback launches:
    LOLTRACE_COORDINATOR=host:port   (the TCP rendezvous of rank 0)
    LOLTRACE_NUM_PROCESSES=N
    LOLTRACE_PROCESS_ID=I
    LOLTRACE_LOCAL_DEVICE_IDS=0      (optional: this rank's card; the
                                      first id is taken, one card a rank)
- LOLTRACE_DISTRIBUTED=1: the `env://` rendezvous of a launcher (torchrun's
  MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), the port's
  counterpart of JAX's cloud auto-detection.

Without either it does nothing and returns False. The backend follows the
devices: NCCL when CUDA is there and each rank on this host has a card of
its own (LOCAL_WORLD_SIZE, else the world size, at most the card count),
gloo otherwise: on the CPU, and for ranks that share one card, whose
collectives gloo carries through the host.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def _int_env(name: str, default: Optional[str] = None) -> int:
    value = os.environ.get(name, default)
    if value is None:
        raise ValueError(f"{name} is not set")
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not an integer") from None


def choose_backend(world_size: int) -> str:
    """"nccl" when CUDA is available and every rank on this host has a card
    of its own, else "gloo"."""
    if not torch.cuda.is_available() or not dist.is_nccl_available():
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def _select_card(device_id: Optional[int]) -> None:
    if device_id is not None and torch.cuda.is_available():
        torch.cuda.set_device(device_id)


def maybe_initialize() -> bool:
    """Start the default process group from the environment (module
    docstring); True when a multi-process group was started or already
    is. A second call is a no-op. Malformed variables raise ValueError."""
    coordinator = os.environ.get("LOLTRACE_COORDINATOR")
    auto = os.environ.get("LOLTRACE_DISTRIBUTED") == "1"
    if not (coordinator or auto):
        return False
    if dist.is_initialized():
        return True
    if coordinator:
        num = _int_env("LOLTRACE_NUM_PROCESSES")
        pid = _int_env("LOLTRACE_PROCESS_ID")
        if num < 1 or not 0 <= pid < num:
            raise ValueError(f"LOLTRACE_PROCESS_ID={pid} is not a rank of "
                             f"LOLTRACE_NUM_PROCESSES={num}")
        local = os.environ.get("LOLTRACE_LOCAL_DEVICE_IDS")
        try:
            ids = [int(x) for x in local.split(",")] if local else []
        except ValueError:
            raise ValueError(f"LOLTRACE_LOCAL_DEVICE_IDS={local!r} is not a list of "
                             "integers") from None
        _select_card(ids[0] if ids else None)
        dist.init_process_group(choose_backend(num), init_method=f"tcp://{coordinator}",
                                world_size=num, rank=pid)
        return True
    _select_card(_int_env("LOCAL_RANK") if "LOCAL_RANK" in os.environ else None)
    dist.init_process_group(choose_backend(_int_env("WORLD_SIZE", "1")), init_method="env://")
    return True


def process_info() -> dict:
    """This process in the world, with the JAX package's keys: its rank,
    the number of ranks, the devices it drives (one) and the devices of
    the world (one a rank). Without a process group, a world of one."""
    initialized = dist.is_available() and dist.is_initialized()
    count = dist.get_world_size() if initialized else 1
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }
