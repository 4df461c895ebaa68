"""Backend resolution (`loltracer_tpu/render/backend.py`).

The port has no "auto" that guesses from the environment: the backend is
the device of the tensors a call is given. CUDA tensors go to the CUDA
kernels; CPU tensors go to the plain PyTorch versions.

`resolve_march_backend` reads `cfg.march_backend` for the differentiable
renderer's frozen marches, with the JAX package's values: "pallas" names
the hand-written march kernels K3 / K4 (csrc/march.cuh), "jnp" the plain
loops (render/march.py `march`, render/shading.py `shadow_march`).
"""

from __future__ import annotations

import torch

MARCH_BACKENDS = ("auto", "jnp", "pallas", "pallas-interpret")


def resolve_backend(*tensors: torch.Tensor) -> str:
    """"cuda" when every tensor is on a CUDA device, "torch" when every
    tensor is on the CPU; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"cpu"}:
        return "torch"
    raise ValueError(
        f"tensors must all be on CUDA or all on the CPU, got {sorted(kinds)}"
    )


def resolve_device(device, who: str) -> torch.device:
    """`device` as a torch.device; raises for CUDA without CUDA: nothing
    falls back to the CPU. `who` names the caller in the message."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: device 'cuda' requested but torch.cuda.is_available() is false"
        )
    return device


def resolve_march_backend(backend: str, *tensors: torch.Tensor) -> str:
    """"pallas" (the march kernels) or "jnp" (the plain loops) for a march
    over `tensors`:

    - "auto": the kernels for CUDA tensors, the plain loops for CPU tensors;
    - "jnp": the plain loops on any device (the plain versions pin it);
    - "pallas": the kernels; raises for CPU tensors;
    - "pallas-interpret": raises, the port has no kernel interpreter.
    """
    if backend not in MARCH_BACKENDS:
        raise ValueError(f"unknown march_backend {backend!r}")
    if backend == "jnp":
        return "jnp"
    if backend == "pallas-interpret":
        raise ValueError(
            "march_backend='pallas-interpret' runs the Pallas kernels in the JAX "
            "package's interpreter; the port has none: use 'jnp' for the plain loops"
        )
    on_cuda = resolve_backend(*tensors) == "cuda"
    if backend == "pallas" and not on_cuda:
        raise ValueError("march_backend='pallas' needs CUDA tensors: the kernels run on the card")
    return "pallas" if on_cuda else "jnp"
