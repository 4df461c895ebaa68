"""Backend resolution (`loltracer_tpu/render/backend.py`).

The port has no "auto" that guesses from the environment: the backend is
the device of the tensors a call is given. CUDA tensors go to the CUDA
kernels; CPU tensors go to the plain PyTorch versions.
"""

from __future__ import annotations

import torch


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
