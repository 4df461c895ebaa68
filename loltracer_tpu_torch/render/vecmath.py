"""Small vector helpers over a trailing axis of 3 (`loltracer_tpu/render/vecmath.py`).

Sums are written out component by component, ((x + y) + z), so that the
CUDA kernel, which computes the same expressions on scalars, rounds exactly
as this code does.
"""

from __future__ import annotations

import torch

# Guard for normalizing near-zero vectors: the squared norm is clamped, so
# exact zeros normalize to the zero vector (as in the JAX package).
_EPS2 = 1e-30


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v):
    """v / sqrt(max(|v|^2, 1e-30)): a divide by the square root, never a
    multiply by rsqrt, so rays are bitwise those of the JAX package."""
    n2 = dot(v, v)[..., None]
    return v / torch.sqrt(torch.clamp_min(n2, _EPS2))


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def maximum(x, lo: float):
    """max(x, lo) with the gradient of torch.maximum / jnp.maximum: a tie
    passes half the cotangent (torch.clamp_min would pass all of it)."""
    return torch.maximum(x, torch.full_like(x, lo))


def minimum(x, hi: float):
    """min(x, hi), a tie passing half the cotangent (see maximum)."""
    return torch.minimum(x, torch.full_like(x, hi))


def clip(x, lo: float, hi: float):
    """min(max(x, lo), hi): the JAX package's jnp.clip, values and gradient.
    At a bound the gradient is half the cotangent, where torch.clamp passes
    all of it; it matters where a clip sits on its bound for every pixel
    (the AA background of a black material 0)."""
    return minimum(maximum(x, lo), hi)


def true_div(x, n):
    """x / n for a Python number n, correctly rounded on every device. On
    CUDA, torch divides by a Python scalar as a multiply by its reciprocal,
    which rounds differently from the kernel's (and the CPU's) division."""
    return x / torch.full_like(x, n)
