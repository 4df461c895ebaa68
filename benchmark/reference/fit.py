"""The reference of a fitting job's first steps: the reference renderer's
image of the whole frame, the mean squared error against the target, its
gradient by autograd, a hand-written Adam update (betas 0.9 / 0.999, eps
1e-8) and the projection into the valid domain, step after step.

It returns what the comparison reads: each step's loss, each leaf's
gradient norm at the first step, and each leaf's change after the last.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.render import Settings, render_rays, pixel_rays, camera_basis, \
    scene_sdf

BETAS = (0.9, 0.999)
EPS = 1e-8

# lower bounds of the projection after each update
PROJECT = {
    "sphere_radius": 1e-3, "box_radius": 0.0, "box_half": 1e-3, "smooth_k": 1e-3,
    "mat_diffuse": 0.0, "mat_specular": 0.0, "mat_ambient": 0.0, "ambient_color": 0.0,
}


def frame_loss_and_grads(structure: dict, P: Dict, leaves: Sequence[str], target, s: Settings,
                         band_rows: int, rows: Optional[Sequence[int]] = None):
    """(loss, {leaf: grad}) of mean((image - target)^2) over the whole
    frame, rendered and differentiated in bands of `band_rows` rows. With
    `rows`, only those image rows count, and the mean is over them (a
    planted fault of the comparison's tests)."""
    height, width = target.shape[0], target.shape[1]
    for f in leaves:
        P[f].grad = None
    sdf_id = scene_sdf(structure, s)
    all_rows = torch.arange(height, device=target.device) if rows is None else \
        torch.as_tensor(list(rows), device=target.device)
    total = 0.0
    n = all_rows.numel() * width * 3
    xs_row = torch.arange(width, device=target.device)
    pr = camera_basis(P, height, width, s)[6].detach() if s.antialias else None
    for b in range(0, all_rows.numel(), band_rows):
        ys = all_rows[b:b + band_rows]
        yy = ys[:, None].expand(-1, width).reshape(-1)
        xx = xs_row[None, :].expand(ys.numel(), -1).reshape(-1)
        rd = pixel_rays({k: v.detach() for k, v in P.items()}, yy, xx, height, width, s)
        img = render_rays(structure, P, P["cam_point"].detach(), rd, s, pr, sdf_id)
        err = ((img - target[ys].reshape(-1, 3).to(img.dtype)) ** 2).sum()
        (err / n).backward()
        total += float(err.detach().double())
    grads = {f: (P[f].grad if P[f].grad is not None else torch.zeros_like(P[f])).detach()
             for f in leaves}
    return total / n, grads


def follow(structure: dict, arrays: Dict[str, np.ndarray], leaves: Sequence[str], target,
           s: Settings, lr: float, steps: int, device, dtype=torch.float32, band_rows: int = 64,
           step_fn: Optional[Callable] = None) -> dict:
    """The first `steps` steps of the fit from `arrays` toward `target`
    ([H, W, 3]), in `dtype`. Returns {"losses": [...], "grad1": {leaf:
    norm}, "change": {leaf: norm}, "moves": {leaf: [each element's
    change]}}, norms and changes in float64 of the leaves' values.
    `step_fn(structure, P, leaves, target, s, band_rows)` replaces
    frame_loss_and_grads (the comparison's tests plant faults there)."""
    step_fn = step_fn or frame_loss_and_grads
    P = {k: torch.tensor(v, device=device, dtype=dtype) for k, v in arrays.items()}  # a copy
    start = {f: P[f].detach().double().clone() for f in leaves}
    for f in leaves:
        P[f].requires_grad_(True)
    m = {f: torch.zeros_like(P[f]) for f in leaves}
    v = {f: torch.zeros_like(P[f]) for f in leaves}
    target = target.to(device=device, dtype=dtype)
    losses: List[float] = []
    grad1 = {}
    for i in range(1, steps + 1):
        loss, g = step_fn(structure, P, leaves, target, s, band_rows)
        losses.append(loss)
        if i == 1:
            grad1 = {f: float(g[f].double().norm()) for f in leaves}
        with torch.no_grad():
            for f in leaves:
                m[f].mul_(BETAS[0]).add_(g[f], alpha=1 - BETAS[0])
                v[f].mul_(BETAS[1]).addcmul_(g[f], g[f], value=1 - BETAS[1])
                denom = (v[f].sqrt() / math.sqrt(1 - BETAS[1] ** i)).add_(EPS)
                P[f].addcdiv_(m[f], denom, value=-lr / (1 - BETAS[0] ** i))
                if f in PROJECT:
                    P[f].clamp_(min=PROJECT[f])
    moves = {f: P[f].detach().double() - start[f] for f in leaves}
    return {"losses": losses, "grad1": grad1,
            "change": {f: float(d.norm()) for f, d in moves.items()},
            "moves": {f: d.flatten().tolist() for f, d in moves.items()}}
