"""Inverse rendering by gradient descent on the scene parameters
(`loltracer_tpu/opt/inverse.py`), on `torch.optim.Adam`.

`fit_scene` trains as the JAX package's does: through the row-sharded
train step of parallel/sharded.py over a mesh of ranks (by default the
most ranks of the world that divide the image height; a lone process is a
world of one rank, parallel/mesh.py), its rows dealt by the LPT schedule
of the step-count cost model computed from the params it starts from, the
loss the all-reduced sum of squared errors over H * W * 3. Each rank
renders its rows through the fused training kernels when
cfg.shadow_grad is "envelope" and the params are on the card (K1r / K2,
or K5r / K6 for instanced structures, with a row table), else through the
differentiable renderer (whose frozen march is the march kernel K3 on the
card and the plain loop on the CPU). `optax.adam` and `torch.optim.Adam`
share their defaults (betas 0.9 / 0.999, eps 1e-8) and their update rule.

Checkpoints (`save_checkpoint` / `load_checkpoint`): every
`checkpoint_every` steps the step, the params (`params_to_numpy`) and the
Adam state (`state_dict()`, its tensors as numpy) go to one pickle file,
written atomically (a temporary file in the same directory, fsync,
os.replace); `fit_scene(checkpoint_path=...)` resumes from it. A missing
file is no checkpoint; a corrupt or truncated file, another format
version, another scene structure (`structure_fingerprint`, the JAX
package's crc32 of the structure's repr) and a file of the JAX package
(whose state is optax's, in its own classes) are refused with a
ValueError. The file is read with an unpickler that admits numpy's
arrays and nothing else.

Spans (utils/tracing.py), their unit the job (`jobs` counts the calls of
fit_scene) and their index the step: `fit_scene.setup` from the entry to
the first step (the target's upload, the world and mesh, the trainable
leaves, Adam, the train step's set-up, the checkpoint's load), then a
`fit_scene.step` a step over the train step's `step.forward` and
`step.backward` (an eager step), or `step.capture` and `step.replay` (the
step as one CUDA graph), and `step.update` (parallel/sharded.py), the
loss's read on the host `fit_scene.loss_read` and each save
`fit_scene.checkpoint`.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import zlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.parallel.mesh import ensure_world, make_mesh
from loltracer_tpu_torch.parallel.sharded import make_sharded_train_step
from loltracer_tpu_torch.render.backend import resolve_device
from loltracer_tpu_torch.scene import (
    FIELDS,
    SceneParams,
    SceneStructure,
    params_from_numpy,
    params_to,
    params_to_numpy,
)
from loltracer_tpu_torch.utils import tracing

# Parameter families it usually makes sense to optimize; the camera is
# excluded (optimizing it against a fixed-camera target is degenerate).
GEOMETRY_FIELDS = (
    "sphere_point",
    "sphere_radius",
    "box_point",
    "box_half",
    "box_radius",
    "plane_y",
    "smooth_k",
)
APPEARANCE_FIELDS = (
    "mat_shininess",
    "mat_diffuse",
    "mat_specular",
    "mat_ambient",
    "ambient_color",
    "light_point",
    "light_diffuse",
    "light_specular",
)
DEFAULT_TRAINABLE = GEOMETRY_FIELDS + APPEARANCE_FIELDS


def trainable_mask(params: SceneParams, fields: Sequence[str]) -> SceneParams:
    """SceneParams of bools marking the fields the optimizer updates."""
    unknown = set(fields) - set(FIELDS)
    if unknown:
        raise KeyError(f"unknown SceneParams fields: {sorted(unknown)}")
    return SceneParams(**{f: f in fields for f in FIELDS})


def trainable_leaves(params: SceneParams, fields: Sequence[str]) -> SceneParams:
    """Fresh copies of params: the listed fields as leaf tensors that
    require grad, every other field detached."""
    mask = trainable_mask(params, fields)
    return SceneParams(**{
        f: getattr(params, f).detach().clone().requires_grad_(getattr(mask, f))
        for f in FIELDS
    })


def masked_optimizer(
    params: SceneParams,
    fields: Sequence[str],
    inner: Callable[..., torch.optim.Optimizer] = torch.optim.Adam,
    **inner_kwargs,
) -> torch.optim.Optimizer:
    """`inner` over the listed fields of params and no other: every other
    field is never written, which is what the JAX package's masked_optimizer
    guarantees by zeroing their updates. The listed fields must be leaves
    that require grad (trainable_leaves makes them)."""
    mask = trainable_mask(params, fields)
    tensors = []
    for f in FIELDS:
        t = getattr(params, f)
        if getattr(mask, f):
            if not (t.is_leaf and t.requires_grad):
                raise ValueError(f"{f} must be a leaf tensor that requires grad")
            tensors.append(t)
        elif t.requires_grad:
            raise ValueError(f"{f} is not trainable but requires grad")
    return inner(tensors, **inner_kwargs)


def default_project(params: SceneParams) -> SceneParams:
    """Keep parameters in their valid domain after each update: radii and
    CSG smoothness positive, material colors and ambient non-negative
    (values in the domain pass bitwise unchanged)."""

    def at_least(t, lo):
        return torch.maximum(t, torch.full_like(t, lo))

    return dataclasses.replace(
        params,
        sphere_radius=at_least(params.sphere_radius, 1e-3),
        box_radius=at_least(params.box_radius, 0.0),
        box_half=at_least(params.box_half, 1e-3),
        smooth_k=at_least(params.smooth_k, 1e-3),
        mat_diffuse=at_least(params.mat_diffuse, 0.0),
        mat_specular=at_least(params.mat_specular, 0.0),
        mat_ambient=at_least(params.mat_ambient, 0.0),
        ambient_color=at_least(params.ambient_color, 0.0),
    )


class FitResult(NamedTuple):
    params: SceneParams
    losses: np.ndarray  # [steps]


jobs = 0


def _default_mesh(height: int, device: torch.device):
    """A mesh over the most ranks of the world that divide `height`."""
    ensure_world(device)
    n = dist.get_world_size()
    while height % n:
        n -= 1
    return make_mesh(n, device=device.type)


def fit_scene(
    structure: SceneStructure,
    params: SceneParams,
    target,
    steps: int = 200,
    learning_rate: float = 1e-2,
    trainable: Sequence[str] = DEFAULT_TRAINABLE,
    cfg: RenderConfig = DEFAULT_CONFIG,
    mesh=None,
    project: Optional[Callable[[SceneParams], SceneParams]] = default_project,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 0,
    device="cuda",
) -> FitResult:
    """Adam-fit the scene to a target image [H, W, 3] (gamma-encoded, as
    the renderers output) through the row-sharded train step over `mesh`
    (module docstring; every rank of the mesh calls it alike). Returns the
    fitted params (detached, on `device`) and the loss of each step run
    here. With `checkpoint_path`, resumes from the checkpoint there when
    there is one and saves one every `checkpoint_every` steps. With
    `log_every`, prints `[fit] step i loss l` every that many steps and at
    the last, as the JAX package's fit_scene. Raises if `device` is a CUDA
    device and CUDA is not available (it never falls back to the CPU)."""
    global jobs
    job, jobs = jobs, jobs + 1
    # the world this call starts (a lone process's world of one) ends with it
    owns_world = mesh is None and not dist.is_initialized()
    try:
        with tracing.span("fit_scene.setup", job):
            device = resolve_device(device, "fit_scene")
            target = torch.as_tensor(target).to(device=device, dtype=torch.float32)
            height, width = int(target.shape[0]), int(target.shape[1])
            params, optimizer, step_fn, start = _setup(
                structure, params, target, learning_rate, trainable, cfg,
                mesh or _default_mesh(height, device), project, checkpoint_path, device)
        losses = []
        for i in range(start, steps):
            with tracing.span("fit_scene.step", job, i):
                loss = step_fn(params, target)
                with tracing.span("fit_scene.loss_read"):
                    losses.append(loss.item())
                if log_every and (i % log_every == 0 or i == steps - 1):
                    print(f"[fit] step {i} loss {losses[-1]:.6g}")
                if checkpoint_path is not None and (i + 1) % checkpoint_every == 0:
                    with tracing.span("fit_scene.checkpoint"):
                        save_checkpoint(checkpoint_path, i + 1, params,
                                        optimizer.state_dict()["state"], structure)
        fitted = SceneParams(**{f: getattr(params, f).detach() for f in FIELDS})
        return FitResult(params=fitted, losses=np.asarray(losses))
    finally:
        if owns_world and dist.is_initialized():
            dist.destroy_process_group()


def _setup(structure, params, target, learning_rate, trainable, cfg, mesh, project,
           checkpoint_path, device):
    """(params, optimizer, step_fn, first step) of fit_scene over `mesh`,
    target on `device`."""
    height, width = int(target.shape[0]), int(target.shape[1])
    params = trainable_leaves(params_to(params, device=device, dtype=torch.float32), trainable)
    optimizer = masked_optimizer(params, trainable, lr=learning_rate)
    # balance_params: the starting params drive the LPT row deal (the block
    # costs drift only as slowly as the fitted geometry)
    step_fn = make_sharded_train_step(structure, mesh, height, width, optimizer, cfg,
                                      project=project, balance_params=params, device=device)

    start = 0
    if checkpoint_path is not None:
        loaded = load_checkpoint(checkpoint_path, structure)
        if loaded is not None:
            start, arrays, opt_state = loaded
            restored = params_from_numpy(arrays, device=device)
            with torch.no_grad():
                for f in FIELDS:
                    getattr(params, f).copy_(getattr(restored, f))
            optimizer.load_state_dict({"state": _tree(opt_state, torch.from_numpy),
                                       "param_groups": optimizer.state_dict()["param_groups"]})
    return params, optimizer, step_fn, start


CKPT_VERSION = 1


def structure_fingerprint(structure: Optional[SceneStructure]) -> Optional[int]:
    """A stable fingerprint of the scene structure a checkpoint's params
    belong to: the crc32 of its repr (Python's hash() is salted per
    process), equal to the JAX package's for the same structure."""
    if structure is None:
        return None
    return zlib.crc32(repr(structure).encode())


def _tree(obj, leaf: Callable):
    """obj with `leaf` applied to every tensor or array of its dicts, lists
    and tuples."""
    if isinstance(obj, dict):
        return {k: _tree(v, leaf) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree(v, leaf) for v in obj)
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return leaf(obj)
    return obj


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_checkpoint(path: str, step: int, params, opt_state,
                    structure: Optional[SceneStructure] = None) -> None:
    """Atomically persist (step, params, opt_state): params as
    `params_to_numpy` gives them (SceneParams, or such a dict already),
    opt_state (the optimizer's state, e.g. `optimizer.state_dict()
    ["state"]`) with every tensor as numpy. The state goes to a temporary
    file in the same directory, fsync'd and os.replace'd into place, so a
    writer dying mid-write leaves the previous checkpoint intact. A format
    version and the structure's fingerprint are stamped for the load."""
    arrays = params_to_numpy(params) if isinstance(params, SceneParams) else params
    state = {
        "version": CKPT_VERSION,
        "structure_fingerprint": structure_fingerprint(structure),
        "step": step,
        "params": _tree(arrays, _to_numpy),
        "opt_state": _tree(opt_state, _to_numpy),
    }
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class _ForeignClass(Exception):
    """A global that a checkpoint of the port never holds."""


class _ArrayUnpickler(pickle.Unpickler):
    """An unpickler that admits numpy's arrays, dtypes and scalars and no
    other class: a checkpoint is dicts, lists, numbers and arrays."""

    _NUMPY = {"_reconstruct", "scalar", "_frombuffer", "ndarray", "dtype"}

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and (name in self._NUMPY or name.endswith("DType")):
            return super().find_class(module, name)
        raise _ForeignClass(f"{module}.{name}")


def load_checkpoint(path: str, structure: Optional[SceneStructure] = None):
    """(step, params as a params_to_numpy dict, opt_state with numpy
    arrays), or None if there is no file at `path`. A corrupt or truncated
    file, another format version, another structure and a checkpoint of
    the JAX package raise ValueError."""
    try:
        with open(path, "rb") as f:
            state = _ArrayUnpickler(f).load()
    except FileNotFoundError:
        return None
    except _ForeignClass as e:
        origin = str(e)
        if origin.split(".")[0] in ("loltracer_tpu", "optax", "jax", "jaxlib"):
            raise ValueError(
                f"checkpoint {path!r} was written by the JAX package (it holds {origin}): "
                "its optax state cannot resume torch.optim.Adam; refit, or resume it with "
                "the JAX package") from None
        raise ValueError(f"checkpoint {path!r} holds {origin}, which a checkpoint of this "
                         "package never does; refusing to load it") from None
    except (pickle.UnpicklingError, EOFError, AttributeError, ValueError, TypeError,
            IndexError) as e:
        raise ValueError(
            f"checkpoint {path!r} is corrupt or truncated: {e!r}; the atomic writer never "
            "produces this: delete or restore the file") from e
    if not isinstance(state, dict):
        raise ValueError(f"checkpoint {path!r} is corrupt or truncated: not a dict")
    version = state.get("version")
    if version != CKPT_VERSION:
        raise ValueError(
            f"checkpoint {path!r} has format version {version!r}, expected {CKPT_VERSION}")
    if structure is not None:
        fp = structure_fingerprint(structure)
        if state.get("structure_fingerprint") not in (None, fp):
            raise ValueError(
                f"checkpoint {path!r} was written for a different scene structure "
                f"(fingerprint {state.get('structure_fingerprint')} != {fp}); refusing to resume")
    return state["step"], state["params"], state["opt_state"]
