"""The system under test: the only module of the benchmark that imports the
program (`loltracer_tpu_torch`), through its user entries, the scene types
they take, and the kernel wrappers' launch counters. Everything is imported
inside the functions, once the harness has checked the device."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from benchmark.scenes.data import SceneData

# RenderConfig keys a configuration's `render` entry and a traffic file may set
RENDER_KEYS = ("max_steps", "epsilon", "max_dist", "shadow_steps", "shadow_w", "shadow_offset",
               "normal_h_scale", "gamma", "aa_width", "atan_fov", "step_clamp", "antialias",
               "shadow_grad")


def render_config(settings: Dict):
    """The program's RenderConfig of these settings (the reference's
    Settings take the same dict)."""
    from loltracer_tpu_torch.config import RenderConfig

    return RenderConfig(**{k: settings[k] for k in RENDER_KEYS if k in settings})


def scene(data: SceneData, device):
    """(structure, params) of the program for the raw scene inputs."""
    from loltracer_tpu_torch.scene import SceneStructure, params_from_numpy

    st = data.structure

    def node(n):
        return tuple(node(c) if isinstance(c, list) else c for c in n)

    structure = SceneStructure(
        num_materials=st["num_materials"], num_lights=st["num_lights"],
        num_spheres=st["num_spheres"], num_boxes=st["num_boxes"], num_planes=st["num_planes"],
        num_unions=st["num_unions"], objects=tuple(node(n) for n in st["objects"]),
        material_ids=tuple(st["material_ids"]), instanced=st["instanced"])
    return structure, params_from_numpy({k: np.asarray(v) for k, v in data.arrays.items()},
                                        device)


def with_camera(params, point, direction):
    """params with the camera moved (float32 tensors on params' device)."""
    import dataclasses

    import torch

    dev = params.cam_point.device
    return dataclasses.replace(
        params,
        cam_point=torch.from_numpy(np.asarray(point, np.float32)).to(dev),
        cam_direction=torch.from_numpy(np.asarray(direction, np.float32)).to(dev))


def start_world(device) -> None:
    """A process group of this one rank, which every fit job then reuses."""
    from loltracer_tpu_torch.parallel.mesh import ensure_world

    ensure_world(device)


def stop_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def fit(structure, params, target, steps: int, lr: float, trainable: Sequence[str], cfg,
        device):
    """One fitting job through `opt.fit_scene`: (losses [steps], fitted
    params)."""
    from loltracer_tpu_torch.opt import fit_scene

    r = fit_scene(structure, params, target, steps=steps, learning_rate=lr,
                  trainable=tuple(trainable), cfg=cfg, device=device)
    return r.losses, r.params


def frame_renderer(structure, height: int, width: int, cfg, device):
    """The forward renderer, built once at its size, as `cli render
    --backend pallas` builds it: `render.cuda_renderer.make_cuda_renderer`,
    which hands an instanced structure to `make_instanced_renderer` (K5)
    and renders a compiled one through K1."""
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer

    return make_cuda_renderer(structure, height, width, cfg, device)


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter and the cell grid's builds."""
    from loltracer_tpu_torch.render import (
        cell_grid,
        fused_fwd,
        fused_train,
        instanced_fwd,
        instanced_train,
        march_kernels,
    )

    counts = {
        "lol_render_fused": fused_fwd.launches,
        "lol_train_fwd": fused_train.launches_fwd,
        "lol_train_bwd": fused_train.launches_bwd,
        "lol_instanced_render": instanced_fwd.launches,
        "lol_instanced_fwd": instanced_train.launches_fwd,
        "lol_instanced_bwd": instanced_train.launches_bwd,
        "cell_grid_builds": cell_grid.builds,
    }
    counts.update(march_kernels.launches)
    return dict(counts)


def launches_since(before: Dict[str, int], device) -> Dict[str, int]:
    """The launches and builds since `before` (launch_counts()); on a card,
    raises unless some kernel of the program launched."""
    after = launch_counts()
    delta = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    kernels = {k: v for k, v in delta.items() if k != "cell_grid_builds"}
    if str(device).startswith("cuda") and not kernels:
        raise RuntimeError("no kernel of the program launched in the window")
    return delta
