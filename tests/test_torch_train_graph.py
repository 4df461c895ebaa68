"""The train step as one CUDA graph (parallel/sharded.py), its CPU facts;
the card's are chip_tests/test_train_graph_chip.py's:

- `graphed_step`, the decision, without a card: the graph only for a
  compiled structure through the fused tier (K1r / K2) on a CUDA device
  over one rank; CPU tensors, `fused="interpret"` or "off", exact
  shadows, the plain march loops, an instanced structure and a mesh of
  more than one rank stay eager;
- a CPU `fit_scene` counts every step as `train_step.eager`, no capture
  and no replay, with either shadow estimator;
- `_graph_key`: what a capture read, None for tensors off the device;
- `camera_pack` copies no up vector from the host (a capture forbids the
  copy of `torch.tensor`), its pack and its gradient bitwise the former
  formula's.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.opt import fit_scene
from loltracer_tpu_torch.parallel import sharded
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.vecmath import cross, normalize, true_div
from loltracer_tpu_torch.scene import FIELDS, build_scene
from loltracer_tpu_torch.scenes import instanced_spheres
from loltracer_tpu_torch.utils import tracing

torch.set_num_threads(1)  # one intra-op thread per pytest worker

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
ENVELOPE = RenderConfig(antialias=True, shadow_grad="envelope", march_backend="pallas")


@pytest.fixture(scope="module")
def scene4(examples_dir):
    return build_scene(parse_scene_file(str(examples_dir / "scene4.lol")), device="cpu")


def _structure(scene4, kind):
    return instanced_spheres(n=64, seed=1, device="cpu").structure if kind == "instanced" \
        else scene4.structure


@pytest.mark.parametrize("kind, cfg, fused, device, ranks, graphed", [
    ("compiled", ENVELOPE, "auto", CUDA, 1, True),
    ("compiled", ENVELOPE, "auto", torch.device("cuda"), 1, True),
    ("compiled", ENVELOPE.replace(march_backend="jnp"), "auto", CPU, 1, False),
    ("compiled", ENVELOPE.replace(march_backend="jnp"), "interpret", CPU, 1, False),
    ("compiled", ENVELOPE, "off", CUDA, 1, False),
    ("compiled", ENVELOPE.replace(shadow_grad="exact"), "auto", CUDA, 1, False),
    ("compiled", ENVELOPE.replace(march_backend="jnp"), "auto", CUDA, 1, False),
    ("instanced", ENVELOPE.replace(step_clamp=2.0), "auto", CUDA, 1, False),
    ("compiled", ENVELOPE, "auto", CUDA, 2, False),
    ("compiled", ENVELOPE, "auto", CUDA, 4, False),
], ids=["card", "card-no-index", "cpu", "interpret", "off", "exact", "plain-march",
        "instanced", "two-ranks", "four-ranks"])
def test_graphed_step_decision(scene4, kind, cfg, fused, device, ranks, graphed):
    assert sharded.graphed_step(_structure(scene4, kind), cfg, fused, device, ranks) is graphed


def _counts():
    c = tracing.counters()
    return {k: c[f"train_step.{k}"] for k in ("captures", "replays", "eager")}


@pytest.mark.parametrize("shadow_grad", ["envelope", "exact"])
def test_cpu_fit_counts_every_step_eager(scene4, shadow_grad):
    before = _counts()
    steps = 3
    target = np.full((8, 12, 3), 0.25, np.float32)
    fit = fit_scene(scene4.structure, scene4.params, target, steps=steps,
                    cfg=RenderConfig(shadow_grad=shadow_grad), device="cpu")
    after = _counts()
    assert len(fit.losses) == steps and np.all(np.isfinite(fit.losses))
    assert after == dict(before, eager=before["eager"] + steps)


def test_graph_key(scene4):
    params, target = scene4.params, torch.zeros((4, 4, 3))
    key = sharded._graph_key(params, target, CPU)
    assert key is not None and len(key) == len(FIELDS) + 1
    assert sharded._graph_key(params, target, CPU) == key
    assert sharded._graph_key(params, target.clone(), CPU) != key
    assert sharded._graph_key(params, torch.zeros((4, 5, 3)), CPU) != key
    moved = dataclasses.replace(params, sphere_point=params.sphere_point.clone())
    assert sharded._graph_key(moved, target, CPU) != key
    assert not params.sphere_point.requires_grad
    leaf = dataclasses.replace(params, sphere_point=params.sphere_point.detach().requires_grad_())
    assert sharded._graph_key(leaf, target, CPU) != key
    assert sharded._graph_key(params, target, CUDA) is None


def _former_camera_pack(params, height, width, cfg, row0=0.0, dtype=torch.float32):
    """camera_pack as it was: the up vector copied from the host."""
    d = normalize(params.cam_direction.to(dtype))
    upg = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=d.device)
    rt = normalize(cross(d, upg))
    up = cross(rt, d)
    half = params.cam_fov.to(dtype) / 2.0
    hh = torch.atan(half) if cfg.atan_fov else torch.tan(half)
    hw = (width / height) * hh
    pixel_rad = true_div(cfg.aa_width * hh, height)
    tail = torch.stack([hw, hh, pixel_rad, torch.full_like(hh, float(row0))])
    return torch.cat([params.cam_point.to(dtype), rt, up, d, tail]).contiguous()


CAMERAS = {
    "scene4": None,
    "down-left": ((-3.0, 4.0, 2.5), (0.4, -0.7, -0.6), 1.2),
    "near-up": ((0.0, 1.0, -5.0), (1e-3, 1.0, -2e-3), 0.5),
    "behind": ((1.5, -0.25, 8.0), (-0.1, 0.05, 1.0), math.pi / 2),
    "wide": ((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 2.6),
    "signed-zeros": ((0.0, -0.0, 2.0), (-0.0, -0.0, -1.0), 1.0),
}


@pytest.mark.parametrize("atan_fov", [True, False])
@pytest.mark.parametrize("camera", list(CAMERAS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_camera_pack_is_the_former_formula(scene4, camera, atan_fov, dtype):
    params = scene4.params
    if CAMERAS[camera] is not None:
        point, direction, fov = CAMERAS[camera]
        params = dataclasses.replace(params, cam_point=torch.tensor(point),
                                     cam_direction=torch.tensor(direction),
                                     cam_fov=torch.tensor(fov))
    cfg = RenderConfig(atan_fov=atan_fov, antialias=True)
    packs, grads = [], []
    for pack in (camera_pack, _former_camera_pack):
        fields = {f: getattr(params, f).detach().clone().requires_grad_(True)
                  for f in ("cam_point", "cam_direction", "cam_fov")}
        p = dataclasses.replace(params, **fields)
        cam = pack(p, 1080, 1920, cfg, row0=17.0, dtype=dtype)
        weights = torch.linspace(-1.0, 2.0, cam.numel(), dtype=dtype)
        (cam * weights).sum().backward()
        packs.append(cam.detach())
        grads.append([fields[f].grad for f in fields])
    assert packs[0].dtype == dtype
    assert torch.equal(_bits(packs[0]), _bits(packs[1]))
    for new, old in zip(*grads):
        assert torch.equal(_bits(new), _bits(old))


def _bits(t):
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64 else torch.int32)
