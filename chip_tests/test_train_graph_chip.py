"""The card's facts of the train step as one CUDA graph
(parallel/sharded.py; the CPU's are tests/test_torch_train_graph.py's):
`python -m pytest chip_tests -q -m chip`.

- scene4 at 1920x1080, AA, envelope shadows: 12 steps of `fit_scene`,
  which captures on its second step and replays on the other ten, give
  losses and params bitwise those of the same 12 steps run eagerly; an
  optimizer step pre-hook fires 12 times; a CUDA-only `torch.profiler`
  session over the fit sees K1r and K2 run 12 times each, while their
  wrappers count the first step's launches alone (the capture launches
  nothing, a replay launches without them); `train_step` counts one
  capture and 11 replays.
- A CUDA-only `torch.profiler` session over replayed steps sees K1r, K2
  and K2's reduce, one each a step.
- Five jobs reach the same peak of allocated memory, and the memory the
  allocator reserves does not grow with them: each job's capture shares
  the memory pool of the graph before it, which can no longer run.
- A capture and a replay pass `torch.cuda.set_sync_debug_mode("error")`:
  nothing on the step's path syncs the host. A replay after the caller
  set the gradients to None gives the leaves the graph's gradients back.
- `camera_pack`, which copies no up vector from the host, gives the
  former formula's pack and gradients bitwise on the card too.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
H, W = 1080, 1920
STEPS = 12
CFG = RenderConfig(antialias=True, shadow_grad="envelope")


@pytest.fixture(scope="module")
def scene4():
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    return build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device="cuda")


def _target(dev):
    """A smooth image [H, W, 3] in [0.1, 0.9]."""
    y = torch.linspace(0.1, 0.6, H, device=dev)[:, None, None]
    x = torch.linspace(0.0, 0.3, W, device=dev)[None, :, None]
    return ((y + x) * torch.tensor([1.0, 0.8, 0.6], device=dev)).contiguous()


def _counts():
    from loltracer_tpu_torch.utils import tracing

    c = tracing.counters()
    return {k: c[f"train_step.{k}"] for k in ("captures", "replays", "eager")}


def _fit(scene, target, dev, steps=STEPS):
    from loltracer_tpu_torch.opt import fit_scene

    return fit_scene(scene.structure, scene.params, target, steps=steps, cfg=CFG, device=dev)


def _bits(t):
    return t.contiguous().view(torch.int32)


class _Step:
    """A train step over a world of one, as fit_scene builds it, for the
    tests that drive the steps themselves."""

    def __init__(self, scene, dev):
        import torch.distributed as dist

        from loltracer_tpu_torch.opt import (
            DEFAULT_TRAINABLE,
            default_project,
            masked_optimizer,
            trainable_leaves,
        )
        from loltracer_tpu_torch.parallel import make_mesh, make_sharded_train_step

        self.owns = not dist.is_initialized()
        mesh = make_mesh(1, device="cuda")
        self.leaves = trainable_leaves(scene.params, DEFAULT_TRAINABLE)
        opt = masked_optimizer(self.leaves, DEFAULT_TRAINABLE, lr=1e-2)
        self.step = make_sharded_train_step(scene.structure, mesh, H, W, opt, CFG,
                                            project=default_project, device=dev)
        self.target = _target(dev)

    def __call__(self):
        return self.step(self.leaves, self.target)

    def close(self):
        import torch.distributed as dist

        if self.owns and dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.chip
def test_replayed_fit_is_bitwise_the_eager_fit(chip, scene4, monkeypatch):
    from torch.autograd import DeviceType
    from torch.optim.optimizer import register_optimizer_step_pre_hook
    from torch.profiler import ProfilerActivity, profile

    from loltracer_tpu_torch.parallel import sharded
    from loltracer_tpu_torch.render import fused_train
    from loltracer_tpu_torch.scene import FIELDS

    target = _target(chip)
    _fit(scene4, target, chip, steps=2)  # builds the kernels
    with monkeypatch.context() as m:
        m.setattr(sharded, "graphed_step", lambda *args: False)
        before = _counts()
        eager = _fit(scene4, target, chip)
        assert _counts() == dict(before, eager=before["eager"] + STEPS)

    updates = []
    handle = register_optimizer_step_pre_hook(lambda opt, args, kwargs: updates.append(opt))
    before = _counts()
    launches = (fused_train.launches_fwd, fused_train.launches_bwd, fused_train.launches_table)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graphed = _fit(scene4, target, chip)
            torch.cuda.synchronize(chip)
    finally:
        handle.remove()
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        "captures": 1, "replays": STEPS - 1, "eager": 1}
    assert len(updates) == STEPS
    # the card ran K1r, K2 and its reduce once a step
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    for kernel in ("fused_fwd_kernel", "fused_bwd_kernel", "bwd_reduce_kernel"):
        assert sum(kernel in n for n in names if "lol::" in n) == STEPS, kernel
    # the wrappers launched them on the eager first step alone, each with the row table
    assert (fused_train.launches_fwd - launches[0], fused_train.launches_bwd - launches[1],
            fused_train.launches_table - launches[2]) == (1, 1, 2)
    assert np.array_equal(graphed.losses.view(np.int64), eager.losses.view(np.int64))
    for f in FIELDS:
        assert torch.equal(_bits(getattr(graphed.params, f)), _bits(getattr(eager.params, f))), f


@pytest.mark.chip
def test_profiler_sees_the_replayed_kernels(chip, scene4):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = _Step(scene4, chip)
    try:
        step()
        step()  # the capture
        torch.cuda.synchronize(chip)
        before = _counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            losses = [step() for _ in range(3)]
            torch.cuda.synchronize(chip)
    finally:
        step.close()
    assert _counts() == dict(before, replays=before["replays"] + 3)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    port = [n for n in names if "lol::" in n]
    for kernel in ("fused_fwd_kernel", "fused_bwd_kernel", "bwd_reduce_kernel"):
        assert sum(kernel in n for n in port) == 3, (kernel, sorted(set(port)))
    # each step's loss is a tensor of its own, which the next replay leaves alone
    assert len({lo.data_ptr() for lo in losses}) == 3
    assert len({float(lo) for lo in losses}) == 3


@pytest.mark.chip
def test_jobs_do_not_pile_up_memory(chip, scene4):
    from loltracer_tpu_torch.parallel import sharded

    target = _target(chip)
    peaks, reserved, pools = [], [], []
    for _ in range(5):
        torch.cuda.reset_peak_memory_stats(chip)
        _fit(scene4, target, chip, steps=4)
        peaks.append(torch.cuda.max_memory_allocated(chip))
        reserved.append(torch.cuda.memory_reserved(chip))
        pools.append(sharded._last_graph[chip][0].pool())
    print("peak allocated", peaks, "reserved", reserved, "pools", pools)
    assert max(peaks[1:]) == min(peaks[1:]) <= peaks[0]
    assert max(reserved[1:]) <= reserved[1]
    assert len(set(pools[1:])) == 1  # each capture took its predecessor's pool


@pytest.mark.chip
def test_capture_and_replay_do_not_sync(chip, scene4):
    from loltracer_tpu_torch.scene import FIELDS

    step = _Step(scene4, chip)
    try:
        step()
        torch.cuda.synchronize(chip)
        before = _counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()  # the capture, its replay, Adam and project
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(chip)
        # a caller's zero_grad() between steps: the replay gives the leaves
        # their gradients back, so Adam still updates them
        grads = {f: getattr(step.leaves, f).grad for f in FIELDS
                 if getattr(step.leaves, f).grad is not None}
        for f in grads:
            getattr(step.leaves, f).grad = None
        start = {f: getattr(step.leaves, f).detach().clone() for f in grads}
        step()
        torch.cuda.synchronize(chip)
    finally:
        step.close()
    assert _counts() == dict(before, captures=before["captures"] + 1,
                             replays=before["replays"] + 3)
    assert grads and all(getattr(step.leaves, f).grad is g for f, g in grads.items())
    assert any(not torch.equal(getattr(step.leaves, f), start[f]) for f in grads)


def _former_camera_pack(params, height, width, cfg, row0=0.0):
    """camera_pack as it was: the up vector copied from the host."""
    from loltracer_tpu_torch.render.vecmath import cross, normalize, true_div

    d = normalize(params.cam_direction)
    upg = torch.tensor([0.0, 1.0, 0.0], device=d.device)
    rt = normalize(cross(d, upg))
    up = cross(rt, d)
    half = params.cam_fov / 2.0
    hh = torch.atan(half) if cfg.atan_fov else torch.tan(half)
    hw = (width / height) * hh
    pixel_rad = true_div(cfg.aa_width * hh, height)
    tail = torch.stack([hw, hh, pixel_rad, torch.full_like(hh, float(row0))])
    return torch.cat([params.cam_point, rt, up, d, tail]).contiguous()


@pytest.mark.chip
@pytest.mark.parametrize("atan_fov", [True, False])
def test_camera_pack_is_the_former_formula_on_the_card(chip, scene4, atan_fov):
    import dataclasses

    from loltracer_tpu_torch.render.camera import camera_pack

    g = torch.Generator(device=chip).manual_seed(7)
    cfg = RenderConfig(atan_fov=atan_fov, antialias=True)
    for i in range(8):
        p = scene4.params if i == 0 else dataclasses.replace(
            scene4.params, cam_direction=torch.randn(3, generator=g, device=chip),
            cam_fov=torch.rand((), generator=g, device=chip) * 2.5 + 0.1)
        fields = {f: getattr(p, f).detach().clone().requires_grad_(True)
                  for f in ("cam_point", "cam_direction", "cam_fov")}
        out = []
        for pack in (camera_pack, _former_camera_pack):
            for t in fields.values():
                t.grad = None
            cam = pack(dataclasses.replace(p, **fields), H, W, cfg, row0=3.0)
            (cam * torch.linspace(-1.0, 2.0, cam.numel(), device=chip)).sum().backward()
            out.append([cam.detach()] + [t.grad.clone() for t in fields.values()])
        for new, old in zip(*out):
            assert torch.equal(_bits(new), _bits(old))
