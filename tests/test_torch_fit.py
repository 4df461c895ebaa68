"""The port's `cli fit` and `cli render --backend`, and `fit_scene` on the
path that the march kernel K3 serves on the card (any estimator but
"envelope": the differentiable renderer), on CPU tensors:

- `cli fit` prints the JAX package's `[fit] step` lines and `final loss:`
  line and writes `-o`; its losses are `fit_scene`'s with antialiasing;
  `--checkpoint` saves and resumes (tests/test_torch_checkpoint.py holds
  the resume bitwise);
- `fit_scene` on CPU tensors takes the differentiable renderer through
  the sharded step (parallel/sharded.py), whatever the estimator, as the
  JAX package's "auto" does off its kernels: the rows in one call for
  compiled structures, 16-row bands for instanced ones; it raises for
  CUDA without CUDA;
- `cli render --backend pallas` is the fused kernel's path, `--backend jnp`
  the differentiable renderer's; on the CPU both give the same PNG; without
  `--backend` it takes "jnp", the JAX package's default.

On the card `chip_smoke.py` phases 19 and 21 run these paths at 1080p."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from loltracer_tpu_torch import cli
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.opt import fit_scene, inverse
from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
from loltracer_tpu_torch.scene import build_scene
from loltracer_tpu_torch.scenes import instanced_spheres
from loltracer_tpu_torch.utils.image import read_png

torch.set_num_threads(1)  # one intra-op thread per pytest worker

H, W = 16, 24


@pytest.fixture(scope="module")
def scene4(examples_dir):
    return build_scene(parse_scene_file(str(examples_dir / "scene4.lol")), device="cpu")


@pytest.fixture(scope="module")
def target(scene4, tmp_path_factory):
    """scene4 at 24x16 with its sphere points moved, rendered with AA, as
    the .npy `cli fit` reads."""
    moved = scene4.params.sphere_point + torch.from_numpy(
        np.random.default_rng(0).uniform(-0.1, 0.1, (scene4.structure.num_spheres, 3))
        .astype(np.float32))
    img = make_cuda_renderer(scene4.structure, H, W, RenderConfig(antialias=True),
                             device="cpu")(dataclasses.replace(scene4.params, sphere_point=moved))
    path = tmp_path_factory.mktemp("fit") / "target.npy"
    np.save(path, img.numpy())
    return path


def test_cli_fit_matches_fit_scene(examples_dir, scene4, target, tmp_path, capsys):
    """2 steps at 24x16 through the CLI (AA on by default, exact shadows),
    then fit_scene with RenderConfig(antialias=True): the same losses."""
    out = tmp_path / "fit.png"
    assert cli.main(["fit", str(examples_dir / "scene4.lol"), "--target", str(target),
                     "--steps", "2", "--trainable", "sphere_point", "--device", "cpu",
                     "-o", str(out)]) == 0
    printed = capsys.readouterr().out
    steps = [float(v) for v in re.findall(r"^\[fit\] step \d+ loss (\S+)$", printed, re.M)]
    final = re.search(r"^final loss: (\S+)$", printed, re.M)
    assert len(steps) == 2 and final and float(final.group(1)) == steps[-1]
    assert read_png(str(out)).shape == (H, W, 3)

    result = fit_scene(scene4.structure, scene4.params, np.load(target), steps=2,
                       trainable=("sphere_point",), cfg=RenderConfig(antialias=True),
                       device="cpu")
    assert [f"{v:.6g}" for v in result.losses] == [f"{v:.6g}" for v in steps]
    assert np.isfinite(result.losses).all()


def test_cli_fit_checkpoint_is_not_ported(examples_dir, target, tmp_path, capsys):
    """`--checkpoint` is ported: from the checkpoint of a fit that stopped
    after step 0 (fit_scene's, saved every step), `cli fit --steps 2` runs
    step 1 alone, prints its final loss and writes `-o`."""
    path = str(tmp_path / "fit.ckpt")
    fit_scene(*_scene4_args(examples_dir), np.load(target), steps=1, checkpoint_path=path,
              checkpoint_every=1, trainable=("sphere_point",),
              cfg=RenderConfig(antialias=True), device="cpu")
    assert inverse.load_checkpoint(path)[0] == 1
    capsys.readouterr()
    out = tmp_path / "fit.png"
    assert cli.main(["fit", str(examples_dir / "scene4.lol"), "--target", str(target),
                     "--steps", "2", "--trainable", "sphere_point", "--device", "cpu",
                     "--checkpoint", path, "-o", str(out)]) == 0
    printed = capsys.readouterr().out
    steps = re.findall(r"^\[fit\] step (\d+) loss (\S+)$", printed, re.M)
    assert [s for s, _ in steps] == ["1"]
    assert re.search(r"^final loss: (\S+)$", printed, re.M).group(1) == steps[0][1]
    assert read_png(str(out)).shape == (H, W, 3)


def _scene4_args(examples_dir):
    s = build_scene(parse_scene_file(str(examples_dir / "scene4.lol")), device="cpu")
    return s.structure, s.params


def test_fit_scene_takes_the_differentiable_renderer(scene4, monkeypatch):
    """On CPU tensors the sharded step renders through the differentiable
    renderer (the JAX package's _jnp_row_renderer), exact and envelope
    shadows alike: a compiled structure's rows in one render_rays call, an
    instanced structure's 32 rows in 16-row bands, each checkpointed (run
    again in the backward). A CUDA request without CUDA raises."""
    from loltracer_tpu_torch.parallel import sharded

    calls = []
    real = sharded.render_rays
    monkeypatch.setattr(sharded, "render_rays",
                        lambda st, p, ro, rd, *a, **k:
                        calls.append((st.instanced, tuple(rd.shape[:2])))
                        or real(st, p, ro, rd, *a, **k))
    for cfg in (RenderConfig(), RenderConfig(shadow_grad="envelope")):
        fit_scene(scene4.structure, scene4.params, np.zeros((4, 6, 3), np.float32), steps=1,
                  cfg=cfg, device="cpu")
    assert calls == [(False, (4, 6))] * 2
    inst = instanced_spheres(n=64, seed=1, device="cpu")
    fit_scene(inst.structure, inst.params, np.zeros((32, 6, 3), np.float32), steps=1,
              cfg=RenderConfig(step_clamp=2.0), trainable=("sphere_point",), device="cpu")
    assert calls[2:] == [(True, (16, 6))] * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        fit_scene(scene4.structure, scene4.params, np.zeros((4, 6, 3), np.float32), steps=1,
                  device="cuda")


@pytest.mark.parametrize("scene", ["scene3.lol", "instanced:64"])
def test_cli_render_backends_agree_on_the_cpu(examples_dir, scene, tmp_path, capsys):
    """`--backend pallas` (the fused kernel's plain version on the CPU) and
    `--backend jnp` (the differentiable renderer) write the same PNG."""
    src = scene if scene.startswith("instanced:") else str(examples_dir / scene)
    pngs = []
    for backend in ("pallas", "jnp"):
        out = tmp_path / f"{backend}.png"
        extra = ["--step-clamp", "2"] if scene.startswith("instanced:") else []
        assert cli.main(["render", src, "--size", "20x12", "--device", "cpu", "--backend",
                         backend, "-o", str(out), *extra]) == 0
        pngs.append(read_png(str(out)))
    np.testing.assert_array_equal(pngs[0], pngs[1])
    assert pngs[0].max() > 0


def test_cli_render_defaults_to_the_jnp_backend(examples_dir, tmp_path, monkeypatch):
    """Without `--backend`, `cli render` takes the differentiable renderer,
    as the JAX package's `loltrace render` does: the fused path is never
    built."""
    from loltracer_tpu_torch.render import cuda_renderer, torch_renderer

    def refuse(*args, **kwargs):
        raise AssertionError("cli render took --backend pallas by default")

    taken = []
    make = torch_renderer.make_renderer
    monkeypatch.setattr(cuda_renderer, "make_cuda_renderer", refuse)
    monkeypatch.setattr(torch_renderer, "make_renderer",
                        lambda *a, **k: taken.append(a[1:3]) or make(*a, **k))
    out = tmp_path / "default.png"
    assert cli.main(["render", str(examples_dir / "scene3.lol"), "--size", "20x12",
                     "--device", "cpu", "-o", str(out)]) == 0
    assert taken == [(12, 20)] and read_png(str(out)).max() > 0
