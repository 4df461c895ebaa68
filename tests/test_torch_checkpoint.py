"""The port's checkpoints (loltracer_tpu_torch/opt/inverse.py) against the
JAX package's (tests/test_checkpoint.py, case for case), on the CPU:

- the six cases of tests/test_checkpoint.py: round trip, a writer dying
  before the rename leaves the previous file, a truncated file, another
  structure and another format version refused, a missing file is None;
- `structure_fingerprint` equal to JAX's on the four examples and
  instanced:10000;
- a checkpoint of the JAX package (its optax state) and a pickle holding
  any other class refused, without importing their classes;
- `fit_scene`: 4 steps bitwise 2 steps and a resume of 2 (losses and
  params), through the sharded step on a world of one rank; `cli fit
  --checkpoint` resumes."""

import dataclasses
import os
import pickle
import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per pytest worker

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
H, W = 16, 24


@pytest.fixture(scope="module")
def scene():
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    return build_scene(parse_scene_file(str(EXAMPLES / "scene3.lol")), device="cpu")


def _save(path, scene, step=5):
    from loltracer_tpu_torch.opt import save_checkpoint

    save_checkpoint(path, step, scene.params, {"adam": np.arange(3)}, scene.structure)


def test_roundtrip(scene, tmp_path):
    from loltracer_tpu_torch.opt import load_checkpoint

    path = str(tmp_path / "a.ckpt")
    _save(path, scene, step=7)
    step, params, opt_state = load_checkpoint(path, scene.structure)
    assert step == 7
    np.testing.assert_array_equal(params["sphere_point"], scene.params.sphere_point.numpy())
    np.testing.assert_array_equal(opt_state["adam"], np.arange(3))


def test_mid_write_death_preserves_previous(scene, tmp_path, monkeypatch):
    from loltracer_tpu_torch.opt import load_checkpoint

    path = str(tmp_path / "a.ckpt")
    _save(path, scene, step=3)
    before = open(path, "rb").read()

    def dying_replace(src, dst):
        raise RuntimeError("host died mid-checkpoint")

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(RuntimeError):
        _save(path, scene, step=4)
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert load_checkpoint(path, scene.structure)[0] == 3
    assert os.listdir(tmp_path) == ["a.ckpt"]  # the temporary file went too


def test_truncated_file_raises_not_garbage(scene, tmp_path):
    from loltracer_tpu_torch.opt import load_checkpoint

    path = str(tmp_path / "a.ckpt")
    _save(path, scene, step=3)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        load_checkpoint(path, scene.structure)


def test_structure_mismatch_refused(scene, tmp_path):
    from loltracer_tpu_torch.opt import load_checkpoint, structure_fingerprint

    path = str(tmp_path / "a.ckpt")
    _save(path, scene)
    other = dataclasses.replace(scene.structure, num_lights=99)
    assert structure_fingerprint(other) != structure_fingerprint(scene.structure)
    with pytest.raises(ValueError, match="different scene structure"):
        load_checkpoint(path, other)


def test_version_mismatch_refused(scene, tmp_path):
    from loltracer_tpu_torch.opt import CKPT_VERSION, load_checkpoint

    path = str(tmp_path / "a.ckpt")
    _save(path, scene)
    with open(path, "rb") as f:
        state = pickle.load(f)
    state["version"] = CKPT_VERSION + 1
    with open(path, "wb") as f:
        pickle.dump(state, f)
    with pytest.raises(ValueError, match="format version"):
        load_checkpoint(path, scene.structure)


def test_missing_file_returns_none(tmp_path):
    from loltracer_tpu_torch.opt import load_checkpoint

    assert load_checkpoint(str(tmp_path / "nope.ckpt")) is None


@pytest.mark.parametrize("name", ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol",
                                  "instanced:10000"])
def test_structure_fingerprint_is_jax(name):
    from loltracer_tpu.lol import parse_scene_file as jax_parse
    from loltracer_tpu.opt.inverse import structure_fingerprint as jax_fingerprint
    from loltracer_tpu.scene import build_scene as jax_build
    from loltracer_tpu.scenes import instanced_spheres as jax_instanced

    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.opt import structure_fingerprint
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    if name.startswith("instanced:"):
        ours = instanced_spheres(n=10_000, device="cpu").structure
        theirs = jax_instanced(n=10_000).structure
    else:
        ours = build_scene(parse_scene_file(str(EXAMPLES / name)), device="cpu").structure
        theirs = jax_build(jax_parse(str(EXAMPLES / name))).structure
    assert structure_fingerprint(ours) == jax_fingerprint(theirs)
    assert structure_fingerprint(None) is None


def test_jax_checkpoint_refused(tmp_path):
    """A checkpoint the JAX package wrote (params as its SceneParams, the
    optax Adam state) is refused by name, not half loaded."""
    import optax

    from loltracer_tpu.lol import parse_scene_file as jax_parse
    from loltracer_tpu.opt import masked_optimizer
    from loltracer_tpu.opt.inverse import save_checkpoint as jax_save
    from loltracer_tpu.scene import build_scene as jax_build

    from loltracer_tpu_torch.opt import load_checkpoint

    jscene = jax_build(jax_parse(str(EXAMPLES / "scene3.lol")))
    opt = masked_optimizer(optax.adam(1e-2), jscene.params, ("sphere_point",))
    path = str(tmp_path / "jax.ckpt")
    jax_save(path, 4, jscene.params, opt.init(jscene.params), jscene.structure)
    with pytest.raises(ValueError, match="written by the JAX package"):
        load_checkpoint(path, None)


class _Foreign:
    pass


def test_a_pickle_of_another_class_is_refused(scene, tmp_path):
    from loltracer_tpu_torch.opt import load_checkpoint

    path = str(tmp_path / "a.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"version": 1, "step": 1, "params": _Foreign(), "opt_state": {}}, f)
    with pytest.raises(ValueError, match="_Foreign"):
        load_checkpoint(path, scene.structure)


@pytest.fixture(scope="module")
def fit_case(scene):
    """scene3, its sphere points moved, rendered with AA at 24x16 (target),
    and the fit's keywords."""
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer

    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    moved = scene.params.sphere_point + torch.from_numpy(
        np.random.default_rng(0).uniform(-0.1, 0.1, (scene.structure.num_spheres, 3))
        .astype(np.float32))
    target = make_cuda_renderer(scene.structure, H, W, cfg, device="cpu")(
        dataclasses.replace(scene.params, sphere_point=moved))
    return target, dict(trainable=("sphere_point", "light_point"), cfg=cfg, learning_rate=3e-2,
                        device="cpu")


def test_resumed_fit_is_bitwise_an_unbroken_one(scene, fit_case, tmp_path):
    from loltracer_tpu_torch.opt import fit_scene, load_checkpoint
    from loltracer_tpu_torch.scene import FIELDS

    target, kw = fit_case
    whole = fit_scene(scene.structure, scene.params, target, steps=4, **kw)
    path = str(tmp_path / "fit.ckpt")
    first = fit_scene(scene.structure, scene.params, target, steps=2, checkpoint_path=path,
                      checkpoint_every=2, **kw)
    assert load_checkpoint(path, scene.structure)[0] == 2
    rest = fit_scene(scene.structure, scene.params, target, steps=4, checkpoint_path=path,
                     checkpoint_every=2, **kw)
    assert len(rest.losses) == 2 and load_checkpoint(path, scene.structure)[0] == 4
    np.testing.assert_array_equal(np.concatenate([first.losses, rest.losses]), whole.losses)
    for f in FIELDS:
        assert torch.equal(getattr(rest.params, f), getattr(whole.params, f)), f
    assert not torch.equal(whole.params.sphere_point, scene.params.sphere_point)


def test_cli_fit_checkpoint_resumes(scene, fit_case, tmp_path, capsys):
    """`cli fit --checkpoint` from a checkpoint of step 1 runs step 1 only,
    with fit_scene's loss there; a corrupt checkpoint is refused."""
    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.opt import fit_scene

    target, kw = fit_case
    # the CLI's config: antialiasing on, exact shadows
    kw = dict(kw, trainable=("sphere_point",), cfg=RenderConfig(antialias=True))
    npy = tmp_path / "target.npy"
    np.save(npy, target.numpy())
    whole = fit_scene(scene.structure, scene.params, target, steps=2, **kw)
    path = str(tmp_path / "fit.ckpt")
    fit_scene(scene.structure, scene.params, target, steps=1, checkpoint_path=path,
              checkpoint_every=1, **kw)
    capsys.readouterr()
    args = ["fit", str(EXAMPLES / "scene3.lol"), "--target", str(npy), "--steps", "2",
            "--trainable", "sphere_point", "--lr", "3e-2", "--device", "cpu",
            "--checkpoint", path]
    assert cli.main(args) == 0
    printed = capsys.readouterr().out
    steps = re.findall(r"^\[fit\] step (\d+) loss (\S+)$", printed, re.M)
    assert [s for s, _ in steps] == ["1"]
    assert float(steps[0][1]) == float(f"{whole.losses[1]:.6g}")
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(ValueError, match="corrupt or truncated"):
        cli.main(args)
