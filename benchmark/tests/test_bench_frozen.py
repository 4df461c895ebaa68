"""The benchmark's frozen inputs equal what the program builds, and its
plain reference agrees with the program's plain versions at a tiny size
on the CPU."""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import viewer
from benchmark.kinds.fit_jobs import make_target
from benchmark.reference import fit as ref_fit
from benchmark.reference.render import Settings, render_pixels
from benchmark.scenes import csg, data, instanced
from benchmark.tests.tiny import REPO

torch.set_num_threads(1)


def config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def port_arrays(params):
    from loltracer_tpu_torch.scene import params_to_numpy

    return params_to_numpy(params)


def test_fields_are_the_programs():
    from loltracer_tpu_torch.scene import FIELDS

    assert data.FIELDS == FIELDS


def test_scene4_is_what_the_program_parses():
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    from benchmark.harness import port

    sc = build_scene(parse_scene_file(str(REPO / "examples" / "scene4.lol")), device="cpu")
    ours = csg.build(config("scene4")["scene"])
    structure, params = port.scene(ours, "cpu")
    assert structure == sc.structure
    theirs = port_arrays(sc.params)
    for f in data.FIELDS:
        assert ours.arrays[f].dtype == np.float32
        np.testing.assert_array_equal(ours.arrays[f], theirs[f], err_msg=f)


@pytest.mark.parametrize("kw", [dict(n=300, seed=3), dict(n=10000, seed=0)])
def test_instanced_generator_is_the_programs(kw):
    from loltracer_tpu_torch.scenes import instanced_spheres

    from benchmark.harness import port

    sc = instanced_spheres(**kw, device="cpu")
    ours = instanced.generate(**kw)
    assert port.scene(ours, "cpu")[0] == sc.structure
    theirs = port_arrays(sc.params)
    for f in data.FIELDS:
        np.testing.assert_array_equal(ours.arrays[f], theirs[f], err_msg=f)
    if kw["n"] == 10000:
        assert instanced.build(config("instanced10k")["scene"]).arrays["sphere_point"].shape \
            == (10000, 3)


def test_move_rule_is_the_viewers():
    from loltracer_tpu_torch import interactive

    rng = np.random.default_rng(0)
    keys = list(viewer.MOVES + viewer.TURNS)
    p, d = np.array([0.0, 4.0, 6.0]), np.array([0.0, -0.15, -1.0]) / np.hypot(0.15, 1.0)
    for _ in range(50):
        k = {keys[i] for i in rng.choice(len(keys), size=3)}
        a = viewer.update_camera(p, d, k)
        b = interactive.update_camera(p, d, k)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        p, d = a


def test_camera_path_is_the_viewers_chain():
    from loltracer_tpu_torch import interactive
    from loltracer_tpu_torch.scenes import instanced_spheres

    params = instanced_spheres(n=10, device="cpu").params
    keys = viewer.key_cycle(5, 24, 2)
    path = viewer.camera_path(params.cam_point.numpy(), params.cam_direction.numpy(), keys)
    for k, (point, direction) in zip(keys, path):
        params = interactive.move_camera(params, k)
        np.testing.assert_array_equal(point, params.cam_point.numpy())
        np.testing.assert_array_equal(direction, params.cam_direction.numpy())


def test_key_cycle_presses_every_key_alike():
    a, b = viewer.key_cycle(1, 120, 2), viewer.key_cycle(2**33 + 1, 120, 2)
    assert a != b and len(a) == 120
    for keys in (a, b):
        flat = [k for s in keys for k in s]
        assert {flat.count(k) for k in viewer.MOVES} == {20}
        assert {flat.count(k) for k in viewer.TURNS} == {15}
    with pytest.raises(ValueError):
        viewer.key_cycle(1, 100, 2)


def test_target_from_the_seed():
    a = make_target(2**32 + 5, 0, 9, 16, (3, 4), "cpu")
    assert torch.equal(a, make_target(2**32 + 5, 0, 9, 16, (3, 4), "cpu"))
    assert not torch.equal(a, make_target(2**32 + 6, 0, 9, 16, (3, 4), "cpu"))
    assert not torch.equal(a, make_target(2**32 + 5, 1, 9, 16, (3, 4), "cpu"))
    assert a.shape == (9, 16, 3) and 0.05 <= a.min() and a.max() <= 0.6


def _port_settings(name, **kw):
    from benchmark.harness import port

    settings = dict(config(name)["render"], **kw)
    return settings, port.render_config(settings)


@pytest.mark.parametrize("shadow_grad", ["envelope", "exact"])
def test_reference_fit_step_agrees_with_the_programs_plain_renderer(shadow_grad):
    """Loss and every leaf's gradient of one step at 8 x 12."""
    from loltracer_tpu_torch.opt.inverse import trainable_leaves
    from loltracer_tpu_torch.render.torch_renderer import render_image

    from benchmark.harness import port

    H, W = 8, 12
    scene = csg.build(config("scene4")["scene"])
    settings, cfg = _port_settings("scene4", antialias=True, shadow_grad=shadow_grad)
    target = make_target(3, 0, H, W, (3, 4), "cpu")
    leaves = [f for f in data.FIELDS if scene.arrays[f].size and f.startswith(
        ("sphere", "plane", "smooth", "mat", "ambient", "light"))]
    structure, params = port.scene(scene, "cpu")
    params = trainable_leaves(params, leaves)
    loss = ((render_image(structure, params, H, W, cfg) - target) ** 2).mean()
    loss.backward()
    P = {k: torch.as_tensor(v) for k, v in scene.arrays.items()}
    for f in leaves:
        P[f].requires_grad_(True)
    ref_loss, grads = ref_fit.frame_loss_and_grads(scene.structure, P, leaves, target,
                                                   Settings(**settings), 3)
    assert ref_loss == pytest.approx(float(loss), rel=1e-5)
    for f in leaves:
        g = getattr(params, f).grad
        np.testing.assert_allclose(grads[f].numpy(), g.numpy(), rtol=1e-4,
                                   atol=1e-5 * float(g.abs().max()) + 1e-9, err_msg=f)


def test_reference_frame_agrees_with_the_programs_plain_renderer():
    from loltracer_tpu_torch.render.torch_renderer import render_image

    from benchmark.harness import port

    H, W = 10, 14
    scene = instanced.generate(n=300, seed=3)
    settings, cfg = _port_settings("instanced10k", antialias=False, shadow_grad="envelope")
    structure, params = port.scene(scene, "cpu")
    with torch.no_grad():
        theirs = render_image(structure, params, H, W, cfg)
        ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
        P = {k: torch.as_tensor(v) for k, v in scene.arrays.items()}
        ours = render_pixels(scene.structure, P, ys.reshape(-1), xs.reshape(-1), H, W,
                             Settings(**settings))
    np.testing.assert_allclose(ours.reshape(H, W, 3).numpy(), theirs.numpy(), atol=1e-6)
