"""The port's instanced training path (loltracer_tpu_torch.render.instanced_train)
against the JAX package, on CPU tensors:

- the plain version of lol_instanced_fwd (image and residual planes) vs the
  Pallas instanced forward with residuals (`make_instanced_fwd_call`) in
  interpret mode;
- end-to-end MSE gradients of `make_instanced_training_renderer(device="cpu")`
  vs `jax.grad` through the banded jnp renderer, envelope shadows, the
  penumbra band masked (tests/_penumbra.py), with clamp 2 and exact: the
  JAX package's own comparison of its fused instanced tier
  (tests/test_instanced_fused.py:111-158). The jnp oracle differentiates
  through the cut max(clamp, distance to the AABB), the kernels freeze it
  (pallas_train `_RecordingDist`); the masked tolerance covers both, as it
  does for the JAX package's own tier;
- one 16x32 patch against JAX's `make_instanced_training_renderer` with the
  Pallas K5 / K6 in interpret mode;
- the wrappers' device rules and `fit_scene` on instanced:64.

Inputs are made once with numpy and handed to both packages. The port runs
under flush-denormal, as XLA on the CPU does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.render.jnp_renderer import render_image_banded as jax_render_banded
from loltracer_tpu.render.pallas_march import P_H, P_W, _from_columns
from loltracer_tpu.render.pallas_scene import cdiv, pack_instanced_spheres
from loltracer_tpu.render.pallas_train import camera_pack as jax_camera_pack
from loltracer_tpu.render.pallas_train import (
    instanced_small_fields,
    instanced_uses_scratch,
    make_instanced_fwd_call,
)
from loltracer_tpu.render.pallas_train import (
    make_instanced_training_renderer as jax_instanced_training_renderer,
)
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.opt import fit_scene
from loltracer_tpu_torch.render import instanced_train
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.instanced_fwd import instanced_forward_reference
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.scene import FIELDS, SceneParams, params_to_numpy
from loltracer_tpu_torch.scenes import instanced_spheres

from _penumbra import penumbra_pixels
from test_torch_train import _allowed, flush_denormals

torch.set_num_threads(1)  # one intra-op thread per pytest worker

H, W = 36, 64  # tests/test_instanced_fused.py's size
N, SEED = 300, 9
CLAMP2 = RenderConfig(step_clamp=2.0, shadow_grad="envelope")
EXACT = RenderConfig(shadow_grad="envelope")
GRAD_FIELDS = ("sphere_point", "sphere_radius", "plane_y", "light_point", "mat_diffuse",
               "mat_ambient", "ambient_color", "cam_point", "cam_direction", "cam_fov")


@pytest.fixture(scope="module")
def scenes():
    return jax_instanced_spheres(n=N, seed=SEED), instanced_spheres(n=N, seed=SEED, device="cpu")


def _jax_cfg(cfg: RenderConfig) -> JaxRenderConfig:
    return JaxRenderConfig(**{**dataclasses.asdict(cfg), "march_backend": "jnp"})


def _port_forward(tscene, cfg, h=H, w=W):
    st = tscene.structure
    cam = camera_pack(tscene.params, h, w, cfg)
    fields = pack_fields(st, tscene.params)
    tables = pack_instanced(st, tscene.params)
    with flush_denormals():
        img, res = instanced_train.instanced_train_forward_reference(
            st, cfg, cam, fields, tables, h, w)
    return cam, fields, tables, img, res


def _pallas_forward(jscene, cfg, h=H, w=W):
    """(img [H, W, 3], res [R, H, W]) of the Pallas K5 with residuals
    (lol_instanced_fwd), interpret mode."""
    st = jscene.structure
    jcfg = _jax_cfg(cfg)
    gph, gpw = cdiv(h, P_H), cdiv(w, P_W)
    fwd = make_instanced_fwd_call(st, gph * P_H, gpw * P_W, jcfg, interpret=True,
                                  full_height=h, with_residuals=True)
    spheres_t, mu_b, blk_b, bbox = pack_instanced_spheres(jscene.params, st.material_ids)
    if instanced_uses_scratch(jcfg):
        from loltracer_tpu.render.pallas_scene import pack_gather_bounds

        gb = (pack_gather_bounds(spheres_t),)
    else:
        gb = ()
    args = [jnp.asarray(getattr(jscene.params, f), jnp.float32)
            for f in instanced_small_fields(st)]
    cam = jax_camera_pack(jscene.params, h, w, jcfg)
    img, res = jax.jit(fwd)(cam, spheres_t, mu_b, blk_b, bbox, *gb, *args)
    img = np.moveaxis(np.asarray(_from_columns(img, gph, gpw)), 0, -1)[:h, :w]
    return img, np.asarray(_from_columns(res, gph, gpw))[:, :h, :w]


@pytest.mark.parametrize("cfg", [CLAMP2, EXACT], ids=["clamp2", "exact"])
def test_forward_residuals_match_pallas(scenes, cfg):
    """Plain lol_instanced_fwd vs the Pallas K5 with residuals (interpret
    mode) on one 16x32 patch: image atol 1e-4 (tests/test_instanced_fused.py:49);
    hit and material equal, t_sh, res and t* within atol/rtol 1e-4, each on
    all but 2 pixels (near-tied argmins); the IFT denominator within rtol
    1e-4 on hit pixels with |den| > 1e-2. The image is the plain K5's
    (instanced_forward_reference), bitwise."""
    jscene, tscene = scenes
    st = tscene.structure
    h, w = P_H, P_W
    jimg, jres = _pallas_forward(jscene, cfg, h, w)
    cam, fields, tables, img, res = _port_forward(tscene, cfg, h, w)
    with flush_denormals():
        k5 = instanced_forward_reference(st, cfg, cam, fields, tables, h, w)
    assert torch.equal(img, k5)
    res = res.numpy()
    assert res.shape == jres.shape == (instanced_train.num_residuals(st), h, w)
    np.testing.assert_allclose(img.numpy(), jimg, atol=1e-4, rtol=0)
    for plane, what in ((1, "hit"), (2, "mat")):
        assert (res[plane] != jres[plane]).sum() <= 2, what
    _allowed(res[0], jres[0], 1e-4, 1e-4, "t_sh")
    for li in range(st.num_lights):
        _allowed(res[4 + 2 * li], jres[4 + 2 * li], 1e-4, 1e-4, f"res{li}")
        _allowed(res[5 + 2 * li], jres[5 + 2 * li], 1e-4, 1e-4, f"t*{li}")
    live = (jres[1] > 0.5) & (res[1] > 0.5) & (np.abs(jres[3]) > 1e-2)
    assert live.sum() > 50
    _allowed(res[3][live], jres[3][live], 0.0, 1e-4, "den")


def _port_grads(tscene, cfg, keep, target, h, w):
    """{field: d loss / d field} through make_instanced_training_renderer
    on the CPU."""
    leaves = SceneParams(**{
        f: getattr(tscene.params, f).detach().clone().requires_grad_(True) for f in FIELDS
    })
    render = instanced_train.make_instanced_training_renderer(
        tscene.structure, h, w, cfg, device="cpu")
    with flush_denormals():
        loss = (torch.from_numpy(keep) * (render(leaves) - target) ** 2).mean()
        loss.backward()
    return params_to_numpy(SceneParams(**{
        f: v.grad if v.grad is not None else torch.zeros_like(v)
        for f, v in vars(leaves).items()
    }))


def _jax_grads(render_fn, params, keep, target):
    def loss(p):
        return jnp.mean(jnp.asarray(keep) * (render_fn(p) - target) ** 2)

    g = jax.jit(jax.grad(loss))(params)
    return {f: np.asarray(getattr(g, f)) for f in FIELDS}


def _assert_grads(ours, ref, atol_scale):
    for f in GRAD_FIELDS:
        a, b = ours[f], ref[f]
        assert np.isfinite(a).all(), f
        scale = max(np.abs(b).max(), 1e-7)
        np.testing.assert_allclose(a, b, atol=atol_scale * scale, rtol=0, err_msg=f)
    assert np.abs(ours["sphere_point"]).max() > 0


@pytest.mark.parametrize("cfg", [CLAMP2, EXACT], ids=["clamp2", "exact"])
def test_training_renderer_gradients_match_banded_jnp(scenes, cfg):
    """MSE gradients through make_instanced_training_renderer(device="cpu")
    vs jax.grad through the banded jnp renderer (8-row bands), envelope
    shadows, penumbra band masked out of the loss: 2e-2 * scale per field
    (tests/test_instanced_fused.py:111-158), sphere positions and radii
    included."""
    jscene, tscene = scenes
    _, _, _, _, res = _port_forward(tscene, cfg)
    keep = (~penumbra_pixels(res.numpy(), tscene.structure.num_lights))[..., None]
    keep = keep.astype(np.float32)
    target = 0.5 * np.ones((H, W, 3), np.float32)
    ours = _port_grads(tscene, cfg, keep, torch.from_numpy(target), H, W)
    ref = _jax_grads(
        lambda p: jax_render_banded(jscene.structure, p, H, W, _jax_cfg(cfg), band_rows=8),
        jscene.params, keep, target)
    _assert_grads(ours, ref, 2e-2)


def test_training_renderer_matches_pallas_training_renderer(scenes):
    """One 16x32 patch, clamp 2: gradients through the port's renderer vs
    jax.grad through JAX's make_instanced_training_renderer, whose forward
    and backward are the Pallas K5 with residuals and K6 in interpret mode
    (the kernels the port's two replace), penumbra band masked:
    2e-2 * scale per field."""
    jscene, tscene = scenes
    h, w = P_H, P_W
    cfg = CLAMP2
    _, _, _, _, res = _port_forward(tscene, cfg, h, w)
    keep = (~penumbra_pixels(res.numpy(), tscene.structure.num_lights))[..., None]
    keep = keep.astype(np.float32)
    target = 0.5 * np.ones((h, w, 3), np.float32)
    ours = _port_grads(tscene, cfg, keep, torch.from_numpy(target), h, w)
    fused = jax_instanced_training_renderer(jscene.structure, h, w, _jax_cfg(cfg),
                                            interpret=True)
    ref = _jax_grads(fused, jscene.params, keep, target)
    _assert_grads(ours, ref, 2e-2)


# --- the wrappers' device rules and the optimizer --------------------------------


def test_training_renderer_refuses_what_the_kernels_do_not_implement(monkeypatch):
    st = instanced_spheres(n=3, device="cpu").structure
    with pytest.raises(ValueError, match="envelope"):
        instanced_train.make_instanced_training_renderer(st, 8, 8, RenderConfig(step_clamp=2.0),
                                                         device="cpu")
    with pytest.raises(ValueError, match="instanced"):
        instanced_train.make_instanced_training_renderer(
            dataclasses.replace(st, instanced=False), 8, 8, CLAMP2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        instanced_train.make_instanced_training_renderer(st, 8, 8, CLAMP2)
    with pytest.raises(RuntimeError, match="is_available"):
        fit_scene(st, instanced_spheres(n=3, device="cpu").params,
                  np.zeros((4, 4, 3), np.float32), steps=1, cfg=CLAMP2)


def test_cpu_tensors_take_plain_versions_and_launch_nothing(scenes):
    _, tscene = scenes
    st, cfg, h, w = tscene.structure, CLAMP2, 6, 10
    instanced_train.launches_fwd = instanced_train.launches_bwd = 0
    cam, fields, tables, img, res = _port_forward(tscene, cfg, h, w)
    got = instanced_train.instanced_train_forward(st, cfg, cam, fields, tables, h, w)
    assert torch.equal(got[0], img) and torch.equal(got[1], res)
    ct = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (h, w, 3)).astype(np.float32))
    grads = instanced_train.instanced_train_backward(st, cfg, cam, fields, tables, res, ct)
    ref = instanced_train.instanced_train_backward_reference(st, cfg, cam, fields, tables, res,
                                                             ct)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    assert grads[2].shape == (st.num_spheres, 4)
    assert instanced_train.launches_fwd == 0 and instanced_train.launches_bwd == 0


def test_fit_scene_lowers_the_loss_on_instanced_64():
    """fit_scene on instanced:64 at 16x24 on the CPU, clamp 2, envelope: the
    sphere points moved and the only trainable field, Adam 1e-2, 4 steps;
    the least loss is below the first, frozen fields stay bitwise."""
    scene = instanced_spheres(n=64, seed=3, device="cpu")
    st, cfg = scene.structure, CLAMP2
    target = instanced_train.make_instanced_training_renderer(st, 16, 24, cfg, device="cpu")(
        scene.params).detach()
    delta = torch.from_numpy(
        np.random.default_rng(0).uniform(-0.2, 0.2, (64, 3)).astype(np.float32))
    start = dataclasses.replace(scene.params, sphere_point=scene.params.sphere_point + delta)
    out = fit_scene(st, start, target, steps=4, learning_rate=1e-2,
                    trainable=("sphere_point",), cfg=cfg, device="cpu")
    assert out.losses.shape == (4,) and np.isfinite(out.losses).all()
    assert out.losses[1:].min() < out.losses[0], out.losses
    before, after = params_to_numpy(start), params_to_numpy(out.params)
    for f in FIELDS:
        if f != "sphere_point":
            np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    assert not np.array_equal(after["sphere_point"], before["sphere_point"])
