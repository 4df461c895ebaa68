"""The port's training path (loltracer_tpu_torch.render.fused_train and the
differentiable plain renderer) against the JAX package, on CPU tensors:

- the plain version of lol_train_fwd (image and residual planes) vs the
  Pallas forward `make_fwd_call` in interpret mode;
- the plain version of lol_train_bwd vs an out-of-kernel `jax.vjp` of
  `pallas_train._shade_from_frozen` on the same residuals and cotangent;
- end-to-end MSE gradients of `make_training_renderer(device="cpu")` vs
  `jax.grad` through the jnp renderer with envelope shadows, the penumbra
  band masked (tests/_penumbra.py);
- one exact-mode gradient of the plain `render_image` vs the jnp renderer.

Inputs are made with numpy and handed to both packages. Tolerances are the
JAX package's own (tests/test_train.py, tests/test_pallas_march.py)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
import loltracer_tpu.render.pallas_train as PT
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.render.jnp_renderer import render_image as jax_render_image
from loltracer_tpu.render.pallas_scene import ScalarScene, active_fields, array_param_values
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import pack_fields, unpack_fields
from loltracer_tpu_torch.render.fused_train import (
    make_training_renderer,
    train_backward_reference,
    train_forward_reference,
)
from loltracer_tpu_torch.render.torch_renderer import render_image
from loltracer_tpu_torch.scene import FIELDS, SceneParams, build_scene, params_to_numpy

from _penumbra import penumbra_pixels

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
H, W = 16, 144  # tests/test_train.py's size: a width that is not a multiple of 128
CFG = RenderConfig(shadow_grad="envelope")
CFG_AA = dataclasses.replace(CFG, antialias=True)


@pytest.fixture(scope="module")
def scenes(examples_dir):
    out = {}
    for name in SCENES:
        path = str(examples_dir / name)
        out[name] = (
            jlt.build_scene(jlt.parse_scene_file(path)),
            build_scene(parse_scene_file(path), device="cpu"),
        )
    return out


def _jax_cfg(cfg: RenderConfig) -> JaxRenderConfig:
    return JaxRenderConfig(**{**dataclasses.asdict(cfg), "march_backend": "jnp"})


def _port_forward(tscene, cfg, h=H, w=W):
    cam = camera_pack(tscene.params, h, w, cfg)
    fields = pack_fields(tscene.structure, tscene.params)
    with flush_denormals():
        img, res = train_forward_reference(tscene.structure, cfg, cam, fields, h, w)
    return cam, fields, img, res


@contextlib.contextmanager
def flush_denormals():
    """XLA on the CPU flushes denormals to zero; torch on the CPU keeps
    them. A color channel in the denormal range (a specular term pow(base,
    50) underflowing) is 0 in the JAX package and tiny in torch, and the
    gamma's gradient c**(1/2.2 - 1) there is ~1e21. The port's calls run in
    the same mode as XLA here."""
    assert torch.set_flush_denormal(True), "this CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _allowed(a, b, atol, rtol, what, most=2):
    """|a - b| <= atol + rtol |b| (or a == b, for the infinite res of a
    hard shadow's first step) on all but `most` pixels."""
    with np.errstate(invalid="ignore"):  # inf - inf
        bad = ~((a == b) | (np.abs(a - b) <= atol + rtol * np.abs(b)))
    assert bad.sum() <= most, (what, int(bad.sum()), np.abs(a - b).max())


@pytest.mark.parametrize(
    "name,cfg",
    [("scene3.lol", CFG), ("scene4.lol", CFG), ("scene4.lol", CFG_AA)],
    ids=["scene3", "scene4", "scene4_aa"],
)
def test_forward_residuals_match_pallas(scenes, name, cfg):
    """Plain lol_train_fwd vs the Pallas forward (interpret mode): image
    atol 5e-5 (tests/test_train.py:50); hit and material equal, t_sh, res
    and t* within atol/rtol 1e-4 (tests/test_pallas_march.py:45), each on
    all but 2 pixels (near-tied argmins)."""
    jscene, tscene = scenes[name]
    st = jscene.structure
    fwd = PT.make_fwd_call(st, H, W, _jax_cfg(cfg), interpret=True)
    jcam = PT.camera_pack(jscene.params, H, W, _jax_cfg(cfg))
    args = [jnp.asarray(getattr(jscene.params, f), jnp.float32) for f in active_fields(st)]
    jimg, jres = jax.jit(fwd)(jcam, *args)
    jimg = np.moveaxis(np.asarray(jimg), 0, -1)[:H, :W]
    jres = np.asarray(jres)[:, :H, :W]

    _, _, img, res = _port_forward(tscene, cfg)
    res = res.numpy()
    assert res.shape == jres.shape
    np.testing.assert_allclose(img.numpy(), jimg, atol=5e-5, rtol=0)
    for plane, what in ((1, "hit"), (2, "mat")):
        assert (res[plane] != jres[plane]).sum() <= 2, what
    _allowed(res[0], jres[0], 1e-4, 1e-4, "t_sh")
    for li in range(st.num_lights):
        _allowed(res[4 + 2 * li], jres[4 + 2 * li], 1e-4, 1e-4, f"res{li}")
        _allowed(res[5 + 2 * li], jres[5 + 2 * li], 1e-4, 1e-4, f"t*{li}")
    # the IFT denominator on hit pixels away from its clamp (rtol 1e-4)
    live = (jres[1] > 0.5) & (np.abs(jres[3]) > 1e-2)
    _allowed(res[3][live], jres[3][live], 0.0, 1e-4, "den")


@pytest.mark.parametrize("name", SCENES)
def test_backward_matches_shade_from_frozen_vjp(scenes, name):
    """Plain lol_train_bwd vs jax.vjp of pallas_train._shade_from_frozen on
    the same residuals and a seeded cotangent, AA on: fields atol
    1e-4 * scale, dcam rtol 2e-3 (tests/test_train.py:260-279)."""
    h, w = 16, 64
    jscene, tscene = scenes[name]
    st = jscene.structure
    cfg = CFG_AA
    cam, fields, _, res = _port_forward(tscene, cfg, h, w)
    ct = np.random.default_rng(SCENES.index(name)).uniform(-1, 1, (h, w, 3))
    ct = ct.astype(np.float32)
    with flush_denormals():
        dcam, dfields = train_backward_reference(
            st, cfg, cam, fields, res, torch.from_numpy(ct)
        )

    jres = jnp.asarray(res.numpy())
    nl = st.num_lights
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")

    def total(values, camt):
        scn = ScalarScene(st, values)
        r, g, b = PT._shade_from_frozen(
            st, _jax_cfg(cfg), scn, camt, jres[0], jres[1], jres[2], jres[3],
            [jres[4 + 2 * l] for l in range(nl)], [jres[5 + 2 * l] for l in range(nl)],
            lambda c: PT._rays_from_xy(c, h, w, jnp.asarray(xs), c[15] + jnp.asarray(ys)),
        )
        return jnp.sum(r * ct[..., 0]) + jnp.sum(g * ct[..., 1]) + jnp.sum(b * ct[..., 2])

    fnames = active_fields(st)
    values = array_param_values(st, jscene.params, fnames)
    camt = tuple(jnp.asarray(cam.numpy())[i] for i in range(PT.CAM_SIZE))
    # eager: compiling this straight-line graph costs more than running it
    dvals, jdcam = jax.grad(total, argnums=(0, 1))(values, camt)

    jdcam = np.asarray(jdcam)
    np.testing.assert_allclose(
        dcam.numpy(), jdcam, rtol=2e-3, atol=1e-5 * max(1.0, np.abs(jdcam).max())
    )
    ours = unpack_fields(st, dfields)
    for f in fnames:
        ref = np.asarray(jax.tree_util.tree_map(np.asarray, dvals[f]), np.float32)
        got = ours[f].numpy()
        scale = max(np.abs(ref).max(), 1e-6)
        np.testing.assert_allclose(got, ref.reshape(got.shape), atol=1e-4 * scale,
                                   rtol=0, err_msg=f)


def _torch_grads(render_fn, params, keep, target):
    """{field: d loss / d field} as numpy, through params_to_numpy."""
    leaves = SceneParams(**{
        f: getattr(params, f).detach().clone().requires_grad_(True) for f in FIELDS
    })
    with flush_denormals():
        loss = (torch.from_numpy(keep) * (render_fn(leaves) - target) ** 2).mean()
        loss.backward()
    grads = SceneParams(**{
        f: v.grad if v.grad is not None else torch.zeros_like(v)
        for f, v in vars(leaves).items()
    })
    return params_to_numpy(grads)


def _jax_grads(jscene, cfg, keep, target, h, w):
    def loss(p):
        img = jax_render_image(jscene.structure, p, h, w, _jax_cfg(cfg))
        return jnp.mean(jnp.asarray(keep) * (img - target) ** 2)

    g = jax.jit(jax.grad(loss))(jscene.params)
    return {f: np.asarray(getattr(g, f)) for f in FIELDS}


@pytest.mark.parametrize("cfg", [CFG, CFG_AA], ids=["parity", "aa"])
@pytest.mark.parametrize("name", ["scene3.lol", "scene4.lol"])
def test_training_renderer_gradients_match_jax(scenes, name, cfg):
    """MSE gradients through make_training_renderer(device="cpu") vs
    jax.grad through the jnp renderer, envelope shadows, penumbra band
    masked out of the loss: 2e-2 * scale (tests/test_train.py:127-136)."""
    h, w = 16, 64
    jscene, tscene = scenes[name]
    _, _, _, res = _port_forward(tscene, cfg, h, w)
    keep = (~penumbra_pixels(res.numpy(), tscene.structure.num_lights))[..., None]
    keep = keep.astype(np.float32)
    target = 0.5 * np.ones((h, w, 3), np.float32)
    render = make_training_renderer(tscene.structure, h, w, cfg, device="cpu")
    ours = _torch_grads(render, tscene.params, keep, torch.from_numpy(target))
    ref = _jax_grads(jscene, cfg, keep, target, h, w)
    for f in FIELDS:
        a, b = ours[f], ref[f]
        if a.size == 0:
            continue
        assert np.isfinite(a).all(), f
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=2e-2 * scale, rtol=0, err_msg=f)
        if np.abs(b).max() > 1e-6:
            assert np.abs(a).max() > 0, f


def test_exact_mode_gradients_match_jax(scenes):
    """The plain render_image with exact shadow gradients (autograd through
    the shadow loop) vs jax.grad through the jnp renderer, scene3 at 8x32:
    no band to mask, so 2e-2 * scale on every field."""
    h, w = 8, 32
    cfg = RenderConfig(shadow_grad="exact")
    jscene, tscene = scenes["scene3.lol"]
    keep = np.ones((h, w, 1), np.float32)
    target = 0.5 * np.ones((h, w, 3), np.float32)
    ours = _torch_grads(
        lambda p: render_image(tscene.structure, p, h, w, cfg),
        tscene.params, keep, torch.from_numpy(target),
    )
    ref = _jax_grads(jscene, cfg, keep, target, h, w)
    for f in FIELDS:
        a, b = ours[f], ref[f]
        if a.size == 0:
            continue
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a, b, atol=2e-2 * scale, rtol=0, err_msg=f)


def test_params_to_numpy_round_trips(scenes):
    """scene.params_to_numpy is the inverse of params_from_numpy, and its
    arrays equal the JAX package's numbers."""
    from loltracer_tpu_torch.scene import params_from_numpy

    jscene, tscene = scenes["scene4.lol"]
    arrays = params_to_numpy(tscene.params)
    back = params_from_numpy(arrays, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(tscene.params, f)), f
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jscene.params, f)))
