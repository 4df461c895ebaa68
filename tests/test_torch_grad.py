"""The port's float64 render path and its gradients, the CPU twin of
tests/test_grad.py at its size (12x16, its coordinates, all four examples):

- reverse-mode AD of the port's `render_image(..., dtype=torch.float64)`
  over float64 params against the JAX package's float64 AD
  (`jax.enable_x64`) of its `render_image(..., dtype=float64)`, every
  field, within 1e-7 * max|g| of the field + 1e-14 (both are the same
  float64 algorithm; only the order of float64 sums differs, and a field
  the loss barely reads, scene3's smooth_k, sits at float64 noise);
- on scene4, the port's AD against float64 central differences of the
  JAX package's golden tracer, with test_grad.py's method and 5 % rule;
- `make_renderer` is differentiable, as the JAX package's is.

The weighted-mean loss and the golden config are test_grad.py's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.golden.tracer import render_golden
from loltracer_tpu.lol import parse_scene_file as jax_parse
from loltracer_tpu.render.jnp_renderer import render_image as jax_render_image
from loltracer_tpu.scene import SceneParams as JaxSceneParams
from loltracer_tpu.scene import build_scene as jax_build_scene
from loltracer_tpu.scene import params_astype
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render.torch_renderer import make_renderer, render_image
from loltracer_tpu_torch.scene import FIELDS, build_scene

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
H, W = 12, 16
CFG_GOLD = JaxRenderConfig(epsilon=1e-8, max_steps=4096)
COORDS = [
    ("sphere_point", (0, 1)),
    ("sphere_radius", (0,)),
    ("light_point", (0, 0)),
    ("light_diffuse", (0, 1)),
    ("mat_diffuse", (1, 0)),
    ("mat_shininess", (1,)),
    ("ambient_color", (0,)),
    ("cam_point", (2,)),
    ("cam_fov", ()),
    ("plane_y", (0,)),
    ("smooth_k", (0,)),
    ("box_radius", (0,)),
]
WEIGHTS = np.random.default_rng(7).uniform(0.5, 1.5, size=(H, W, 3))
AD_RTOL = 1e-7


def _port_grads(path: str):
    scene = build_scene(parse_scene_file(path), dtype=torch.float64, device="cpu")
    params = scene.params
    for f in FIELDS:
        getattr(params, f).requires_grad_(True)
    img = render_image(scene.structure, params, H, W, RenderConfig(), dtype=torch.float64)
    assert img.dtype == torch.float64 and img.shape == (H, W, 3)
    (torch.from_numpy(WEIGHTS) * img).mean().backward()
    # a field the image does not read has no .grad; JAX gives it zeros
    return {f: np.zeros(tuple(getattr(params, f).shape)) if getattr(params, f).grad is None
            else getattr(params, f).grad.numpy() for f in FIELDS}


@pytest.fixture(scope="module", params=SCENES)
def grads(request, examples_dir):
    """(name, port grads, JAX grads) of the weighted-mean loss, float64."""
    path = str(examples_dir / request.param)
    jscene = jax_build_scene(jax_parse(path), dtype=np.float64)
    with jax.enable_x64(True):
        p64 = params_astype(jscene.params, np.float64)

        def loss(params):
            img = jax_render_image(jscene.structure, params, H, W, JaxRenderConfig(),
                                   dtype=np.float64)
            return (WEIGHTS * img).mean()

        ref = jax.jit(jax.grad(loss))(p64)
        ref = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    return request.param, _port_grads(path), ref


def test_float64_ad_matches_jax(grads):
    name, ours, ref = grads
    nonzero = 0
    for f in FIELDS:
        assert ours[f].dtype == np.float64 and ours[f].shape == ref[f].shape, f
        if ref[f].size == 0:
            continue
        scale = np.abs(ref[f]).max()
        err = np.abs(ours[f] - ref[f]).max()
        assert err <= AD_RTOL * scale + 1e-14, (
            f"{name} d/d {f}: max |diff| {err:.3g} of {scale:.3g}")
        nonzero += bool(np.abs(ref[f]).max() > 0)
    assert nonzero >= 8, f"{name}: only {nonzero} fields with a gradient"


def _golden_loss(jscene, params) -> float:
    img = render_golden(dataclasses.replace(jscene, params=params), W, H, CFG_GOLD)
    return float(np.mean(WEIGHTS * img))


def test_float64_ad_matches_golden_central_differences(examples_dir):
    """test_grad.py's check on scene4, with the port's AD: central steps of
    1e-4, coordinates whose one-sided quotients disagree (a coverage flip)
    skipped, 5 % + 2e-4."""
    path = str(examples_dir / "scene4.lol")
    ours = _port_grads(path)
    jscene = jax_build_scene(jax_parse(path), dtype=np.float64)
    base = {f.name: np.array(getattr(jscene.params, f.name), dtype=np.float64)
            for f in dataclasses.fields(JaxSceneParams)}
    l0 = _golden_loss(jscene, JaxSceneParams(**base))
    h = 1e-4
    checked, skipped = 0, []
    for field, idx in COORDS:
        if base[field].size == 0 or (idx and idx[0] >= base[field].shape[0]):
            continue
        losses = []
        for delta in (h, -h):
            arrays = {k: v.copy() for k, v in base.items()}
            arrays[field][idx] += delta
            losses.append(_golden_loss(jscene, JaxSceneParams(**arrays)))
        lp, lm = losses
        fd, fwd, bwd = (lp - lm) / (2 * h), (lp - l0) / h, (l0 - lm) / h
        if abs(fwd - bwd) > 0.2 * max(abs(fd), abs(fwd), abs(bwd), 1e-6) + 1e-6:
            skipped.append((field, idx))
            continue
        ad = float(ours[field][idx])
        assert abs(ad - fd) <= 5e-2 * max(abs(fd), abs(ad)) + 2e-4, (
            f"scene4 d/d {field}{idx}: AD={ad:.6g} FD={fd:.6g}")
        checked += 1
    assert checked >= 6, f"only {checked} coords checked (skipped {skipped})"


def test_make_renderer_is_differentiable(examples_dir):
    """JAX's make_renderer "maps params -> image and is differentiable":
    the port's renders under autograd and its gradients are render_image's."""
    scene = build_scene(parse_scene_file(str(examples_dir / "scene2.lol")), device="cpu")
    params = scene.params
    params.sphere_radius.requires_grad_(True)
    img = make_renderer(scene.structure, 6, 8)(params)
    assert img.requires_grad
    (g,) = torch.autograd.grad(img.sum(), params.sphere_radius)
    (ref,) = torch.autograd.grad(render_image(scene.structure, params, 6, 8).sum(),
                                 params.sphere_radius)
    assert torch.equal(g, ref) and g.abs().max() > 0
