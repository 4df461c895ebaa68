"""The port's plain PyTorch pipeline (loltracer_tpu_torch) against the JAX
package, on CPU tensors: camera pack, scene SDF, march, and whole images
through `fused_forward_reference` — the plain version the CUDA kernel is
held against on the card (chip_smoke.py) — vs the jnp renderer, the Pallas
fused kernel in interpret mode, and the float64 golden oracle.

Inputs are made once with numpy and handed to both packages. Tolerances are
the JAX package's own: 5e-5 kernel-vs-renderer (tests/test_pallas.py), 2e-4
vs golden (tests/test_jnp_renderer.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.golden import render_golden
from loltracer_tpu.render.camera import camera_rays as jax_camera_rays
from loltracer_tpu.render.jnp_renderer import make_renderer as jax_make_renderer
from loltracer_tpu.render.march import march as jax_march
from loltracer_tpu.render.pallas_renderer import make_pallas_renderer
from loltracer_tpu.render.pallas_train import camera_pack as jax_camera_pack
from loltracer_tpu.render.sdf import make_scene_sdf as jax_sdf
from loltracer_tpu.render.sdf import make_scene_sdf_with_id as jax_sdf_id
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.fused_fwd import fused_forward_reference
from loltracer_tpu_torch.render.march import march
from loltracer_tpu_torch.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu_torch.scene import build_scene

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
H, W = 16, 128  # tests/test_pallas.py's size


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
    return JaxRenderConfig(**dataclasses.asdict(cfg))


def _port_image(scene, height, width, cfg):
    cam = camera_pack(scene.params, height, width, cfg)
    fields = pack_fields(scene.structure, scene.params)
    img = fused_forward_reference(scene.structure, cfg, cam, fields, height, width)
    assert img.shape == (height, width, 3) and img.dtype == torch.float32
    return img.numpy()


@pytest.mark.parametrize("name", SCENES)
def test_camera_pack_matches(scenes, name):
    jscene, tscene = scenes[name]
    for cfg in (RenderConfig(), RenderConfig(atan_fov=False, aa_width=1.5)):
        ours = camera_pack(tscene.params, H, W, cfg).numpy()
        ref = np.asarray(jax_camera_pack(jscene.params, H, W, _jax_cfg(cfg)))
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_scene_sdf_matches(scenes, name):
    jscene, tscene = scenes[name]
    rng = np.random.default_rng(SCENES.index(name))
    pts = rng.uniform(-6.0, 6.0, (4096, 3)).astype(np.float32)
    pts[:, 2] -= 6.0  # the examples' objects sit in front of the camera, at -z
    d = make_scene_sdf(tscene.structure)(tscene.params, torch.from_numpy(pts)).numpy()
    d_id, ids = make_scene_sdf_with_id(tscene.structure)(tscene.params, torch.from_numpy(pts))
    jd = np.asarray(jax_sdf(jscene.structure)(jscene.params, pts))
    jd_id, jids = jax_sdf_id(jscene.structure)(jscene.params, pts)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_id.numpy(), np.asarray(jd_id), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("name", SCENES)
def test_march_matches(scenes, name):
    jscene, tscene = scenes[name]
    jcfg = JaxRenderConfig()
    ro, rd = jax_camera_rays(jscene.params, H, W, jcfg)
    ro, rd = np.array(ro), np.array(rd)
    sdf = jax_sdf(jscene.structure)
    ref = jax.jit(lambda p, o, d: jax_march(sdf, p, o, d, jcfg))(jscene.params, ro, rd)
    res = march(
        make_scene_sdf(tscene.structure), tscene.params,
        torch.from_numpy(ro), torch.from_numpy(rd), RenderConfig(),
    )
    hit, ref_hit = res.t.numpy() < 100.0, np.asarray(ref.t) < 100.0
    np.testing.assert_array_equal(hit, ref_hit)
    assert hit.any()
    # rtol as tests/test_pallas_march.py:45: rays that use up the 256-step
    # budget grazing the floor carry ~1 ulp of t per step (1.7e-5 relative
    # at t = 40 for scene4)
    np.testing.assert_allclose(res.t.numpy()[hit], np.asarray(ref.t)[hit], rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("name", SCENES)
def test_image_matches_jnp_renderer(scenes, name):
    jscene, tscene = scenes[name]
    ref = np.asarray(jax_make_renderer(jscene.structure, H, W)(jscene.params))
    np.testing.assert_allclose(_port_image(tscene, H, W, RenderConfig()), ref, atol=5e-5)


def test_image_matches_pallas_interpret(scenes):
    jscene, tscene = scenes["scene4.lol"]
    ref = np.asarray(
        make_pallas_renderer(jscene.structure, H, W, interpret=True)(jscene.params)
    )
    np.testing.assert_allclose(_port_image(tscene, H, W, RenderConfig()), ref, atol=5e-5)


@pytest.mark.parametrize(
    "name,cfg,size",
    [
        ("scene4.lol", RenderConfig(antialias=True), (H, W)),
        ("scene2.lol", RenderConfig(max_steps=64, shadow_steps=32, gamma=1.0), (H, W)),
        ("scene.lol", RenderConfig(), (13, 150)),
    ],
    ids=["antialias", "custom_config", "ragged"],
)
def test_image_variants_match_jnp_renderer(scenes, name, cfg, size):
    jscene, tscene = scenes[name]
    h, w = size
    ref = np.asarray(jax_make_renderer(jscene.structure, h, w, _jax_cfg(cfg))(jscene.params))
    np.testing.assert_allclose(_port_image(tscene, h, w, cfg), ref, atol=5e-5)


@pytest.mark.parametrize("name", SCENES)
def test_image_matches_golden(examples_dir, scenes, name):
    _, tscene = scenes[name]
    scene64 = jlt.build_scene(
        jlt.parse_scene_file(str(examples_dir / name)), dtype=np.float64
    )
    gold = render_golden(scene64, 32, 24)
    img = _port_image(tscene, 24, 32, RenderConfig())
    assert np.all(np.isfinite(img)) and img.min() >= 0.0 and img.max() <= 1.0
    np.testing.assert_allclose(img, gold, atol=2e-4)
