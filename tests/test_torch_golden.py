"""The port's float64 golden oracle (loltracer_tpu_torch/golden/) against the
JAX package's, and the small entry points beside it (`scene.params_astype`,
`render/march.intersect`, `torch_renderer.render_scene`).

Both goldens are float64 NumPy over the same numbers, so the images are
held bitwise. The port's renderers are held against the port's golden at
the JAX package's tolerances: 2e-4 for the examples
(tests/test_jnp_renderer.py), 3e-4 for 150 instanced spheres
(tests/test_instanced.py)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
from loltracer_tpu import cli as jcli
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.golden import render_golden as jax_golden
from loltracer_tpu.golden import render_golden_scalar as jax_golden_scalar
from loltracer_tpu.golden import trace_pixel as jax_trace_pixel
from loltracer_tpu.render.camera import camera_rays as jax_camera_rays
from loltracer_tpu.render.march import intersect as jax_intersect
from loltracer_tpu.render.sdf import make_scene_sdf as jax_sdf
from loltracer_tpu.render.sdf import make_scene_sdf_with_id as jax_sdf_id
from loltracer_tpu.scene import params_astype as jax_params_astype
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu.utils import cache as jax_cache
from loltracer_tpu_torch import cli
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.golden import render_golden, render_golden_scalar, trace_pixel
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render.camera import camera_rays
from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
from loltracer_tpu_torch.render.march import intersect
from loltracer_tpu_torch.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu_torch.render.torch_renderer import make_renderer, render_scene
from loltracer_tpu_torch.scene import FIELDS, build_scene, params_astype
from loltracer_tpu_torch.scenes import instanced_spheres
from loltracer_tpu_torch.utils.image import read_png

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol", "instanced"]
W, H = 32, 24  # tests/test_jnp_renderer.py's size
SW, SH = 8, 6  # tests/test_golden.py's scalar size


@pytest.fixture(scope="module")
def pairs(examples_dir):
    """name -> (JAX float64 scene, port float64 scene, port float32 scene)."""
    out = {}
    for name in SCENES[:4]:
        path = str(examples_dir / name)
        out[name] = (
            jlt.build_scene(jlt.parse_scene_file(path), dtype=np.float64),
            build_scene(parse_scene_file(path), dtype=torch.float64, device="cpu"),
            build_scene(parse_scene_file(path), device="cpu"),
        )
    # the port's golden casts float32 params to float64 at entry, as the
    # JAX package's tests cast them with params_astype first
    jinst = jax_instanced_spheres(n=150, seed=3)
    jinst.params = jax_params_astype(jinst.params, np.float64)
    tinst = instanced_spheres(n=150, seed=3, device="cpu")
    out["instanced"] = (jinst, tinst, tinst)
    return out


@pytest.mark.parametrize("name", SCENES)
def test_golden_is_bitwise_jax(pairs, name):
    jscene, tscene, _ = pairs[name]
    gold = render_golden(tscene, W, H)
    assert gold.dtype == np.float64 and gold.shape == (H, W, 3)
    np.testing.assert_array_equal(gold, jax_golden(jscene, W, H))


@pytest.mark.parametrize("name", SCENES)
def test_scalar_golden_is_bitwise_jax(pairs, name):
    """The scalar path walks `structure.objects`, which an instanced
    structure leaves empty: both packages then miss everywhere (non-finite
    pixels, equal as arrays)."""
    jscene, tscene, _ = pairs[name]
    np.testing.assert_array_equal(
        render_golden_scalar(tscene, SW, SH), jax_golden_scalar(jscene, SW, SH)
    )
    for x, y in [(0, 0), (SW // 2, SH // 2), (SW - 1, SH - 1)]:
        np.testing.assert_array_equal(
            trace_pixel(tscene, x, y, SW, SH), jax_trace_pixel(jscene, x, y, SW, SH)
        )


@pytest.mark.parametrize("name", SCENES)
def test_port_renderers_match_golden(pairs, name):
    """The plain renderer (`render_scene`) and the fused kernel's plain
    version (`make_cuda_renderer` on the CPU) within the JAX package's
    tolerance of the port's golden."""
    _, tscene, scene32 = pairs[name]
    gold = render_golden(tscene, W, H)
    atol = 3e-4 if name == "instanced" else 2e-4
    with torch.no_grad():
        img = render_scene(scene32, H, W)
    assert img.dtype == torch.float32
    np.testing.assert_allclose(img.numpy(), gold, atol=atol)
    fused = make_cuda_renderer(scene32.structure, H, W, device="cpu")(scene32.params)
    np.testing.assert_allclose(fused.numpy(), gold, atol=atol)


def test_render_scene_is_make_renderer(pairs):
    _, _, scene32 = pairs["scene3.lol"]
    with torch.no_grad():
        a = render_scene(scene32, H, W, RenderConfig(antialias=True), device="cpu")
        b = make_renderer(scene32.structure, H, W, RenderConfig(antialias=True))(scene32.params)
    assert torch.equal(a, b)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_render_golden_writes_jax_png(examples_dir, tmp_path, monkeypatch, capsys, device):
    """`render --backend golden` writes the JAX CLI's PNG bytes, on the CPU
    whatever `--device` says (no CUDA here: `cuda` would raise anywhere
    else)."""
    monkeypatch.setattr(jax_cache, "enable_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = str(examples_dir / "scene4.lol")
    ours, theirs = tmp_path / "port.png", tmp_path / "jax.png"
    assert cli.main(["render", src, "--backend", "golden", "--size", f"{W}x{H}",
                     "--device", device, "-o", str(ours)]) == 0
    assert "on cpu" in capsys.readouterr().out
    jcli.main(["render", src, "--backend", "golden", "--size", f"{W}x{H}", "-o", str(theirs)])
    assert ours.read_bytes() == theirs.read_bytes()
    assert read_png(str(ours)).max() > 0


@pytest.mark.parametrize("name", ["scene4.lol", "instanced"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_params_astype_matches_jax(examples_dir, pairs, name, dtype):
    _, _, scene32 = pairs[name]
    jparams = (jlt.build_scene(jlt.parse_scene_file(str(examples_dir / name))).params
               if name != "instanced" else jax_instanced_spheres(n=150, seed=3).params)
    want = jax_params_astype(jparams, dtype)
    got = params_astype(scene32.params, dtype)
    for f in FIELDS:
        g = getattr(got, f)
        assert g.device.type == "cpu"
        assert g.numpy().dtype == np.dtype(dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("name", ["scene2.lol", "scene4.lol"])
def test_intersect_matches_jax(examples_dir, name):
    path = str(examples_dir / name)
    jscene = jlt.build_scene(jlt.parse_scene_file(path))
    tscene = build_scene(parse_scene_file(path), device="cpu")
    jcfg, cfg = JaxRenderConfig(), RenderConfig()
    h, w = 12, 16
    ro, rd = jax_camera_rays(jscene.params, h, w, jcfg)
    sdf, sdf_id = jax_sdf(jscene.structure), jax_sdf_id(jscene.structure)
    jt, jid = jax.jit(lambda p, o, d: jax_intersect(sdf, sdf_id, p, o, d, jcfg))(
        jscene.params, ro, rd)
    jt, jid = np.asarray(jt), np.asarray(jid)
    tro, trd = camera_rays(tscene.params, h, w, cfg)
    np.testing.assert_array_equal(tro.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(trd.numpy(), np.asarray(rd))
    with torch.no_grad():
        t, obj_id = intersect(make_scene_sdf(tscene.structure),
                              make_scene_sdf_with_id(tscene.structure),
                              tscene.params, tro, trd, cfg)
    np.testing.assert_array_equal(obj_id.numpy(), jid)
    assert (jid > 0).any() and (jid == 0).any()
    hit = jid > 0
    # the march's rtol, tests/test_pallas_march.py:45
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-4, atol=5e-5)


def test_intersect_reattaches_the_gradient(pairs):
    """t carries the IFT gradient at hits, as JAX's intersect: d t / d
    (sphere radius) is finite and nonzero for a ray on the sphere."""
    _, _, scene32 = pairs["scene.lol"]
    params = dataclasses.replace(
        scene32.params, sphere_radius=scene32.params.sphere_radius.clone().requires_grad_(True))
    ro, rd = camera_rays(params, 6, 8, RenderConfig())
    t, obj_id = intersect(make_scene_sdf(scene32.structure),
                          make_scene_sdf_with_id(scene32.structure), params, ro, rd,
                          RenderConfig())
    (g,) = torch.autograd.grad(t.sum(), params.sphere_radius)
    assert torch.isfinite(g).all() and (g != 0).any()
