"""The plain versions of the port's value march kernels K3 and K4, and the
differentiable renderer that selects them, against the JAX package on CPU
tensors:

- `march_values_reference` vs `pallas_march.make_pallas_march` (interpret
  mode) on the four examples and instanced:300 (clamp 2 and exact), and
  `shadow_values_reference` vs `make_pallas_shadow_march` on the real
  shadow rays of scene4 (with the segment cull in both, and without) and
  of instanced:300 with shadow clamp 8;
- `render_image` with march_backend "jnp", envelope shadows and
  antialiasing: the image and MSE gradients vs the JAX renderer with
  march_backend "pallas-interpret";
- the exact shadow estimator's per-step checkpoint: bitwise the same
  gradients, a fraction of the saved bytes; the banded renderer's per-band
  checkpoint;
- the march-backend resolver, and the plain versions of the earlier
  kernels pinned to the plain loops.

Inputs are made with numpy and handed to both packages
(`scene.params_from_numpy`). Tolerances are the JAX package's own
(tests/test_pallas_march.py); the port runs under flush-denormal, as XLA
on the CPU does."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.render.camera import camera_rays as jax_camera_rays
from loltracer_tpu.render.jnp_renderer import render_image as jax_render_image
from loltracer_tpu.render.pallas_march import make_pallas_march, make_pallas_shadow_march
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render import fused_fwd, instanced_fwd, march_kernels, torch_renderer
from loltracer_tpu_torch.render.backend import resolve_march_backend
from loltracer_tpu_torch.render.camera import camera_pack, camera_rays
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.fused_train import train_forward_reference
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.render.march_kernels import (
    march_values,
    march_values_reference,
    pack_march_scene,
    shadow_values,
    shadow_values_reference,
)
from loltracer_tpu_torch.render.sdf import make_scene_sdf
from loltracer_tpu_torch.render.shading import segment_lit, shadow_march
from loltracer_tpu_torch.render.torch_renderer import render_image, render_image_banded
from loltracer_tpu_torch.render.vecmath import dot, normalize
from loltracer_tpu_torch.scene import FIELDS, SceneParams, build_scene, params_from_numpy
from loltracer_tpu_torch.scenes import instanced_spheres

from _penumbra import penumbra_pixels

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]


@contextlib.contextmanager
def flush_denormals():
    """XLA on the CPU flushes denormals to zero; torch keeps them. The
    port's calls run in XLA's mode here."""
    assert torch.set_flush_denormal(True), "this CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _jax_cfg(cfg: RenderConfig, backend: str = "jnp") -> JaxRenderConfig:
    return JaxRenderConfig(**{**dataclasses.asdict(cfg), "march_backend": backend})


def _carried(jparams) -> SceneParams:
    """The JAX scene's numbers as the port's SceneParams."""
    return params_from_numpy({f: np.asarray(getattr(jparams, f)) for f in FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def examples(examples_dir):
    out = {}
    for name in SCENES:
        path = str(examples_dir / name)
        jscene = jlt.build_scene(jlt.parse_scene_file(path))
        out[name] = (jscene, build_scene(parse_scene_file(path), device="cpu").structure,
                     _carried(jscene.params))
    return out


@pytest.fixture(scope="module")
def instanced():
    jscene = jax_instanced_spheres(n=300, seed=9)
    return jscene, instanced_spheres(n=300, seed=9, device="cpu").structure, _carried(jscene.params)


def _rays(jscene, cfg, h, w):
    """The JAX camera's rays (ro [3], rd [h, w, 3]) as numpy: the one input
    both marches take."""
    ro, rd = jax_camera_rays(jscene.params, h, w, _jax_cfg(cfg))
    return np.array(ro, np.float32), np.array(rd, np.float32)  # writable copies for torch


def _assert_march_close(got, want):
    """t, t_query, t_close and the finite s_min within atol/rtol 1e-4
    (tests/test_pallas_march.py:45-55)."""
    for name in ("t", "t_query", "t_close"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    s_got, s_want = got.s_min.numpy(), np.asarray(want.s_min)
    fin = np.isfinite(s_want)
    np.testing.assert_array_equal(np.isfinite(s_got), fin)
    np.testing.assert_allclose(s_got[fin], s_want[fin], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", SCENES)
def test_march_reference_matches_pallas_march(examples, name):
    """K3's plain version vs the Pallas K3 in interpret mode at 13x37, a
    ragged size (the Pallas call pads and crops, the port masks)."""
    jscene, structure, params = examples[name]
    cfg = RenderConfig()
    ro, rd = _rays(jscene, cfg, 13, 37)
    want = make_pallas_march(jscene.structure, _jax_cfg(cfg), interpret=True)(
        jscene.params, jnp.asarray(ro), jnp.asarray(rd))
    with flush_denormals():
        got = march_values_reference(structure, cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                     pack_march_scene(structure, params))
    _assert_march_close(got, want)


@pytest.mark.parametrize("clamp", [2.0, None], ids=["clamp2", "exact"])
def test_instanced_march_reference_matches_pallas_march(instanced, clamp):
    """instanced:300 (seed 9) at 10x24: the plain march over the blockwise
    SDF vs the Pallas traversal in interpret mode."""
    jscene, structure, params = instanced
    cfg = RenderConfig(step_clamp=clamp)
    ro, rd = _rays(jscene, cfg, 10, 24)
    want = make_pallas_march(jscene.structure, _jax_cfg(cfg), interpret=True)(
        jscene.params, jnp.asarray(ro), jnp.asarray(rd))
    with flush_denormals():
        got = march_values_reference(structure, cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                     pack_march_scene(structure, params))
    _assert_march_close(got, want)


def _shadow_inputs(structure, params, cfg, ro, rd, t):
    """Per light, what shading.phong hands the shadow march from the hits
    at t: (origin, direction, distance to the light), contiguous numpy."""
    p = torch.from_numpy(ro) + t[..., None] * torch.from_numpy(rd)
    out = []
    for li in range(structure.num_lights):
        to_light = params.light_point[li] - p
        light_dir = normalize(to_light)
        out.append(tuple(np.ascontiguousarray(x.numpy()) for x in (
            p + light_dir * cfg.shadow_offset, light_dir, torch.sqrt(dot(to_light, to_light)))))
    return out


@pytest.mark.parametrize("case", ["scene4", "scene4_no_cull", "instanced_clamp8"])
def test_shadow_reference_matches_pallas_shadow_march(examples, instanced, case):
    """K4's plain version vs the Pallas K4 in interpret mode on each light's
    real shadow rays: res within atol 5e-5 / rtol 1e-4 where finite and
    infinite at the same rays, t* likewise (tests/test_pallas_march.py:
    259-264). On scene4 both run the segment cull (cfg.shadow_cull, the
    default: the port's plain K4 starts the rays shading.segment_lit marks
    done, `init_done`, as the Pallas kernel does), or both leave it out;
    the culled rays give res = 1, t* = 0 in both. The instanced case
    marches under shadow clamp 8."""
    if case.startswith("scene4"):
        (jscene, structure, params), h, w = examples["scene4.lol"], 13, 37
        cfg = RenderConfig(shadow_cull=case == "scene4")
    else:
        (jscene, structure, params) = instanced
        cfg, h, w = RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0), 10, 24
    ro, rd = _rays(jscene, cfg, h, w)
    scene = pack_march_scene(structure, params)
    pallas = make_pallas_shadow_march(jscene.structure, _jax_cfg(cfg), interpret=True)
    with flush_denormals():
        t = march_values_reference(structure, cfg, torch.from_numpy(ro), torch.from_numpy(rd),
                                   scene).t
    culled = 0
    for so, ld, dist in _shadow_inputs(structure, params, cfg, ro, rd, t):
        want = [np.asarray(x) for x in pallas(jscene.params, jnp.asarray(so), jnp.asarray(ld),
                                              jnp.asarray(dist))]
        with flush_denormals():
            got = [x.numpy() for x in shadow_values_reference(
                structure, cfg, torch.from_numpy(so), torch.from_numpy(ld),
                torch.from_numpy(dist), scene)]
            if case == "scene4":
                with torch.no_grad():
                    lit = segment_lit(structure, params, torch.from_numpy(so),
                                      torch.from_numpy(ld), torch.from_numpy(dist),
                                      cfg.shadow_w).numpy()
                    plain = shadow_march(make_scene_sdf(structure), params, torch.from_numpy(so),
                                         torch.from_numpy(ld), torch.from_numpy(dist), cfg,
                                         init_done=torch.from_numpy(lit))
                for a, b in zip(got, plain):
                    np.testing.assert_array_equal(a, b.numpy())
                for x in (got, want):
                    assert (x[0][lit] == 1.0).all() and (x[1][lit] == 0.0).all()
                culled += int(lit.sum())
        fin = np.isfinite(want[0])
        np.testing.assert_array_equal(np.isfinite(got[0]), fin)
        np.testing.assert_array_equal(got[0][~fin], want[0][~fin])
        np.testing.assert_allclose(got[0][fin], want[0][fin], atol=5e-5, rtol=1e-4)
        np.testing.assert_allclose(got[1], want[1], atol=5e-5, rtol=1e-4)
    if case == "scene4":
        assert culled > 0, "the segment cull marked no shadow ray"


def test_march_wrappers_take_the_plain_versions_on_the_cpu(examples, instanced):
    """On CPU tensors march_values / shadow_values are their plain
    versions, bitwise, and launch nothing."""
    for jscene, structure, params in (examples["scene2.lol"], instanced):
        cfg = RenderConfig(step_clamp=2.0)
        ro, rd = (torch.from_numpy(a) for a in _rays(jscene, cfg, 6, 10))
        scene = pack_march_scene(structure, params)
        before = dict(march_kernels.launches)
        got, want = (f(structure, cfg, ro, rd, scene)
                     for f in (march_values, march_values_reference))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        dist = torch.full(rd.shape[:-1], 5.0)
        got, want = (f(structure, cfg, ro + rd, rd, dist, scene)
                     for f in (shadow_values, shadow_values_reference))
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert march_kernels.launches == before


def _grads(render_fn, params, target, keep=1.0):
    """The image and {field: d mean(keep * (img - target)^2) / d field} as
    numpy."""
    leaves = SceneParams(**{f: getattr(params, f).detach().clone().requires_grad_(True)
                            for f in FIELDS})
    with flush_denormals():
        img = render_fn(leaves)
        (keep * (img - target) ** 2).mean().backward()
    return img.detach().numpy(), {
        f: (v.grad if v.grad is not None else torch.zeros_like(v)).numpy()
        for f, v in vars(leaves).items()}


def test_render_image_matches_jax_with_pallas_marches(examples):
    """render_image (march_backend "jnp": the plain loops the kernels are
    held to) vs the JAX renderer with both Pallas marches in interpret
    mode, scene4 at 16x48 with antialiasing and envelope shadows: image
    atol 5e-5, MSE gradients atol 1e-4 / rtol 1e-3 (tests/test_pallas_march.py:
    86, 107). The penumbra band is masked out of the loss
    (tests/_penumbra.py): there the two packages' argmins t* flip on
    near-ties, which moves the envelope gradient by up to ~10 % of its
    scale (against the JAX package's jnp march as much as against its
    Pallas one); outside it the two agree to ~1e-7 of it."""
    jscene, structure, params = examples["scene4.lol"]
    h, w = 16, 48
    cfg = RenderConfig(antialias=True, shadow_grad="envelope", march_backend="jnp")
    cam = camera_pack(params, h, w, cfg)
    with flush_denormals():
        _, res = train_forward_reference(structure, cfg, cam, pack_fields(structure, params),
                                         h, w)
    keep = (~penumbra_pixels(res.numpy(), structure.num_lights))[..., None].astype(np.float32)
    assert 0.2 < keep.mean() < 0.9
    target = np.full((h, w, 3), 0.5, np.float32)
    img, ours = _grads(lambda p: render_image(structure, p, h, w, cfg), params,
                       torch.from_numpy(target), torch.from_numpy(keep))
    jcfg = _jax_cfg(cfg, "pallas-interpret")

    def loss(p):
        img = jax_render_image(jscene.structure, p, h, w, jcfg)
        return jnp.mean(jnp.asarray(keep) * (img - target) ** 2)

    jimg = np.asarray(jax.jit(lambda p: jax_render_image(jscene.structure, p, h, w, jcfg))(
        jscene.params))
    ref = jax.jit(jax.grad(loss))(jscene.params)
    np.testing.assert_allclose(img, jimg, atol=5e-5, rtol=0)
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        if want.size:
            np.testing.assert_allclose(ours[f], want, atol=1e-4, rtol=1e-3, err_msg=f)
    assert np.abs(ours["sphere_point"]).max() > 0


def _shadow_loss_grads(structure, params, cfg, h=6, w=10):
    """Gradients of a weighted sum of the exact shadow march's res over
    scene3's hit points toward light 0, and the bytes autograd saved
    outside checkpointed regions."""
    leaves = SceneParams(**{f: getattr(params, f).detach().clone().requires_grad_(True)
                            for f in FIELDS})
    sdf = make_scene_sdf(structure)
    ro, rd = camera_rays(leaves, h, w, cfg)
    t = march_values_reference(structure, cfg, ro, rd, pack_march_scene(structure, params)).t
    p = ro + t[..., None] * rd
    to_light = leaves.light_point[0] - p
    light_dir = normalize(to_light)
    weights = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (h, w)).astype(np.float32))
    (res, _), saved = _saved_bytes(lambda: shadow_march(
        sdf, leaves, p + light_dir * cfg.shadow_offset, light_dir,
        torch.sqrt(dot(to_light, to_light)), cfg))
    (torch.clamp_min(res, 0.0) * weights).sum().backward()
    return {f: getattr(leaves, f).grad for f in FIELDS}, saved


@pytest.fixture()
def straight(monkeypatch):
    """Call to make shading's per-step checkpoint run its step straight."""
    from loltracer_tpu_torch.render import shading

    return lambda: monkeypatch.setattr(shading, "checkpoint", lambda fn, *args, **kw: fn(*args))


def test_exact_shadow_checkpoint_keeps_gradients_bitwise(examples, straight):
    """The exact estimator with each shadow step checkpointed vs the loop
    differentiated straight: bitwise the same gradients; with the
    checkpoints, autograd keeps a fraction of the bytes outside them (one
    carry per step)."""
    _, structure, params = examples["scene3.lol"]
    cfg = RenderConfig()
    with_ckpt, saved_ckpt = _shadow_loss_grads(structure, params, cfg)
    straight()
    without, saved_plain = _shadow_loss_grads(structure, params, cfg)
    for f in FIELDS:
        a, b = with_ckpt[f], without[f]
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b), f
    assert with_ckpt["light_point"].abs().max() > 0
    assert saved_ckpt * 5 < saved_plain, (saved_ckpt, saved_plain)


def test_exact_render_checkpoint_keeps_gradients_bitwise(examples, straight):
    """render_image with exact shadows: the same gradients bitwise with the
    per-step checkpoint and with the loop differentiated straight."""
    _, structure, params = examples["scene3.lol"]
    cfg = RenderConfig(antialias=True)
    target = torch.full((6, 10, 3), 0.5)
    _, with_ckpt = _grads(lambda p: render_image(structure, p, 6, 10, cfg), params, target)
    straight()
    _, without = _grads(lambda p: render_image(structure, p, 6, 10, cfg), params, target)
    for f in FIELDS:
        np.testing.assert_array_equal(with_ckpt[f], without[f], err_msg=f)


def _saved_bytes(fn):
    """fn() and the bytes autograd saved for its backward outside
    checkpointed regions."""
    saved = [0]

    def pack(x):
        saved[0] += x.numel() * x.element_size()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = fn()
    return out, saved[0]


def test_banded_render_checkpoints_each_band(examples):
    """render_image_banded under autograd: the image render_image's (to
    1e-6: torch's CPU kernels take their vectorised or their scalar path
    for a transcendental by the batch's length, 1 ulp apart; on CUDA the
    bands are bitwise the frame's rows), gradients equal up to the order
    of the sum over pixels (1e-5 * scale), and outside the per-band
    checkpoints autograd saves almost nothing."""
    _, structure, params = examples["scene4.lol"]
    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    target = torch.full((9, 12, 3), 0.5)
    img_b, banded = _grads(lambda p: render_image_banded(structure, p, 9, 12, cfg, 4), params,
                           target)
    img, whole = _grads(lambda p: render_image(structure, p, 9, 12, cfg), params, target)
    np.testing.assert_allclose(img_b, img, atol=1e-6, rtol=0)
    for f in FIELDS:
        scale = max(np.abs(whole[f]).max(initial=0.0), 1e-6)
        np.testing.assert_allclose(banded[f], whole[f], atol=1e-5 * scale, rtol=0, err_msg=f)
    leaves = SceneParams(**{f: getattr(params, f).detach().clone().requires_grad_(True)
                            for f in FIELDS})
    _, saved_banded = _saved_bytes(
        lambda: render_image_banded(structure, leaves, 9, 12, cfg, 4))
    _, saved_whole = _saved_bytes(lambda: render_image(structure, leaves, 9, 12, cfg))
    assert saved_banded * 10 < saved_whole, (saved_banded, saved_whole)


@pytest.mark.parametrize("shadow_grad", ["exact", "envelope"])
def test_differentiable_render_leaves_no_tensor_in_a_cycle(examples, shadow_grad):
    """After render_image's backward nothing of its graph waits for the
    garbage collector: no tensor sits in a reference cycle (a recursive
    closure in the plain SDF once kept every evaluation's graph alive, ~60
    GB at scene4 @1080p with exact shadows)."""
    import gc

    _, structure, params = examples["scene4.lol"]
    cfg = RenderConfig(antialias=True, shadow_grad=shadow_grad)
    leaves = SceneParams(**{f: getattr(params, f).detach().clone().requires_grad_(True)
                            for f in FIELDS})
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        img = render_image(structure, leaves, 6, 10, cfg)
        ((img - 0.5) ** 2).mean().backward()
        del img
        gc.collect()
        cycled = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert leaves.sphere_point.grad is not None
    assert not cycled, f"{len(cycled)} tensors in reference cycles"


def test_march_backend_resolver():
    cpu = torch.zeros(3)
    assert resolve_march_backend("auto", cpu) == "jnp"
    assert resolve_march_backend("jnp", cpu) == "jnp"
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_march_backend("pallas", cpu)
    with pytest.raises(ValueError, match="interpreter"):
        resolve_march_backend("pallas-interpret", cpu)
    with pytest.raises(ValueError, match="unknown"):
        resolve_march_backend("triton", cpu)
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        resolve_march_backend("auto", cpu, meta)


@pytest.fixture()
def kernels_selected(monkeypatch):
    """The resolver as on the card ("auto" and "pallas" name the kernels,
    whatever the device) and the kernels' factories recording their use:
    what a CPU run can show of the selection."""
    used = []
    monkeypatch.setattr(torch_renderer, "resolve_march_backend",
                        lambda backend, *tensors: "jnp" if backend == "jnp" else "pallas")
    for name in ("make_cuda_march", "make_cuda_shadow_march"):
        real = getattr(march_kernels, name)
        monkeypatch.setattr(march_kernels, name,
                            lambda s, c, _real=real, _name=name: used.append(_name) or _real(s, c))
    return used


def test_render_rays_selects_the_kernels_as_jax_does(examples, kernels_selected):
    """Under a resolver that picks the kernels: K3 for "exact", K3 and K4
    (once per light) for "envelope"; counting live rays raises."""
    _, structure, params = examples["scene4.lol"]
    render_image(structure, params, 4, 6, RenderConfig())
    assert kernels_selected == ["make_cuda_march"]
    kernels_selected.clear()
    render_image(structure, params, 4, 6, RenderConfig(shadow_grad="envelope"))
    assert kernels_selected == ["make_cuda_march", "make_cuda_shadow_march"]
    kernels_selected.clear()
    render_image(structure, params, 4, 6, RenderConfig(march_backend="jnp"))
    assert kernels_selected == []
    ro, rd = camera_rays(params, 4, 6, RenderConfig())
    with pytest.raises(ValueError, match="live"):
        torch_renderer.render_rays(structure, params, ro, rd, RenderConfig(),
                                   live={"march": []})


def test_plain_versions_of_earlier_kernels_run_no_march_kernel(examples, instanced,
                                                                kernels_selected):
    """fused_forward_reference and instanced_forward_reference pin the
    plain loops: under a resolver that would pick the kernels they select
    none and launch none."""
    _, structure, params = examples["scene4.lol"]
    launches = dict(march_kernels.launches)
    for cfg in (RenderConfig(), RenderConfig(antialias=True, shadow_grad="envelope")):
        cam = camera_pack(params, 4, 6, cfg)
        fused_fwd.fused_forward_reference(structure, cfg, cam, pack_fields(structure, params),
                                          4, 6)
    _, ist, iparams = instanced
    cfg = RenderConfig(step_clamp=2.0, shadow_grad="envelope")
    instanced_fwd.instanced_forward_reference(
        ist, cfg, camera_pack(iparams, 4, 6, cfg), pack_fields(ist, iparams),
        pack_instanced(ist, iparams), 4, 6, live={"march": [], "shadow": []})
    assert kernels_selected == []
    assert march_kernels.launches == launches
