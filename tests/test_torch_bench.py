"""The port's benchmark (loltracer_tpu_torch/bench.py and `cli bench`)
against the root bench.py, the JAX package's, on the CPU:

- every override's default is bench.py's, and the settings give the
  RenderConfig bench.py builds;
- each route of bench.py:112-197 takes the port's renderer for it, with
  bench.py's label and metric string; the metric equals the one bench.py
  prints for the same settings (bench.py's `main()` run once, at 16x8 on a
  jnp route);
- the timed scalar at a few rows of scene4 and of instanced_spheres(150,
  seed=3) against the JAX package's `render_image` / `value_and_grad` on
  the same params: the image within atol 5e-5 (tests/test_train.py:50);
  fwd's sum(image) within 5e-5 per pixel channel; fwdbwd's gradients within
  1e-4 * max|g| per field (tests/test_torch_train.py's backward rule) with
  the penumbra band masked out of the loss. The envelope estimator's
  argmin near-ties flip between two float32 compilations in that band
  (tests/_penumbra.py), an O(1) change of a pixel's gradient, so every
  gradient suite of the repo masks it; the fwdbwd scalar is held to
  bench.py's formula over the route's own image and gradients, and its
  masked twin to JAX's within the bound the two tolerances give;
- `cli bench` prints the detail line and the record on the CPU, raises
  for `--device cuda` without CUDA, and a card run whose kernels did not
  launch fails;
- the module imports neither jax nor anything of the JAX package.

The port runs under flush-denormal, as XLA on the CPU does."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.render.jnp_renderer import render_image as jax_render_image
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu_torch import bench, cli
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render import (
    cuda_renderer,
    fused_train,
    instanced_train,
    regroup,
    torch_renderer,
)
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.scene import FIELDS, SceneParams, build_scene
from loltracer_tpu_torch.scenes import instanced_spheres

from _penumbra import penumbra_pixels
from test_torch_train import flush_denormals

torch.set_num_threads(1)  # one intra-op thread per pytest worker

ROOT = Path(__file__).resolve().parent.parent
SCENE4 = str(ROOT / "examples" / "scene4.lol")
H, W = 8, 32  # a few rows
IMG_ATOL = 5e-5
GRAD_RTOL = 1e-4  # of max|g| per field


def _settings(**env):
    return bench.Settings.from_env({k: str(v) for k, v in env.items()})


# --- the settings ---------------------------------------------------------------


def test_defaults_are_bench_pys():
    s = bench.Settings.from_env({})
    assert s == bench.Settings(
        scene="examples/scene4.lol", width=1920, height=1080, mode="fwdbwd", reps=5,
        shadow_grad="envelope", antialias=False, march="auto", clamp=2.0, shadow_cull=True,
        scratch_window=True, shadow_steps=None, max_steps=None, scratch_rows=None,
        backend=None, band=16, regroup=False, frames=None)
    compiled = build_scene(parse_scene_file(SCENE4), device="cpu").structure
    inst = instanced_spheres(n=3, device="cpu").structure
    # the clamp applies to instanced scenes only (bench.py:83)
    assert bench.render_config(s, compiled) == RenderConfig(shadow_grad="envelope")
    assert bench.render_config(s, inst) == RenderConfig(shadow_grad="envelope", step_clamp=2.0)
    # BENCH_BACKEND: the kernels where "auto" resolves to them, else jnp
    # (bench.py:104-108); CPU tensors resolve to the plain loops
    b = bench.build(_settings(BENCH_W=4, BENCH_H=2), "cpu")
    assert b.label == "jnp" and b.frames == 8
    b = bench.build(_settings(BENCH_SCENE="instanced:3", BENCH_W=4, BENCH_H=2), "cpu")
    assert b.label == "banded-jnp-march" and b.frames == 1


@pytest.mark.parametrize("value,clamp", [("none", None), ("None", None), ("0", None),
                                         ("", None), ("8", 8.0), ("0.5", 0.5)])
def test_clamp_override(value, clamp):
    assert _settings(BENCH_CLAMP=value).clamp == clamp


def test_overrides_make_bench_pys_config():
    """Every override at a value other than its default: the config equals
    the JAX package's RenderConfig built as bench.py:79-97 builds it."""
    env = dict(BENCH_SHADOW_GRAD="exact", BENCH_AA=1, BENCH_MARCH="jnp", BENCH_CLAMP=3,
               BENCH_SHADOW_CULL=0, BENCH_SCRATCH_WINDOW=0, BENCH_SHADOW_STEPS=40,
               BENCH_MAX_STEPS=100, BENCH_SCRATCH_ROWS=4096, BENCH_REPS=2, BENCH_BAND=8,
               BENCH_REGROUP=1, BENCH_FRAMES_PER_FETCH=3, BENCH_BACKEND="pallas",
               BENCH_MODE="fwd", BENCH_W=64, BENCH_H=32, BENCH_SCENE="instanced:7")
    s = _settings(**env)
    assert (s.reps, s.band, s.regroup, s.frames, s.backend, s.mode, s.width, s.height,
            s.scene) == (2, 8, True, 3, "pallas", "fwd", 64, 32, "instanced:7")
    inst = instanced_spheres(n=7, device="cpu").structure
    want = JaxRenderConfig(shadow_grad="exact", antialias=True, march_backend="jnp",
                           step_clamp=3.0, shadow_cull=False, scratch_window=False)
    want = want.replace(shadow_steps=40).replace(max_steps=100).replace(shadow_scratch=4096)
    assert dataclasses.asdict(bench.render_config(s, inst)) == dataclasses.asdict(want)


# --- the routes -----------------------------------------------------------------


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


LOL, INST = SCENE4, "instanced:150"
ROUTES = [
    # (id, overrides, label, the renderer called, the kernels on the card)
    ("fwd-lol-pallas", dict(BENCH_SCENE=LOL, BENCH_MODE="fwd", BENCH_BACKEND="pallas"),
     "pallas", "make_cuda_renderer", [("fused_fwd", "lol_render_fused")]),
    ("fwd-inst-pallas", dict(BENCH_SCENE=INST, BENCH_MODE="fwd", BENCH_BACKEND="pallas"),
     "pallas-fused-instanced", "make_instanced_renderer",
     [("instanced_fwd", "lol_instanced_render")]),
    ("fwd-inst-regroup", dict(BENCH_SCENE=INST, BENCH_MODE="fwd", BENCH_BACKEND="pallas",
                              BENCH_REGROUP=1),
     "pallas-instanced-regrouped", "make_instanced_renderer_regrouped",
     [("regroup", "lol_rg_march"), ("regroup", "lol_rg_shadow"), ("regroup", "lol_rg_shade")]),
    ("fwd-lol-jnp", dict(BENCH_SCENE=LOL, BENCH_MODE="fwd", BENCH_BACKEND="jnp"),
     "jnp", "render_image", [("march_kernels", "lol_march"),
                             ("march_kernels", "lol_shadow_march")]),
    ("fwd-inst-jnp", dict(BENCH_SCENE=INST, BENCH_MODE="fwd", BENCH_BACKEND="jnp"),
     "banded-jnp-march", "render_image_banded",
     [("march_kernels", "lol_march_instanced"), ("march_kernels", "lol_shadow_march_instanced")]),
    ("fwdbwd-inst-jnp", dict(BENCH_SCENE=INST, BENCH_BACKEND="jnp"),
     "banded-jnp-march", "render_image_banded",
     [("march_kernels", "lol_march_instanced"), ("march_kernels", "lol_shadow_march_instanced")]),
    ("fwdbwd-lol-pallas", dict(BENCH_SCENE=LOL, BENCH_BACKEND="pallas"),
     "pallas", "make_training_renderer",
     [("fused_train", "lol_train_fwd"), ("fused_train", "lol_train_bwd")]),
    ("fwdbwd-inst-pallas", dict(BENCH_SCENE=INST, BENCH_BACKEND="pallas"),
     "pallas-fused-instanced", "make_instanced_training_renderer",
     [("instanced_train", "lol_instanced_fwd"), ("instanced_train", "lol_instanced_bwd")]),
    ("fwdbwd-lol-jnp", dict(BENCH_SCENE=LOL, BENCH_BACKEND="jnp"),
     "jnp", "render_image", [("march_kernels", "lol_march"),
                             ("march_kernels", "lol_shadow_march")]),
    # the instanced scene's default backend on the CPU, BENCH_REGROUP ignored
    # outside the fused forward (bench.py:135-140), an exact clamp, exact
    # shadows (no K4), the plain march (no kernel)
    ("fwd-inst-default", dict(BENCH_SCENE=INST, BENCH_MODE="fwd", BENCH_REGROUP=1),
     "banded-jnp-march", "render_image_banded",
     [("march_kernels", "lol_march_instanced"), ("march_kernels", "lol_shadow_march_instanced")]),
    ("fwd-inst-exact", dict(BENCH_SCENE=INST, BENCH_MODE="fwd", BENCH_BACKEND="pallas",
                            BENCH_CLAMP="none"),
     "pallas-fused-instanced", "make_instanced_renderer",
     [("instanced_fwd", "lol_instanced_render")]),
    ("fwd-lol-jnp-exact-shadows", dict(BENCH_SCENE=LOL, BENCH_MODE="fwd",
                                       BENCH_SHADOW_GRAD="exact"),
     "jnp", "render_image", [("march_kernels", "lol_march"),
                             ("march_kernels", "lol_exact_shadow")]),
    ("fwd-lol-jnp-plain-march", dict(BENCH_SCENE=LOL, BENCH_MODE="fwd", BENCH_MARCH="jnp"),
     "jnp", "render_image", []),
]


@pytest.mark.parametrize("overrides,label,renderer,kernels",
                         [r[1:] for r in ROUTES], ids=[r[0] for r in ROUTES])
def test_route(monkeypatch, overrides, label, renderer, kernels):
    """build() takes the port's renderer of the route, with bench.py's
    label, metric string and frame count, and its frame runs."""
    calls = []
    for module, name in ((cuda_renderer, "make_cuda_renderer"),
                         (cuda_renderer, "make_instanced_renderer"),
                         (regroup, "make_instanced_renderer_regrouped"),
                         (fused_train, "make_training_renderer"),
                         (instanced_train, "make_instanced_training_renderer"),
                         (torch_renderer, "render_image"),
                         (torch_renderer, "render_image_banded")):
        _spy(monkeypatch, module, name, calls)
    s = _settings(BENCH_W=16, BENCH_H=4, **overrides)
    b = bench.build(s, "cpu")
    instanced = s.scene.startswith("instanced:")
    assert b.label == label and b.kernels == tuple(kernels)
    assert b.frames == (1 if instanced else 8) and b.rays == 16 * 4 * b.frames
    assert b.structure.instanced == instanced
    assert b.cfg.step_clamp == (s.clamp if instanced else None)
    # bench.py:250-261's format, the CPU's "rays/s/cpu" in place of "rays/s/chip"
    tags = (f" frames_per_fetch={b.frames}" if b.frames > 1 else "") + (
        f" shadow_grad={s.shadow_grad}" if s.mode == "fwdbwd" else "") + (
        f" clamp={s.clamp:g}" if instanced and s.clamp is not None else "")
    name = "scene4.lol" if not instanced else INST
    assert b.metric == f"rays/s/cpu {s.mode}/{label} {name} 16x4{tags}"
    with flush_denormals():
        value = b.fn()
    assert calls and set(calls) == {renderer}
    assert value.shape == () and torch.isfinite(value)
    assert all(getattr(b.params, f).requires_grad == (s.mode == "fwdbwd") for f in FIELDS)


def test_bad_settings_raise():
    with pytest.raises(ValueError, match="BENCH_MODE"):
        bench.build(_settings(BENCH_MODE="bwd", BENCH_W=4, BENCH_H=2), "cpu")
    with pytest.raises(ValueError, match="BENCH_BACKEND"):
        bench.build(_settings(BENCH_BACKEND="xla", BENCH_W=4, BENCH_H=2), "cpu")
    with pytest.raises(ValueError, match="BENCH_REPS"):
        bench.build(_settings(BENCH_REPS=0, BENCH_W=4, BENCH_H=2), "cpu")


def test_metric_equals_jax_bench(monkeypatch):
    """bench.py's main() at 16x8 on scene4 fwd (the jnp route on the CPU)
    prints the metric that the port's record carries on the card, and the
    same keys; the port's CPU run prints it with rays/s/cpu."""
    env = dict(BENCH_SCENE="examples/scene4.lol", BENCH_W="16", BENCH_H="8", BENCH_MODE="fwd",
               BENCH_REPS="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # bench.py's enable_cache(): keep the tests' compile cache
    monkeypatch.setenv("LOLTRACER_CACHE", str(ROOT / ".jax_cache"))
    monkeypatch.chdir(ROOT)
    spec = importlib.util.spec_from_file_location("jax_bench", ROOT / "bench.py")
    jax_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_bench)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_bench.main()
    want = json.loads(buf.getvalue().strip().splitlines()[-1])

    b = bench.build(bench.Settings.from_env(env), "cpu")
    assert bench.metric(b.settings, b.label, b.frames, False, "cuda") == want["metric"]
    assert want["metric"] == "rays/s/chip fwd/jnp scene4.lol 16x8 frames_per_fetch=8"
    detail, record = bench.run(b)
    assert set(record) == set(want)
    assert record["metric"] == want["metric"].replace("rays/s/chip", "rays/s/cpu", 1)


# --- the timed scalar against the JAX package -----------------------------------------


@pytest.fixture(scope="module")
def scenes():
    """{key: (JAX scene, port scene)}: scene4 and instanced_spheres(150, seed=3)."""
    return {
        "scene4": (jlt.build_scene(jlt.parse_scene_file(SCENE4)),
                   build_scene(parse_scene_file(SCENE4), device="cpu")),
        "instanced": (jax_instanced_spheres(n=150, seed=3),
                      instanced_spheres(n=150, seed=3, device="cpu")),
    }


def _jax_render(jscene, cfg: RenderConfig):
    jcfg = JaxRenderConfig(**{**dataclasses.asdict(cfg), "march_backend": "jnp"})
    return lambda p: jax_render_image(jscene.structure, p, H, W, jcfg)


def _build(tscene, key, **overrides):
    s = _settings(BENCH_W=W, BENCH_H=H, BENCH_SCENE="instanced:150" if key == "instanced"
                  else SCENE4, **overrides)
    return bench.build(s, "cpu", scene=tscene)


FWD = [("scene4", "pallas"), ("scene4", "jnp"), ("instanced", "pallas"),
       ("instanced", "regroup"), ("instanced", "jnp")]


@pytest.mark.parametrize("key,route", FWD, ids=[f"{k}-{r}" for k, r in FWD])
def test_fwd_scalar_matches_jax(scenes, key, route):
    """sum(image): the image within atol 5e-5 of JAX's render_image, the
    scalar within 5e-5 a pixel channel of JAX's sum."""
    jscene, tscene = scenes[key]
    over = dict(BENCH_MODE="fwd", BENCH_BACKEND="jnp" if route == "jnp" else "pallas")
    if route == "regroup":
        over["BENCH_REGROUP"] = 1
    b = _build(tscene, key, **over)
    with flush_denormals():
        img = b.render(b.params)
        got = b.fn()
    assert torch.equal(got, torch.sum(img))
    jimg = np.asarray(jax.jit(_jax_render(jscene, b.cfg))(jscene.params))
    np.testing.assert_allclose(img.numpy(), jimg, atol=IMG_ATOL, rtol=0)
    assert abs(got.item() - float(jnp.sum(jimg))) <= IMG_ATOL * jimg.size


def _penumbra_keep(b, tscene):
    """[H, W, 1] float: 0 on the penumbra band of the route's scene (the
    residual planes of the training forward's plain version), else 1."""
    cfg = b.cfg.replace(march_backend="jnp")
    cam, fields = camera_pack(tscene.params, H, W, cfg), pack_fields(tscene.structure,
                                                                      tscene.params)
    with flush_denormals():
        if tscene.structure.instanced:
            _, res = instanced_train.instanced_train_forward_reference(
                tscene.structure, cfg, cam, fields, pack_instanced(tscene.structure,
                                                                   tscene.params), H, W)
        else:
            _, res = fused_train.train_forward_reference(tscene.structure, cfg, cam, fields, H, W)
    pen = penumbra_pixels(res.numpy(), tscene.structure.num_lights)
    return (~pen).astype(np.float32)[..., None]


def _port_scalar(b, keep):
    """(scalar, image, {field: grad}) of mean(keep * image ** 2) + the sum
    of every squared gradient, through the route's renderer."""
    leaves = SceneParams(**{f: getattr(b.params, f).detach().clone().requires_grad_(True)
                            for f in FIELDS})
    with flush_denormals():
        img = b.render(leaves)
        loss = torch.mean(torch.from_numpy(keep) * img * img)
        loss.backward()
    grads = {f: np.zeros(tuple(getattr(leaves, f).shape), np.float32)
             if getattr(leaves, f).grad is None else getattr(leaves, f).grad.numpy()
             for f in FIELDS}
    return loss.item() + sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()), \
        img.detach().numpy(), grads


def _jax_scalar(render, params, keep):
    loss, g = jax.jit(jax.value_and_grad(lambda p: jnp.mean(keep * render(p) ** 2)))(params)
    grads = {f: np.asarray(getattr(g, f)) for f in FIELDS}
    return float(loss) + sum(float(np.sum(x.astype(np.float64) ** 2))
                             for x in grads.values()), grads


FWDBWD = [("scene4", "pallas"), ("scene4", "jnp"), ("instanced", "pallas"),
          ("instanced", "jnp")]


@pytest.mark.parametrize("key,route", FWDBWD, ids=[f"{k}-{r}" for k, r in FWDBWD])
def test_fwdbwd_scalar_matches_jax(scenes, key, route):
    """loss + sum of squared gradients, envelope shadows: the route's
    scalar is bench.py's formula over its own image and gradients (rtol
    1e-6: float32 sums in another order); the image within atol 5e-5 of
    JAX's; with the penumbra band masked out of the loss, every field's
    gradient within 1e-4 * max|g| of jax.grad's and the scalar within the
    bound those two give: 2 * 5e-5 for the loss, and per field
    sum(2 |g| d + d ** 2) with d = 1e-4 * max|g|."""
    jscene, tscene = scenes[key]
    b = _build(tscene, key, BENCH_BACKEND=route)
    with flush_denormals():
        got = b.fn().item()
    ones = np.ones((H, W, 1), np.float32)
    want, img, _ = _port_scalar(b, ones)
    assert got == pytest.approx(want, rel=1e-6)
    render = _jax_render(jscene, b.cfg)
    np.testing.assert_allclose(img, np.asarray(jax.jit(render)(jscene.params)), atol=IMG_ATOL,
                               rtol=0)

    keep = _penumbra_keep(b, tscene)
    assert 0 < keep.sum() < keep.size
    ours, _, grads = _port_scalar(b, keep)
    ref, jgrads = _jax_scalar(render, jscene.params, keep)
    bound = 2 * IMG_ATOL
    for f in FIELDS:
        g, jg = grads[f], jgrads[f]
        if not jg.size:
            continue
        d = GRAD_RTOL * max(np.abs(jg).max(), 1e-30)
        np.testing.assert_allclose(g, jg, atol=d, rtol=0, err_msg=f)
        bound += float(np.sum(2 * np.abs(jg).astype(np.float64) * d + d * d))
    assert np.abs(grads["cam_point"]).max() > 0
    assert abs(ours - ref) <= bound


# --- the command ----------------------------------------------------------------


def test_cli_bench_prints_the_record_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_REPS", "2")
    monkeypatch.delenv("BENCH_SCENE", raising=False)
    monkeypatch.delenv("BENCH_MODE", raising=False)
    assert cli.main(["bench", str(ROOT / "examples" / "scene.lol"), "--size", "8x4", "--mode",
                     "fwd", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    detail, record = json.loads(lines[-2]), json.loads(lines[-1])
    assert record["metric"] == "rays/s/cpu fwd/jnp scene.lol 8x4 frames_per_fetch=8"
    assert record["unit"] == "rays/s"
    rays_per_s = 8 * 4 * 8 / (detail["best_ms"] / 1e3)
    assert record["value"] == round(rays_per_s, 1)
    assert record["vs_baseline"] == round(rays_per_s / 518186.3, 3)
    assert len(detail["samples_ms"]) == 2 and detail["best_ms"] == min(detail["samples_ms"])
    assert detail["frames"] == 8 and detail["card"] is None
    # the plain versions launch nothing
    assert not any(n for fam in detail["launches"].values() for n in fam.values())
    assert set(detail["launches"]) == {"fused_fwd", "fused_train", "instanced_fwd",
                                       "instanced_train", "regroup", "march_kernels"}


def test_cli_bench_env_wins_over_the_arguments_but_size(monkeypatch, capsys):
    """JAX's cmd_bench: BENCH_SCENE / BENCH_MODE set in the environment
    win over the positional scene and --mode (setdefault); --size sets
    BENCH_W / BENCH_H; the environment is left as it was."""
    monkeypatch.setenv("BENCH_REPS", "1")
    monkeypatch.setenv("BENCH_SCENE", str(ROOT / "examples" / "scene2.lol"))
    monkeypatch.setenv("BENCH_MODE", "fwd")
    monkeypatch.setenv("BENCH_W", "99")
    assert cli.main(["bench", "examples/scene.lol", "--size", "8x4", "--mode", "fwdbwd",
                     "--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["metric"] == "rays/s/cpu fwd/jnp scene2.lol 8x4 frames_per_fetch=8"
    assert __import__("os").environ["BENCH_W"] == "99"


def test_cli_bench_on_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["bench", str(ROOT / "examples" / "scene.lol"), "--size", "8x4"])


def test_a_card_run_whose_kernels_did_not_launch_fails(monkeypatch):
    """run() on the card checks the counters: a route whose kernel did not
    launch (here the plain version ran) raises instead of timing it."""
    b = bench.build(_settings(BENCH_SCENE=SCENE4, BENCH_W=8, BENCH_H=4, BENCH_MODE="fwd",
                              BENCH_BACKEND="pallas", BENCH_REPS=1), "cpu")
    b = dataclasses.replace(b, device=torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(bench, "samples_ms", lambda b, reps: [1.0] * reps)
    monkeypatch.setattr(bench, "card_line", lambda: "a card, 700.00 W")
    with pytest.raises(RuntimeError, match="lol_render_fused.*did not launch"):
        bench.run(b)


def test_imports_no_jax():
    """bench.py and the CLI import neither jax nor the JAX package, by
    their text and in a fresh interpreter."""
    tree = ast.parse((ROOT / "loltracer_tpu_torch" / "bench.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "loltracer_tpu")]
    code = ("import sys; import loltracer_tpu_torch.bench, loltracer_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'loltracer_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
