"""The port's roofline model (loltracer_tpu_torch/utils/roofline.py and
`cli roofline`) against the JAX package's: the same operation counts, and
the same record at the JAX package's own tile to rtol 1e-12; its own
defaults (the card's warp as the tile, the H100's modelled ceiling
without a measured one)."""

import json

import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.render.pallas_scene import resolve_tile
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu.utils import roofline as jroof
from loltracer_tpu_torch import cli
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.scene import build_scene
from loltracer_tpu_torch.scenes import instanced_spheres
from loltracer_tpu_torch.utils import peak, roofline

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
JAX_KEYS = ("sdf_eval_cost_weighted_ops", "march_evals", "shadow_evals", "total_weighted_ops",
            "achieved_ops_per_s", "peak_ops_per_s", "peak_source", "fraction_of_peak")


def _structures(examples_dir, name):
    if name == "instanced":
        return (jax_instanced_spheres(n=150, seed=3).structure,
                instanced_spheres(n=150, seed=3, device="cpu").structure)
    path = str(examples_dir / name)
    return (jlt.build_scene(jlt.parse_scene_file(path)).structure,
            build_scene(parse_scene_file(path), device="cpu").structure)


@pytest.mark.parametrize("name", SCENES + ["instanced"])
def test_op_costs_match_jax(examples_dir, name):
    jst, st = _structures(examples_dir, name)
    assert [roofline.node_op_cost(n) for n in st.objects] == [
        jroof.node_op_cost(n) for n in jst.objects]
    assert roofline.sdf_eval_cost(st) == jroof.sdf_eval_cost(jst)
    assert roofline.TRANSCENDENTAL_WEIGHT == jroof.TRANSCENDENTAL_WEIGHT == 4.0


@pytest.mark.parametrize("mode", ["fwd", "fwdbwd"])
def test_estimate_matches_jax_at_its_tile(examples_dir, mode):
    h, w = 48, 64
    path = str(examples_dir / "scene4.lol")
    jscene = jlt.build_scene(jlt.parse_scene_file(path))
    scene = build_scene(parse_scene_file(path), device="cpu")
    jcfg = JaxRenderConfig()
    tile = resolve_tile(jcfg, False, h, jscene.structure.num_lights)
    want = jroof.roofline_estimate(jscene.structure, jscene.params, h, w, 0.0125, jcfg,
                                   peak_flops=5e13, mode=mode)
    got = roofline.roofline_estimate(scene.structure, scene.params, h, w, 0.0125,
                                     RenderConfig(), peak_flops=5e13, mode=mode, tile=tile)
    assert set(got) == set(JAX_KEYS) | {"tile"} and got["tile"] == list(tile)
    assert got["peak_source"] == want["peak_source"] == "explicit"
    for k in JAX_KEYS:
        if k != "peak_source":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)


def test_defaults_are_the_cards(examples_dir, monkeypatch):
    """The tile is the card's warp (8 x 4 pixels); without a measured
    record the peak is the H100's modelled FP32 ceiling, not the TPU's."""
    scene = build_scene(parse_scene_file(str(examples_dir / "scene3.lol")), device="cpu")
    monkeypatch.setattr(peak, "load_measured_peak", lambda *a, **k: None)
    rec = roofline.roofline_estimate(scene.structure, scene.params, 12, 16, 1e-3)
    assert rec["tile"] == [4, 8] == list(roofline.WARP_TILE)
    assert rec["peak_source"] == "modeled_constant"
    assert rec["peak_ops_per_s"] == 132 * 128 * 2 * 1.98e9 == roofline.H100_FP32_PEAK
    assert rec["peak_ops_per_s"] != jroof.V5E_VPU_PEAK_F32
    monkeypatch.setattr(peak, "load_measured_peak", lambda *a, **k: 6.5e13)
    rec = roofline.roofline_estimate(scene.structure, scene.params, 12, 16, 1e-3)
    assert rec["peak_source"] == "measured_artifact" and rec["peak_ops_per_s"] == 6.5e13


@pytest.mark.parametrize("mode", ["fwd", "fwdbwd"])
def test_cli_roofline_prints_the_record(examples_dir, capsys, mode):
    assert cli.main(["roofline", str(examples_dir / "scene.lol"), "--size", "16x12",
                     "--device", "cpu", "--reps", "2", "--mode", mode]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert set(rec) == set(JAX_KEYS) | {"tile", "measured_seconds", "rays_per_s"}
    assert rec["measured_seconds"] > 0 and rec["fraction_of_peak"] > 0
    assert rec["rays_per_s"] == pytest.approx(16 * 12 / rec["measured_seconds"])
    assert rec["tile"] == [4, 8]


def test_cli_roofline_on_cuda_without_cuda_raises(examples_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["roofline", str(examples_dir / "scene.lol"), "--size", "16x12"])
