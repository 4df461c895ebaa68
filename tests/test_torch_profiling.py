"""The port's step counts and row-sharding cost model
(loltracer_tpu_torch/utils/profiling.py) against the JAX package's
(tests/test_profiling.py, case for case, and utils/profiling.py), on the
CPU:

- march and shadow step counts on the four examples at 24x32 and on an
  instanced scene equal JAX's on all but max(2, 1e-3 * pixels) pixels,
  and off by at most 1 there;
- `march_step_stats`, `band_balance`, `block_row_costs` and
  `shard_balance` (snake, LPT, compiled and instanced) against JAX's;
- the contiguous fallback of `shard_balance` where JAX's raises (rows
  that do not split into equal tile-row bands): each shard costs the tile
  rows its own rows fall in, worked out from `block_row_costs`;
- `trace` names the renderer's stages, and `cli stats` prints
  `march_step_stats`."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per pytest worker

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]


def _scenes(name):
    """(JAX scene, port scene) of an example or of `instanced:N`."""
    from loltracer_tpu.lol import parse_scene_file as jax_parse
    from loltracer_tpu.scene import build_scene as jax_build
    from loltracer_tpu.scenes import instanced_spheres as jax_instanced

    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    if name.startswith("instanced:"):
        n = int(name.split(":")[1])
        return jax_instanced(n=n, seed=4), instanced_spheres(n=n, seed=4, device="cpu")
    path = str(EXAMPLES / name)
    return jax_build(jax_parse(path)), build_scene(parse_scene_file(path), device="cpu")


def _check_counts(got, want, what):
    """Equal on all but max(2, 1e-3 * pixels) pixels, off by at most 1."""
    assert got.shape == want.shape and got.dtype == np.int32, what
    diff = np.abs(got.astype(np.int64) - want)
    pixels = want.shape[-1] * want.shape[-2]
    assert diff.max() <= 1 and (diff > 0).sum() <= max(2, 1e-3 * pixels), (
        f"{what}: {(diff > 0).sum()} pixels differ, by up to {diff.max()}")


@pytest.mark.parametrize("name", SCENES + ["instanced:150"])
def test_step_counts_match_jax(name):
    from loltracer_tpu.config import RenderConfig as JaxRenderConfig
    from loltracer_tpu.utils import profiling as jax_profiling

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.utils import profiling

    jscene, scene = _scenes(name)
    h, w = 24, 32
    # a step clamp is ignored by the counts, in both packages
    cfg, jcfg = RenderConfig(step_clamp=2.0), JaxRenderConfig(step_clamp=2.0)
    for fn in ("march_step_counts", "shadow_step_counts"):
        got = getattr(profiling, fn)(scene.structure, scene.params, h, w, cfg)
        want = np.asarray(getattr(jax_profiling, fn)(jscene.structure, jscene.params, h, w,
                                                     jcfg))
        _check_counts(got, want, f"{name} {fn}")
        assert got.min() >= 1 and got.max() > got.min()


def test_step_counts_bounded_and_varied():
    from loltracer_tpu_torch.utils.profiling import march_step_counts

    _, scene = _scenes("scene.lol")
    steps = march_step_counts(scene.structure, scene.params, 24, 32)
    assert steps.shape == (24, 32)
    assert steps.min() >= 1
    assert steps.max() <= 256
    assert steps.max() > steps.min()


def test_stats_summary_matches_jax():
    from loltracer_tpu.utils.profiling import march_step_stats as jax_stats

    from loltracer_tpu_torch.utils.profiling import march_step_stats

    jscene, scene = _scenes("scene3.lol")
    stats = march_step_stats(scene.structure, scene.params, 16, 128)
    want = jax_stats(jscene.structure, jscene.params, 16, 128)
    assert list(stats) == list(want)
    assert 1 <= stats["mean_steps"] <= 256
    assert stats["p50_steps"] <= stats["p99_steps"] <= stats["max_steps"]
    assert stats["tile_waste"] >= 1.0 and stats["tile_waste_64x128"] is None
    for k, v in want.items():
        if v is None:
            assert stats[k] is None, k
        else:
            assert stats[k] == pytest.approx(v, rel=1e-3), k


def test_max_steps_config_respected():
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.utils.profiling import march_step_counts

    _, scene = _scenes("scene.lol")
    steps = march_step_counts(scene.structure, scene.params, 12, 16, RenderConfig(max_steps=16))
    assert steps.max() <= 16


def test_trace_names_the_renderer_stages(tmp_path):
    """The stages carry the JAX package's scope names in the profile
    (tests/test_profiling.py looks for them in the lowered HLO)."""
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render.torch_renderer import render_image
    from loltracer_tpu_torch.utils.profiling import trace

    _, scene = _scenes("scene.lol")
    with trace(str(tmp_path)), torch.no_grad():
        render_image(scene.structure, scene.params, 8, 16, RenderConfig(shadow_grad="envelope"))
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    text = files[0].read_text()
    for name in ("lol_march", "lol_shadow_march", "lol_normal", "lol_shade"):
        assert name in text, f"{name} missing from the trace"


def test_cost_model_matches_jax():
    """band_balance, block_row_costs (8- and 16-row blocks) and
    shard_balance (LPT and snake) against JAX's, scene3 at 32x128."""
    from loltracer_tpu.utils import profiling as jax_profiling

    from loltracer_tpu_torch.utils import profiling

    jscene, scene = _scenes("scene3.lol")
    h, w = 32, 128
    a = (scene.structure, scene.params, h, w)
    b = (jscene.structure, jscene.params, h, w)
    got, want = profiling.band_balance(*a, 2), jax_profiling.band_balance(*b, 2)
    assert got.keys() == want.keys() and got["n_bands"] == want["n_bands"]
    np.testing.assert_allclose(got["band_costs"], want["band_costs"], rtol=1e-3)
    for G in (8, 16):
        got_c = profiling.block_row_costs(*a, G)
        want_c = jax_profiling.block_row_costs(*b, G)
        assert got_c.dtype == np.float64 and got_c.shape == want_c.shape == (h // G,)
        np.testing.assert_allclose(got_c, want_c, rtol=1e-3)
    for cost_aware in (True, False):
        _check_balance(profiling.shard_balance(*a, 2, cost_aware=cost_aware),
                       jax_profiling.shard_balance(*b, 2, cost_aware=cost_aware))


def test_instanced_shard_balance_matches_jax():
    """The LPT deal of 16-row patch rows: instanced_spheres(150, seed=4)
    at 32x128 over 2 shards."""
    from loltracer_tpu.utils.profiling import shard_balance as jax_shard_balance

    from loltracer_tpu_torch.utils.profiling import shard_balance

    jscene, scene = _scenes("instanced:150")
    got = shard_balance(scene.structure, scene.params, 32, 128, 2)
    _check_balance(got, jax_shard_balance(jscene.structure, jscene.params, 32, 128, 2))
    assert got["assignment"] == "lpt" and got["granularity"] == 16


def _check_balance(got, want):
    keys = ("n_shards", "assignment", "granularity")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    np.testing.assert_allclose(got["shard_costs"], want["shard_costs"], rtol=1e-3)
    assert got["efficiency_balance"] == pytest.approx(want["efficiency_balance"], rel=1e-3)


def test_shard_balance_contiguous_fallback_costs_each_shards_own_tile_rows():
    """24 rows over 2 shards of 8-row blocks give no deal (24 % 16), and the
    3 tile rows do not split into 2 bands (the JAX package raises there).
    Shard 0's rows 0-11 fall in tile rows 0 and 1, shard 1's rows 12-23 in
    tile rows 1 and 2."""
    from loltracer_tpu_torch.utils.profiling import block_row_costs, shard_balance

    _, scene = _scenes("scene3.lol")
    c = block_row_costs(scene.structure, scene.params, 24, 128, 8)
    assert c.shape == (3,) and (c > 0).all()
    got = shard_balance(scene.structure, scene.params, 24, 128, 2)
    assert got["assignment"] == "contiguous" and got["granularity"] == 8
    want = [c[0] + c[1], c[1] + c[2]]
    assert got["shard_costs"] == want
    assert got["efficiency_balance"] == sum(want) / (2 * max(want))


def test_cli_stats_prints_march_step_stats(capsys):
    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.utils.profiling import march_step_stats

    _, scene = _scenes("scene4.lol")
    assert cli.main(["stats", str(EXAMPLES / "scene4.lol"), "--size", "40x24",
                     "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == march_step_stats(scene.structure, scene.params, 24, 40)
    assert printed["tile_waste"] is None  # narrower than a tile: null, not NaN

