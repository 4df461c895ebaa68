"""The port's row sharding (loltracer_tpu_torch/parallel/sharded.py) against
the JAX package's (tests/test_sharding.py, case for case), on the CPU:

- `assign_blocks` / `interleave_rows` bitwise JAX's: the snake deal, LPT on
  seeded costs with ties, and the heights that give no deal (1080 over 2
  shards of 8-row blocks); on one rank the deal is the identity whatever
  the costs, which is why the port does not run the cost model there;
- one gloo world of 2 spawned processes for the module (a FileStore under
  tmp_path), every case computed in it: `make_sharded_renderer` with
  fused "off" and "interpret" on scene3 AA envelope at 32x144 (also dealt
  by LPT over the cost model) and on instanced_spheres(200, seed=5) clamp 2
  at 64x64 (also over a 2-D (hosts, chips) mesh), the banded
  differentiable tier on instanced_spheres(150, seed=4) at 48x32, the
  gradients of `make_sharded_loss` (compiled and instanced) and
  `make_sharded_train_step` (25 Adam steps, and one step of the fused
  tier);
- each image held against JAX's `make_sharded_renderer` on 2 faked CPU
  devices within atol 5e-5, the "interpret" tier bitwise the port's
  single-device training renderer, the loss gradients within 1e-4 *
  max|g| of JAX's, the params of every rank bitwise equal after a step.

Run as a script (`python tests/test_torch_sharded.py WORLD RANK STORE OUT`),
this file is one rank of that world: it imports no JAX then."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per pytest worker and per rank

WORLD = 2
SPAWN_TIMEOUT_S = 300
EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
H3, W3 = 32, 144  # scene3 AA envelope (tests/test_sharding.py's fused-tier size)
HI, WI = 64, 64  # instanced_spheres(200, seed=5), clamp 2, envelope
HB, WB = 48, 32  # instanced_spheres(150, seed=4), clamp 2: 24 rows a rank, bands of 12
HG, WG = 16, 32  # the gradient and train-step cases (tests/test_sharding.py's size)
GRAD_FIELDS = ("sphere_point", "smooth_k", "mat_diffuse", "light_point")
INST_GRAD_FIELDS = ("sphere_point", "sphere_radius", "plane_y", "light_point", "mat_diffuse",
                    "cam_point", "cam_fov")
STEPS = 25


def _cfgs():
    from loltracer_tpu_torch.config import RenderConfig

    return {
        "s3": RenderConfig(antialias=True, shadow_grad="envelope"),
        "inst": RenderConfig(shadow_grad="envelope", step_clamp=2.0),
        "band": RenderConfig(step_clamp=2.0),
        "aa": RenderConfig(antialias=True),
    }


# --- the ranks of the spawned world ----------------------------------------------


def _rank_main(world: int, rank: int, store: str, out: str) -> None:
    """One rank: every case of the module in the gloo world of `world`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.opt import masked_optimizer, trainable_leaves
    from loltracer_tpu_torch.parallel import (
        make_mesh,
        make_sharded_loss,
        make_sharded_renderer,
        make_sharded_train_step,
    )
    from loltracer_tpu_torch.parallel.sharded import _row_permutation
    from loltracer_tpu_torch.render.fused_train import make_training_renderer
    from loltracer_tpu_torch.render.instanced_train import make_instanced_training_renderer
    from loltracer_tpu_torch.render.torch_renderer import make_renderer
    from loltracer_tpu_torch.scene import FIELDS, build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    torch.set_flush_denormal(True)  # as XLA on the CPU
    cfg = _cfgs()
    s3 = build_scene(parse_scene_file(str(EXAMPLES / "scene3.lol")), device="cpu")
    inst = instanced_spheres(n=200, seed=5, device="cpu")
    band = instanced_spheres(n=150, seed=4, device="cpu")
    mesh = make_mesh(world, device="cpu")
    res = {}
    with torch.no_grad():
        for tier in ("off", "interpret"):
            res[f"s3_{tier}"] = make_sharded_renderer(s3.structure, mesh, H3, W3, cfg["s3"],
                                                      fused=tier)(s3.params)
            res[f"inst_{tier}"] = make_sharded_renderer(inst.structure, mesh, HI, WI,
                                                        cfg["inst"], fused=tier)(inst.params)
        res["s3_lpt"] = make_sharded_renderer(s3.structure, mesh, H3, W3, cfg["s3"],
                                              fused="interpret",
                                              balance_params=s3.params)(s3.params)
        res["s3_lpt_perm"] = _row_permutation(s3.structure, H3, W3, world, cfg["s3"], True,
                                              s3.params)[0]
        mesh2d = DeviceMesh("cpu", torch.arange(world).reshape(1, world),
                            mesh_dim_names=("hosts", "chips"))
        res["inst_2d"] = make_sharded_renderer(inst.structure, mesh2d, HI, WI, cfg["inst"],
                                               fused="interpret")(inst.params)
        res["band_off"] = make_sharded_renderer(band.structure, mesh, HB, WB, cfg["band"],
                                                fused="off")(band.params)
        if rank == 0:
            res["s3_single"] = make_training_renderer(s3.structure, H3, W3, cfg["s3"],
                                                      device="cpu")(s3.params)
            res["inst_single"] = make_instanced_training_renderer(
                inst.structure, HI, WI, cfg["inst"], device="cpu")(inst.params)
            res["band_single"] = make_renderer(band.structure, HB, WB, cfg["band"])(band.params)
    one = make_mesh(1, device="cpu")
    try:
        make_sharded_renderer(s3.structure, one, H3, W3, cfg["s3"])
        res["outside_refused"] = np.bool_(rank == 0)
    except ValueError as e:
        res["outside_refused"] = np.bool_(rank == 1 and "not in the mesh" in str(e))

    # the loss gradients (target 0, tests/test_sharding.py) through both
    # tiers: the differentiable one with AA and exact shadows (JAX's own
    # sharded-gradient case), the fused one with AA and envelope shadows
    target = torch.zeros((HG, WG, 3))
    for tier, c in (("off", cfg["aa"]), ("interpret", cfg["s3"])):
        leaves = trainable_leaves(s3.params, FIELDS)
        make_sharded_loss(s3.structure, mesh, HG, WG, c, fused=tier)(leaves, target).backward()
        for f in GRAD_FIELDS:
            res[f"grad_{tier}_{f}"] = getattr(leaves, f).grad.numpy()
    if rank == 0:
        leaves = trainable_leaves(s3.params, FIELDS)
        img = make_training_renderer(s3.structure, HG, WG, cfg["s3"], device="cpu")(leaves)
        (img ** 2).mean().backward()
        for f in GRAD_FIELDS:
            res[f"grad_single_{f}"] = getattr(leaves, f).grad.numpy()
    # the instanced fused tier's gradients (tests/test_sharding.py's target 0.5)
    half = torch.full((HI, WI, 3), 0.5)
    leaves = trainable_leaves(inst.params, FIELDS)
    make_sharded_loss(inst.structure, mesh, HI, WI, cfg["inst"], fused="interpret")(
        leaves, half).backward()
    for f in INST_GRAD_FIELDS:
        res[f"inst_grad_{f}"] = getattr(leaves, f).grad.numpy()
    if rank == 0:
        leaves = trainable_leaves(inst.params, FIELDS)
        img = make_instanced_training_renderer(inst.structure, HI, WI, cfg["inst"],
                                               device="cpu")(leaves)
        ((img - half) ** 2).mean().backward()
        for f in INST_GRAD_FIELDS:
            res[f"inst_grad_single_{f}"] = getattr(leaves, f).grad.numpy()

    # Adam on sphere_point from a perturbed start, toward scene3's own image
    with torch.no_grad():
        aa_target = make_renderer(s3.structure, HG, WG, cfg["aa"])(s3.params)
    start = s3.params.sphere_point.clone()
    start[0, 0] += 0.2
    for tag, tier, cfg_step, steps in (("adam", "auto", cfg["aa"], STEPS),
                                       ("fused", "interpret", cfg["s3"], 1)):
        leaves = trainable_leaves(dataclasses.replace(s3.params, sphere_point=start),
                                  ("sphere_point",))
        opt = masked_optimizer(leaves, ("sphere_point",), lr=2e-2)
        step = make_sharded_train_step(s3.structure, mesh, HG, WG, opt, cfg_step, fused=tier)
        res[f"{tag}_losses"] = np.array([step(leaves, aa_target).item() for _ in range(steps)])
        for f in FIELDS:
            res[f"{tag}_param_{f}"] = getattr(leaves, f).detach().numpy()
    res = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in res.items()}
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


# --- the JAX side ----------------------------------------------------------------------


def _jax_side():
    """JAX's images and gradients of the world's cases, on 2 faked CPU
    devices (tests/conftest.py)."""
    import jax
    import jax.numpy as jnp

    from loltracer_tpu.config import RenderConfig as JaxRenderConfig
    from loltracer_tpu.lol import parse_scene_file
    from loltracer_tpu.parallel import make_mesh
    from loltracer_tpu.parallel.sharded import make_sharded_loss, make_sharded_renderer
    from loltracer_tpu.render.jnp_renderer import make_renderer
    from loltracer_tpu.scene import build_scene
    from loltracer_tpu.scenes import instanced_spheres

    mesh = make_mesh(jax.devices("cpu"), n_devices=WORLD)
    s3 = build_scene(parse_scene_file(str(EXAMPLES / "scene3.lol")))
    inst = instanced_spheres(n=200, seed=5)
    band = instanced_spheres(n=150, seed=4)
    c3 = JaxRenderConfig(antialias=True, shadow_grad="envelope", march_backend="jnp")
    caa = JaxRenderConfig(antialias=True, march_backend="jnp")
    ci = JaxRenderConfig(shadow_grad="envelope", step_clamp=2.0, march_backend="jnp")
    out = {
        "s3": np.asarray(make_sharded_renderer(s3.structure, mesh, H3, W3, c3,
                                               fused="off")(s3.params)),
        "inst": np.asarray(make_sharded_renderer(inst.structure, mesh, HI, WI, ci,
                                                 fused="off")(inst.params)),
        "band": np.asarray(make_renderer(band.structure, HB, WB, JaxRenderConfig(
            step_clamp=2.0, march_backend="jnp"))(band.params)),
    }
    loss = make_sharded_loss(s3.structure, mesh, HG, WG, caa, fused="off")
    g = jax.jit(jax.grad(loss))(s3.params, jnp.zeros((HG, WG, 3), jnp.float32))
    out.update({f"grad_{f}": np.asarray(getattr(g, f)) for f in GRAD_FIELDS})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the outputs of every rank of one spawned gloo world of WORLD,
    _jax_side()); JAX computes while the ranks run."""
    tmp = tmp_path_factory.mktemp("sharded_world")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent),
               OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk over the loopback
    procs = [subprocess.Popen([sys.executable, __file__, str(WORLD), str(r),
                               str(tmp / "store"), str(tmp / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    logs = []
    try:
        jax_side = _jax_side()
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo world of {WORLD} did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"ranks failed: {bad}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)], jax_side


def _same_on_every_rank(ranks, key):
    img = ranks[0][key]
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r][key], img, err_msg=key)
    return img


# --- the deal, without spawning ---------------------------------------------------------


def _seeded_costs(n, seed):
    """Costs with ties: integers drawn from a short range."""
    return np.random.default_rng(seed).integers(0, 6, n).astype(np.float64)


@pytest.mark.parametrize("n_blocks, n_shards, costs", [
    (16, 2, None), (24, 4, None), (135, 5, None),
    (16, 2, 0), (48, 4, 1), (136, 8, 2), (64, 4, "equal"),
])
def test_assign_blocks_is_bitwise_jax(n_blocks, n_shards, costs):
    from loltracer_tpu.parallel.sharded import assign_blocks as jax_assign

    from loltracer_tpu_torch.parallel.sharded import assign_blocks

    if costs == "equal":
        costs = np.ones(n_blocks)
    elif costs is not None:
        costs = _seeded_costs(n_blocks, costs)
    got, want = assign_blocks(n_blocks, n_shards, costs), jax_assign(n_blocks, n_shards, costs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert np.bincount(got, minlength=n_shards).tolist() == [n_blocks // n_shards] * n_shards


@pytest.mark.parametrize("height, n_shards, G, costs", [
    (32, 2, 8, None), (64, 4, 16, None), (1088, 2, 8, 3), (1088, 2, 16, 4),
    (1080, 2, 8, None), (1080, 2, 16, 5), (48, 4, 16, None), (36, 2, 8, None),
])
def test_interleave_rows_is_bitwise_jax(height, n_shards, G, costs):
    from loltracer_tpu.parallel.sharded import interleave_rows as jax_interleave

    from loltracer_tpu_torch.parallel.sharded import interleave_rows

    bc = None if costs is None or height % G else _seeded_costs(height // G, costs)
    got, want = interleave_rows(height, n_shards, G, bc), jax_interleave(height, n_shards, G, bc)
    if want is None:
        assert got is None and height % (n_shards * G)
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0][got[1]], np.arange(height))


@pytest.mark.parametrize("height, G", [(64, 8), (1088, 16), (1080, 8), (40, 16)])
def test_one_rank_deal_is_the_identity_whatever_the_costs(height, G):
    """On one rank the deal is the identity with or without costs, in the
    JAX package too: the port may skip the cost model there."""
    from loltracer_tpu.parallel.sharded import interleave_rows as jax_interleave

    from loltracer_tpu_torch.parallel.sharded import interleave_rows

    costs = _seeded_costs(height // G, 7) if height % G == 0 else None
    for fn in (interleave_rows, jax_interleave):
        for bc in (None, costs):
            pi = fn(height, 1, G, bc)
            assert pi is None or np.array_equal(pi[0], np.arange(height))


def test_row_granularity_is_jax():
    from loltracer_tpu.parallel.sharded import row_granularity as jax_granularity
    from loltracer_tpu.scenes import instanced_spheres as jax_instanced

    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.parallel.sharded import row_granularity
    from loltracer_tpu_torch.render.cuda_scene import PATCH_ROW_BLOCK, TRAIN_ROW_BLOCK
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    s3 = build_scene(parse_scene_file(str(EXAMPLES / "scene3.lol")), device="cpu")
    assert row_granularity(s3.structure) == 8 == TRAIN_ROW_BLOCK
    got = row_granularity(instanced_spheres(n=5, device="cpu").structure)
    assert got == jax_granularity(jax_instanced(n=5).structure) == PATCH_ROW_BLOCK


def test_height_must_divide():
    from loltracer_tpu_torch.parallel.sharded import _check_divisible

    class Mesh4:
        def size(self):
            return 4

    with pytest.raises(ValueError, match="divide"):
        _check_divisible(18, Mesh4())
    _check_divisible(16, Mesh4())


# --- the world --------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["off", "interpret"])
def test_sharded_render_matches_jax(world, tier):
    """Both tiers over 2 ranks, compiled and instanced, within atol 5e-5 of
    JAX's sharded renderer; every rank returns the whole image."""
    ranks, jax_side = world
    for key, want in ((f"s3_{tier}", jax_side["s3"]), (f"inst_{tier}", jax_side["inst"])):
        img = _same_on_every_rank(ranks, key)
        assert img.shape == want.shape and np.isfinite(img).all()
        np.testing.assert_allclose(img, want, atol=5e-5, rtol=0, err_msg=key)


def test_sharded_fused_tier_is_bitwise_the_single_device_renderer(world):
    """The "interpret" tier (the kernels' plain twins, each rank its rows
    through a row table) is bitwise the single-device training renderer,
    compiled and instanced, over a 1-D and a 2-D mesh."""
    ranks, _ = world
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "s3_interpret"),
                                  ranks[0]["s3_single"])
    for key in ("inst_interpret", "inst_2d"):
        np.testing.assert_array_equal(_same_on_every_rank(ranks, key), ranks[0]["inst_single"])


def test_lpt_deal_changes_no_pixel(world):
    """The cost model's LPT deal really deals the rows, and the image is
    the undealt one, bitwise."""
    ranks, _ = world
    perm = ranks[0]["s3_lpt_perm"]
    assert sorted(perm.tolist()) == list(range(H3)) and not np.array_equal(perm, np.arange(H3))
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "s3_lpt"), ranks[0]["s3_single"])


def test_sharded_instanced_jnp_tier_is_banded(world):
    """24 rows a rank render in bands of 12: the image within 2e-6 of the
    single-device render and of JAX's."""
    ranks, jax_side = world
    img = _same_on_every_rank(ranks, "band_off")
    np.testing.assert_allclose(img, ranks[0]["band_single"], atol=2e-6, rtol=0)
    np.testing.assert_allclose(img, jax_side["band"], atol=2e-5, rtol=0)


@pytest.mark.parametrize("tier", ["off", "interpret"])
def test_sharded_loss_gradients_match(world, tier):
    """make_sharded_loss's gradients, the same on every rank: the "off"
    tier (AA, exact shadows) within 1e-4 * max|g| of JAX's sharded loss,
    the "interpret" tier (AA, envelope shadows) of the single-device
    training renderer's. (Envelope gradients are compared with JAX's only
    outside the penumbra band, where argmin near-ties do not flip:
    tests/_penumbra.py, tests/test_torch_train.py.)"""
    ranks, jax_side = world
    for f in GRAD_FIELDS:
        got = _same_on_every_rank(ranks, f"grad_{tier}_{f}")
        want = jax_side[f"grad_{f}"] if tier == "off" else ranks[0][f"grad_single_{f}"]
        scale = np.abs(want).max()
        assert scale > 0, f
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=0, err_msg=f)


def test_sharded_instanced_fused_gradients_match_single(world):
    """The instanced fused tier's loss gradients over 2 ranks (the plain
    K5r / K6 twins, each rank its rows through a row table) within 1e-4 *
    max|g| of the single-device training renderer's, sphere positions
    and radii included (tests/test_sharding.py's instanced case)."""
    ranks, _ = world
    for f in INST_GRAD_FIELDS:
        got = _same_on_every_rank(ranks, f"inst_grad_{f}")
        want = ranks[0][f"inst_grad_single_{f}"]
        assert np.isfinite(got).all(), f
        scale = max(np.abs(want).max(), 1e-7)
        np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-4, err_msg=f)
    assert np.abs(ranks[0]["inst_grad_sphere_point"]).max() > 0


def test_sharded_train_step_decreases_loss(world):
    """25 Adam steps on sphere_point over 2 ranks halve the loss, and every
    rank ends with the same params, bitwise."""
    ranks, _ = world
    losses = _same_on_every_rank(ranks, "adam_losses")
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    for key in ranks[0]:
        if key.startswith("adam_param_"):
            _same_on_every_rank(ranks, key)


def test_sharded_fused_train_step_is_replicated(world):
    """One step of the fused tier: finite, the field moved, every rank's
    params bitwise equal."""
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    ranks, _ = world
    assert np.isfinite(_same_on_every_rank(ranks, "fused_losses")).all()
    start = build_scene(parse_scene_file(str(EXAMPLES / "scene3.lol")),
                        device="cpu").params.sphere_point.numpy().copy()
    start[0, 0] += 0.2
    moved = _same_on_every_rank(ranks, "fused_param_sphere_point")
    assert np.isfinite(moved).all() and np.abs(moved - start).max() > 1e-5
    for key in ranks[0]:
        if key.startswith("fused_param_"):
            _same_on_every_rank(ranks, key)


def test_a_rank_outside_the_mesh_is_refused(world):
    ranks, _ = world
    assert all(bool(r["outside_refused"]) for r in ranks)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
