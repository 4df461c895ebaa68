"""The port's object-axis sharding (loltracer_tpu_torch/parallel/) against the
JAX package's (tests/test_object_sharding.py, case for case), on the CPU:

- one gloo world of 4 spawned processes for the whole module (a FileStore
  under tmp_path, its own timeout), every case computed in it: object
  groups of 2 (the object dimension of a (2, 2) mesh) and of 4, clamp None
  and 2; a (2, 2) rows x objects mesh; the kernel tier (the resolver as on
  the card, so K7's plain version runs through `_make_kernel_pmin_sdf`'s
  autograd.Function and collectives) at both clamps and on the (2, 2)
  mesh; shadow clamp 8 with both tiers; the hit id where the cut wins;
  the kernel tier's gradient at points;
- each image held against JAX's `make_object_sharded_renderer` (jnp, on the
  faked CPU devices of tests/conftest.py) and JAX's single-device
  `make_renderer`, at atol 2e-5 (tests/test_object_sharding.py:46); every
  rank returns the same full image;
- without spawning: render_rays refusing an override without shadow_sdf,
  `pad_spheres_for_sharding` bitwise JAX's, `maybe_initialize`,
  `process_info`, `make_mesh` in a world of one.

Run as a script (`python tests/test_torch_objects.py WORLD RANK STORE
OUT`), this file is one rank of that world: it imports no JAX then."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per pytest worker and per rank

H, W = 24, 32
N = 150  # not divisible by 4: the shards are padded
WORLD = 4
SPAWN_TIMEOUT_S = 300


# --- the ranks of the spawned world ----------------------------------------------


def _cases():
    """(name, mesh shape, mesh dim names, row axis, tier, cfg kwargs)."""
    from loltracer_tpu_torch.parallel import OBJ_AXIS

    flat, rep, rows = (4,), (2, 2), (2, 2)
    return [
        ("obj2_exact", rep, ("replica", OBJ_AXIS), None, "jnp", dict(step_clamp=None)),
        ("obj2_clamp2", rep, ("replica", OBJ_AXIS), None, "jnp", dict(step_clamp=2.0)),
        ("obj4_exact", flat, (OBJ_AXIS,), None, "jnp", dict(step_clamp=None)),
        ("obj4_clamp2", flat, (OBJ_AXIS,), None, "jnp", dict(step_clamp=2.0)),
        ("rows_obj_exact", rows, ("rows", OBJ_AXIS), "rows", "jnp", dict(step_clamp=None)),
        ("k_obj4_exact", flat, (OBJ_AXIS,), None, "kernel", dict(step_clamp=None)),
        ("k_obj4_clamp2", flat, (OBJ_AXIS,), None, "kernel", dict(step_clamp=2.0)),
        ("k_rows_obj_clamp2", rows, ("rows", OBJ_AXIS), "rows", "kernel",
         dict(step_clamp=2.0)),
        ("shadow8_jnp", flat, (OBJ_AXIS,), None, "jnp",
         dict(step_clamp=1.0, shadow_step_clamp=8.0)),
        ("shadow8_kernel", flat, (OBJ_AXIS,), None, "kernel",
         dict(step_clamp=1.0, shadow_step_clamp=8.0)),
    ]


def _cut_probe_points():
    """Points far above the slab (tests/test_object_sharding.py): the cut
    wins on every shard."""
    return np.stack([np.linspace(-30, 30, 16), np.full(16, 30.0),
                     np.linspace(-60, -10, 16)], axis=-1).astype(np.float32)


def _grad_points():
    """Points among the spheres and over the floor, seeded."""
    gen = np.random.default_rng(7)
    return np.stack([gen.uniform(-40, 40, 64), gen.uniform(-1.5, 10, 64),
                     gen.uniform(-80, -4, 64)], axis=-1).astype(np.float32)


def _rank_main(world: int, rank: int, store: str, out: str) -> None:
    """One rank: every case of the module in the gloo world of `world`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.parallel import OBJ_AXIS, make_object_sharded_renderer, objects
    from loltracer_tpu_torch.render import march_kernels
    from loltracer_tpu_torch.render.backend import resolve_march_backend
    from loltracer_tpu_torch.scenes import instanced_spheres

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    torch.set_flush_denormal(True)  # as XLA on the CPU
    sc = instanced_spheres(n=N, seed=3, device="cpu")
    twin_calls = [0]
    twin = march_kernels.instanced_eval_reference

    def counted_twin(*a, **k):
        twin_calls[0] += 1
        return twin(*a, **k)

    march_kernels.instanced_eval_reference = counted_twin
    meshes, res = {}, {}
    for name, shape, dims, row_axis, tier, kw in _cases():
        if (shape, dims) not in meshes:
            meshes[shape, dims] = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                                             mesh_dim_names=dims)
        # the kernel tier as on the card: "pallas" names K7, whose wrapper
        # runs its plain version on these CPU tensors
        objects.resolve_march_backend = (resolve_march_backend if tier == "jnp" else
                                         lambda b, *t: "jnp" if b == "jnp" else "pallas")
        cfg = RenderConfig(march_backend="pallas" if tier == "kernel" else "jnp", **kw)
        before = twin_calls[0]
        with torch.no_grad():
            img = make_object_sharded_renderer(sc.structure, meshes[shape, dims], H, W, cfg,
                                               row_axis=row_axis, device="cpu")(sc.params)
        res[name] = img.numpy()
        res[name + "_twin_calls"] = np.int64(twin_calls[0] - before)
    objects.resolve_march_backend = resolve_march_backend

    # the hit id where the cut wins, and the kernel tier's gradient at points
    mesh = meshes[(4,), (OBJ_AXIS,)]
    axis = objects.ObjectAxis(mesh.get_group(OBJ_AXIS), world, mesh.get_local_rank(OBJ_AXIS))
    st = sc.structure
    ns_pad = N + (-N) % world
    st_local = dataclasses.replace(st, num_spheres=ns_pad // world, material_ids=())
    local = objects.shard_spheres(objects.pad_spheres_for_sharding(sc.params, world), axis)
    bbox = objects.combined_bbox(local, axis)
    _, sdf_id, _ = objects._sharded_sdfs(st_local, RenderConfig(step_clamp=0.25), axis, bbox)
    d, ids = sdf_id(local, torch.from_numpy(_cut_probe_points()))
    res["cut_d"], res["cut_id"] = d.numpy(), ids.numpy()

    cfg = RenderConfig(step_clamp=2.0)
    plain_sdf, _, plain_local = objects._sharded_sdfs(st_local, cfg, axis, bbox)
    kernel_sdf = objects._make_kernel_pmin_sdf(
        axis, march_kernels.make_instanced_eval(st_local, cfg),
        *objects._shard_tables(local, bbox, cfg), plain_local)
    for tag, fn in (("plain", plain_sdf), ("kernel", kernel_sdf)):
        leaves = {f: getattr(local, f).detach().clone().requires_grad_(True)
                  for f in ("sphere_point", "sphere_radius", "plane_y")}
        p = torch.from_numpy(_grad_points()).requires_grad_(True)
        dist_p = fn(dataclasses.replace(local, **leaves), p)
        (dist_p * torch.linspace(0.5, 1.5, dist_p.shape[0])).sum().backward()
        res[f"grad_{tag}_value"] = dist_p.detach().numpy()
        res[f"grad_{tag}_p"] = p.grad.numpy()
        for f, v in leaves.items():
            res[f"grad_{tag}_{f}"] = v.grad.numpy()
    np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


# --- the tests ----------------------------------------------------------------------


def _jax_images():
    """The JAX scene and JAX's images of every config of _cases():
    single-device `make_renderer` and `make_object_sharded_renderer` (jnp)
    over 4 faked CPU devices, keyed by the config's kwargs. (The JAX
    package's own tests hold its 2-shard and (rows, objects) images to the
    same single-device ones.)"""
    import jax
    from jax.sharding import Mesh

    from loltracer_tpu.config import RenderConfig as JaxRenderConfig
    from loltracer_tpu.parallel.objects import OBJ_AXIS, make_object_sharded_renderer
    from loltracer_tpu.render.jnp_renderer import make_renderer
    from loltracer_tpu.scenes import instanced_spheres

    scene = instanced_spheres(n=N, seed=3)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:4]), (OBJ_AXIS,))
    single, sharded = {}, {}
    configs = {tuple(sorted(c[5].items())) for c in _cases()}
    configs.add((("shadow_step_clamp", 1.0), ("step_clamp", 1.0)))
    for key in sorted(configs, key=repr):
        cfg = JaxRenderConfig(march_backend="jnp", **dict(key))
        single[key] = np.asarray(make_renderer(scene.structure, H, W, cfg)(scene.params))
        if key[0][0] != "shadow_step_clamp" or key[0][1] != 1.0:
            sharded[key] = np.asarray(make_object_sharded_renderer(
                scene.structure, mesh, H, W, cfg)(scene.params))
    return scene, single, sharded


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the outputs of every rank of one spawned gloo world of WORLD,
    _jax_images()); JAX renders while the ranks run."""
    tmp = tmp_path_factory.mktemp("objects_world")
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
        jax_side = _jax_images()
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


def _check_case(world, name):
    ranks, (_, single, sharded) = world
    case = next(c for c in _cases() if c[0] == name)
    _, _, dims, row_axis, tier, kw = case
    key = tuple(sorted(kw.items()))
    img = ranks[0][name]
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    for r in range(1, WORLD):  # every rank returns the whole image
        np.testing.assert_array_equal(ranks[r][name], img)
    np.testing.assert_allclose(img, sharded[key], atol=2e-5)
    np.testing.assert_allclose(img, single[key], atol=2e-5)
    calls = [int(ranks[r][name + "_twin_calls"]) for r in range(WORLD)]
    if tier == "kernel":
        # every rank evaluated through the K7 wrapper, as often as the other
        # ranks of its object group (ranks 0, 1 and 2, 3 of a 2-D mesh)
        groups = [[0, 1, 2, 3]] if len(dims) == 1 else [[0, 1], [2, 3]]
        for g in groups:
            assert calls[g[0]] > 0 and len({calls[r] for r in g}) == 1, calls
    else:
        assert calls == [0] * WORLD


@pytest.mark.parametrize("n_obj", [2, 4])
@pytest.mark.parametrize("clamp", [None, 2.0], ids=["exact", "clamp2"])
def test_object_sharded_matches_single(world, n_obj, clamp):
    _check_case(world, f"obj{n_obj}_{'exact' if clamp is None else 'clamp2'}")


def test_object_plus_row_sharding(world):
    """(2, 2) mesh: rows over one axis, objects over the other."""
    _check_case(world, "rows_obj_exact")


@pytest.mark.parametrize("clamp", [None, 2.0], ids=["exact", "clamp2"])
def test_object_sharded_kernel_tier_matches_single(world, clamp):
    """The kernel tier: every distance through `_make_kernel_pmin_sdf` with
    K7's wrapper (its plain version on the CPU), all-reduced."""
    _check_case(world, f"k_obj4_{'exact' if clamp is None else 'clamp2'}")


def test_object_sharded_kernel_tier_plus_row_sharding(world):
    _check_case(world, "k_rows_obj_clamp2")


@pytest.mark.parametrize("tier", ["jnp", "kernel"])
def test_object_sharded_respects_shadow_step_clamp(world, tier):
    """A shadow clamp other than the step clamp gets a second all-reduced
    distance; the clamps really diverge on this scene."""
    _check_case(world, f"shadow8_{tier}")
    single = world[1][1]
    shared = single[(("shadow_step_clamp", 1.0), ("step_clamp", 1.0))]
    assert np.abs(shared - single[(("shadow_step_clamp", 8.0), ("step_clamp", 1.0))]).max() > 1e-4


def test_sharded_id_unclamped_argmin_where_cut_wins(world):
    """Where the step clamp's cut wins on every shard, all shards tie at
    the cut; the id is still the global unclamped argmin (first-wins)."""
    from loltracer_tpu.render.sdf import make_scene_sdf_with_id

    ranks, (scene, _, _) = world
    pts = _cut_probe_points()
    d_ref, id_ref = make_scene_sdf_with_id(scene.structure, None)(scene.params, pts)
    keep = np.asarray(id_ref) <= N  # sphere-winning probes
    assert keep.any()
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["cut_id"][keep], np.asarray(id_ref)[keep])
        np.testing.assert_array_equal(ranks[r]["cut_d"], ranks[0]["cut_d"])
    d = ranks[0]["cut_d"]
    assert (d <= np.asarray(d_ref) + 1e-5).all()
    assert (d < np.asarray(d_ref) - 1e-2).any()


def test_kernel_tier_gradient_matches_plain_sharded_sdf(world):
    """The K7 autograd.Function (its plain version on the CPU) against the
    plain sharded distance at points (step clamp 2): the same value and,
    on every rank, the same gradients in p and in the rank's own spheres
    and planes. Against JAX's unsharded distance: the same value; where
    one sphere wins, the gradient in p summed over the ranks is JAX's
    (one rank attains the minimum); where the cut or the plane wins, every
    rank ties and each rank's gradient in p is JAX's (the JAX package's
    subgradient rule)."""
    import jax
    import jax.numpy as jnp

    from loltracer_tpu.render.sdf import make_scene_sdf, make_scene_sdf_with_id

    ranks, (scene, _, _) = world
    for r in range(WORLD):
        got = ranks[r]
        np.testing.assert_array_equal(got["grad_kernel_value"], got["grad_plain_value"])
        for f in ("p", "sphere_point", "sphere_radius", "plane_y"):
            np.testing.assert_allclose(got[f"grad_kernel_{f}"], got[f"grad_plain_{f}"],
                                       atol=1e-6, rtol=1e-6, err_msg=f)
    pts = jnp.asarray(_grad_points())
    sdf = make_scene_sdf(scene.structure, 2.0)
    wgt = np.linspace(0.5, 1.5, pts.shape[0], dtype=np.float32)
    value, ids = (np.asarray(x) for x in make_scene_sdf_with_id(scene.structure, 2.0)(
        scene.params, pts))
    unclamped = np.asarray(make_scene_sdf(scene.structure, None)(scene.params, pts))
    want = np.asarray(jax.grad(lambda p: jnp.sum(sdf(scene.params, p) * wgt))(pts))
    np.testing.assert_allclose(ranks[0]["grad_kernel_value"], value, atol=2e-5)
    one = (ids <= N) & (value == unclamped)  # a sphere wins, on one rank
    assert one.any() and (~one).any()
    summed = sum(ranks[r]["grad_kernel_p"] for r in range(WORLD))
    np.testing.assert_allclose(summed[one], want[one], atol=1e-5)
    for r in range(WORLD):
        np.testing.assert_allclose(ranks[r]["grad_kernel_p"][~one], want[~one], atol=1e-5)


# --- without spawning -----------------------------------------------------------------


def test_render_rays_rejects_override_without_shadow_sdf():
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render.camera import camera_rays
    from loltracer_tpu_torch.render.sdf import make_scene_sdf
    from loltracer_tpu_torch.render.torch_renderer import render_rays
    from loltracer_tpu_torch.scenes import instanced_spheres

    sc = instanced_spheres(n=N, seed=3, device="cpu")
    cfg = RenderConfig(march_backend="jnp", step_clamp=1.0, shadow_step_clamp=8.0)
    ro, rd = camera_rays(sc.params, 4, 6, cfg)
    with pytest.raises(ValueError, match="shadow_sdf"):
        render_rays(sc.structure, sc.params, ro, rd, cfg, sdf=make_scene_sdf(sc.structure, 1.0))


@pytest.mark.parametrize("n_shards", [1, 3, 4, 7])
def test_pad_spheres_for_sharding_is_bitwise_jax(n_shards):
    from loltracer_tpu.parallel.objects import pad_spheres_for_sharding as jax_pad
    from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres

    from loltracer_tpu_torch.parallel import pad_spheres_for_sharding
    from loltracer_tpu_torch.scene import FIELDS, params_from_numpy

    jparams = jax_pad(jax_instanced_spheres(n=N, seed=3).params, n_shards)
    jp = {f: np.asarray(getattr(jparams, f)) for f in FIELDS}
    carried = params_from_numpy({f: np.asarray(getattr(jax_instanced_spheres(n=N, seed=3).params,
                                                       f)) for f in FIELDS}, device="cpu")
    got = pad_spheres_for_sharding(carried, n_shards)
    for f in FIELDS:
        v = getattr(got, f).numpy()
        assert v.dtype == jp[f].dtype and v.shape == jp[f].shape, f
        np.testing.assert_array_equal(v, jp[f], err_msg=f)


_DIST_VARS = ("LOLTRACE_COORDINATOR", "LOLTRACE_NUM_PROCESSES", "LOLTRACE_PROCESS_ID",
              "LOLTRACE_LOCAL_DEVICE_IDS", "LOLTRACE_DISTRIBUTED")


@pytest.fixture()
def no_dist_env(monkeypatch):
    for v in _DIST_VARS:
        monkeypatch.delenv(v, raising=False)
    return monkeypatch


def test_maybe_initialize_is_a_no_op_without_the_variables(no_dist_env):
    import torch.distributed as dist

    from loltracer_tpu_torch.parallel import maybe_initialize

    assert maybe_initialize() is False
    assert maybe_initialize() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("var, value", [("LOLTRACE_NUM_PROCESSES", "two"),
                                        ("LOLTRACE_PROCESS_ID", "0.5"),
                                        ("LOLTRACE_NUM_PROCESSES", None)])
def test_maybe_initialize_rejects_malformed_variables(no_dist_env, var, value):
    import torch.distributed as dist

    from loltracer_tpu_torch.parallel import maybe_initialize

    no_dist_env.setenv("LOLTRACE_COORDINATOR", "127.0.0.1:1")
    no_dist_env.setenv("LOLTRACE_NUM_PROCESSES", "2")
    no_dist_env.setenv("LOLTRACE_PROCESS_ID", "0")
    if value is None:
        no_dist_env.delenv(var)
    else:
        no_dist_env.setenv(var, value)
    with pytest.raises(ValueError, match=var):
        maybe_initialize()
    assert not dist.is_initialized()


def test_process_info_has_jax_keys(no_dist_env):
    import torch.distributed as dist

    from loltracer_tpu_torch.parallel import process_info

    assert not dist.is_initialized()
    assert process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                              "global_devices": 1}


def test_world_of_one_mesh(no_dist_env):
    """Alone and without the variables, make_mesh makes a world of one
    rank in-process; asking for two ranks raises; the mesh renders as the
    plain renderer does; the CUDA default raises without CUDA."""
    import torch.distributed as dist

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.parallel import (AXIS, CHIPS_AXIS, HOSTS_AXIS, make_mesh,
                                              make_mesh_2d, make_object_sharded_renderer,
                                              process_info)
    from loltracer_tpu_torch.render.torch_renderer import render_image
    from loltracer_tpu_torch.scenes import instanced_spheres

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()
    try:
        mesh = make_mesh(device="cpu")
        assert dist.get_world_size() == 1 and mesh.mesh_dim_names == (AXIS,)
        assert mesh.size(0) == 1 and process_info()["process_count"] == 1
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            make_mesh(n_devices=2, device="cpu")
        mesh2 = make_mesh_2d(device="cpu")
        assert mesh2.mesh_dim_names == (HOSTS_AXIS, CHIPS_AXIS)
        assert tuple(mesh2.mesh.shape) == (1, 1)
        sc = instanced_spheres(n=40, seed=3, device="cpu")
        cfg = RenderConfig(march_backend="jnp", step_clamp=2.0)
        with torch.no_grad():
            img = make_object_sharded_renderer(sc.structure, mesh, 6, 8, cfg, obj_axis=AXIS,
                                               device="cpu")(sc.params)
            ref = render_image(sc.structure, sc.params, 6, 8, cfg)
        torch.testing.assert_close(img, ref, atol=0, rtol=0)
        with pytest.raises(ValueError, match="pallas"):
            make_object_sharded_renderer(sc.structure, mesh, 6, 8,
                                         cfg.replace(march_backend="pallas"), obj_axis=AXIS,
                                         device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
