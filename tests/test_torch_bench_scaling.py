"""The port's weak-scaling harness (loltracer_tpu_torch/bench_scaling.py)
against the root bench_scaling.py, the JAX package's, on the CPU:

- (a) each shard's row table of the device-time ladder, element for
  element, the one bench_scaling.py:119-135 builds from the JAX package's
  `interleave_rows` and `block_row_costs`: scene4 at SCALE_ROWS 16 and
  instanced_spheres(150, seed=5) at 32, SCALE_W 32 (where the (8, 128)
  tile model prices every row at 0; scene4 also at 128, where it does
  not), n = 2
  and 4, each deal, and the contiguous fallback of a height that does not
  split into n * G blocks (instanced at SCALE_ROWS 8);
- (b) one band's image within atol 5e-5 of JAX's `make_training_renderer`
  / `make_instanced_training_renderer(..., interpret=True, full_height=,
  with_row_table=True)` on the same table; its scalar bench.py's formula
  over its own image and gradients, and with the penumbra band masked
  (tests/_penumbra.py) every gradient within 1e-4 * max|g| of jax.grad's
  and the masked scalar within the bound those give
  (tests/test_torch_bench.py's rule);
- (c) the device-time records (efficiency_device_time, keys, rounding),
  the wall records and both ladders' keys equal those JAX's harness
  writes for the same times (its `device_time_main` and `main` run with
  their renders stubbed and a scripted clock); the port's `_merge_ladder`
  and the root one write the same file from the same ladders, a corrupt
  prior file and an old single-ladder file included;
- (d) the wall ladder in a gloo world of 2 spawned CPU processes under
  SCALE_PLATFORM=cpu (one world for the module, its ranks in
  `_rank_main`): rungs 1 and 2 printed by rank 0 only; the target made to
  differ from the render (so Adam really moves the params), every run's
  pre-update loss equal to the first, and within rtol 1e-6 of the loss of
  one rank over the same height (the sum in another order); the params
  bitwise the start at every step;
- (e) without CUDA and without SCALE_PLATFORM=cpu both ladders raise; a
  card run whose kernels did not launch fails; the default SCALE_OUT is
  not the root SCALING.json; the module imports neither jax nor the JAX
  package;
- the device-time clock's split of a scripted profile at its marker
  kernels, and `measure_rungs`'s samples on the CPU.

The port runs under flush-denormal, as XLA on the CPU does. Run as a
script (`python tests/test_torch_bench_scaling.py WORLD RANK STORE OUT`),
this file is one rank of (d)'s world: it imports no JAX then."""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # one intra-op thread per pytest worker and per rank

ROOT = Path(__file__).resolve().parent.parent
SCENE4 = str(ROOT / "examples" / "scene4.lol")
WORLD = 2
SPAWN_TIMEOUT_S = 300
WALL_ROWS, WALL_W, WALL_REPS = 8, 16, 2  # (d): rungs of 8 x 16 and 16 x 16 pixels
TARGET_SCALE = 0.9  # (d): the target is the render times this
IMG_ATOL = 5e-5
GRAD_RTOL = 1e-4  # of max|g| per field


def _cpu_settings(**kw):
    from loltracer_tpu_torch.bench_scaling import Settings

    return Settings(platform="cpu", **kw)


# --- (d)'s ranks ------------------------------------------------------------------------


def _rank_main(world: int, rank: int, store: str, out: str) -> None:
    """One rank of the wall ladder's world: the ladder over scene4 with the
    target scaled, then the one-rank loss of each rung's height."""
    import torch.distributed as dist

    from loltracer_tpu_torch import bench_scaling as bs
    from loltracer_tpu_torch.bench import load_scene
    from loltracer_tpu_torch.parallel import make_mesh, make_sharded_loss
    from loltracer_tpu_torch.scene import FIELDS

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    torch.set_flush_denormal(True)
    real_renderer, real_step = bs.make_sharded_renderer, bs.make_sharded_train_step

    def scaled_renderer(*args, **kwargs):
        render = real_renderer(*args, **kwargs)
        return lambda p: TARGET_SCALE * render(p)

    entries = []  # the trainable params at the entry of every step

    def recording_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def run(params, target):
            entries.append({f: getattr(params, f).detach().clone() for f in FIELDS})
            return step(params, target)

        return run

    bs.make_sharded_renderer, bs.make_sharded_train_step = scaled_renderer, recording_step
    scene = load_scene(SCENE4, "cpu")
    lines = []
    s = _cpu_settings(rows=WALL_ROWS, width=WALL_W, reps=WALL_REPS, out=out + ".json")
    bs.wall_main(s, scene=scene, emit=lines.append)
    start = {f: getattr(scene.params, f) for f in FIELDS}
    restored = [all(torch.equal(e[f], start[f]) for f in FIELDS) for e in entries]
    one = make_mesh(1, device="cpu")  # every rank: the groups are collective
    single = []
    if rank == 0:
        cfg = bs.RenderConfig(shadow_grad="envelope")
        for n in (1, 2):
            h = WALL_ROWS * n
            target = scaled_renderer(scene.structure, one, h, WALL_W, cfg, fused="interpret",
                                     device="cpu")(scene.params)
            loss = make_sharded_loss(scene.structure, one, h, WALL_W, cfg, fused="interpret",
                                     device="cpu")
            single.append(loss(scene.params, target).item())
    np.savez(out, lines=np.array(lines, dtype=object), restored=np.array(restored),
             steps=np.array(len(entries)), single=np.array(single))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The world of (d), started at once so that it runs beside the other
    tests: (procs, tmp dir)."""
    tmp = tmp_path_factory.mktemp("scaling_world")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks talk over the loopback
    procs = [subprocess.Popen([sys.executable, __file__, str(WORLD), str(r), str(tmp / "store"),
                               str(tmp / f"rank{r}.npz")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    yield procs, tmp
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def world(spawned):
    """Every rank's outputs (a dict each)."""
    procs, tmp = spawned
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"the gloo world of {WORLD} did not finish in {SPAWN_TIMEOUT_S} s")
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"ranks failed: {bad}"
    return [dict(np.load(tmp / f"rank{r}.npz", allow_pickle=True)) for r in range(WORLD)]


# --- the scenes -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scenes(spawned):
    """{key: (JAX scene, port scene)}: scene4 and instanced_spheres(150, seed=5)."""
    import loltracer_tpu as jlt
    from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres

    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.scenes import instanced_spheres

    return {
        "scene4": (jlt.build_scene(jlt.parse_scene_file(SCENE4)),
                   build_scene(parse_scene_file(SCENE4), device="cpu")),
        "instanced": (jax_instanced_spheres(n=150, seed=5),
                      instanced_spheres(n=150, seed=5, device="cpu")),
    }


def _configs(structure):
    """(port cfg, JAX cfg) of the device-time ladder (bench_scaling.py:60-63)."""
    from loltracer_tpu.config import RenderConfig as JaxRenderConfig

    from loltracer_tpu_torch.config import RenderConfig

    clamp = 2.0 if structure.instanced else None
    return (RenderConfig(shadow_grad="envelope", step_clamp=clamp),
            JaxRenderConfig(shadow_grad="envelope", step_clamp=clamp, march_backend="jnp"))


@pytest.fixture(scope="module")
def jax_costs():
    """JAX's block_row_costs, computed once per (scene, height, width)."""
    return {}


# --- (a) the row tables -----------------------------------------------------------------

TABLE_CASES = [  # (scene, SCALE_ROWS, SCALE_W, n, deal)
    *[(k, r, 32, n, a) for k, r in (("scene4", 16), ("instanced", 32),
                                    ("instanced", 8))  # 8 rows of 16-row blocks: no deal
      for n in (2, 4) for a in ("lpt", "snake", "contiguous")],
    ("scene4", 16, 128, 2, "lpt"), ("scene4", 16, 128, 4, "lpt"),
]


@pytest.mark.parametrize("key,rows,width,n,assign", TABLE_CASES,
                         ids=[f"{k}-R{r}-W{w}-n{n}-{a}" for k, r, w, n, a in TABLE_CASES])
def test_row_tables_are_jaxs(scenes, jax_costs, key, rows, width, n, assign):
    """The port's deal and tables equal bench_scaling.py:119-135's, rebuilt
    here from the JAX package's functions; the deal is contiguous exactly
    where asked or where the height does not split into n * G blocks."""
    import jax.numpy as jnp
    from loltracer_tpu.parallel.sharded import interleave_rows, row_granularity
    from loltracer_tpu.utils.profiling import block_row_costs

    from loltracer_tpu_torch import bench_scaling as bs

    jscene, tscene = scenes[key]
    cfg, jcfg = _configs(tscene.structure)
    height = rows * n
    G = row_granularity(jscene.structure)
    assert bs.row_granularity(tscene.structure) == G
    # bench_scaling.py:119-130
    if assign == "contiguous":
        perm = np.arange(height)
    else:
        bc = None
        if assign == "lpt":
            ck = (key, height, width)
            if ck not in jax_costs:
                jax_costs[ck] = block_row_costs(jscene.structure, jscene.params, height, width,
                                                G, jcfg)
            bc = jax_costs[ck]
        pi = interleave_rows(height, n, G, block_costs=bc)
        perm = pi[0] if pi is not None else np.arange(height)

    got, tperm = bs.deal(tscene.structure, tscene.params, height, width, n, cfg, assign)
    tables = bs.shard_tables(tperm, n, rows, G, "cpu")
    fallback = assign == "contiguous" or height % (n * G) != 0
    assert got == ("contiguous" if fallback else assign)
    assert len(tables) == n
    for i in range(n):
        rows_i = perm[i * rows:(i + 1) * rows]
        want = np.asarray(jnp.asarray(rows_i[::G], jnp.float32))  # bench_scaling.py:135
        assert tables[i].dtype == torch.float32 and tables[i].device.type == "cpu"
        np.testing.assert_array_equal(tables[i].numpy(), want)


# --- (b) one band against JAX's -----------------------------------------------------------

BAND_CASES = [("scene4", 16, 2, 1, "lpt"), ("instanced", 16, 4, 2, "snake")]  # (scene, rows, n, shard, deal)


def _penumbra_keep(tscene, cfg, rows, width, height, tab):
    """[rows, W, 1] float: 0 on the band's penumbra (tests/_penumbra.py,
    from the plain training forward's residual planes), else 1."""
    from _penumbra import penumbra_pixels
    from test_torch_train import flush_denormals

    from loltracer_tpu_torch.render import fused_train, instanced_train
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced

    st, p = tscene.structure, tscene.params
    cam, fields = camera_pack(p, height, width, cfg), pack_fields(st, p)
    with flush_denormals():
        if st.instanced:
            _, res = instanced_train.instanced_train_forward_reference(
                st, cfg, cam, fields, pack_instanced(st, p), rows, width, full_height=height,
                rowtab=tab)
        else:
            _, res = fused_train.train_forward_reference(st, cfg, cam, fields, rows, width,
                                                         full_height=height, rowtab=tab)
    return (~penumbra_pixels(res.numpy(), st.num_lights)).astype(np.float32)[..., None]


@pytest.mark.parametrize("key,rows,n,shard,assign", BAND_CASES, ids=[c[0] for c in BAND_CASES])
def test_band_matches_jax(scenes, key, rows, n, shard, assign):
    """One shard's band of a deal at SCALE_W 32 (scene4's LPT; the
    instanced scene's snake deal, whose cost model the plain SDF runs
    slowly on the CPU): its frame's scalar is
    bench.py's formula over the band's own image and gradients (rtol 1e-6:
    float32 sums in another order); the image within atol 5e-5 of JAX's
    band on the same table; with the penumbra masked out of the loss,
    every gradient within 1e-4 * max|g| of jax.grad's and the scalar within
    2 * 5e-5 + sum(2 |g| d + d ** 2), d = 1e-4 * max|g| per field."""
    import jax
    import jax.numpy as jnp
    from loltracer_tpu.render.pallas_train import (
        make_instanced_training_renderer,
        make_training_renderer,
    )
    from test_torch_train import flush_denormals

    from loltracer_tpu_torch import bench
    from loltracer_tpu_torch import bench_scaling as bs
    from loltracer_tpu_torch.scene import FIELDS, SceneParams

    jscene, tscene = scenes[key]
    st = tscene.structure
    cfg, jcfg = _configs(st)
    width, height = 32, rows * n
    G = bs.row_granularity(st)
    got_deal, perm = bs.deal(st, tscene.params, height, width, n, cfg, assign)
    assert got_deal == assign
    tab = bs.shard_tables(perm, n, rows, G, "cpu")[shard]
    band = bs.band_renderer(st, rows, width, height, cfg, "cpu")

    leaves, frame = bench.fwdbwd_frame(lambda p: band(p, tab), tscene.params)
    with flush_denormals():
        got = frame().item()
    grads = {f: getattr(leaves, f).grad for f in FIELDS}
    with torch.no_grad(), flush_denormals():
        img = band(tscene.params, tab).numpy()
    want = float(np.mean(img.astype(np.float32) ** 2)) + sum(
        float(np.sum(g.numpy().astype(np.float64) ** 2)) for g in grads.values() if g is not None)
    assert got == pytest.approx(want, rel=1e-6)

    keep = _penumbra_keep(tscene, cfg, rows, width, height, tab)
    assert 0 < keep.sum() < keep.size
    mleaves = SceneParams(**{f: getattr(tscene.params, f).detach().clone().requires_grad_(True)
                             for f in FIELDS})
    with flush_denormals():
        mloss = torch.mean(torch.from_numpy(keep) * band(mleaves, tab) ** 2)
        mloss.backward()
    mgrads = {f: np.zeros(tuple(getattr(mleaves, f).shape), np.float32)
              if getattr(mleaves, f).grad is None else getattr(mleaves, f).grad.numpy()
              for f in FIELDS}
    ours = mloss.item() + sum(float(np.sum(g.astype(np.float64) ** 2)) for g in mgrads.values())

    make = make_instanced_training_renderer if st.instanced else make_training_renderer
    jband = make(jscene.structure, rows, width, jcfg, interpret=True, full_height=height,
                 with_row_table=True)
    jtab = jnp.asarray(tab.numpy())

    def masked(p):
        out = jband(p, jtab)
        return jnp.mean(keep * out ** 2), out

    (jloss, jimg), jg = jax.jit(jax.value_and_grad(masked, has_aux=True))(jscene.params)
    np.testing.assert_allclose(img, np.asarray(jimg), atol=IMG_ATOL, rtol=0)
    jgrads = {f: np.asarray(getattr(jg, f)) for f in FIELDS}
    ref = float(jloss) + sum(float(np.sum(x.astype(np.float64) ** 2)) for x in jgrads.values())
    bound = 2 * IMG_ATOL
    for f in FIELDS:
        g, jgf = mgrads[f], jgrads[f]
        if not jgf.size:
            continue
        d = GRAD_RTOL * max(np.abs(jgf).max(), 1e-30)
        np.testing.assert_allclose(g, jgf, atol=d, rtol=0, err_msg=f)
        bound += float(np.sum(2 * np.abs(jgf).astype(np.float64) * d + d * d))
    assert np.abs(mgrads["cam_point"]).max() > 0
    assert abs(ours - ref) <= bound


# --- (c) the records and the merge against the root script --------------------------------


def _root_harness(monkeypatch, env):
    """The root bench_scaling.py, imported with `env` set (its module level
    reads SCALE_ROWS, SCALE_W, SCALE_MODE and SCALE_SCENE; it imports no
    jax there)."""
    for k in [k for k in os.environ if k.startswith("SCALE_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location("jax_bench_scaling", ROOT / "bench_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """A perf_counter that moves by the scripted seconds: each timed window
    (two calls) takes the next of `dts`."""

    def __init__(self, dts):
        self.dts, self.t, self.calls = list(dts), 100.0, 0

    def perf_counter(self):
        self.calls += 1
        if self.calls % 2 == 0:
            self.t += self.dts.pop(0)
        return self.t


def _scripted_seconds(count, seed):
    return list(np.random.default_rng(seed).uniform(1e-3, 2e-2, count))


def test_settings_defaults_are_bench_scalings(monkeypatch):
    from loltracer_tpu_torch import bench_scaling as bs

    root = _root_harness(monkeypatch, {})
    s = bs.Settings.from_env({})
    assert (s.rows, s.width, s.mode, s.scene) == (root.ROWS_PER_DEVICE, root.WIDTH, root.MODE,
                                                  root.SCENE)
    assert s == bs.Settings(rows=128, width=768, mode="fwdbwd", scene="examples/scene4.lol",
                            clamp=2.0, reps=3, assign="lpt", device_time=False, platform="",
                            out=None)
    s = bs.Settings.from_env({"SCALE_ROWS": "16", "SCALE_W": "32", "SCALE_MODE": "fwd",
                              "SCALE_SCENE": "instanced:9", "SCALE_CLAMP": "none",
                              "SCALE_REPS": "2", "SCALE_ASSIGN": "snake",
                              "SCALE_DEVICE_TIME": "1", "SCALE_PLATFORM": "cpu",
                              "SCALE_OUT": "x.json"})
    assert s == bs.Settings(rows=16, width=32, mode="fwd", scene="instanced:9", clamp=None,
                            reps=2, assign="snake", device_time=True, platform="cpu",
                            out="x.json")
    for value, clamp in (("0", None), ("", None), ("8", 8.0)):
        assert bs.Settings.from_env({"SCALE_CLAMP": value}).clamp == clamp


def test_device_time_records_are_jaxs(monkeypatch, tmp_path):
    """JAX's device_time_main (its band stubbed, its clock scripted) and the
    port's (its samples the same seconds) print the same records and write
    the same ladder, but for "backend" (JAX's "interpret" on the CPU, the
    port's "cpu")."""
    import loltracer_tpu.render.pallas_train as jax_train

    from loltracer_tpu_torch import bench_scaling as bs

    rows, width, reps = 16, 32, 2
    env = dict(SCALE_ROWS=str(rows), SCALE_W=str(width), SCALE_REPS=str(reps),
               SCALE_ASSIGN="snake", SCALE_PLATFORM="cpu", SCALE_DEVICE_TIME="1",
               SCALE_SCENE="examples/scene4.lol")
    dts = _scripted_seconds(sum(bs.DEVICE_TIME_COUNTS) * reps, 3)
    root = _root_harness(monkeypatch, dict(env, SCALE_OUT=str(tmp_path / "jax.json")))
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("LOLTRACER_CACHE", str(ROOT / ".jax_cache"))
    import jax.numpy as jnp

    monkeypatch.setattr(jax_train, "make_training_renderer",
                        lambda st, h, w, *a, **k: lambda p, tab: jnp.zeros((h, w, 3)) * p.cam_fov)
    monkeypatch.setattr(root, "time", types.SimpleNamespace(perf_counter=_Clock(dts).perf_counter))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        root.device_time_main()
    want = [json.loads(line) for line in buf.getvalue().strip().splitlines()]

    it = iter(dts)

    def measure(rungs, frames, reps_, device, kernels):
        assert frames == 32 and reps_ == reps and device.type == "cpu"
        for r in rungs:
            r.device_ms = [[next(it) * 1e3 for _ in range(reps_)] for _ in range(r.n)]
            r.windows_ms = r.device_ms
            r.launches = [{"fused_train.lol_train_fwd": 0, "fused_train.lol_train_bwd": 0}] * r.n
        return {}

    monkeypatch.setattr(bs, "measure_rungs", measure)
    lines = []
    s = bs.Settings.from_env(dict(env, SCALE_OUT=str(tmp_path / "port.json")))
    records = bs.device_time_main(s, emit=lines.append)
    assert [json.loads(line) for line in lines[1::2]] == records == want
    detail = json.loads(lines[0])
    assert detail["deal"] == "snake" and detail["frames"] == 32 and detail["card"] is None
    jl = json.loads((tmp_path / "jax.json").read_text())["ladders"]
    pl = json.loads((tmp_path / "port.json").read_text())["ladders"]
    assert len(jl) == len(pl) == 1
    assert jl[0].pop("backend") == "interpret" and pl[0].pop("backend") == "cpu"
    assert jl[0] == pl[0]


def test_wall_records_are_jaxs(monkeypatch, tmp_path):
    """JAX's wall ladder (its step and renderer stubbed, its clock scripted,
    8 faked CPU devices) against the port's `wall_record` / `wall_ladder`
    over the same seconds, and the port's `wall_main` on a world of one
    writing that ladder's first rung."""
    import loltracer_tpu.parallel as jax_parallel
    import loltracer_tpu.parallel.sharded as jax_sharded

    from loltracer_tpu_torch import bench_scaling as bs

    rows, width, reps = 8, 16, 2
    env = dict(SCALE_ROWS=str(rows), SCALE_W=str(width), SCALE_REPS=str(reps),
               SCALE_PLATFORM="cpu", SCALE_SCENE="examples/scene4.lol")
    counts = bs.WALL_COUNTS
    per_rung = [_scripted_seconds(1 + reps, 10 + i) for i in range(len(counts))]
    root = _root_harness(monkeypatch, dict(env, SCALE_OUT=str(tmp_path / "jax.json")))
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("LOLTRACER_CACHE", str(ROOT / ".jax_cache"))
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))  # main() appends to it
    import jax.numpy as jnp

    monkeypatch.setattr(jax_parallel, "make_sharded_train_step",
                        lambda *a, **k: lambda p, o, t: (p, o, jnp.float32(0.5)))
    monkeypatch.setattr(jax_sharded, "make_sharded_renderer",
                        lambda st, mesh, h, w, cfg: lambda p: jnp.zeros((h, w, 3)))
    monkeypatch.setattr(root, "time", types.SimpleNamespace(
        perf_counter=_Clock([t for ts in per_rung for t in ts[1:]]).perf_counter))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        root.main()
    want = [json.loads(line) for line in buf.getvalue().strip().splitlines()]
    assert [r["devices"] for r in want] == list(counts)

    s = bs.Settings.from_env(dict(env, SCALE_OUT=str(tmp_path / "port.json")))
    base, got = None, []
    for n, ts in zip(counts, per_rung):
        rps = rows * n * width / min(ts[1:])  # the warm-up is not timed
        base = rps if base is None else base
        got.append(bs.wall_record(n, rows * n, rps, base, s.mode))
    assert got == want
    jl = json.loads((tmp_path / "jax.json").read_text())["ladders"][0]
    assert bs.wall_ladder(s, "cpu", None, got) == jl

    monkeypatch.setattr(bs, "wall_rung", lambda s_, sc, mesh, n, cfg, dev: (
        per_rung[0][1:], [0.5] * (1 + reps)))
    lines = []
    assert bs.wall_main(s, emit=lines.append) == want[:1]
    assert json.loads(lines[1]) == want[0]
    assert json.loads(lines[0])["loss"] == [0.5] * (1 + reps)
    assert json.loads((tmp_path / "port.json").read_text())["ladders"][0] == dict(
        jl, records=want[:1])
    import torch.distributed as dist

    assert not dist.is_initialized()  # the world of one it made is gone


def test_measure_rungs_on_the_cpu_runs_each_band_one_plus_reps_samples():
    """measure_rungs on the CPU: each band's frame runs `frames` times for
    the untimed sample and for each of `reps` samples, band after band;
    the device time there is the host clock's window; no profiler."""
    from loltracer_tpu_torch import bench_scaling as bs

    calls = []

    def frame_of(tag):
        return lambda: calls.append(tag)

    rungs = [bs.Rung(n, 4 * n, "snake", [], [frame_of((n, i)) for i in range(n)])
             for n in (2, 4)]
    kernels = (("fused_train", "lol_train_fwd"), ("fused_train", "lol_train_bwd"))
    assert bs.measure_rungs(rungs, 3, 2, torch.device("cpu"), kernels) == {}
    warm = [(n, i) for n in (2, 4) for i in range(n) for _ in range(3)]
    timed = [(n, i) for n in (2, 4) for i in range(n) for _ in range(2 * 3)]
    assert calls == warm + timed
    for r in rungs:
        assert len(r.windows_ms) == r.n and all(len(w) == 2 and min(w) >= 0
                                                for w in r.windows_ms)
        assert r.device_ms is r.windows_ms
        assert r.launches == [{"fused_train.lol_train_fwd": 0,
                               "fused_train.lol_train_bwd": 0}] * r.n


def test_merge_ladder_is_the_root_ones(monkeypatch, tmp_path):
    """The same ladders merged in the same order, from no file, a corrupt
    file and an old single-ladder file, give the same bytes."""
    from loltracer_tpu_torch import bench_scaling as bs

    root = _root_harness(monkeypatch, {})
    a = {"platform": "device_time-lpt", "scene": "s4", "mode": "fwdbwd", "records": [1]}
    b = {"platform": "cuda", "scene": "s4", "mode": "fwdbwd", "records": [2]}
    c = {"platform": "cuda", "scene": "s4", "mode": "fwd", "records": [3]}
    a2 = dict(a, records=[4])
    priors = {"none": None, "corrupt": "{not json", "old": json.dumps(
        {"platform": "cpu", "scene": "s4", "mode": "fwdbwd", "records": [0]}),
              "ladders": json.dumps({"ladders": [b]})}
    for tag, prior in priors.items():
        files = []
        for who, merge in (("jax", root._merge_ladder), ("port", bs._merge_ladder)):
            path = tmp_path / f"{tag}-{who}.json"
            if prior is not None:
                path.write_text(prior)
            for lad in (a, b, c, a2):
                merge(str(path), lad)
            files.append(path.read_bytes())
        assert files[0] == files[1], tag
    got = json.loads(files[1])["ladders"]
    assert [lad["records"] for lad in got] == [[2], [3], [4]]


# --- (d) the wall ladder over two ranks ---------------------------------------------------


def test_wall_ladder_two_ranks_prints_on_rank_zero(world):
    r0, r1 = world
    assert len(r1["lines"]) == 0
    lines = [json.loads(line) for line in r0["lines"]]
    assert len(lines) == 4
    details, records = lines[0::2], lines[1::2]
    assert [r["devices"] for r in records] == [1, 2]
    assert [r["height"] for r in records] == [WALL_ROWS, 2 * WALL_ROWS]
    for rec, det in zip(records, details):
        assert set(rec) == {"devices", "height", "rays_per_s", "efficiency", "mode"}
        assert rec["mode"] == "fwdbwd" and rec["rays_per_s"] > 0
        assert len(det["samples_s"]) == WALL_REPS and det["card"] is None
        assert rec["rays_per_s"] == round(rec["height"] * WALL_W / min(det["samples_s"]), 1)
    assert records[0]["efficiency"] == 1.0


def test_wall_ladder_two_ranks_loss_is_one_ranks(world):
    """Every run of a rung starts from the same params (its loss equal to
    the warm-up's, bitwise), and that loss is one rank's over the same
    height within rtol 1e-6; the target differs from the render, so the
    loss is not 0 and Adam moves the params between runs."""
    r0, _ = world
    details = [json.loads(line) for line in r0["lines"]][0::2]
    for det, single in zip(details, r0["single"]):
        losses = det["loss"]
        assert len(losses) == 1 + WALL_REPS and losses[0] > 0
        assert all(v == losses[0] for v in losses)
        assert losses[0] == pytest.approx(float(single), rel=1e-6)


def test_wall_ladder_restores_the_params_before_every_step(world):
    """Rank 0 steps in both rungs, rank 1 in the second: every step, the
    warm-ups included, starts from the scene's params bitwise."""
    r0, r1 = world
    assert int(r0["steps"]) == 2 * (1 + WALL_REPS) and int(r1["steps"]) == 1 + WALL_REPS
    assert r0["restored"].all() and r1["restored"].all()


# --- (e) no fallback, and no jax --------------------------------------------------------------


@pytest.mark.parametrize("device_time", [True, False], ids=["device-time", "wall"])
def test_without_cuda_the_card_path_raises(monkeypatch, tmp_path, device_time):
    from loltracer_tpu_torch import bench_scaling as bs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = bs.Settings(device_time=device_time, out=str(tmp_path / "x.json"))
    with pytest.raises(RuntimeError, match="is_available"):
        (bs.device_time_main if device_time else bs.wall_main)(s)
    assert not (tmp_path / "x.json").exists()
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_a_card_band_whose_kernels_did_not_launch_fails(monkeypatch, tmp_path):
    """device_time_main on the card checks each band's counters: here the
    plain versions ran (no launch), so it raises instead of writing."""
    from loltracer_tpu_torch import bench_scaling as bs

    def measure(rungs, frames, reps, device, kernels):
        for r in rungs:
            r.device_ms = r.windows_ms = [[1.0] * reps for _ in range(r.n)]
            r.launches = [{f"{fam}.{k}": 0 for fam, k in kernels}] * r.n
        return {}

    monkeypatch.setattr(bs, "_device", lambda s, who: torch.device("cuda", 0))
    monkeypatch.setattr(bs, "_card", lambda dev: "a card, 700.00 W")
    monkeypatch.setattr(bs, "measure_rungs", measure)
    monkeypatch.setattr(bs, "build_rungs", lambda s, scene, device: (
        [bs.Rung(n, s.rows * n, "lpt", [], []) for n in bs.DEVICE_TIME_COUNTS],
        bs.RenderConfig(shadow_grad="envelope"), 32))
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    scene = build_scene(parse_scene_file(SCENE4), device="cpu")
    s = bs.Settings(device_time=True, rows=16, width=32, out=str(tmp_path / "x.json"))
    with pytest.raises(RuntimeError, match="lol_train_bwd.*did not launch"):
        bs.device_time_main(s, scene=scene)
    assert not (tmp_path / "x.json").exists()


@pytest.mark.parametrize("kernels,want", [
    # marker, sample, marker, sample, three closing markers
    ("M a b M c MMM", [3.0, 3.0]),
    # the session dropped its first and its last kernel (a spare marker each)
    ("a b M c M d", [3.0, 3.0, 4.0]),
    # a marker lost between two samples merges them: refused
    ("M a M b c MMM", None),
])
def test_kernel_clock_splits_the_profile_at_markers(kernels, want):
    """KernelClock.samples_ms on a scripted profile: a sample is the
    kernels between two markers, a run of markers one boundary; a count of
    groups other than the samples run raises."""
    from loltracer_tpu_torch import bench_scaling as bs

    clock = object.__new__(bs.KernelClock)
    durs = {"a": 1_000_000, "b": 2_000_000, "c": 3_000_000, "d": 4_000_000}
    names = kernels.replace("MMM", "M M M").split()
    clock.kernels = lambda: [(t, 0 if k == "M" else durs[k],
                              "at::cuda::spin_kernel(long)" if k == "M" else f"kernel_{k}")
                             for t, k in enumerate(names)]
    n = 3 if want is None else len(want)
    if want is None:
        with pytest.raises(RuntimeError, match="groups of kernels"):
            clock.samples_ms(n)
    else:
        assert clock.samples_ms(n) == want


def test_default_out_is_not_the_root_scaling_json():
    from loltracer_tpu_torch import bench_scaling as bs

    gpu, cpu = bs.Settings().out_path, bs.Settings(platform="cpu").out_path
    assert Path(gpu) == ROOT / "artifacts" / "scaling_gpu.json"
    assert Path(cpu) == ROOT / "artifacts" / "scaling_cpu.json"
    assert ROOT / "SCALING.json" not in (Path(gpu), Path(cpu))
    assert bs.Settings(out="elsewhere.json").out_path == "elsewhere.json"


def test_imports_no_jax():
    """The harness imports neither jax nor the JAX package (nor the root
    bench_scaling.py), by its text and in a fresh interpreter."""
    tree = ast.parse((ROOT / "loltracer_tpu_torch" / "bench_scaling.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m.split(".")[0] in ("jax", "loltracer_tpu", "bench_scaling")]
    code = ("import sys; import loltracer_tpu_torch.bench_scaling; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'loltracer_tpu', 'bench_scaling')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
