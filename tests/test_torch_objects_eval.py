"""The plain version of the port's K7 (`lol_instanced_eval`,
render/march_kernels.py) against the JAX package's Pallas kernel
(`pallas_march.make_instanced_eval`, interpret mode) on the CPU:

- instanced_spheres(150, seed=3), the whole sphere set, clamp 2 and
  exact, at 400 points through the scene and above it;
- the last shard of that set padded over 4 (two sentinel spheres of
  radius -1e30 among its 38) under the AABB combined over all four
  shards, which is wider than the shard's own;
- the tables: value-only, Morton-sorted, sentinels in the runs but not in
  the AABB; and the wrapper on CPU tensors takes the plain version without
  counting a launch.

Tolerance atol/rtol 1e-4 (tests/test_pallas_march.py:45); XLA on the CPU
contracts multiplies and adds into FMAs where the port's ((x+y)+z) sums
round each step, so the values agree to an ulp or so and are not held
bitwise (the test prints how many points are)."""

import dataclasses

import numpy as np
import pytest
import torch

from loltracer_tpu.parallel.objects import pad_spheres_for_sharding as jax_pad
from loltracer_tpu.render.pallas_march import make_instanced_eval as jax_make_instanced_eval
from loltracer_tpu.render.pallas_scene import pack_instanced_spheres
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render import march_kernels
from loltracer_tpu_torch.render.cuda_scene import INSTANCED_EVAL
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.render.march_kernels import (
    instanced_eval_reference,
    make_instanced_eval,
    pack_eval_tables,
)
from loltracer_tpu_torch.render.sdf import make_scene_sdf
from loltracer_tpu_torch.scene import FIELDS, params_from_numpy
from loltracer_tpu_torch.scenes import instanced_spheres

torch.set_num_threads(1)  # one intra-op thread per pytest worker

N, SHARDS = 150, 4


def _points(n=400, seed=11):
    """Points among the spheres, near the floor and far above: the cut, the
    spheres and the plane each win somewhere."""
    gen = np.random.default_rng(seed)
    return np.stack([gen.uniform(-50, 50, n), gen.uniform(-2.0, 40, n),
                     gen.uniform(-90, 10, n)], axis=-1).astype(np.float32)


def _carried(jparams):
    return params_from_numpy({f: np.asarray(getattr(jparams, f)) for f in FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def scene():
    return jax_instanced_spheres(n=N, seed=3)


def _shard(params, index):
    """Shard `index` of the sphere set padded over SHARDS (JAX's padding),
    and the AABB of all real spheres (lo, hi)."""
    padded = jax_pad(params, SHARDS)
    per = padded.sphere_radius.shape[0] // SHARDS
    cut = slice(index * per, (index + 1) * per)
    local = dataclasses.replace(padded, sphere_point=padded.sphere_point[cut],
                                sphere_radius=padded.sphere_radius[cut])
    pos, rad = np.asarray(params.sphere_point), np.asarray(params.sphere_radius)
    bbox = np.concatenate([(pos - rad[:, None]).min(0), (pos + rad[:, None]).max(0)])
    return local, bbox.astype(np.float32)


def _compare(jparams, structure, cfg, bbox=None):
    """(port's plain K7, JAX's Pallas K7) at _points(), with the AABB
    replaced by `bbox` when given."""
    pts = _points()
    jtables = pack_instanced_spheres(jparams)
    tables = pack_eval_tables(_carried(jparams))
    if bbox is not None:
        jtables = jtables[:3] + (np.asarray(bbox),)
        tables = tables._replace(bbox=torch.from_numpy(bbox))
    want = np.asarray(jax_make_instanced_eval(
        structure, JaxRenderConfig(**dataclasses.asdict(cfg)), interpret=True)(
            jtables, jparams.plane_y, pts))
    st = instanced_spheres(n=structure.num_spheres, device="cpu").structure
    got = make_instanced_eval(st, cfg)(
        tables, torch.from_numpy(np.asarray(jparams.plane_y)), torch.from_numpy(pts))
    return got.numpy(), want


@pytest.mark.parametrize("clamp", [2.0, None], ids=["clamp2", "exact"])
def test_eval_reference_matches_pallas_eval_full_set(scene, clamp):
    cfg = RenderConfig(step_clamp=clamp)
    got, want = _compare(scene.params, scene.structure, cfg)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    print(f"bitwise on {int((got == want).sum())} of {got.size} points")
    # and the port's own instanced SDF, the distance K5 marches
    carried = _carried(scene.params)
    sdf = make_scene_sdf(instanced_spheres(n=N, seed=3, device="cpu").structure, clamp)
    np.testing.assert_array_equal(got, sdf(carried, torch.from_numpy(_points())).numpy())


@pytest.mark.parametrize("clamp", [2.0, None], ids=["clamp2", "exact"])
def test_eval_reference_matches_pallas_eval_padded_shard(scene, clamp):
    """The last shard (two sentinels) under the combined AABB."""
    local, bbox = _shard(scene.params, SHARDS - 1)
    assert (np.asarray(local.sphere_radius) < -1e29).sum() == 2
    structure = dataclasses.replace(scene.structure, num_spheres=local.sphere_radius.shape[0],
                                    material_ids=())
    cfg = RenderConfig(step_clamp=clamp)
    got, want = _compare(local, structure, cfg, bbox)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    print(f"bitwise on {int((got == want).sum())} of {got.size} points")


def test_eval_tables_leave_sentinels_out_of_the_bbox(scene):
    """pack_eval_tables: the shard's spheres Morton-sorted with their
    sentinels, the AABB over the real ones only; on a set without
    sentinels the tables are pack_instanced's (sphere rows, runs, AABB)."""
    local, _ = _shard(scene.params, SHARDS - 1)
    tables = pack_eval_tables(_carried(local))
    rad = tables.spheres[:, 3]
    real = rad > -1e29
    assert int((~real).sum()) == 2
    pos = tables.spheres[:, :3]
    lo = (pos - rad[:, None])[real].amin(0)
    hi = (pos + rad[:, None])[real].amax(0)
    torch.testing.assert_close(tables.bbox, torch.cat([lo, hi]), atol=0, rtol=0)
    whole = instanced_spheres(n=N, seed=3, device="cpu")
    full = pack_eval_tables(whole.params)
    inst = pack_instanced(whole.structure, whole.params)
    for name in ("spheres", "groups", "bbox"):
        torch.testing.assert_close(getattr(full, name), getattr(inst, name), atol=0, rtol=0)


def test_eval_wrapper_takes_the_plain_version_on_the_cpu(scene):
    """CPU tensors take the plain version, at any batch shape [..., 3],
    and count no launch."""
    whole = instanced_spheres(n=N, seed=3, device="cpu")
    tables = pack_eval_tables(whole.params)
    pts = torch.from_numpy(_points()).reshape(20, 20, 3)
    before = march_kernels.launches[INSTANCED_EVAL]
    got = make_instanced_eval(whole.structure, RenderConfig(step_clamp=2.0))(
        tables, whole.params.plane_y, pts)
    assert march_kernels.launches[INSTANCED_EVAL] == before
    assert tuple(got.shape) == (20, 20)
    torch.testing.assert_close(
        got, instanced_eval_reference(tables, whole.params.plane_y, pts, 2.0), atol=0, rtol=0)
