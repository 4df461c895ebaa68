"""The port's instanced tier (10k+ spheres) against the JAX package, on CPU
tensors: the procedural scene, the Morton packing, the plain instanced SDF,
and whole images through `instanced_forward_reference`, the plain version
that `lol_instanced_render` is held against on the card (chip_smoke.py),
vs the jnp oracle and the Pallas instanced kernel in interpret mode.

Inputs are made once with numpy and handed to both packages. Image
tolerance is the JAX package's own (tests/test_instanced_fused.py: atol
1e-4); the port runs under flush-denormal, as XLA on the CPU does."""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.render.jnp_renderer import render_image as jax_render_image
from loltracer_tpu.render.pallas_scene import _morton_codes
from loltracer_tpu.render.pallas_scene import pack_order as jax_pack_order
from loltracer_tpu.render.pallas_train import make_instanced_renderer as jax_instanced_renderer
from loltracer_tpu.render.sdf import make_scene_sdf_with_id as jax_sdf_id
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.instanced_fwd import instanced_forward_reference
from loltracer_tpu_torch.render.instanced_pack import (
    BOUND_MARGIN,
    GROUP,
    morton_codes,
    pack_instanced,
    pack_order,
)
from loltracer_tpu_torch.render.sdf import make_scene_sdf, make_scene_sdf_with_id
from loltracer_tpu_torch.render.torch_renderer import render_image, render_image_banded
from loltracer_tpu_torch.scene import FIELDS
from loltracer_tpu_torch.scenes import instanced_spheres

torch.set_num_threads(1)  # one intra-op thread per pytest worker

H, W = 36, 64  # tests/test_instanced_fused.py's size
N, SEED = 300, 9


@contextlib.contextmanager
def flush_denormals():
    """XLA on the CPU flushes denormals to zero; torch keeps them (a
    specular pow(base, shininess) that underflows). The port's calls run
    in XLA's mode here."""
    assert torch.set_flush_denormal(True), "this CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


@pytest.fixture(scope="module")
def scenes():
    return {
        n: (jax_instanced_spheres(n=n, seed=SEED), instanced_spheres(n=n, seed=SEED, device="cpu"))
        for n in (1, N)
    }


def _points(tscene, n_pts=2048, seed=0):
    """Seeded points: inside the field (many inside spheres), on the faces
    of the sphere set's AABB, and far outside it."""
    rng = np.random.default_rng(seed)
    pos, rad = tscene.params.sphere_point.numpy(), tscene.params.sphere_radius.numpy()
    lo, hi = (pos - rad[:, None]).min(0), (pos + rad[:, None]).max(0)
    k = n_pts // 4
    inside = pos[rng.integers(0, len(pos), k)] + rng.normal(0.0, 0.3, (k, 3))
    field = rng.uniform(lo, hi, (k, 3))
    faces = rng.uniform(lo, hi, (k, 3))
    axis = rng.integers(0, 3, k)
    faces[np.arange(k), axis] = np.where(rng.random(k) < 0.5, lo[axis], hi[axis])
    far = rng.uniform(-300.0, 300.0, (n_pts - 3 * k, 3))
    return np.concatenate([inside, field, faces, far]).astype(np.float32)


@pytest.mark.parametrize("n", [1, N, 10_000])
def test_instanced_spheres_params_are_bitwise_jax(n):
    j = jax_instanced_spheres(n=n)
    t = instanced_spheres(n=n, device="cpu")
    assert dataclasses.asdict(t.structure) == dataclasses.asdict(j.structure)
    for f in FIELDS:
        ours, ref = getattr(t.params, f).numpy(), np.asarray(getattr(j.params, f))
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, f
        np.testing.assert_array_equal(ours, ref, err_msg=f)


@pytest.mark.parametrize("n", [1, N, 10_000])
def test_morton_codes_and_order_equal_jax(n):
    t = instanced_spheres(n=n, device="cpu")
    pos = t.params.sphere_point
    np.testing.assert_array_equal(
        morton_codes(pos).numpy(), np.asarray(_morton_codes(pos.numpy())).astype(np.int64)
    )
    j = jax_instanced_spheres(n=n)
    np.testing.assert_array_equal(pack_order(pos).numpy(), np.asarray(jax_pack_order(j.params)))


@pytest.mark.parametrize("n", [1, N, 10_000])
def test_group_bounds_are_true_bounds(n):
    """Every packed ball bounds its members: for each member i,
    |c_i - ctr| + r_i <= R - margin / 2, and min_i |c_i - ctr| - r_i <=
    S - margin / 2, in float64 (so |p - ctr| - R lower-bounds every member's distance and
    |p - ctr| + S upper-bounds the least one, with slack for f32 rounding).
    The tables hold every sphere once, with its material."""
    t = instanced_spheres(n=n, device="cpu")
    tab = pack_instanced(t.structure, t.params)
    sph = tab.spheres.double().numpy()
    groups = tab.groups.double().numpy()
    assert groups.shape == (-(-n // GROUP), 8)
    for g, row in enumerate(groups):
        members = sph[g * GROUP : (g + 1) * GROUP]
        off = np.linalg.norm(members[:, :3] - row[:3], axis=1)
        assert (off + members[:, 3] <= row[3] - BOUND_MARGIN / 2).all(), g
        assert (off - members[:, 3]).min() <= row[4] - BOUND_MARGIN / 2, g
    ids = tab.ids.numpy()
    np.testing.assert_array_equal(np.sort(ids[:n, 0]), np.arange(n))
    np.testing.assert_array_equal(tab.spheres[:, :3].numpy(), t.params.sphere_point.numpy()[ids[:n, 0]])
    mats = np.asarray(t.structure.material_ids)
    np.testing.assert_array_equal(ids[:, 1], mats[1 + ids[:n, 0]].tolist() + [mats[-1]])
    lo = (t.params.sphere_point - t.params.sphere_radius[:, None]).amin(0)
    hi = (t.params.sphere_point + t.params.sphere_radius[:, None]).amax(0)
    np.testing.assert_array_equal(tab.bbox.numpy(), torch.cat([lo, hi]).numpy())


def _brute_force(params, pts):
    """min and first argmin over all spheres at once, in torch, each
    product rounded (torch's CPU sqrt can round 1 ulp off numpy's)."""
    c, r = params.sphere_point, params.sphere_radius
    p = torch.from_numpy(pts)
    dx, dy, dz = p[:, 0, None] - c[:, 0], p[:, 1, None] - c[:, 1], p[:, 2, None] - c[:, 2]
    dist = torch.sqrt((dx * dx + dy * dy) + dz * dz) - r
    return dist.min(dim=1).values.numpy(), dist.argmin(dim=1).numpy()


@pytest.mark.parametrize("n", [1, N])
@pytest.mark.parametrize("clamp", [None, 2.0], ids=["exact", "clamp2"])
def test_instanced_sdf_matches_jax(scenes, n, clamp):
    """Distance within 2 ulp of the square root it comes from (|d| + the
    largest radius) of JAX's, ids equal. The 2 ulp: XLA's CPU reduce of
    the broadcast [..., 512, 3] squares contracts into two FMAs,
    fma(z, z, fma(y, y, x * x)), where the port (and its kernel, built
    with --fmad=false) rounds every product. The sphere part is bitwise
    the numpy brute-force min with rounded products, and the first-wins
    argmin."""
    jscene, tscene = scenes[n]
    pts = _points(tscene)
    jd, jid = jax.jit(jax_sdf_id(jscene.structure, clamp))(jscene.params, pts)
    jd, jid = np.asarray(jd), np.asarray(jid)
    p = torch.from_numpy(pts)
    d, oid = make_scene_sdf_with_id(tscene.structure, clamp)(tscene.params, p)
    d_only = make_scene_sdf(tscene.structure, clamp)(tscene.params, p)
    d, oid = d.numpy(), oid.numpy()
    assert np.array_equal(d_only.numpy(), d)
    root = np.abs(jd) + tscene.params.sphere_radius.numpy().max()
    ulp = np.abs(d - jd) / np.spacing(root.astype(np.float32))
    assert ulp.max() <= 2.0, ulp.max()
    np.testing.assert_array_equal(oid, jid)

    bmin, barg = _brute_force(tscene.params, pts)
    spheres_win = oid <= n
    np.testing.assert_array_equal(oid[spheres_win] - 1, barg[spheres_win])
    if clamp is None:
        np.testing.assert_array_equal(d[spheres_win], bmin[spheres_win])


CONFIGS = [
    RenderConfig(),
    RenderConfig(step_clamp=2.0),
    RenderConfig(step_clamp=2.0, antialias=True),
    RenderConfig(step_clamp=2.0, shadow_step_clamp=8.0),
]
CONFIG_IDS = ["exact", "clamp", "clamp-aa", "shadow-clamp"]


def _jax_cfg(cfg: RenderConfig) -> JaxRenderConfig:
    return JaxRenderConfig(**dataclasses.asdict(cfg))


def _port_image(tscene, cfg, h=H, w=W):
    st = tscene.structure
    cam = camera_pack(tscene.params, h, w, cfg)
    fields = pack_fields(st, tscene.params)
    tables = pack_instanced(st, tscene.params)
    with flush_denormals():
        img = instanced_forward_reference(st, cfg, cam, fields, tables, h, w)
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    return img.numpy()


@pytest.mark.parametrize(
    "n,cfg", [(N, c) for c in CONFIGS] + [(1, RenderConfig(step_clamp=2.0))],
    ids=CONFIG_IDS + ["single-sphere"],
)
def test_plain_render_matches_jnp_oracle(scenes, n, cfg):
    """The plain instanced render vs the jitted jnp oracle at n=300 seed 9,
    36x64 (the sizes of tests/test_instanced_fused.py), atol 1e-4 on every
    pixel."""
    jscene, tscene = scenes[n]
    ref = np.asarray(
        jax.jit(lambda p: jax_render_image(jscene.structure, p, H, W, _jax_cfg(cfg)))(
            jscene.params
        )
    )
    img = _port_image(tscene, cfg)
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    np.testing.assert_allclose(img, ref, atol=1e-4, rtol=0)


def test_plain_render_matches_pallas_instanced_interpret(scenes):
    """vs JAX's K5 (lol_instanced_render) in interpret mode, clamp 2."""
    jscene, tscene = scenes[N]
    cfg = RenderConfig(step_clamp=2.0)
    ref = np.asarray(
        jax_instanced_renderer(jscene.structure, H, W, _jax_cfg(cfg), interpret=True)(
            jscene.params
        )
    )
    np.testing.assert_allclose(_port_image(tscene, cfg), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("band_rows", [8, 64, 7])
def test_render_image_banded_equals_render_image(scenes, band_rows):
    """Bitwise where every band's pixels fill whole vectors of the CPU's
    SIMD width (8 rows x 24 pixels x 3). With 7-row bands some pixels
    fall in a vector loop's scalar tail, where torch's CPU `x ** gamma`
    calls libm instead of its vector pow and may round 1 ulp apart; on
    the card every element takes the same path."""
    _, tscene = scenes[N]
    cfg = RenderConfig(step_clamp=2.0, antialias=True)
    h, w = 20, 24
    with torch.no_grad():
        whole = render_image(tscene.structure, tscene.params, h, w, cfg)
        banded = render_image_banded(tscene.structure, tscene.params, h, w, cfg, band_rows)
    if band_rows % 8 == 0:
        assert torch.equal(banded, whole)
    else:
        np.testing.assert_array_max_ulp(banded.numpy(), whole.numpy(), maxulp=1)


def test_band_through_the_camera_pack_equals_rows_of_the_image(scenes):
    """A band rendered through the pack's row0 and full_height is bitwise
    those rows of the whole image (how chip_smoke.py holds the kernel to
    the plain version at 1920x1080)."""
    _, tscene = scenes[N]
    st, cfg = tscene.structure, RenderConfig(step_clamp=2.0)
    h, w = 24, 32  # SIMD-aligned bands (see the test above)
    fields = pack_fields(st, tscene.params)
    tables = pack_instanced(st, tscene.params)
    whole = instanced_forward_reference(
        st, cfg, camera_pack(tscene.params, h, w, cfg), fields, tables, h, w
    )
    band = instanced_forward_reference(
        st, cfg, camera_pack(tscene.params, h, w, cfg, row0=8), fields, tables, 8, w, h
    )
    assert torch.equal(band, whole[8:16])
