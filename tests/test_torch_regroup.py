"""The plain versions of the port's regrouped instanced forward K9
(render/regroup.py) against the JAX package's `pallas_regroup`, on CPU
tensors:

- `morton_keys` bitwise JAX's, and the same stable permutation;
- `regrouped_forward_reference` at 32x64 on instanced_spheres(150, seed=5)
  (tests/test_regroup.py's scene), clamp 2 and exact: against JAX's
  `make_instanced_renderer_regrouped` in interpret mode (atol 1e-4,
  tests/test_instanced_fused.py:49), and bitwise against the port's
  `instanced_forward_reference` (the plain version of K5);
- each plain piece against the planes of its JAX kernel, captured from
  that same run: `march_track_reference` vs `lol_rg_march`'s (t_sh, hit,
  material), `shadow_sorted_reference` on JAX's sorted records vs
  `lol_rg_shadow`'s (res, t*), `shade_planes_reference` on JAX's frozen
  planes vs `lol_rg_shade`'s image;
- `warp_stats`' arithmetic; the entry point's contract.

Inputs are made with numpy and handed to both packages; the port runs
under flush-denormal, as XLA on the CPU does."""

import contextlib

import numpy as np
import pytest
import torch

import loltracer_tpu.render.pallas_regroup as jax_regroup
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.render.pallas_march import P_H, P_W, _from_columns
from loltracer_tpu.scenes import instanced_spheres as jax_instanced_spheres
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.render import regroup
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_scene import pack_fields
from loltracer_tpu_torch.render.instanced_fwd import instanced_forward_reference
from loltracer_tpu_torch.render.instanced_pack import pack_instanced
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.scene import FIELDS, build_scene
from loltracer_tpu_torch.scenes import instanced_spheres

torch.set_num_threads(1)  # one intra-op thread per pytest worker

H, W = 32, 64  # tests/test_regroup.py's size
CLAMPS = {"clamp2": 2.0, "exact": None}


@contextlib.contextmanager
def flush_denormals():
    assert torch.set_flush_denormal(True), "this CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def test_morton_keys_and_order_bitwise_jax():
    """Points in, on and outside the box, with ties: the same keys and the
    same stable permutation."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    pts = rng.uniform(-2.0, 12.0, (3, 4096)).astype(np.float32)
    pts[:, 100:140] = pts[:, 60:100]  # equal keys: the stable order decides
    lo = np.array([0.0, -1.0, 0.5], np.float32)
    hi = np.array([10.0, 9.0, 10.5], np.float32)
    ref = np.asarray(jax_regroup.morton_keys(*(jnp.asarray(p) for p in pts), jnp.asarray(lo),
                                             jnp.asarray(hi)))
    ours = regroup.morton_keys(*(torch.from_numpy(p) for p in pts), torch.from_numpy(lo),
                               torch.from_numpy(hi))
    assert ours.dtype == torch.int64 and ref.dtype == np.uint32
    np.testing.assert_array_equal(ours.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(torch.argsort(ours, stable=True).numpy(),
                                  np.asarray(jnp.argsort(jnp.asarray(ref))))
    # a flat box (span 0 on an axis) quantises by the 1e-6 floor, as JAX's
    flat = regroup.morton_keys(*(torch.from_numpy(p) for p in pts), torch.from_numpy(lo),
                               torch.from_numpy(lo))
    ref = jax_regroup.morton_keys(*(jnp.asarray(p) for p in pts), jnp.asarray(lo),
                                  jnp.asarray(lo))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref).astype(np.int64))


class _Capture:
    """`pallas_regroup.pl` with pallas_call wrapped: each call's inputs and
    output are kept under its name (tracers while jit traces: the traced
    function returns them)."""

    def __init__(self, pl):
        self._pl, self.calls = pl, {}

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, kernel, *args, name=None, **kwargs):
        call = self._pl.pallas_call(kernel, *args, name=name, **kwargs)

        def run(*inputs):
            out = call(*inputs)
            self.calls.setdefault(name, []).append((list(inputs), out))
            return out

        return run


@pytest.fixture(scope="module", params=list(CLAMPS), ids=list(CLAMPS))
def run(request):
    """JAX's regrouped renderer in interpret mode on test_regroup.py's scene,
    jitted with its three kernels' inputs and planes as outputs, and the
    port's plain pipeline on the same numbers: its pieces, its image and
    the plain K5 image."""
    import jax

    clamp = CLAMPS[request.param]
    jscene = jax_instanced_spheres(n=150, seed=5)
    jcfg = JaxRenderConfig(step_clamp=clamp, shadow_grad="envelope")
    cap = _Capture(jax_regroup.pl)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_regroup, "pl", cap)
    try:
        render = jax_regroup.make_instanced_renderer_regrouped(
            jscene.structure, H, W, jcfg, interpret=True, with_row_offset=True)
        img, calls = jax.jit(lambda p: (render(p, 0.0), cap.calls))(jscene.params)
    finally:
        mp.undo()
    calls = jax.tree_util.tree_map(np.asarray, calls)
    scene = instanced_spheres(n=150, seed=5, device="cpu")
    st = scene.structure
    for f in FIELDS:  # both packages hold the same numbers
        np.testing.assert_array_equal(getattr(scene.params, f).numpy(),
                                      np.asarray(getattr(jscene.params, f)))
    cfg = RenderConfig(step_clamp=clamp, shadow_grad="envelope")
    cam = camera_pack(scene.params, H, W, cfg)
    fields, tables = pack_fields(st, scene.params), pack_instanced(st, scene.params)
    with flush_denormals():
        tr = regroup.march_track_reference(st, cfg, cam, fields, tables, H, W)
        lo, hi = regroup.hit_box(tr.hitp)
        shadow = torch.stack([
            regroup.shadow_sorted_reference(st, cfg, fields, tables, r,
                                            regroup.shadow_order(r, lo, hi)) for r in tr.rec])
        ours = regroup.shade_planes_reference(st, cfg, cam, fields, tables, tr.track, shadow,
                                              H, W)
        k5_plain = instanced_forward_reference(st, cfg, cam, fields, tables, H, W)
    return dict(img=np.asarray(img), calls=calls, scene=scene, cfg=cfg, cam=cam,
                fields=fields, tables=tables, gph=-(-H // P_H), gpw=-(-W // P_W),
                track=tr, ours=ours, k5_plain=k5_plain)


def _planes(run, a):
    """A Pallas kernel's (C, npad) column planes as (C, H, W)."""
    return _from_columns(a, run["gph"], run["gpw"])[:, :H, :W]


def test_regrouped_forward_reference_matches_jax(run):
    """The plain pipeline's image (march_track_reference, the Morton order,
    shadow_sorted_reference, shade_planes_reference: regrouped_forward_reference's
    steps) bitwise the plain K5's, and within 1e-4 of JAX's."""
    st, ours = run["scene"].structure, run["ours"]
    assert ours.shape == (H, W, 3) and ours.dtype == torch.float32
    torch.testing.assert_close(ours, run["k5_plain"], rtol=0, atol=0)
    np.testing.assert_allclose(ours.numpy(), run["img"], rtol=0, atol=1e-4)
    assert ours.max() > 0
    # one lol_rg_march, one lol_rg_shadow per light, one lol_rg_shade
    assert [len(run["calls"][k]) for k in ("lol_rg_march", "lol_rg_shadow", "lol_rg_shade")] \
        == [1, st.num_lights, 1]


def test_march_track_reference_matches_jax_planes(run):
    st = run["scene"].structure
    (_, track), = run["calls"]["lol_rg_march"]
    ref = _planes(run, track)
    ours = run["track"]
    np.testing.assert_array_equal(ours.track[1].numpy(), ref[1])
    hit = ref[1] > 0.5
    np.testing.assert_array_equal(ours.track[2].numpy()[hit], ref[2][hit])
    np.testing.assert_allclose(ours.track[0].numpy(), ref[0], rtol=1e-4, atol=1e-4)
    assert ours.rec.shape == (st.num_lights, 7, H, W) and hit.any() and (~hit).any()


def test_shadow_sorted_reference_matches_jax_planes(run):
    """JAX's sorted records of light 0 through the port's plain shadow
    march in a shuffled order: its (res, t*) where JAX put them."""
    st = run["scene"].structure
    inputs, out = run["calls"]["lol_rg_shadow"][0]
    so, ld, md = inputs[-3:]
    rec = torch.from_numpy(np.concatenate([so, ld, md]))  # [7, npad]
    perm = torch.from_numpy(np.random.default_rng(1).permutation(rec.shape[1]))
    with flush_denormals():
        ours = regroup.shadow_sorted_reference(st, run["cfg"], run["fields"], run["tables"],
                                               rec, perm).numpy()
    np.testing.assert_allclose(ours[0], out[0], rtol=0, atol=1e-4)
    lit = (out[0] > 0) & (out[0] < 1)
    np.testing.assert_allclose(ours[1][lit], out[1][lit], rtol=1e-4, atol=1e-4)


def test_shade_planes_reference_matches_jax_planes(run):
    st = run["scene"].structure
    (inputs, img), = run["calls"]["lol_rg_shade"]
    frozen = torch.from_numpy(np.ascontiguousarray(_planes(run, inputs[-1])))
    shadow = frozen[3:].reshape(st.num_lights, 2, H, W)
    with flush_denormals():
        ours = regroup.shade_planes_reference(st, run["cfg"], run["cam"], run["fields"],
                                              run["tables"], frozen[:3], shadow, H, W)
    ref = np.moveaxis(_planes(run, img), 0, -1)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)


def test_warp_stats_arithmetic():
    """Two warps of 32 and a short one of 2: evaluations, the worst lane per
    warp, and the warp's distinct runs read at its worst lane."""
    evals = torch.tensor([1.0] * 31 + [9.0] + [4.0] * 32 + [2.0, 6.0])
    lane = evals * 3.0
    warp = torch.cat([torch.full((32,), 45.0), torch.full((32,), 20.0),
                      torch.tensor([7.0, 30.0])])
    s = regroup.warp_stats(torch.stack([evals, lane, warp]))
    assert s["rays"] == 66 and s["warps"] == 3
    assert s["evals_per_ray"] == pytest.approx(float(evals.mean()))
    assert s["worst_lane_evals_per_warp"] == pytest.approx((9 + 4 + 6) / 3)
    assert s["warp_efficiency"] == pytest.approx(float(evals.mean()) / ((9 + 4 + 6) / 3))
    assert s["runs_per_ray_eval"] == pytest.approx(3.0)
    assert s["runs_per_warp_step"] == pytest.approx((45 + 20 + 30) / (9 + 4 + 6))


def test_regrouped_renderer_contract(monkeypatch, examples_dir):
    """make_instanced_renderer_regrouped on the CPU is the plain pipeline,
    with row offsets too; it raises for a compiled structure and for CUDA
    without CUDA, and the stats need the card."""
    scene = instanced_spheres(n=40, seed=2, device="cpu")
    cfg = RenderConfig(step_clamp=2.0)
    regroup.launches.update({k: 0 for k in regroup.launches})
    img = regroup.make_instanced_renderer_regrouped(scene.structure, 6, 10, cfg,
                                                    device="cpu")(scene.params)
    cam = camera_pack(scene.params, 6, 10, cfg)
    args = (pack_fields(scene.structure, scene.params),
            pack_instanced(scene.structure, scene.params))
    torch.testing.assert_close(
        img, instanced_forward_reference(scene.structure, cfg, cam, *args, 6, 10), rtol=0, atol=0)
    rows = regroup.make_instanced_renderer_regrouped(scene.structure, 2, 10, cfg, device="cpu",
                                                     full_height=6, with_row_offset=True)
    band_cam = camera_pack(scene.params, 6, 10, cfg, row0=3.0)
    band = rows(scene.params, 3.0)
    torch.testing.assert_close(
        band, instanced_forward_reference(scene.structure, cfg, band_cam, *args, 2, 10, 6),
        rtol=0, atol=0)
    # torch's CPU pow rounds by where a value sits in its batch: 1 ulp
    torch.testing.assert_close(band, img[3:5], rtol=0, atol=1e-6)
    assert not any(regroup.launches.values())
    scene4 = build_scene(parse_scene_file(str(examples_dir / "scene4.lol")), device="cpu")
    with pytest.raises(ValueError):
        regroup.make_instanced_renderer_regrouped(scene4.structure, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="card"):
        regroup.shadow_gather_stats(scene.structure, scene.params, 4, 4, cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        regroup.make_instanced_renderer_regrouped(scene.structure, 4, 4, cfg)
