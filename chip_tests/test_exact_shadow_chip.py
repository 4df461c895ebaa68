"""The exact soft shadow's kernels on the card: K4x (`lol_exact_shadow`)
and K4xb (`lol_exact_shadow_bwd`, csrc/exact_shadow.cuh).

- K4x's res is bitwise the plain loop's (`shading.shadow_march` on the
  card), with the segment cull and its `shadow_cull=False` twin;
- K4xb's cotangents of ro and rd match `exact_shadow_reference` and
  autograd through the loop, each ray's within the JAX package's
  training-gradient rule (1e-4 of the largest, tests/test_train.py) on
  all but RAYS_OFF rays, and its summed gradient of the packed buffer
  matches the reference's float64 total of the same float32 terms within
  FIELDS_TOL of those terms' magnitudes (a launch missing one tile's rays
  does not); on scene4 at 960x540 AA (the rays of the
  `scene4-fit-exact-540p` cell), on a small box and smooth-min scene, and
  on 112 spheres whose accumulators outgrow shared memory (the global
  path); two backward launches are bitwise equal;
- three `fit_scene` steps through the kernels against the plain loop's,
  by the numbers of `benchmark/harness/compare.py` under the cell's
  limits (`benchmark/limits/scene4-fit-exact-540p.json`).

    python -m pytest chip_tests/test_exact_shadow_chip.py -q -m chip
"""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
H, W = 540, 960

# tests/test_torch_exact_shadow.py's box and smooth-min scene
_BOX_SMIN = """
materials {
  { shininess = 0, diffuse = (0, 0, 0), specular = (0, 0, 0), ambient = (0, 0, 0) },
  { shininess = 8, diffuse = (0.5, 0.4, 0.3), specular = (0.2, 0.2, 0.2), ambient = (0.1, 0.1, 0.1) }
}
scene {
  ambient { color = (0.1, 0.1, 0.1) },
  camera { point = (0, 1.5, 3), direction = (0, -0.3, -1), fov = 90 },
  point_light { point = (-2, 6, -1), diffuse_intensity = (1, 1, 1), specular_intensity = (1, 1, 1) },
  point_light { point = (4, 3, 1), diffuse_intensity = (0.5, 0.5, 0.5), specular_intensity = (0.5, 0.5, 0.5) },
  box { point = (-1.5, 0.2, -3), point2 = (0.9, 0.7, 0.6), radius = 0.1, material = #1 },
  smooth-union { smoothness = 0.6, material = #1,
    a = sphere { point = (1.2, 0.4, -3.5), radius = 0.7 },
    b = sphere { point = (1.9, 1.1, -4), radius = 0.5 } },
  plane { y = -1, material = #1 }
}
"""


def _sphere_field(n):
    """tests/test_torch_exact_shadow.py's n spheres above a plane."""
    spheres = ",\n".join(
        f"  sphere {{ point = ({(i % 12) * 0.6 - 3.3:.2f}, {0.3 + 0.25 * (i % 3):.2f}, "
        f"{-2.0 - (i // 12) * 0.6:.2f}), radius = {0.18 + 0.02 * (i % 4):.2f}, material = #1 }}"
        for i in range(n))
    return _BOX_SMIN.split("  box {", 1)[0] + spheres + ",\n  plane { y = -1, material = #1 }\n}\n"


def _scene(name, dev):
    from loltracer_tpu_torch.lol import parse_scene, parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    if name == "scene4":
        return build_scene(parse_scene_file(str(ROOT / "examples" / "scene4.lol")), device=dev)
    if name == "spheres112":
        return build_scene(parse_scene(_sphere_field(112)), device=dev)
    return build_scene(parse_scene(_BOX_SMIN), device=dev)


def _rays(scene, cfg, h, w):
    """Per light, the shadow rays of K3's shading points at h x w AA:
    (origin, direction, distance to the light), contiguous."""
    import torch

    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.camera import camera_rays
    from loltracer_tpu_torch.render.vecmath import dot, normalize

    st, params = scene.structure, scene.params
    ro, rd = camera_rays(params, h, w, cfg)
    m = mk.march_values(st, cfg, ro, rd, mk.pack_march_scene(st, params))
    p = ro + torch.where(m.t < cfg.max_dist, m.t, m.t_close)[..., None] * rd
    out = []
    for li in range(st.num_lights):
        to_light = params.light_point[li] - p
        ld = normalize(to_light)
        out.append(tuple(x.contiguous() for x in (
            p + ld * cfg.shadow_offset, ld, torch.sqrt(dot(to_light, to_light)))))
    return out


CASES = [("scene4", H, W), ("box_smin", 97, 161), ("spheres112", 97, 161)]
# each ray's g_ro, g_rd: 1e-4 of the largest (tests/test_train.py's rule)
# on all but RAYS_OFF rays (at most 3 seen off, PERF.md: a ray whose march
# ties near a flip of its running minimum takes another gradient from
# another order of rounding, between the plain version on the CPU and on
# the card too)
RAY_TOL, RAYS_OFF = 1e-4, 4
# the summed g_fields against the float64 total of the plain version's
# float32 terms, element by element in units of those terms' magnitudes
# (their sum cancels: the magnitudes sum to 2e3-2e5 times the largest
# total, so float32 resolves no total better than ~6e-8 of its mass): the
# kernel's per-thread, block and fixed-order float32 sums read up to 5.6e-7
# of the mass, a launch without the largest gradient's tile 1.2e-4 or more
# (PERF.md)
FIELDS_TOL, MASS_FLOOR = 4e-6, 1e-6


def _rays_near(got, want, what):
    """Each ray's cotangents within RAY_TOL of want's largest magnitude on
    all but RAYS_OFF rays; returns the rays off."""
    scale = max(float(want.abs().max()), 1e-6)
    off = int(((got - want).abs() > RAY_TOL * scale).any(dim=-1).sum())
    assert off <= RAYS_OFF, (what, off)
    return off


def _total_near(got, want, mass, what):
    """A summed gradient within FIELDS_TOL of the float64 total want, in
    units of its terms' magnitudes mass, element by element (at least
    MASS_FLOOR of the largest mass: a slot a single 128-step ray barely
    touches takes a term torch on the card rounds 1e-5 apart from the
    kernel and from torch on the CPU), and zero where it has no terms;
    returns the worst share."""
    has = mass > 0
    assert not got[~has].any(), (what, "a gradient where no term reaches")
    unit = mass[has].clamp(min=MASS_FLOOR * float(mass.max()))
    err = float(((got.double() - want).abs()[has] / unit).max())
    assert err <= FIELDS_TOL, (what, err)
    return err


@pytest.mark.chip
@pytest.mark.parametrize("name,h,w", CASES)
def test_k4x_res_is_bitwise_the_loops(chip, name, h, w):
    import torch

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.sdf import make_scene_sdf
    from loltracer_tpu_torch.render.shading import shadow_march

    sc = _scene(name, chip)
    cfg = RenderConfig(antialias=True)
    sdf = make_scene_sdf(sc.structure)
    before = mk.launches[mk.EXACT_SHADOW]
    with torch.no_grad():
        for so, ld, dist in _rays(sc, cfg, h, w):
            want, _ = shadow_march(sdf, sc.params, so, ld, dist, cfg)
            for c in (cfg, cfg.replace(shadow_cull=False)):
                res, _ = mk.make_cuda_exact_shadow(sc.structure, c)(sc.params, so, ld, dist)
                assert torch.equal(res, want), int((res != want).sum())
    assert mk.launches[mk.EXACT_SHADOW] == before + 2 * sc.structure.num_lights


@pytest.mark.chip
@pytest.mark.parametrize("name,h,w", CASES)
def test_k4xb_matches_the_reference_and_the_loop(chip, name, h, w):
    import torch

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.render import march_kernels as mk
    from loltracer_tpu_torch.render.sdf import make_scene_sdf
    from loltracer_tpu_torch.render.shading import shadow_march

    sc = _scene(name, chip)
    st = sc.structure
    cfg = RenderConfig(antialias=True)
    fields = mk.pack_march_scene(st, sc.params).fields
    for li, (so, ld, dist) in enumerate(_rays(sc, cfg, h, w)):
        g = torch.randn(dist.shape, generator=torch.Generator(device=chip).manual_seed(li),
                        device=chip)
        f = fields.clone().requires_grad_(True)
        so_k, ld_k = so.clone().requires_grad_(True), ld.clone().requires_grad_(True)
        res = mk.ExactShadow.apply(so_k, ld_k, dist, f, st, cfg)
        got = torch.autograd.grad((res * g).sum(), (so_k, ld_k, f))
        mass = []
        ref = mk.exact_shadow_reference(st, cfg, so, ld, dist, fields, g,
                                        sum_dtype=torch.float64, mass=mass)
        so_l, ld_l = so.clone().requires_grad_(True), ld.clone().requires_grad_(True)
        res_l, _ = shadow_march(make_scene_sdf(st), mk._scene_params(st, mk.MarchScene(fields,
                                                                                    None)),
                                so_l, ld_l, dist, cfg)
        loop = torch.autograd.grad((res_l * g).sum(), (so_l, ld_l))
        assert torch.equal(res.detach(), res_l.detach())
        for what, a, b, c in zip(("g_ro", "g_rd"), got, ref, loop):
            _rays_near(a, b, f"{name} light {li} {what} vs the reference")
            _rays_near(a, c, f"{name} light {li} {what} vs the loop")
        _total_near(got[2], ref[2], mass[0], f"{name} light {li} g_fields vs the float64 total")
        # the check's teeth: the same launch with one 32 x 4 tile's rays left
        # out (a lost block of partials; the tile of the largest g_ro) reads
        # far past the limit
        y, x = divmod(int(got[0].norm(dim=-1).argmax()), dist.shape[1])
        lost = g.clone()
        lost[y // 4 * 4:y // 4 * 4 + 4, x // 32 * 32:x // 32 * 32 + 32] = 0
        g_lost = torch.autograd.grad((mk.ExactShadow.apply(so_k, ld_k, dist, f, st, cfg)
                                      * lost).sum(), f)[0]
        with pytest.raises(AssertionError):
            _total_near(g_lost, ref[2], mass[0], "the lost tile")
        again = torch.autograd.grad((mk.ExactShadow.apply(so_k, ld_k, dist, f, st, cfg) * g).sum(),
                                    (so_k, ld_k, f))
        for a, b in zip(got, again):
            assert torch.equal(a, b), "two backward launches differ"


@pytest.mark.chip
def test_fit_steps_within_the_cells_limits(chip, monkeypatch):
    """fit_scene on scene4 at 960x540 AA with exact shadows, the cell's
    traffic (`fit_540p_exact`: its trainable fields, lr and target grid),
    toward a smooth seeded target: the first three steps through K4x /
    K4xb against the same steps through the plain loop, by
    compare.fit_numbers under the cell's limits."""
    import json

    import torch
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from benchmark.harness import compare
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.opt import fit_scene
    from loltracer_tpu_torch.render import shading, torch_renderer
    from loltracer_tpu_torch.scene import FIELDS

    traffic = json.loads((ROOT / "benchmark" / "traffic" / "fit_540p_exact.json").read_text())
    sc = _scene("scene4", chip)
    cfg = RenderConfig(antialias=True)
    # fit_scene's Adam takes the trainable fields in FIELDS order, empty ones
    # too; the numbers compare the leaves with elements, as the cell's kind
    trainable = [f for f in FIELDS if f in traffic["trainable"]]
    leaves = [f for f in trainable if getattr(sc.params, f).numel()]
    g = torch.Generator(device=chip).manual_seed(11)
    coarse = torch.rand((1, 3, *traffic["target_grid"]), generator=g, device=chip)
    target = (0.05 + 0.55 * torch.nn.functional.interpolate(
        coarse, size=(H, W), mode="bilinear", align_corners=False))[0].permute(1, 2, 0)
    target = target.contiguous()

    def job():
        got, n = {}, [0]

        def hook(opt, args, kwargs):
            n[0] += 1
            ps = opt.param_groups[0]["params"]
            if n[0] == 2:
                got["grad1"] = {f: float((opt.state[p]["exp_avg"].double() / 0.1).norm())
                                for f, p in zip(trainable, ps) if f in leaves}
            if n[0] == 4:
                got["change"] = {f: float((p.detach().double()
                                           - getattr(sc.params, f).double()).norm())
                                 for f, p in zip(trainable, ps) if f in leaves}

        handle = register_optimizer_step_pre_hook(hook)
        try:
            r = fit_scene(sc.structure, sc.params, target, steps=4, learning_rate=traffic["lr"],
                          trainable=tuple(trainable), cfg=cfg, device=chip)
        finally:
            handle.remove()
        return {"losses": [float(v) for v in r.losses[:3]], **got}

    k0 = dict(shading.exact_marches)
    kernel = job()
    assert shading.exact_marches["kernel"] > k0["kernel"]
    assert shading.exact_marches["loop"] == k0["loop"]
    route = torch_renderer._march_kernels
    monkeypatch.setattr(torch_renderer, "_march_kernels",
                        lambda *a: (route(*a)[0], None))
    loop = job()
    assert shading.exact_marches["loop"] > k0["loop"]
    numbers = compare.fit_numbers(kernel, loop)
    limits = compare.load_limits(ROOT, "scene4-fit-exact-540p")
    for k, limit in limits.items():
        assert numbers[k] <= limit, (k, numbers[k], limit, numbers)
