"""The reference's gridded instanced distance (`reference/instanced_grid.py`)
against its brute force (`reference/render._instanced_sdf`), on the CPU:

- distances bitwise at seeded points inside and outside the field's box,
  on sphere surfaces, at exact ties (two spheres alike) and after a step
  that moves the spheres (the grid rebuilt); object ids bitwise wherever
  the distance is below the clamp, the first minimum winning;
- gradients of a loss of the distances in sphere_point, sphere_radius and
  plane_y: bitwise in plane_y, and in the gathered sphere rows equal but
  for the order of each row's sum;
- on the real 10 000-sphere generator and on a 300-sphere field; and a
  frame's loss and gradients through the renderer, bitwise where no
  sphere row sums.
"""

import pytest
import torch

from benchmark.reference import fit as ref_fit
from benchmark.reference import instanced_grid
from benchmark.reference import render as R
from benchmark.reference.render import Settings
from benchmark.scenes.instanced import generate

torch.set_num_threads(1)

CLAMP = 2.0
GEOMETRY = ("sphere_point", "sphere_radius", "plane_y")


@pytest.fixture(scope="module", params=[10_000, 300], ids=["n10000", "n300"])
def field(request):
    n = request.param
    sc = generate(n=n, seed=0) if n == 10_000 else generate(n=n, seed=3, extent=8.0)
    return sc


def _params(sc, grad=False):
    P = {k: torch.tensor(v) for k, v in sc.arrays.items()}
    for f in GEOMETRY:
        P[f].requires_grad_(grad)
    return P


def _points(P, n=4096, seed=0):
    """Seeded points over the field's box grown by 5 units (inside and
    outside it), and on the surfaces of seeded spheres."""
    g = torch.Generator().manual_seed(seed)
    pos, rad = P["sphere_point"].detach(), P["sphere_radius"].detach()
    lo = (pos - rad[:, None]).amin(0) - 5.0
    hi = (pos + rad[:, None]).amax(0) + 5.0
    box = lo + (hi - lo) * torch.rand((n - n // 4, 3), generator=g)
    j = torch.randint(0, pos.shape[0], (n // 4,), generator=g)
    u = torch.nn.functional.normalize(torch.randn((n // 4, 3), generator=g), dim=1)
    surface = pos[j] + u * rad[j, None]
    return torch.cat([box, surface])


def _both(sc, P, p):
    brute = R._instanced_sdf(sc.structure, CLAMP, 2048)
    grid = instanced_grid.scene_sdf(sc.structure, P, CLAMP)
    return brute(P, p), grid(P, p)


def _assert_same(sc, P, p):
    (d1, i1), (d2, i2) = _both(sc, P, p)
    assert torch.equal(d1, d2)
    near = d1 < CLAMP
    assert near.any() and (~near).any()
    assert torch.equal(i1[near], i2[near])
    return near


def test_distances_and_ids_bitwise(field):
    P = _params(field)
    p = _points(P)
    outside = ((p < (P["sphere_point"] - P["sphere_radius"][:, None]).amin(0)) |
               (p > (P["sphere_point"] + P["sphere_radius"][:, None]).amax(0))).any(1)
    assert outside.any() and (~outside).any()
    _assert_same(field, P, p)


def test_exact_ties_take_the_first_sphere(field):
    P = _params(field)
    # sphere 7 copied onto sphere 3: the same distance everywhere
    for f in ("sphere_point", "sphere_radius"):
        P[f][7] = P[f][3]
    g = torch.Generator().manual_seed(1)
    p = P["sphere_point"][3] + 0.3 * torch.randn((256, 3), generator=g)
    p = torch.cat([p, _points(P, 512, seed=2)])
    (d1, i1), (d2, i2) = _both(field, P, p)
    assert torch.equal(d1, d2) and torch.equal(i1[d1 < CLAMP], i2[d1 < CLAMP])
    assert (i2 == 4).any() and not (i2 == 8).any()  # ids are 1-based


def test_after_a_step_the_grid_follows_the_spheres(field):
    P = _params(field)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        P["sphere_point"] += 0.7 * torch.randn(P["sphere_point"].shape, generator=g)
        P["sphere_radius"] *= 1.0 + 0.3 * torch.rand(P["sphere_radius"].shape, generator=g)
    _assert_same(field, P, _points(P, seed=5))


def test_gradients_match_the_brute_force(field):
    p = _points(_params(field), 2048, seed=6)
    w = torch.rand(p.shape[0], generator=torch.Generator().manual_seed(7))
    grads = []
    for make in (lambda sc, P: R._instanced_sdf(sc.structure, CLAMP, 2048),
                 lambda sc, P: instanced_grid.scene_sdf(sc.structure, P, CLAMP)):
        P = _params(field, grad=True)
        pp = p.clone().requires_grad_(True)
        d, _ = make(field, P)(P, pp)
        (d * w).sum().backward()
        grads.append({**{f: P[f].grad for f in GEOMETRY}, "p": pp.grad})
    brute, grid = grads
    assert torch.equal(brute["plane_y"], grid["plane_y"])
    assert torch.equal(brute["p"], grid["p"])
    for f in ("sphere_point", "sphere_radius"):
        assert brute[f].abs().max() > 0
        torch.testing.assert_close(grid[f], brute[f], rtol=0, atol=1e-6 * brute[f].abs().max())


def test_frame_loss_and_gradients_through_the_renderer():
    sc = generate(n=300, seed=3, extent=8.0)
    s = Settings(max_steps=64, shadow_steps=32, step_clamp=CLAMP, antialias=True)
    leaves = [f for f in sc.arrays if sc.arrays[f].size and not f.startswith("cam")]
    target = 0.05 + 0.5 * torch.rand((6, 8, 3), generator=torch.Generator().manual_seed(8))
    out = []
    for step_fn in (ref_fit.frame_loss_and_grads, instanced_grid.frame_loss_and_grads):
        P = {k: torch.tensor(v) for k, v in sc.arrays.items()}
        for f in leaves:
            P[f].requires_grad_(True)
        out.append(step_fn(sc.structure, P, leaves, target, s, 4))
    (l1, g1), (l2, g2) = out
    assert l1 == l2
    for f in leaves:
        if f in ("sphere_point", "sphere_radius"):
            torch.testing.assert_close(g2[f], g1[f], rtol=0, atol=1e-6 * g1[f].abs().max())
        else:
            assert torch.equal(g1[f], g2[f]), f
