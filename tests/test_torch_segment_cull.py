"""The port's plain shadow segment cull (`render/shading.py` `segment_lit`)
against the JAX package's `ScalarScene.segment_lit`
(`loltracer_tpu/render/pallas_scene.py`), on CPU tensors:

- the flags bitwise JAX's on scene2, scene3 and scene4 over the rays of
  tests/test_segment_cull.py (numpy RandomState(0), n = 512), on a
  structure with a box, and on one with a smooth-min over a plane (which
  culls nothing);
- soundness: wherever a flag is set, the port's plain shadow march gives
  res == 1 and t* == 0 exactly, and the march started done there
  (`init_done`, as the kernels skip it) gives every plane bitwise.

The generated `Scene::segment_lit` is held to these flags in
tests/test_torch_train_host.py."""

import jax
import numpy as np
import pytest
import torch

from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.lol import parse_scene as jax_parse_scene
from loltracer_tpu.lol import parse_scene_file as jax_parse_scene_file
from loltracer_tpu.render.pallas_scene import GEOM_FIELDS, ScalarScene, active_fields
from loltracer_tpu.render.pallas_scene import array_param_values
from loltracer_tpu.scene import build_scene as jax_build_scene
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene, parse_scene_file
from loltracer_tpu_torch.render.sdf import make_scene_sdf
from loltracer_tpu_torch.render.shading import segment_allowed, segment_lit, shadow_march
from loltracer_tpu_torch.scene import build_scene

torch.set_num_threads(1)  # one intra-op thread per pytest worker

CFG = RenderConfig()

# A sphere beside a rounded box over a floor, one light; and a smooth-min
# whose second operand is the floor.
_BOX = """
materials {
  { shininess = 0, diffuse = (0, 0, 0), specular = (0, 0, 0), ambient = (0, 0, 0) },
  { shininess = 8, diffuse = (0.5, 0.5, 0.5), specular = (0.2, 0.2, 0.2), ambient = (0.1, 0.1, 0.1) }
}
scene {
  ambient { color = (0.1, 0.1, 0.1) },
  camera { point = (0, 1, 3), direction = (0, -0.2, -1), fov = 90 },
  point_light { point = (-2, 9, -1), diffuse_intensity = (1, 1, 1), specular_intensity = (1, 1, 1) },
  sphere { point = (1.5, 0.5, -4), radius = 0.8, material = #1 },
  box { point = (-1.5, 0.5, -3), point2 = (1.2, 0.7, 0.9), radius = 0.2, material = #1 },
  plane { y = -1, material = #1 }
}
"""
_SMIN_PLANE = """
materials {
  { shininess = 0, diffuse = (0, 0, 0), specular = (0, 0, 0), ambient = (0, 0, 0) },
  { shininess = 8, diffuse = (0.5, 0.5, 0.5), specular = (0.2, 0.2, 0.2), ambient = (0.1, 0.1, 0.1) }
}
scene {
  ambient { color = (0.1, 0.1, 0.1) },
  camera { point = (0, 1, 3), direction = (0, -0.2, -1), fov = 90 },
  point_light { point = (-2, 9, -1), diffuse_intensity = (1, 1, 1), specular_intensity = (1, 1, 1) },
  sphere { point = (2, 1, -5), radius = 1, material = #1 },
  smooth-union { smoothness = 0.5, material = #1,
    a = sphere { point = (0, 0, -4), radius = 1 },
    b = plane { y = -1 } }
}
"""


def _rays(n=512):
    """tests/test_segment_cull.py's rays: origins across the scene volume,
    targets around the lights' region."""
    rng = np.random.RandomState(0)
    so = rng.uniform((-4, -2, -6), (4, 4, 2), size=(n, 3)).astype(np.float32)
    tgt = rng.uniform((-6, 3, -6), (6, 8, 2), size=(n, 3)).astype(np.float32)
    d = tgt - so
    T = np.linalg.norm(d, axis=-1).astype(np.float32)
    return so, d / T[:, None], T


def _jax_flags(scene, so, ld, T):
    st = scene.structure
    scn = ScalarScene(st, array_param_values(st, scene.params, active_fields(st, GEOM_FIELDS)))

    def planes(a):
        return jax.numpy.asarray(a, jax.numpy.float32).reshape(1, -1)

    sop = tuple(planes(so[:, i]) for i in range(3))
    ldp = tuple(planes(ld[:, i]) for i in range(3))
    lit = jax.jit(lambda: scn.segment_lit(sop, ldp, planes(T), None,
                                          JaxRenderConfig().shadow_w))()
    return np.asarray(lit)[0] > 0.5


def _port_flags(scene, so, ld, T):
    lit = segment_lit(scene.structure, scene.params, torch.from_numpy(so), torch.from_numpy(ld),
                      torch.from_numpy(T), CFG.shadow_w)
    return lit.numpy()


def _scenes(examples_dir, name):
    if name == "box":
        return build_scene(parse_scene(_BOX), device="cpu"), jax_build_scene(jax_parse_scene(_BOX))
    if name == "smin_plane":
        return (build_scene(parse_scene(_SMIN_PLANE), device="cpu"),
                jax_build_scene(jax_parse_scene(_SMIN_PLANE)))
    path = str(examples_dir / name)
    return build_scene(parse_scene_file(path), device="cpu"), jax_build_scene(
        jax_parse_scene_file(path))


CASES = ["scene2.lol", "scene3.lol", "scene4.lol", "box", "smin_plane"]


@pytest.mark.parametrize("name", CASES)
def test_segment_lit_flags_are_jaxs(examples_dir, name):
    port, ref = _scenes(examples_dir, name)
    so, ld, T = _rays()
    with torch.no_grad():
        ours = _port_flags(port, so, ld, T)
    np.testing.assert_array_equal(ours, _jax_flags(ref, so, ld, T))
    if name == "smin_plane":
        assert not segment_allowed(port.structure) and not ours.any()
    else:
        assert segment_allowed(port.structure) and ours.any(), "the bound never fires"


@pytest.mark.parametrize("name", ["scene2.lol", "scene3.lol", "scene4.lol", "box"])
def test_segment_lit_is_sound(examples_dir, name):
    """Where a flag is set the plain march gives res == 1 and t* == 0, so
    the march started done there gives both planes bitwise; the flagged
    rays evaluate nothing."""
    port, _ = _scenes(examples_dir, name)
    so, ld, T = (torch.from_numpy(a) for a in _rays())
    sdf = make_scene_sdf(port.structure)
    with torch.no_grad():
        lit = segment_lit(port.structure, port.params, so, ld, T, CFG.shadow_w)
        res, t_star = shadow_march(sdf, port.params, so, ld, T, CFG)
        counts = torch.zeros(T.shape, dtype=torch.int32)
        res_c, t_star_c = shadow_march(sdf, port.params, so, ld, T, CFG, init_done=lit,
                                       counts=counts)
    assert int(lit.sum()) > 0
    assert bool((res[lit] == 1.0).all()) and bool((t_star[lit] == 0.0).all())
    assert torch.equal(res, res_c) and torch.equal(t_star, t_star_c)
    assert int(counts[lit].sum()) == 0 and bool((counts[~lit] > 0).all())
