"""Host side of the port's CUDA kernel, on a machine without CUDA: the
generated source (deterministic, one per structure, free of scene numbers),
the packed scene buffer, and the wrapper's device rules — CPU tensors take
the plain version and launch nothing, a CUDA request without CUDA raises.
The kernel itself runs only on the card (chip_smoke.py, phase 2)."""

import numpy as np
import pytest
import torch

from loltracer_tpu_torch import cli
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene, parse_scene_file
from loltracer_tpu_torch.render import fused_fwd
from loltracer_tpu_torch.render.backend import resolve_backend
from loltracer_tpu_torch.render.camera import camera_pack
from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
from loltracer_tpu_torch.render.cuda_scene import (
    _f32,
    generate_source,
    pack_fields,
    packed_size,
    unpack_fields,
)
from loltracer_tpu_torch.render.torch_renderer import make_renderer
from loltracer_tpu_torch.scene import build_scene
from loltracer_tpu_torch.utils.image import image_to_u8, read_png

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]

# One structure (a sphere, a rounded box, a smooth union, a plane, two
# lights), two sets of numbers that occur nowhere else in the source.
_TEMPLATE = """
materials {{
  {{ shininess = {m0}, diffuse = (0, 0, 0), specular = (0, 0, 0), ambient = ({m1}, 0, 0) }},
  {{ shininess = {m2}, diffuse = ({m3}, {m4}, 0), specular = (0, {m5}, 0), ambient = (0, 0, {m6}) }}
}}
scene {{
  ambient {{ color = ({a0}, {a0}, {a0}) }},
  camera {{ point = ({c0}, {c1}, {c2}), direction = ({c3}, -0.25, -1), fov = {c4} }},
  point_light {{ point = ({l0}, {l1}, {l2}), diffuse_intensity = ({l3}, 1, 1), specular_intensity = (1, {l4}, 1) }},
  point_light {{ point = ({l5}, 3, -2), diffuse_intensity = (1, 1, 1), specular_intensity = (1, 1, 1) }},
  sphere {{ point = ({s0}, {s1}, {s2}), radius = {s3}, material = #1 }},
  box {{ point = ({b0}, 0.5, {b1}), point2 = ({b2}, {b3}, 0.75), radius = {b4}, material = #1 }},
  smooth-union {{ smoothness = {k0}, material = #1,
    a = sphere {{ point = ({u0}, 1, -7), radius = {u1} }},
    b = sphere {{ point = (1, {u2}, -9), radius = {u3} }} }},
  plane {{ y = {p0}, material = #1 }}
}}
"""
_KEYS = ["m0", "m1", "m2", "m3", "m4", "m5", "m6", "a0", "c0", "c1", "c2", "c3",
         "c4", "l0", "l1", "l2", "l3", "l4", "l5", "s0", "s1", "s2", "s3", "b0",
         "b1", "b2", "b3", "b4", "k0", "u0", "u1", "u2", "u3", "p0"]


def _numbers(seed):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.1, 0.9, len(_KEYS)) + rng.integers(1, 6, len(_KEYS))
    return {k: f"{v:.5f}" for k, v in zip(_KEYS, vals)}


def _structured(seed):
    return build_scene(parse_scene(_TEMPLATE.format(**_numbers(seed))), device="cpu")


@pytest.fixture(scope="module")
def examples(examples_dir):
    return {n: build_scene(parse_scene_file(str(examples_dir / n)), device="cpu") for n in SCENES}


def test_source_is_deterministic(examples):
    s = examples["scene4.lol"].structure
    assert generate_source(s, RenderConfig()) == generate_source(s, RenderConfig())


def test_source_has_offsets_not_numbers():
    a, b = _structured(1), _structured(2)
    assert a.structure == b.structure
    src_a = generate_source(a.structure, RenderConfig())
    assert src_a == generate_source(b.structure, RenderConfig())
    for seed in (1, 2):
        for text in _numbers(seed).values():
            assert text not in src_a
            assert _f32(float(text)) not in src_a


def test_source_differs_between_structures(examples):
    sources = {generate_source(s.structure, RenderConfig()) for s in examples.values()}
    assert len(sources) == len(SCENES)
    s = examples["scene.lol"].structure
    assert generate_source(s, RenderConfig(antialias=True)) != generate_source(
        s, RenderConfig()
    )


@pytest.mark.parametrize("x", [1e-3, 100.0, 50.0, 0.01, 1 / 2.2, 1.0])
def test_float_literals_are_exact(x):
    lit = _f32(x)
    assert lit.endswith("f") and float.fromhex(lit[:-1]) == float(np.float32(x))


def test_pack_fields_round_trips(examples):
    for scene in list(examples.values()) + [_structured(3)]:
        st, params = scene.structure, scene.params
        buf = pack_fields(st, params)
        assert buf.shape == (packed_size(st),)
        for f, v in unpack_fields(st, buf).items():
            assert torch.equal(v, getattr(params, f).to(torch.float32)), f


def test_cpu_tensors_take_plain_version_and_launch_nothing(examples):
    scene = _structured(4)
    cfg = RenderConfig()
    fused_fwd.launches = 0
    cam = camera_pack(scene.params, 6, 10, cfg)
    fields = pack_fields(scene.structure, scene.params)
    img = fused_fwd.fused_forward(scene.structure, cfg, cam, fields, 6, 10)
    ref = make_renderer(scene.structure, 6, 10, cfg)(scene.params)
    assert fused_fwd.launches == 0
    assert torch.equal(img, ref)
    cpu = make_cuda_renderer(scene.structure, 6, 10, cfg, device="cpu")
    assert torch.equal(cpu(scene.params), ref)
    assert fused_fwd.launches == 0


def test_backend_follows_tensor_device():
    cpu = torch.zeros(3)
    assert resolve_backend(cpu, cpu) == "torch"
    with pytest.raises(ValueError):
        resolve_backend(torch.zeros(3, device="meta"))


def test_cuda_request_without_cuda_raises(examples, monkeypatch, tmp_path, examples_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_cuda_renderer(examples["scene4.lol"].structure, 8, 8)
    out = tmp_path / "out.png"
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["render", str(examples_dir / "scene4.lol"), "--size", "8x4", "-o", str(out)])
    assert not out.exists()


def test_cli_render_cpu_and_info(examples, examples_dir, tmp_path, capsys):
    out = tmp_path / "out.png"
    fused_fwd.launches = 0
    cli.main(["render", str(examples_dir / "scene3.lol"), "--size", "12x6",
              "--device", "cpu", "-o", str(out)])
    ref = make_renderer(examples["scene3.lol"].structure, 6, 12)(examples["scene3.lol"].params)
    assert np.array_equal(read_png(str(out)), image_to_u8(ref.numpy()))
    assert fused_fwd.launches == 0
    cli.main(["info", str(examples_dir / "scene4.lol")])
    assert '"spheres": 5' in capsys.readouterr().out
    cli.main(["info", "instanced:100"])
    out = capsys.readouterr().out
    assert '"spheres": 100' in out and '"objects": 101' in out
