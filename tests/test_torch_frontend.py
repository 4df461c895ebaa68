"""The port's frontend (loltracer_tpu_torch: config, lol/, scene, utils/image)
against the JAX package's: the port holds copies of these modules, because
importing anything from loltracer_tpu imports jax. These tests hold the
copies equal."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
from loltracer_tpu.config import RenderConfig as JaxRenderConfig
from loltracer_tpu.lol import LolSyntaxError as JaxLolSyntaxError
from loltracer_tpu.utils import image as jimage
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import LolSyntaxError, parse_scene, parse_scene_file
from loltracer_tpu_torch.scene import (
    FIELDS,
    SceneStructure,
    build_scene,
    params_from_numpy,
    params_to,
)
from loltracer_tpu_torch.utils import image as timage

torch.set_num_threads(1)  # one intra-op thread per pytest worker

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
ROOT = Path(__file__).resolve().parent.parent


def _np_params(params):
    return {f: np.asarray(getattr(params, f)) for f in FIELDS}


def test_render_config_matches():
    assert dataclasses.asdict(RenderConfig()) == dataclasses.asdict(JaxRenderConfig())
    assert [f.name for f in dataclasses.fields(RenderConfig)] == [
        f.name for f in dataclasses.fields(JaxRenderConfig)
    ]
    assert hash(RenderConfig(antialias=True)) == hash(RenderConfig(antialias=True))


@pytest.mark.parametrize("name", SCENES)
def test_ast_matches(examples_dir, name):
    path = str(examples_dir / name)
    assert dataclasses.asdict(parse_scene_file(path)) == dataclasses.asdict(
        jlt.parse_scene_file(path)
    )


@pytest.mark.parametrize("name", SCENES)
def test_build_scene_matches(examples_dir, name):
    path = str(examples_dir / name)
    port = build_scene(parse_scene_file(path), device="cpu")
    ref = jlt.build_scene(jlt.parse_scene_file(path))
    assert isinstance(port.structure, SceneStructure)
    for f in dataclasses.fields(SceneStructure):
        assert getattr(port.structure, f.name) == getattr(ref.structure, f.name), f.name
    assert port.structure.num_objects == ref.structure.num_objects
    for f in FIELDS:
        a = getattr(port.params, f).numpy()
        b = np.asarray(getattr(ref.params, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), f


_BAD = [
    ("materials { { shininess = 1 } }\nscene {\n  sphere { radius = 1 $ }\n}", 3),
    ("materials { { shininess = 1 } }\nscene {\n\n  cube { radius = 1 }\n}", 4),
    ("materials { { shininess = 1 } }\nscene {\n  sphere { radius = (1, 2) }\n}", 3),
    ("materials {\n { shininess = 1 }\n}\nscene {\n  sphere { radius = 1 \n}", 6),
]


@pytest.mark.parametrize("text,line", _BAD)
def test_malformed_input_raises_with_line(text, line):
    with pytest.raises(LolSyntaxError) as err:
        parse_scene(text)
    with pytest.raises(JaxLolSyntaxError) as jerr:
        jlt.parse_scene(text)
    assert err.value.line == jerr.value.line == line
    assert str(err.value) == str(jerr.value)


def test_params_from_numpy_round_trips_jax_params(examples_dir):
    ref = jlt.build_scene(jlt.parse_scene_file(str(examples_dir / "scene4.lol")))
    arrays = _np_params(ref.params)
    port = params_from_numpy(arrays, device="cpu")
    for f in FIELDS:
        back = getattr(port, f).numpy()
        assert back.dtype == arrays[f].dtype and np.array_equal(back, arrays[f]), f
    moved = params_to(port, dtype=__import__("torch").float64)
    assert all(getattr(moved, f).dtype.is_floating_point for f in FIELDS)
    with pytest.raises(KeyError):
        params_from_numpy({k: v for k, v in arrays.items() if k != "smooth_k"}, device="cpu")


def test_builders_default_to_the_card(examples_dir, monkeypatch):
    """build_scene, params_from_numpy and instanced_spheres put their
    parameters on the card unless told otherwise: without CUDA they raise,
    nothing falls back to the CPU."""
    from loltracer_tpu_torch.scenes import instanced_spheres

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ast = parse_scene_file(str(examples_dir / "scene4.lol"))
    arrays = _np_params(build_scene(ast, device="cpu").params)
    for make in (lambda: build_scene(ast), lambda: params_from_numpy(arrays),
                 lambda: instanced_spheres(64)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    assert instanced_spheres(64, device="cpu").params.sphere_point.device.type == "cpu"


def test_png_writer_matches(tmp_path):
    img = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    timage.write_png(str(tmp_path / "a.png"), img)
    jimage.write_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    assert np.array_equal(timage.read_png(str(tmp_path / "a.png")), timage.image_to_u8(img))


def test_port_imports_no_jax():
    """Every module of the port imports without jax (the GPU machine has
    none), so importing all of them must not load it."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import loltracer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 16, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'loltracer_tpu.')) or m == 'loltracer_tpu')\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
