"""The port's native parser binding (loltracer_tpu_torch/lol/native.py over
native/lolparse.cpp) against the port's Python parser and the JAX
package's binding: the same AST on the examples, the same errors and line
numbers (tests/test_native_parser.py's cases), the same default camera;
the library built into the port's build directory."""

import dataclasses
import math

import pytest

from loltracer_tpu.lol import native as jnative
from loltracer_tpu_torch._build import BUILD_DIR
from loltracer_tpu_torch.lol import LolSyntaxError, native, parse_scene, parse_scene_file

SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
ERRORS = [  # tests/test_native_parser.py:36-47
    "materials { { shininess = 1-2 } } scene { plane { y = 0 } }",
    "materials { { shininess = 1 } } scene { plane { y = 0 } } $",
    "materials { { bogus = 1 } } scene { plane { y = 0 } }",
    "materials { { radius = 1 } } scene { plane { y = 0 } }",
    "materials { { shininess = (1,2) } } scene { plane { y = 0 } }",
    "materials { { shininess = 1 } } scene { sphere { material = #5 } }",
    "materials { { shininess = 1 } } scene { camera { direction = (0,0,0) } }",
    "materials { { shininess = 1 } } scene { smooth_union { smoothness = 1 } }",
]


@pytest.fixture(scope="module", autouse=True)
def built():
    if not native.native_available():
        pytest.skip("g++ not found: the native parser cannot be built")


def _plain(x):
    """An AST as nested tuples of (type name, field values): the port's
    and the JAX package's AST classes are distinct types."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(_plain(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, tuple):
        return tuple(_plain(v) for v in x)
    return x


@pytest.mark.parametrize("name", SCENES)
def test_examples_parity(examples_dir, name):
    path = str(examples_dir / name)
    py, cc = parse_scene_file(path), native.parse_scene_file_native(path)
    assert py.materials == cc.materials
    assert py.ambient_color == cc.ambient_color
    assert py.lights == cc.lights
    assert py.objects == cc.objects
    assert py.camera.point == cc.camera.point
    # the camera's normalisation may differ by an ulp between C++ and Python
    for a, b in zip(py.camera.direction, cc.camera.direction):
        assert a == pytest.approx(b, abs=1e-12)
    assert py.camera.fov == pytest.approx(cc.camera.fov, abs=1e-12)
    assert _plain(cc) == _plain(jnative.parse_scene_file_native(path))


@pytest.mark.parametrize("text", ERRORS)
def test_error_parity(text):
    with pytest.raises(LolSyntaxError) as py:
        parse_scene(text)
    with pytest.raises(LolSyntaxError) as cc:
        native.parse_scene_native(text)
    with pytest.raises(jnative.LolSyntaxError) as jx:
        jnative.parse_scene_native(text)
    assert str(cc.value) == str(jx.value) and cc.value.line == jx.value.line
    assert py.value.line == cc.value.line


def test_error_line_number():
    text = "materials {\n  { shininess = 1 }\n}\nscene {\n  plane { y = &0 }\n}"
    with pytest.raises(LolSyntaxError, match="line 5"):
        native.parse_scene_native(text)


def test_default_camera_parity():
    text = "materials { { shininess = 1 } } scene { plane { y = 0 } }"
    py, cc = parse_scene(text), native.parse_scene_native(text)
    assert cc.camera.direction == (0.0, 0.0, 1.0)
    assert cc.camera.fov == pytest.approx(math.pi / 2)
    assert py.camera == cc.camera


def test_built_into_the_port_build_dir():
    so = native._compile()
    assert so.parent == BUILD_DIR and so.name.startswith("liblolparse-")
    assert native.SOURCE == BUILD_DIR.parents[1] / "native" / "lolparse.cpp"


def test_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.parse_scene_native("materials { { shininess = 1 } } scene { }")
