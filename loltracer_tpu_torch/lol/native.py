"""ctypes binding for the native C++ .lol parser (`loltracer_tpu/lol/native.py`
over native/lolparse.cpp).

The native parser is the framework's counterpart of the reference's
flex/bison frontend; it performs the same tokenization, grammar, semantic
extraction and validation as the Python parser and returns JSON, which
this module turns into the port's AST (raising the port's LolSyntaxError).
Parity between the two is tested in tests/test_torch_native.py.

The shared library is compiled at first use from the repo's
native/lolparse.cpp with g++ and the flags of native/Makefile, into
loltracer_tpu_torch/_build/ under a name keyed by the sha256 of the source
and the flags, as `_build.py` keys the CUDA libraries; native/ itself is
only read. Without g++, `native_available()` is False and
`parse_scene_native` raises RuntimeError: callers fall back to the Python
parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
from typing import Optional

from loltracer_tpu_torch._build import BUILD_DIR
from loltracer_tpu_torch.lol.ast import (
    Box,
    Camera,
    Light,
    Material,
    ObjectAst,
    Plane,
    SceneAst,
    SmoothUnion,
    Sphere,
)
from loltracer_tpu_torch.lol.parser import LolSyntaxError

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "lolparse.cpp"
# native/Makefile's CXXFLAGS and link step
CXX_FLAGS = ("-O2", "-Wall", "-Wextra", "-std=c++17", "-fPIC", "-shared")

_lib = None


def _compile() -> Optional[pathlib.Path]:
    """The built library's path, compiling it first if needed; None
    without g++ or the source, or when g++ fails."""
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.is_file():
        return None
    source = SOURCE.read_bytes()
    key = hashlib.sha256(source + "\0".join(CXX_FLAGS).encode()).hexdigest()[:24]
    so = BUILD_DIR / f"liblolparse-{key}.so"
    if not so.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, so)  # atomic: a concurrent process never loads half a file
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    so = _compile()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.lol_parse.argtypes = [ctypes.c_char_p]
    lib.lol_parse.restype = ctypes.c_void_p
    lib.lol_free.argtypes = [ctypes.c_void_p]
    lib.lol_free.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _v3(x) -> tuple:
    return (float(x[0]), float(x[1]), float(x[2]))


def _object_from_json(o: dict) -> ObjectAst:
    t = o["type"]
    if t == "sphere":
        return Sphere(
            point=_v3(o["point"]),
            radius=float(o["radius"]),
            material=int(o["material"]),
        )
    if t == "box":
        return Box(
            point=_v3(o["point"]),
            point2=_v3(o["point2"]),
            radius=float(o["radius"]),
            material=int(o["material"]),
        )
    if t == "plane":
        return Plane(y=float(o["y"]), material=int(o["material"]))
    if t == "smooth_union":
        return SmoothUnion(
            smoothness=float(o["smoothness"]),
            a=_object_from_json(o["a"]),
            b=_object_from_json(o["b"]),
            material=int(o["material"]),
        )
    raise ValueError(f"unknown object type {t!r}")


def parse_scene_native(text: str) -> SceneAst:
    """Parse .lol text with the native parser. Raises LolSyntaxError with
    the same messages/line numbers as the Python parser; RuntimeError if
    the native library cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser library unavailable (no g++?)")
    ptr = lib.lol_parse(text.encode("utf-8"))
    try:
        payload = ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.lol_free(ptr)
    data = json.loads(payload)
    if "error" in data:
        raise LolSyntaxError(data["error"], data["line"])
    cam = data["camera"]
    return SceneAst(
        materials=tuple(
            Material(
                shininess=float(m["shininess"]),
                diffuse=_v3(m["diffuse"]),
                specular=_v3(m["specular"]),
                ambient=_v3(m["ambient"]),
            )
            for m in data["materials"]
        ),
        ambient_color=_v3(data["ambient_color"]),
        lights=tuple(
            Light(
                point=_v3(l["point"]),
                diffuse_intensity=_v3(l["diffuse_intensity"]),
                specular_intensity=_v3(l["specular_intensity"]),
            )
            for l in data["lights"]
        ),
        objects=tuple(_object_from_json(o) for o in data["objects"]),
        camera=Camera(
            point=_v3(cam["point"]),
            direction=_v3(cam["direction"]),
            fov=float(cam["fov"]),
        ),
    )


def parse_scene_file_native(path: str) -> SceneAst:
    with open(path, "r") as f:
        return parse_scene_native(f.read())
