"""Tokenizer + recursive-descent parser for the `.lol` scene DSL.

A copy of `loltracer_tpu/lol/parser.py`: importing anything from `loltracer_tpu` runs its
package `__init__`, which imports jax. tests/test_torch_frontend.py holds
the two equal.

Token set and grammar follow the reference's flex lexer (scene-lexer.l:12-48)
and bison grammar (scene-parser.y:73-189); semantic extraction follows
scene.c:140-264 (including camera direction normalization and degrees->radians
conversion, scene.c:173-174, and plane anchoring, scene.c:215).

Deliberate strictness fixes over the reference (documented divergences, see
SURVEY.md §2.1.10):

- numbers must be well-formed floats — the reference's `[-.0-9]+` + sscanf
  silently accepts `1-2`, `--`, `1.2.3`;
- unknown characters are an error with a line number — the reference silently
  skips them (scene-lexer.l:50);
- a zero-length camera direction is an error — the reference normalizes it
  into NaNs;
- duplicate properties keep the last occurrence, matching the reference's
  overwrite-in-order extraction loops.

Both `-` and `_` spellings of multi-word keywords are accepted, as in
scene-lexer.l:20-21,25-26,36-39.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
    Vec3,
)


class LolSyntaxError(ValueError):
    """A parse/semantic error in a .lol file, with a 1-based line number."""

    def __init__(self, message: str, line: int):
        super().__init__(f"line {line}: {message}")
        self.line = line


# --- Tokenizer -------------------------------------------------------------

# Keyword spellings -> canonical keyword (scene-lexer.l:15-46).
_KEYWORDS = {
    "materials": "materials",
    "scene": "scene",
    "ambient": "ambient",
    "camera": "camera",
    "point_light": "point_light",
    "point-light": "point_light",
    "sphere": "sphere",
    "box": "box",
    "plane": "plane",
    "smooth_union": "smooth_union",
    "smooth-union": "smooth_union",
    "shininess": "shininess",
    "diffuse": "diffuse",
    "specular": "specular",
    "color": "color",
    "point": "point",
    "direction": "direction",
    "fov": "fov",
    "diffuse_intensity": "diffuse_intensity",
    "diffuse-intensity": "diffuse_intensity",
    "specular_intensity": "specular_intensity",
    "specular-intensity": "specular_intensity",
    "radius": "radius",
    "material": "material",
    "point2": "point2",
    "y": "y",
    "smoothness": "smoothness",
    "a": "a",
    "b": "b",
}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>[ \t\r]+)
  | (?P<nl>\n)
  | (?P<num>-?(?:\d+\.\d*|\.\d+|\d+))
  | (?P<id>\#\d+)
  | (?P<word>[A-Za-z][A-Za-z0-9_-]*)
  | (?P<punct>[,(){}=])
    """,
    re.VERBOSE,
)


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str  # 'num' | 'id' | keyword | one of ,(){}= | 'eof'
    value: Union[float, int, str, None]
    line: int


def tokenize(text: str) -> List[Token]:
    tokens: List[Token] = []
    line = 1
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise LolSyntaxError(f"unexpected character {text[pos]!r}", line)
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "nl":
            line += 1
            continue
        if m.lastgroup == "num":
            tokens.append(Token("num", float(m.group("num")), line))
        elif m.lastgroup == "id":
            tokens.append(Token("id", int(m.group("id")[1:]), line))
        elif m.lastgroup == "word":
            word = m.group("word")
            kw = _KEYWORDS.get(word)
            if kw is None:
                raise LolSyntaxError(f"unknown keyword {word!r}", line)
            tokens.append(Token(kw, word, line))
        else:
            p = m.group("punct")
            tokens.append(Token(p, p, line))
    tokens.append(Token("eof", None, line))
    return tokens


# --- Parser ----------------------------------------------------------------

_TYPE_KEYWORDS = (
    "ambient",
    "camera",
    "point_light",
    "sphere",
    "box",
    "plane",
    "smooth_union",
)

_PROPERTY_KEYWORDS = (
    "shininess",
    "diffuse",
    "specular",
    "ambient",
    "color",
    "point",
    "direction",
    "fov",
    "diffuse_intensity",
    "specular_intensity",
    "radius",
    "material",
    "point2",
    "y",
    "smoothness",
    "a",
    "b",
)

# A parsed `property = value` pair; value is float | tuple (num list) |
# ('id', int) | ObjectAst.
_Value = Union[float, Tuple[float, ...], Tuple[str, int], ObjectAst]
_Definition = Tuple[str, _Value, int]  # (property, value, line)


class _Parser:
    def __init__(self, tokens: Sequence[Token]):
        self._tokens = tokens
        self._i = 0

    # token plumbing
    def _peek(self) -> Token:
        return self._tokens[self._i]

    def _next(self) -> Token:
        tok = self._tokens[self._i]
        self._i += 1
        return tok

    def _expect(self, kind: str) -> Token:
        tok = self._next()
        if tok.kind != kind:
            raise LolSyntaxError(
                f"expected {kind!r}, found {tok.kind!r}", tok.line
            )
        return tok

    # grammar: input -> materials scene  (scene-parser.y:73-78)
    def parse(self) -> SceneAst:
        materials = self._parse_materials()
        scene = self._parse_scene(materials)
        self._expect("eof")
        return scene

    def _parse_materials(self) -> Tuple[Material, ...]:
        self._expect("materials")
        self._expect("{")
        mats = [self._parse_material()]
        while self._peek().kind == ",":
            self._next()
            mats.append(self._parse_material())
        self._expect("}")
        return tuple(mats)

    def _parse_material(self) -> Material:
        line = self._peek().line
        self._expect("{")
        defs = self._parse_definition_list()
        self._expect("}")
        return _material_from_defs(defs, line)

    def _parse_scene(self, materials: Tuple[Material, ...]) -> SceneAst:
        self._expect("scene")
        self._expect("{")
        builder = _SceneBuilder(materials)
        self._parse_component(builder)
        while self._peek().kind == ",":
            self._next()
            self._parse_component(builder)
        self._expect("}")
        return builder.build()

    def _parse_component(self, builder: "_SceneBuilder") -> None:
        tok = self._next()
        if tok.kind not in _TYPE_KEYWORDS:
            raise LolSyntaxError(
                f"expected a component type, found {tok.kind!r}", tok.line
            )
        self._expect("{")
        defs = self._parse_definition_list()
        self._expect("}")
        builder.add(tok.kind, defs, tok.line)

    def _parse_definition_list(self) -> List[_Definition]:
        defs = [self._parse_definition()]
        while self._peek().kind == ",":
            self._next()
            defs.append(self._parse_definition())
        return defs

    def _parse_definition(self) -> _Definition:
        tok = self._next()
        if tok.kind not in _PROPERTY_KEYWORDS:
            raise LolSyntaxError(
                f"expected a property name, found {tok.kind!r}", tok.line
            )
        self._expect("=")
        value = self._parse_value()
        return (tok.kind, value, tok.line)

    def _parse_value(self) -> _Value:
        tok = self._peek()
        if tok.kind == "num":
            self._next()
            return float(tok.value)  # type: ignore[arg-type]
        if tok.kind == "id":
            self._next()
            return ("id", int(tok.value))  # type: ignore[arg-type]
        if tok.kind == "(":
            self._next()
            nums = [float(self._expect("num").value)]  # type: ignore[arg-type]
            while self._peek().kind == ",":
                self._next()
                nums.append(float(self._expect("num").value))  # type: ignore[arg-type]
            self._expect(")")
            return tuple(nums)
        if tok.kind in _TYPE_KEYWORDS:
            # nested object value (scene-parser.y:140-144)
            self._next()
            self._expect("{")
            defs = self._parse_definition_list()
            self._expect("}")
            return _object_from_defs(tok.kind, defs, tok.line)
        raise LolSyntaxError(f"expected a value, found {tok.kind!r}", tok.line)


# --- Semantic extraction (scene.c:140-264) ---------------------------------


def _as_num(prop: str, value: _Value, line: int) -> float:
    if not isinstance(value, float):
        raise LolSyntaxError(f"property {prop!r} expects a number", line)
    return value


def _as_v3(prop: str, value: _Value, line: int) -> Vec3:
    if not (
        isinstance(value, tuple)
        and len(value) == 3
        and all(isinstance(v, float) for v in value)
    ):
        raise LolSyntaxError(
            f"property {prop!r} expects a 3-component vector", line
        )
    return (value[0], value[1], value[2])


def _as_id(prop: str, value: _Value, line: int) -> int:
    if not (isinstance(value, tuple) and len(value) == 2 and value[0] == "id"):
        raise LolSyntaxError(f"property {prop!r} expects a material #id", line)
    return int(value[1])


def _as_obj(prop: str, value: _Value, line: int) -> ObjectAst:
    if not isinstance(value, (Sphere, Box, Plane, SmoothUnion)):
        raise LolSyntaxError(f"property {prop!r} expects a nested object", line)
    return value


def _extract(
    kind: str,
    defs: Sequence[_Definition],
    spec: Dict[str, str],
    line: int,
) -> Dict[str, Union[float, Vec3, int, ObjectAst]]:
    """Generic property extractor: the analog of scene.c's _Generic-dispatched
    PROP_CASE loops (scene.c:104-138). Unknown properties are an error
    (scene.c:131-134); duplicates overwrite in order."""
    out: Dict[str, Union[float, Vec3, int, ObjectAst]] = {}
    casts = {"num": _as_num, "v3": _as_v3, "id": _as_id, "obj": _as_obj}
    for prop, value, pline in defs:
        if prop not in spec:
            raise LolSyntaxError(f"unknown {kind} property {prop!r}", pline)
        out[prop] = casts[spec[prop]](prop, value, pline)
    return out


def _material_from_defs(defs: Sequence[_Definition], line: int) -> Material:
    p = _extract(
        "material",
        defs,
        {"shininess": "num", "diffuse": "v3", "specular": "v3", "ambient": "v3"},
        line,
    )
    return Material(
        shininess=p.get("shininess", 0.0),  # type: ignore[arg-type]
        diffuse=p.get("diffuse", (0.0, 0.0, 0.0)),  # type: ignore[arg-type]
        specular=p.get("specular", (0.0, 0.0, 0.0)),  # type: ignore[arg-type]
        ambient=p.get("ambient", (0.0, 0.0, 0.0)),  # type: ignore[arg-type]
    )


def _camera_from_defs(defs: Sequence[_Definition], line: int) -> Camera:
    p = _extract(
        "camera", defs, {"point": "v3", "direction": "v3", "fov": "num"}, line
    )
    direction = p.get("direction", (0.0, 0.0, 0.0))
    norm = math.sqrt(sum(c * c for c in direction))  # type: ignore[union-attr]
    if norm == 0.0:
        # Documented strictness fix: the reference would normalize (0,0,0)
        # into NaNs (scene.c:173).
        raise LolSyntaxError("camera direction must be non-zero", line)
    direction = tuple(c / norm for c in direction)  # type: ignore[union-attr]
    fov_deg = p.get("fov", 0.0)
    return Camera(
        point=p.get("point", (0.0, 0.0, 0.0)),  # type: ignore[arg-type]
        direction=direction,  # type: ignore[arg-type]
        fov=float(fov_deg) / 180.0 * math.pi,  # type: ignore[arg-type]
    )


def _light_from_defs(defs: Sequence[_Definition], line: int) -> Light:
    p = _extract(
        "point_light",
        defs,
        {
            "point": "v3",
            "diffuse_intensity": "v3",
            "specular_intensity": "v3",
        },
        line,
    )
    zero = (0.0, 0.0, 0.0)
    return Light(
        point=p.get("point", zero),  # type: ignore[arg-type]
        diffuse_intensity=p.get("diffuse_intensity", zero),  # type: ignore[arg-type]
        specular_intensity=p.get("specular_intensity", zero),  # type: ignore[arg-type]
    )


def _object_from_defs(
    kind: str, defs: Sequence[_Definition], line: int
) -> ObjectAst:
    zero = (0.0, 0.0, 0.0)
    if kind == "sphere":
        p = _extract(
            "sphere", defs, {"point": "v3", "material": "id", "radius": "num"}, line
        )
        return Sphere(
            point=p.get("point", zero),  # type: ignore[arg-type]
            radius=p.get("radius", 0.0),  # type: ignore[arg-type]
            material=p.get("material", 0),  # type: ignore[arg-type]
        )
    if kind == "box":
        p = _extract(
            "box",
            defs,
            {"point": "v3", "material": "id", "point2": "v3", "radius": "num"},
            line,
        )
        return Box(
            point=p.get("point", zero),  # type: ignore[arg-type]
            point2=p.get("point2", zero),  # type: ignore[arg-type]
            radius=p.get("radius", 0.0),  # type: ignore[arg-type]
            material=p.get("material", 0),  # type: ignore[arg-type]
        )
    if kind == "plane":
        p = _extract("plane", defs, {"material": "id", "y": "num"}, line)
        return Plane(
            y=p.get("y", 0.0),  # type: ignore[arg-type]
            material=p.get("material", 0),  # type: ignore[arg-type]
        )
    if kind == "smooth_union":
        p = _extract(
            "smooth_union",
            defs,
            {"material": "id", "smoothness": "num", "a": "obj", "b": "obj"},
            line,
        )
        if "a" not in p or "b" not in p:
            raise LolSyntaxError(
                "smooth_union requires both 'a' and 'b' children", line
            )
        return SmoothUnion(
            smoothness=p.get("smoothness", 0.0),  # type: ignore[arg-type]
            a=p["a"],  # type: ignore[arg-type]
            b=p["b"],  # type: ignore[arg-type]
            material=p.get("material", 0),  # type: ignore[arg-type]
        )
    raise LolSyntaxError(f"{kind!r} cannot be used as a scene object", line)


class _SceneBuilder:
    """Accumulates components in file order (scene.c:229-264)."""

    def __init__(self, materials: Tuple[Material, ...]):
        self.materials = materials
        self.ambient_color: Vec3 = (0.0, 0.0, 0.0)
        self.camera = Camera()
        self.lights: List[Light] = []
        self.objects: List[ObjectAst] = []

    def add(self, kind: str, defs: Sequence[_Definition], line: int) -> None:
        if kind == "ambient":
            p = _extract("ambient", defs, {"color": "v3"}, line)
            self.ambient_color = p.get("color", (0.0, 0.0, 0.0))  # type: ignore[assignment]
        elif kind == "camera":
            self.camera = _camera_from_defs(defs, line)
        elif kind == "point_light":
            self.lights.append(_light_from_defs(defs, line))
        else:
            self.objects.append(_object_from_defs(kind, defs, line))

    def build(self) -> SceneAst:
        return SceneAst(
            materials=self.materials,
            ambient_color=self.ambient_color,
            lights=tuple(self.lights),
            objects=tuple(self.objects),
            camera=self.camera,
        )


def parse_scene(text: str) -> SceneAst:
    """Parse .lol source text into a SceneAst (analog of scene_parse,
    scene-parser.y:197-214, plus the material validation main.c:235)."""
    scene = _Parser(tokenize(text)).parse()
    if not scene.validate_materials():
        raise LolSyntaxError(
            "an object references a material index out of range", 0
        )
    return scene


def parse_scene_file(path: Optional[str]) -> SceneAst:
    """Parse a .lol file; path "-" or None reads stdin, matching the
    reference's `scene_parse(NULL)` fallback (scene-parser.y:200-203)."""
    if path is None or path == "-":
        import sys

        return parse_scene(sys.stdin.read())
    with open(path, "r") as f:
        return parse_scene(f.read())
