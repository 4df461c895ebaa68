"""The `.lol` scene-description DSL frontend: tokenizer, parser, AST."""

from loltracer_tpu_torch.lol.ast import (
    Box,
    Camera,
    Light,
    Material,
    Plane,
    SceneAst,
    SmoothUnion,
    Sphere,
)
from loltracer_tpu_torch.lol.parser import LolSyntaxError, parse_scene, parse_scene_file

__all__ = [
    "Material",
    "Camera",
    "Light",
    "Sphere",
    "Box",
    "Plane",
    "SmoothUnion",
    "SceneAst",
    "parse_scene",
    "parse_scene_file",
    "LolSyntaxError",
]
