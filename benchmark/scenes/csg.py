"""A scene of compiled CSG objects whose numbers are frozen in the
configuration file itself (the structure and every parameter array)."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.data import SceneData


def build(entry: dict) -> SceneData:
    structure = dict(entry["structure"], instanced=False)
    arrays = {
        f: np.asarray(spec["values"], np.float32).reshape(spec["shape"])
        for f, spec in entry["params"].items()
    }
    return SceneData(structure, arrays)
