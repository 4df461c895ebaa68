"""The viewer's fly camera and the camera paths the frame traffic drives.

`update_camera` is a copy of the move rule of the reference's viewer
(main.c:70-112, as the program's interactive.update_camera states it):
translate along the direction, right and world-up axes by STEP a frame,
rotate by nudging the direction along the right and up basis vectors and
renormalising, all in float64.
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

STEP = 0.1
MOVES = ("w", "a", "s", "d", "space", "ctrl")
TURNS = ("up", "down", "left", "right")


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def update_camera(point, direction, keys: Set[str]) -> Tuple[np.ndarray, np.ndarray]:
    point = np.asarray(point, np.float64).copy()
    direction = np.asarray(direction, np.float64).copy()
    right_dir = _normalize(np.cross(direction, np.array([0.0, 1.0, 0.0])))
    up_dir = _normalize(np.cross(right_dir, direction))
    if "w" in keys:
        point += direction * STEP
    if "a" in keys:
        point -= right_dir * STEP
    if "s" in keys:
        point -= direction * STEP
    if "d" in keys:
        point += right_dir * STEP
    if "space" in keys:
        point[1] += STEP
    if "ctrl" in keys:
        point[1] -= STEP
    if "up" in keys:
        direction = _normalize(direction + up_dir * STEP)
    if "down" in keys:
        direction = _normalize(direction - up_dir * STEP)
    if "left" in keys:
        direction = _normalize(direction - right_dir * STEP)
    if "right" in keys:
        direction = _normalize(direction + right_dir * STEP)
    return point, direction


def key_cycle(seed: int, frames: int, turn_every: int) -> List[Set[str]]:
    """The keys of each frame of one cycle: every frame one move key, every
    `turn_every`-th frame one turn key besides, each move key and each turn
    key equally often; the seed orders them. Every seed presses the same
    keys, in another order."""
    if frames % len(MOVES) or (frames // turn_every) % len(TURNS):
        raise ValueError(f"{frames} frames do not hold every key equally often")
    rng = np.random.default_rng(seed)
    moves = rng.permutation(np.repeat(np.arange(len(MOVES)), frames // len(MOVES)))
    turns = rng.permutation(np.repeat(np.arange(len(TURNS)),
                                      frames // turn_every // len(TURNS)))
    keys = [{MOVES[m]} for m in moves]
    for j, t in enumerate(turns):
        keys[j * turn_every].add(TURNS[t])
    return keys


def camera_path(point, direction, keys: List[Set[str]]):
    """float32 (point, direction) of each frame: the keys applied frame
    after frame from the start, as the viewer stores them."""
    path = []
    p, d = np.asarray(point, np.float32), np.asarray(direction, np.float32)
    for k in keys:
        p, d = (v.astype(np.float32) for v in update_camera(p, d, k))
        path.append((p, d))
    return path
