"""Interactive camera controls and terminal preview (`loltracer_tpu/interactive.py`).

Replaces the reference's SDL window + WASD/arrow fly camera (main.c:26-112,
163-211) with a pure functional camera update and an ANSI half-block
terminal viewer (two pixels per character cell). The camera math replicates
update_camera exactly: translate along direction/right/up-axis by 0.1 per
frame, rotate by nudging the direction along the right/up basis vectors and
renormalizing (main.c:70-112 — including its 'ultra hacky' rotation feel).
The camera update runs in float64 NumPy, as the JAX package's does, so the
moved camera is bitwise its.

Frames come from the port's forward path for the scene's device
(`resolve_viewer_renderer`): on the card the fused kernel K1
(`lol_render_fused`), or K5 for instanced scenes; on the CPU the plain
renderer. Two differences from the JAX package's viewer:
- an explicit size renders at exactly that size, or is refused
  (`check_view_size`); the JAX package rounds it silently;
- keys are read from the terminal's file descriptor, so a burst of keys
  (a "q" among them) is seen in the frame it arrives in, not left in a
  text buffer that `select` cannot see.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Set, Tuple

import numpy as np
import torch

from loltracer_tpu_torch.scene import Scene, SceneParams

STEP = 0.1  # per-frame movement/rotation step (main.c:78-111)
MIN_SIZE = 16  # the smallest frame side (terminal_frame_size's floor)


def _normalize(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def update_camera(
    point: np.ndarray, direction: np.ndarray, keys: Set[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """One frame of camera motion. `keys` holds any of
    w/a/s/d/space/ctrl/up/down/left/right (pressed this frame)."""
    point = np.asarray(point, np.float64).copy()
    direction = np.asarray(direction, np.float64).copy()
    up_guide = np.array([0.0, 1.0, 0.0])
    right_dir = _normalize(np.cross(direction, up_guide))
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


def move_camera(params: SceneParams, keys: Set[str]) -> SceneParams:
    """Functional camera update on the scene params; the camera keeps its
    dtype and device."""
    cp, cd = params.cam_point, params.cam_direction
    point, direction = update_camera(
        cp.detach().cpu().numpy(), cd.detach().cpu().numpy(), keys
    )
    dtype = cp.detach().cpu().numpy().dtype
    return dataclasses.replace(
        params,
        cam_point=torch.from_numpy(point.astype(dtype)).to(cp.device),
        cam_direction=torch.from_numpy(direction.astype(dtype)).to(cd.device),
    )


def frame_to_ansi(img: np.ndarray) -> str:
    """[H, W, 3] float -> ANSI truecolor half-block art (2 rows per line)."""
    u8 = np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)
    h = u8.shape[0] - (u8.shape[0] % 2)
    lines = []
    for y in range(0, h, 2):
        top, bot = u8[y], u8[y + 1]
        line = []
        for x in range(u8.shape[1]):
            tr, tg, tb = top[x]
            br, bg, bb = bot[x]
            line.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(line) + "\x1b[0m")
    return "\n".join(lines)


_KEYMAP = {
    "w": "w", "a": "a", "s": "s", "d": "d",
    " ": "space", "c": "ctrl",
    "\x1b[A": "up", "\x1b[B": "down", "\x1b[D": "left", "\x1b[C": "right",
}


def terminal_frame_size(term_size=None, reserve_lines: int = 2):
    """Render size (height, width) for the CURRENT terminal: one pixel per
    column, two per text row (half blocks), minus a status-bar reserve —
    re-read every frame like the reference re-fetches its window surface
    (main.c:182, naive_renderer.c:207-213), so a live resize changes the
    next frame's resolution and camera aspect. Height is even (half-block
    pairs); both dims floor at 16."""
    if term_size is None:
        import shutil

        term_size = shutil.get_terminal_size((96, 38))
    cols, lines = term_size
    width = max(MIN_SIZE, int(cols))
    height = max(MIN_SIZE, 2 * max(int(lines) - reserve_lines, 8))
    return height, width


def check_view_size(width: int, height: int) -> None:
    """Raise ValueError unless (width, height) is a size the viewer renders
    as it is: both at least MIN_SIZE, the height even (half-block pairs)."""
    if width < MIN_SIZE or height < MIN_SIZE or height % 2:
        raise ValueError(
            f"view size {width}x{height}: width and height must be at least "
            f"{MIN_SIZE} and the height even (two pixel rows a text row)"
        )


def resolve_viewer_renderer(scene: Scene, height: int, width: int, cfg):
    """The port's forward path at this size for the scene's device:
    `params -> [H, W, 3]`. On CUDA the fused kernel (K1, or K5 for
    instanced scenes; render/cuda_renderer.make_cuda_renderer); on the CPU
    the plain renderer under no_grad. A scene on a CUDA device without
    CUDA raises there: never a CPU frame in its place."""
    device = scene.params.cam_point.device
    if device.type == "cuda":
        from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer

        return make_cuda_renderer(scene.structure, height, width, cfg, device=device)
    from loltracer_tpu_torch.render.torch_renderer import make_renderer

    plain = make_renderer(scene.structure, height, width, cfg, device=device)

    def renderer(params: SceneParams) -> torch.Tensor:
        with torch.no_grad():
            return plain(params)

    return renderer


class SizeAdaptiveRenderer:
    """Per-size renderer cache for the viewer: frame(params, term_size)
    re-resolves the renderer whenever the terminal size changes (the
    kernel is built once per structure, `_build.py`; a size costs only
    its first call). Tracks build-to-first-frame latency per size."""

    def __init__(self, scene: Scene, cfg):
        self.scene = scene
        self.cfg = cfg
        self._renderers = {}
        self.first_frame_s: dict = {}
        self.size = None

    def frame(self, params: SceneParams, term_size=None, size=None) -> np.ndarray:
        """The frame [H, W, 3] as float32 NumPy: at `size` (height, width)
        when given, exactly (check_view_size), else at the terminal's
        size (terminal_frame_size of `term_size`, or of the live
        terminal)."""
        import time

        if size is not None:
            check_view_size(size[1], size[0])
            self.size = tuple(size)
        else:
            self.size = terminal_frame_size(term_size)
        h, w = self.size
        if (h, w) not in self._renderers:
            t0 = time.perf_counter()
            fn = resolve_viewer_renderer(self.scene, h, w, self.cfg)
            img = fn(params).cpu().numpy()
            self.first_frame_s[(h, w)] = time.perf_counter() - t0
            self._renderers[(h, w)] = fn
            return img
        return self._renderers[(h, w)](params).cpu().numpy()


def read_keys(fd: int) -> Tuple[Set[str], bool]:
    """(keys, quit) from the bytes waiting on `fd` (a terminal in cbreak
    mode), without blocking past 10 ms: every byte read is parsed, so a
    burst of keys is seen at once."""
    import select

    data = b""
    while select.select([fd], [], [], 0.01)[0]:
        chunk = os.read(fd, 1024)
        if not chunk:
            break
        data += chunk
    text = data.decode("utf-8", "replace")
    keys: Set[str] = set()
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "q":
            return keys, True
        if ch == "\x1b":
            ch = text[i:i + 3]
        i += len(ch)
        if ch in _KEYMAP:
            keys.add(_KEYMAP[ch])
    return keys, False


def run_viewer(scene: Scene, width: int = None, height: int = None, cfg=None) -> None:
    """Terminal render loop: WASD move, arrows rotate, space/c up/down,
    q quits. Frame-time stats printed like main.c:202-204. With no
    explicit size the viewer follows the live terminal size every frame;
    an explicit size (both given) is rendered exactly, or refused with a
    ValueError (check_view_size) at the first frame."""
    import termios
    import time
    import tty

    from loltracer_tpu_torch.config import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    fixed = (height, width) if height and width else None
    adaptive = SizeAdaptiveRenderer(scene, cfg)
    params = scene.params

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    frames = 0
    tmin, tmax, ttot = float("inf"), 0.0, 0.0
    try:
        tty.setcbreak(fd)
        sys.stdout.write("\x1b[2J")  # clear
        while True:
            t0 = time.perf_counter()
            img = adaptive.frame(params, size=fixed)
            dt = time.perf_counter() - t0
            frames += 1
            tmin, tmax, ttot = min(tmin, dt), max(tmax, dt), ttot + dt
            h, w = adaptive.size
            first = adaptive.first_frame_s.get((h, w), 0.0)
            sys.stdout.write("\x1b[H" + frame_to_ansi(img) + "\n")
            sys.stdout.write(
                f"{w}x{h}  frame {frames}  time {dt*1e3:.0f}ms  "
                f"min {tmin*1e3:.0f} max {tmax*1e3:.0f} "
                f"avg {ttot/frames*1e3:.0f}  first {first*1e3:.0f}ms   "
                "[wasd move, arrows rotate, space/c up/down, q quit]\x1b[K\n"
            )
            sys.stdout.flush()

            keys, quit_ = read_keys(fd)
            if quit_:
                return
            if keys:
                params = move_camera(params, keys)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")
