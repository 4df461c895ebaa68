"""The port's terminal viewer (loltracer_tpu_torch/interactive.py and
`cli view`) against the JAX package's: the camera update and the ANSI
frame bitwise, the frame size plumbing, the per-size renderer cache on the
CPU, and the viewer itself under a pseudo-terminal. An explicit size is
rendered exactly or refused, never rounded."""

import os
import pty
import re
import select
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import loltracer_tpu as jlt
from loltracer_tpu import interactive as jview
from loltracer_tpu_torch import cli
from loltracer_tpu_torch import interactive as view
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol import parse_scene_file
from loltracer_tpu_torch.render.torch_renderer import make_renderer
from loltracer_tpu_torch.scene import build_scene

torch.set_num_threads(1)  # one intra-op thread per pytest worker

ROOT = Path(__file__).resolve().parent.parent
KEY_SETS = [{k} for k in ("w", "a", "s", "d", "space", "ctrl", "up", "down", "left", "right")] + [
    {"left", "up"}, {"w", "d", "space"}, {"s", "a", "ctrl", "down", "right"}, set(),
]  # tests/test_utils.py's sets, every key alone, and none
STATUS = re.compile(rb"\d+x\d+  frame (\d+)  time")


def _cameras():
    d0 = np.array([0.3, -0.7, -1.0])
    rng = np.random.default_rng(15)
    yield np.zeros(3), np.array([0.0, 0.0, -1.0])
    yield np.zeros(3), d0 / np.linalg.norm(d0)
    for _ in range(4):
        d = rng.normal(size=3)
        yield rng.uniform(-5, 5, 3), d / np.linalg.norm(d)


def test_update_camera_is_bitwise_jax():
    for point, direction in _cameras():
        for keys in KEY_SETS:
            got = view.update_camera(point, direction, keys)
            want = jview.update_camera(point, direction, keys)
            for g, w in zip(got, want):
                assert g.dtype == np.float64
                np.testing.assert_array_equal(g, w, err_msg=str(keys))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_move_camera_is_bitwise_jax(examples_dir, dtype):
    path = str(examples_dir / "scene4.lol")
    params = build_scene(parse_scene_file(path), dtype=dtype, device="cpu").params
    jparams = jlt.build_scene(jlt.parse_scene_file(path),
                              dtype=torch.empty((), dtype=dtype).numpy().dtype).params
    for keys in KEY_SETS:
        params, jparams = view.move_camera(params, keys), jview.move_camera(jparams, keys)
        for f in ("cam_point", "cam_direction"):
            got = getattr(params, f)
            assert got.dtype == dtype and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jparams, f)))
    assert torch.equal(params.sphere_point, build_scene(
        parse_scene_file(path), dtype=dtype, device="cpu").params.sphere_point)


@pytest.mark.parametrize("shape", [(6, 5), (7, 4)])
def test_frame_to_ansi_is_jax(shape):
    img = np.random.default_rng(4).uniform(-0.1, 1.1, size=shape + (3,)).astype(np.float32)
    want = jview.frame_to_ansi(img)
    assert view.frame_to_ansi(img) == want


def test_terminal_frame_size_is_jax():
    sizes = [(96, 38), (120, 50), (4, 3), (17, 11), (200, 9)]
    for term in sizes:
        assert view.terminal_frame_size(term) == jview.terminal_frame_size(term)
    assert view.terminal_frame_size((96, 38)) == (72, 96)  # tests/test_viewer.py
    assert view.terminal_frame_size((4, 3)) == (16, 16)


def test_resize_reresolves_on_the_cpu(examples_dir):
    scene = build_scene(parse_scene_file(str(examples_dir / "scene3.lol")), device="cpu")
    cfg = RenderConfig()
    adaptive = view.SizeAdaptiveRenderer(scene, cfg)
    img1 = adaptive.frame(scene.params, term_size=(32, 14))
    assert img1.shape == (24, 32, 3) and adaptive.size == (24, 32)
    img2 = adaptive.frame(scene.params, term_size=(48, 18))
    assert img2.shape == (32, 48, 3) and adaptive.size == (32, 48)
    assert set(adaptive.first_frame_s) == {(24, 32), (32, 48)}
    assert all(v > 0 for v in adaptive.first_frame_s.values())
    img3 = adaptive.frame(scene.params, size=(24, 32))  # an explicit size, cached
    np.testing.assert_array_equal(img1, img3)
    assert set(adaptive.first_frame_s) == {(24, 32), (32, 48)}
    with torch.no_grad():
        ref = make_renderer(scene.structure, 24, 32, cfg)(scene.params)
    np.testing.assert_array_equal(img1, ref.numpy())
    img4 = adaptive.frame(scene.params, size=(18, 20))  # exactly, where the JAX viewer rounds
    assert img4.shape == (18, 20, 3)


@pytest.mark.parametrize("size", [(25, 32), (24, 8), (14, 40)])
def test_explicit_size_is_refused_not_rounded(examples_dir, size, capsys):
    scene = build_scene(parse_scene_file(str(examples_dir / "scene3.lol")), device="cpu")
    with pytest.raises(ValueError, match="view size"):
        view.SizeAdaptiveRenderer(scene, RenderConfig()).frame(scene.params, size=size)
    h, w = size
    assert cli.main(["view", str(examples_dir / "scene3.lol"), "--size", f"{w}x{h}",
                     "--device", "cpu"]) == 2
    assert "view size" in capsys.readouterr().err


def test_cli_view_on_cuda_without_cuda_raises(examples_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["view", str(examples_dir / "scene3.lol"), "--size", "32x24"])


def test_read_keys_sees_a_burst():
    r, w = os.pipe()
    try:
        os.write(w, b"wd\x1b[C")
        assert view.read_keys(r) == ({"w", "d", "right"}, False)
        os.write(w, b"a q")
        assert view.read_keys(r)[1] is True
        assert view.read_keys(r) == (set(), False)
    finally:
        os.close(r)
        os.close(w)


def test_cli_view_runs_under_a_pty():
    """`cli view --device cpu --size 32x24` in its own process on a pty,
    fed w then q: it exits 0 after at least two frames. The process is
    killed if it outlives 60 s."""
    master, slave = pty.openpty()
    proc = subprocess.Popen(
        [sys.executable, "-m", "loltracer_tpu_torch.cli", "view", "examples/scene4.lol",
         "--size", "32x24", "--device", "cpu"],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, cwd=ROOT,
    )
    os.close(slave)
    out, fed, keys = b"", 0, [b"w", b"q"]
    deadline = time.monotonic() + 60
    try:
        while time.monotonic() < deadline:
            ready = select.select([master], [], [], 0.1)[0]
            if ready:
                try:
                    chunk = os.read(master, 65536)
                except OSError:  # the child closed its end
                    break
                if not chunk:
                    break
                out += chunk
            frames = len(STATUS.findall(out))
            if fed < len(keys) and frames > fed:
                os.write(master, keys[fed])
                fed += 1
            if not ready and proc.poll() is not None:
                break
    finally:
        # the pty closes before the child is reaped: wait out the deadline
        try:
            rc, timed_out = proc.wait(timeout=max(1.0, deadline - time.monotonic())), False
        except subprocess.TimeoutExpired:
            proc.kill()
            rc, timed_out = proc.wait(timeout=10), True
        err = proc.stderr.read()
        proc.stderr.close()
        os.close(master)
    assert not timed_out, f"cli view still running after 60 s; output tail {out[-300:]!r}"
    assert rc == 0, err[-2000:]
    frames = [int(n) for n in STATUS.findall(out)]
    assert len(frames) >= 2 and frames[:2] == [1, 2]
    assert b"32x24  frame" in out
