"""The comparison that decides `correct` fails its control and the faults a
cell can have. On the CPU at a tiny size: a whole run with the timed path
broken underneath, the look for a card skipped, reads `correct` false; the
control (the reference in bfloat16 put in the program's place) fails a
limit. On the card (`-m chip`): the control at each cell's own size on
three seeds."""

import pytest
import torch

from benchmark import calibrate
from benchmark.harness import compare
from benchmark.harness import main as harness
from benchmark.tests.tiny import REPO, make_root

torch.set_num_threads(1)


def run(root, name, seed=11):
    return harness.run_cell(root, name, seed, 0.2, False, "cpu", 0.0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", ["tiny-fit", "tiny-exact", "tiny-frames"])
def test_sound_run_is_correct(root, name):
    r = run(root, name)
    assert r["correct"] is True, r["checks"]


def _state_unchanged(monkeypatch):
    """Every step leaves the parameters as they were (Adam at lr 0)."""
    from loltracer_tpu_torch.opt import inverse

    orig = inverse.masked_optimizer
    monkeypatch.setattr(inverse, "masked_optimizer",
                        lambda params, fields, inner=torch.optim.Adam, **kw:
                        orig(params, fields, inner, **dict(kw, lr=0.0)))


def _half_rows(monkeypatch):
    """The loss over the first half of the frame's rows, its mean taken
    over them."""
    from loltracer_tpu_torch.parallel import sharded

    orig = sharded._sharding

    def half(*args, **kw):
        sh = orig(*args, **kw)
        return sh._replace(rows=sh.rows[: sh.rows.numel() // 2])

    monkeypatch.setattr(sharded, "_sharding", half)
    monkeypatch.setattr(sharded, "true_div", lambda x, n: x / (n // 2))


def _altered_frame(monkeypatch):
    """Each frame's red channel off by 0.01 where the kernel's wrapper
    returns it."""
    from loltracer_tpu_torch.render import cuda_renderer

    orig = cuda_renderer.instanced_forward

    def altered(*args, **kw):
        img = orig(*args, **kw).clone()
        img[..., 0] += 0.01
        return img

    monkeypatch.setattr(cuda_renderer, "instanced_forward", altered)


@pytest.mark.parametrize("name,fault", [
    ("tiny-fit", _state_unchanged), ("tiny-fit", _half_rows),
    ("tiny-exact", _state_unchanged), ("tiny-exact", _half_rows),
    ("tiny-frames", _altered_frame)], ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    r = run(root, name)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", ["tiny-fit", "tiny-exact", "tiny-frames"])
def test_control_is_not_correct(root, name):
    cell = harness.Cell(root, name)
    ctx = harness.Context(cell, 13, 0.2, False, "cpu", 0.0)
    limits = compare.load_limits(root, name)
    controls = calibrate.fit_controls if cell.traffic["kind"] == "fit_jobs" \
        else calibrate.frame_controls
    numbers = controls(ctx)["control"]
    assert not compare.passed(compare.checks(numbers, limits)), numbers


@pytest.mark.chip
@pytest.mark.parametrize("name", ["scene4-fit-1080p", "instanced10k-frames-4k",
                                  "scene4-fit-exact-540p"])
def test_control_fails_at_the_cells_size(chip, name):
    cell = harness.Cell(REPO, name)
    limits = compare.load_limits(REPO, name)
    controls = calibrate.fit_controls if cell.traffic["kind"] == "fit_jobs" \
        else calibrate.frame_controls
    for seed in (101, 2**31 + 7, 40961):
        numbers = controls(harness.Context(cell, seed, 1.0, False, chip, 0.0))["control"]
        assert not compare.passed(compare.checks(numbers, limits)), (seed, numbers)


