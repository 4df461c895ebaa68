"""The instanced fitting cell (`instanced10k-fit-1080p`, kind
`instanced_fit_jobs`) on the CPU, cut to a few pixels and steps in a tiny
root of its own (tiny.py's, with one more cell):

- a sound run through the harness reads `correct` true;
- the control (the gridded reference in bfloat16) and the half-rows fault
  read `correct` false under the cell's limits;
- its four span and counter readers give numbers on a traced record and
  None on an untraced one, and a traced run carries the window's spans;
- `instanced10k-fit.json` builds arrays bitwise `instanced10k.json`'s.

On the card (`-m chip`): the control of each of the two newer cells, at
the cell's own size on three seeds, reads `correct` false.
"""

import importlib.util
import json

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark import calibrate_instanced_fit as cal
from benchmark.harness import compare
from benchmark.harness import main as harness
from benchmark.tests import tiny

torch.set_num_threads(1)

CELL = "instanced10k-fit-1080p"
NAME = "tiny-instanced-fit"
TINY = ("instanced10k-fit", "fit_1080p_instanced",
        dict(height=16, width=8, steps=4, trace_from=1, trace_steps=1, reference_band_rows=16),
        CELL)
READERS = ("grid_build_ms.fit", "host_sync_ms.fit", "instanced_host_ms.fit", "grid_entries.fit")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tiny.TINY, NAME, TINY)
        return tiny.make_root(tmp_path_factory.mktemp("tiny"), (NAME,))


def test_sound_run_is_correct(root):
    r = harness.run_cell(root, NAME, 2**31 + 12345, 0.2, False, "cpu", 0.0)
    assert set(r["metrics"]) == {"setup_s", "fit_rays_per_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["correct"] is True, r["checks"]


def test_control_and_half_rows_fail(root):
    cell = harness.Cell(root, NAME)
    ctx = harness.Context(cell, 21, 0.2, False, "cpu", 0.0)
    numbers = cal.controls(ctx, {})
    limits = compare.load_limits(root, NAME)
    for what in ("control", "half_rows", "state_unchanged"):
        assert not compare.passed(compare.checks(numbers[what], limits)), (what, numbers[what])


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m", tiny.REPO / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_readers_read_spans_and_counters():
    spans = {"cell_grid.build": {"count": 4, "total_ms": 8.0, "self_ms": 6.0},
             "cell_grid.sync": {"count": 16, "total_ms": 2.0, "self_ms": 2.0},
             "shading.sync": {"count": 4, "total_ms": 1.0, "self_ms": 1.0},
             "instanced_train.forward": {"count": 4, "total_ms": 10.0, "self_ms": 2.0},
             "instanced_train.backward": {"count": 4, "total_ms": 2.0, "self_ms": 2.0}}
    record = {"unit": "step", "trace": None,
              "spans": {"units": 4, "spans": spans,
                        "counters": {"cell_grid.builds": 4, "cell_grid.entries": 9_600_000}}}
    got = {n: _reader(n)(record) for n in READERS}
    assert got == {"grid_build_ms.fit": 2.0, "host_sync_ms.fit": 0.75,
                   "instanced_host_ms.fit": 3.0, "grid_entries.fit": 2_400_000.0}
    for untraced in ({"unit": "step", "trace": None},
                     {"unit": "step", "trace": None, "spans": None},
                     {"unit": "step", "trace": None,
                      "spans": {"units": 4, "spans": {}, "counters": {"cell_grid.builds": 0}}}):
        assert all(_reader(n)(untraced) is None for n in READERS)


def test_traced_run_holds_the_window(root, monkeypatch):
    from benchmark.kinds import instanced_fit_jobs
    from benchmark.tests.test_bench_harness import FakeSession

    monkeypatch.setattr(instanced_fit_jobs, "Session", FakeSession)
    record = {}
    orig = instanced_fit_jobs.run
    monkeypatch.setattr(instanced_fit_jobs, "run", lambda ctx: record.setdefault("r", orig(ctx)))
    result = harness.run_cell(root, NAME, 7, 0.2, True, "cpu", 0.0)
    window = record["r"]["spans"]
    assert window["units"] == 1 and isinstance(window["spans"], dict)
    assert window["counters"]["cell_grid.builds"] == 0  # the CPU path builds no grid
    assert set(result["metrics"]) == {"kernel_ms.fit", "torch_ms.fit", "torch_launches.fit",
                                      "device_idle_pct.fit"}


def test_fit_configuration_is_the_field():
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    a, b = (harness.load_json(tiny.REPO / files[n]) for n in ("instanced10k", "instanced10k-fit"))
    assert a["scene"] == b["scene"] and a["render"] == b["render"] and b["reduced"] == []
    sa, sb = (harness.Cell(tiny.REPO, w).scene for w in ("instanced10k-frames-4k", CELL))
    assert sa.structure == sb.structure and sa.arrays.keys() == sb.arrays.keys()
    for k in sa.arrays:
        assert sa.arrays[k].dtype == sb.arrays[k].dtype
        assert np.array_equal(sa.arrays[k], sb.arrays[k]) and \
            sa.arrays[k].tobytes() == sb.arrays[k].tobytes()


@pytest.mark.chip
@pytest.mark.parametrize("name", [CELL, "scene4-frames-1080p"])
def test_control_fails_at_the_cells_size(chip, name):
    cell = harness.Cell(tiny.REPO, name)
    limits = compare.load_limits(tiny.REPO, name)
    controls = (lambda ctx: cal.controls(ctx, {})) if name == CELL else calibrate.frame_controls
    for seed in (101, 2**31 + 7, 40961):
        numbers = controls(harness.Context(cell, seed, 1.0, False, chip, 0.0))["control"]
        assert not compare.passed(compare.checks(numbers, limits)), (seed, numbers)
