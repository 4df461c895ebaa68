"""The harness finds everything by name, runs a cell added as data on the
CPU, and prints a last line of exactly the contract's keys."""

import json
import re

import pytest
import torch

from benchmark.harness import main as harness
from benchmark.harness.trace import MARKER, summarize
from benchmark.tests.tiny import REPO, make_root

torch.set_num_threads(1)

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_benchmark_json_names_resolve():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and (REPO / c["file"]).exists()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


def test_cell_found_by_name():
    cell = harness.Cell(REPO, "scene4-fit-1080p")
    assert cell.config["name"] == "scene4"
    assert cell.kind.__name__ == "benchmark.kinds.fit_jobs"
    assert cell.scene.structure["num_spheres"] == 5
    assert [m["name"] for m, _ in cell.metrics(False)] == ["setup_s", "fit_rays_per_s"]
    assert {m["name"] for m, _ in cell.metrics(True)} == {
        "kernel_ms.fit", "torch_ms.fit", "torch_launches.fit", "device_idle_pct.fit"}
    frames = harness.Cell(REPO, "instanced10k-frames-4k")
    assert frames.kind.__name__ == "benchmark.kinds.camera_frames"
    assert frames.scene.arrays["sphere_point"].shape == (10000, 3)


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(harness.CellError):
        harness.Cell(REPO, "no-such-cell")
    root = make_root(tmp_path, ("tiny-fit",))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"][-1]["traffic"] = "no-such-traffic"
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(harness.CellError):
        harness.Cell(root, "tiny-fit")


FRAME_E2E = {"setup_s", "frame_rays_per_s", "frame_ms_p95"}


@pytest.mark.parametrize("name,e2e", [("tiny-fit", {"setup_s", "fit_rays_per_s"}),
                                      ("tiny-frames", FRAME_E2E),
                                      ("tiny-scene4-frames", FRAME_E2E)])
def test_cell_added_as_data_runs_on_cpu(tmp_path, name, e2e):
    root = make_root(tmp_path, (name,))
    result = harness.run_cell(root, name, 2**31 + 12345, 1.0, False, "cpu", 0.0)
    assert set(result) == KEYS | {"checks"} and list(result)[-1] == "checks"
    assert set(result["metrics"]) == e2e
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] is True
    json.loads(json.dumps(result))


class FakeSession:
    """A profiler session that records nothing (no card here)."""

    def __init__(self, device):
        self.prof = None

    def start(self):
        self.prof = object()

    def stop(self):
        pass

    def summary(self, units):
        return {"port_ms": 1.0, "torch_ms": 2.0, "torch_launches": 3.0, "busy_s": 0.5,
                "window_s": 1.0, "idle_pct": 50.0, "device_ops": [["lol::k", 0.4]],
                "idle_gaps": [["host before x", 0.1]]}


def test_traced_line_has_breakdown(tmp_path, monkeypatch):
    from benchmark.kinds import fit_jobs

    monkeypatch.setattr(fit_jobs, "Session", FakeSession)
    root = make_root(tmp_path, ("tiny-fit",))
    result = harness.run_cell(root, "tiny-fit", 7, 0.2, True, "cpu", 0.0)
    assert set(result) == KEYS | {"breakdown", "checks"}
    assert set(result["metrics"]) == {"kernel_ms.fit", "torch_ms.fit", "torch_launches.fit",
                                      "device_idle_pct.fit"}
    assert result["device"]["busy_s"] == 0.5 and result["device"]["window_s"] == 1.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_trace_summary_reads_between_markers():
    ms = 1_000_000
    dev = [(0, 1, MARKER), (1 * ms, 1 * ms + 1, MARKER),  # opening markers
           (2 * ms, 5 * ms, "void lol::train_fwd<...>"), (6 * ms, 7 * ms, "elementwise_kernel"),
           (7 * ms, 8 * ms, "Memcpy DtoH"), (10 * ms, 10 * ms + 1, MARKER),
           (11 * ms, 11 * ms + 1, MARKER)]
    host = [(8 * ms, 9 * ms, "cudaStreamSynchronize")]
    s = summarize(dev, host, 2)
    assert s["port_ms"] == pytest.approx(1.5)
    assert s["torch_ms"] == pytest.approx(1.0) and s["torch_launches"] == 1.0
    assert s["window_s"] == pytest.approx((10 * ms - (1 * ms + 1)) / 1e9)
    assert s["busy_s"] == pytest.approx(5e-3)
    assert s["idle_gaps"][0][0] == "cudaStreamSynchronize before the window's close"
    assert s["idle_gaps"][0][1] == pytest.approx(2e-3)
    assert s["idle_pct"] == pytest.approx(100 * (1 - 5e-3 / s["window_s"]))
    assert summarize(dev[:2], host, 2) == {}


def test_metric_reader_finds_nothing_returns_none():
    cell = harness.Cell(REPO, "scene4-fit-1080p")
    record = {"unit": "step", "trace": None, "setup_s": 1.0,
              "window": {"rays": 10, "seconds": 1.0, "steps": 1}}
    for entry, reader in cell.metrics(True):
        assert reader.read(record) is None
    frames = harness.Cell(REPO, "instanced10k-frames-4k")
    for entry, reader in frames.metrics(False):
        if entry["name"] != "setup_s":
            assert reader.read(record) is None


def _fit_side(change, losses=(1.0, 0.9, 0.8)):
    return {"losses": list(losses), "grad1": dict.fromkeys(change, 1.0), "change": change}


def test_step_gap_median_holds_one_flipped_leaf_and_not_a_still_state():
    from benchmark.harness import compare

    ref = _fit_side({f"leaf{i}": 0.06 for i in range(12)})
    flipped = _fit_side(dict(ref["change"], leaf3=0.0652))  # one element's near-tie
    still = _fit_side(dict.fromkeys(ref["change"], 0.0))
    n = compare.fit_numbers(flipped, ref)
    assert n["step_gap"] == pytest.approx(0.0052 / 0.06) and n["step_gap_median"] == 0.0
    assert compare.fit_numbers(still, ref)["step_gap_median"] == 1.0


def test_checks_compare_the_numbers_the_limits_name():
    from benchmark.harness import compare

    numbers = {"loss_gap": 1e-6, "step_gap": 0.07, "step_gap_median": 1e-6}
    got = compare.checks(numbers, {"loss_gap": 1e-4, "step_gap_median": 1e-3})
    assert list(got) == ["loss_gap", "step_gap_median"] and compare.passed(got)
    missing = compare.checks(numbers, {"grad_gap": 2e-4})
    assert missing == {"grad_gap": {"value": compare.NO_READING, "limit": 2e-4}}
    assert not compare.passed(missing)
    assert not compare.passed(compare.checks(numbers, None))
