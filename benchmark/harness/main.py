"""Runs one cell once: finds its configuration, traffic and metrics by the
names in BENCHMARK.json, sets up, runs the timed window through the
cell's traffic kind, compares with the reference, and prints the result
as the last line of standard output (and the compared numbers, each
beside its limit, as the last lines of standard error)."""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional

from benchmark.harness import compare

# top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "loltracer_tpu")


class CellError(Exception):
    """A cell, configuration, traffic file or metric that cannot be found
    or does not fit the harness."""


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise CellError(f"{path} does not exist") from None


def load_file_module(path: Path, name: str):
    """The module of a file found by name (a metric's reader: its file
    name may hold dots)."""
    if not path.exists():
        raise CellError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload of BENCHMARK.json with what its names point to."""

    def __init__(self, root: Path, workload: str):
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not found:
            raise CellError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = found[0]
        configs = {c["name"]: c for c in self.bench["configs"]}
        if self.workload["config"] not in configs:
            raise CellError(f"no configuration {self.workload['config']!r}")
        self.config = load_json(root / configs[self.workload["config"]]["file"])
        self.traffic = load_json(root / "benchmark" / "traffic" /
                                 f"{self.workload['traffic']}.json")
        self.kind = importlib.import_module(f"benchmark.kinds.{self.traffic['kind']}")
        scene_kind = importlib.import_module(f"benchmark.scenes.{self.config['scene']['kind']}")
        self.scene = scene_kind.build(self.config["scene"])

    def metrics(self, trace: bool):
        """(entry, reader module) of each metric this cell reports."""
        entries = self.bench["per_layer" if trace else "end_to_end"]
        name = self.workload["name"]
        for m in entries:
            if "workloads" in m and name not in m["workloads"]:
                continue
            path = self.root / "benchmark" / "metrics" / f"{m['name']}.py"
            yield m, load_file_module(path, "benchmark_metric_" + m["name"].replace(".", "_"))


class Context:
    """What a traffic kind's `run(ctx)` takes."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device, t_start):
        import torch

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.config, self.traffic, self.scene = cell.config, cell.traffic, cell.scene
        self.device = torch.device(device)
        self.t_start = t_start

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    def ready(self) -> float:
        """The end of set-up: the device idle, the garbage collected;
        returns the set-up's seconds."""
        self.sync()
        gc.collect()
        return self.elapsed()

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_peak(self) -> Optional[int]:
        import torch

        if self.device.type != "cuda":
            return None
        self.sync()
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        """Return the program's freed device memory before the reference."""
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, count: int, record: dict, trace: bool) -> dict:
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": count, "memory_peak_bytes": record["memory_peak_bytes"]}
    if trace and record.get("trace"):
        info["busy_s"] = record["trace"]["busy_s"]
        info["window_s"] = record["trace"]["window_s"]
    return info


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, count: int = 1, readings: bool = False) -> dict:
    """The result object of one run (without the look for a chip); with
    `readings`, also what the compared numbers were worked out from, under
    "readings" (calibrate.py's; a run's result line never has it)."""
    cell = Cell(root, workload)
    ctx = Context(cell, seed, seconds, trace, device, t_start)
    record = cell.kind.run(ctx)
    w = record["window"]
    d = sorted(w["durations_s"])
    if d:
        what = "jobs" if record["unit"] == "step" else "frames"
        print(f"window: {len(d)} {what} in {w['seconds']:.3f} s, each {d[0]:.4f} / "
              f"{d[len(d) // 2]:.4f} / {d[-1]:.4f} s (least / median / most); "
              f"launches {record['launches']}", file=sys.stderr)
    metrics = {}
    for entry, reader in cell.metrics(trace):
        value = reader.read(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    checks = compare.checks(record["numbers"], compare.load_limits(root, workload))
    result = {
        "correct": compare.passed(checks) and record["failed"] == 0,
        "attempted": record["attempted"],
        "failed": record["failed"],
        "metrics": metrics,
        "device": device_info(ctx.device, count, record, trace),
    }
    if trace and record.get("trace"):
        result["breakdown"] = {"device_ops": record["trace"]["device_ops"],
                               "idle_gaps": record["trace"]["idle_gaps"]}
    if readings:
        result["readings"] = record.get("readings")
    result["checks"] = checks
    return result


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    try:
        chips = Cell(root, args.workload).workload["chips"]
    except CellError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start, chips)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run's process holds {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
