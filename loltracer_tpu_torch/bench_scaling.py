"""Weak-scaling harness of the port: the root `bench_scaling.py`'s two
ladders over the row-sharded training path (parallel/sharded.py), fixed
rows per device.

    python -m loltracer_tpu_torch.bench_scaling                         # the wall ladder
    SCALE_DEVICE_TIME=1 python -m loltracer_tpu_torch.bench_scaling     # the device-time ladder
    SCALE_DEVICE_TIME=1 SCALE_ASSIGN=contiguous SCALE_SCENE=instanced:10000 python -m ...
    LOLTRACE_DISTRIBUTED=1 torchrun --nproc-per-node 4 -m loltracer_tpu_torch.bench_scaling
    SCALE_PLATFORM=cpu SCALE_ROWS=16 SCALE_W=32 python -m ...           # the plain versions

The root `bench_scaling.py` is the JAX package's harness: it imports jax.
This is its counterpart, with its settings, its ladders and its records.

Settings (environment variables, bench_scaling.py's names and defaults;
`Settings.from_env`): `SCALE_ROWS` (128 rows a device), `SCALE_W` (768),
`SCALE_MODE` (`fwdbwd` | `fwd`, the wall ladder's), `SCALE_SCENE`
(`examples/scene4.lol`; `instanced:N` is `scenes.instanced_spheres(n=N)`),
`SCALE_CLAMP` (2.0, instanced scenes only; `none`, `0` or empty = exact),
`SCALE_REPS` (3), `SCALE_ASSIGN` (`lpt` | `snake` | `contiguous`, the
device-time ladder's deal), `SCALE_DEVICE_TIME` (`1`: that ladder),
`SCALE_PLATFORM` (holding `cpu`: the CPU, through the plain versions, for
tests; else the card) and `SCALE_OUT` (the JSON file the ladder is merged
into, by (scene, platform, mode) as bench_scaling.py's `_merge_ladder`
does; default `artifacts/scaling_gpu.json` under the repository, or
`artifacts/scaling_cpu.json` on the CPU. The root `SCALING.json` is the
JAX package's record and is never written here).

The device-time ladder (`device_time_main`, bench_scaling.py:40-165): for
n = 2, 4, 8 and height = SCALE_ROWS * n, the rows dealt over n shards in
G-row blocks (G = `sharded.row_granularity`: 8 compiled, 16 instanced;
`deal`: contiguous, the snake deal, or LPT over
`utils/profiling.block_row_costs`, computed once a rung; a height that
does not split into n * G blocks is dealt contiguously, as JAX's), each
shard's SCALE_ROWS rows rendered serially on ONE device through the fused
training tier with a row table (`rows[::G]`, f32): K1r + K2 for compiled
scenes, K5r + K6 for instanced ones (which also build their cell grid
every frame: its kernels count, its host syncs do not). A frame is fwd +
bwd of mean(img ** 2) and bench.py's scalar `loss + sum over SceneParams
leaves of sum(g * g)`; a sample is `frames` frames (32; 1 instanced); one
sample a band first, untimed (it builds the kernels); `band_s` is the
best of SCALE_REPS samples. On the card `band_s` is the band's DEVICE
time: the sum of the durations of every CUDA kernel the sample launched
(the kernels', the plain torch ops', the cell grid's), from one
torch.profiler session over every sample of the ladder, split at a
marker kernel launched between samples. A scene4 band of 128 x 768 rays
spends a few tenths of a ms in its kernels beside about a ms of host glue
a frame, the same for every shard: a host-clock window would read an
efficiency near 1 whatever the deal. The CUDA-event window of each sample
and each band's launch counters go on the line printed before each
record, with each shard's row table and the host seconds the profile's
stop and reading took. On the CPU `band_s` is the host
clock's. The record is JAX's:
`efficiency_device_time = sum(band_s) / (n * max(band_s))`, what row
sharding over n devices loses to the imbalance of the deal.

The wall ladder (`wall_main`, bench_scaling.py:183-302): the ranks are
the port's devices (parallel/mesh.py); the world comes from the
environment (`parallel.distributed.maybe_initialize`: torchrun's or the
LOLTRACE_* variables), else a world of this one process. For n = 1, 2,
4, 8 up to the world's size, `make_mesh(n)`; ranks past n hold no shard
of that rung and wait at a barrier. SCALE_MODE=fwdbwd: Adam (lr 1e-3)
over opt.DEFAULT_TRAINABLE, `make_sharded_train_step` toward
`make_sharded_renderer`'s image of the same params; the step updates the
params in place, so they and the optimizer's state are restored before
every step, outside the timed window. SCALE_MODE=fwd:
`make_sharded_renderer` with exact shadows, sum(img). Each step between a
synchronize and a barrier on both sides, on the host clock (collectives
inside); `efficiency = rays/s / (rays/s at one device * n)`. Rank 0
prints and writes. Nothing falls back: on the card without CUDA it
raises, one card gives one rung, and a kernel of the path that did not
launch fails the run; the CPU (gloo, the kernels' plain twins through
`fused="interpret"`) runs only under SCALE_PLATFORM=cpu. On one card the
fwdbwd step is one CUDA graph from its second call (parallel/sharded.py):
its `launches` are the wrappers' counts, the target's K1r and the
warm-up step's K1r and K2, and the timed steps replay the graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from loltracer_tpu_torch import bench
from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.opt import masked_optimizer, trainable_leaves
from loltracer_tpu_torch.opt.inverse import DEFAULT_TRAINABLE
from loltracer_tpu_torch.parallel import (
    make_mesh,
    make_sharded_renderer,
    make_sharded_train_step,
    maybe_initialize,
    process_info,
)
from loltracer_tpu_torch.parallel.mesh import ensure_world
from loltracer_tpu_torch.parallel.sharded import interleave_rows, row_granularity
from loltracer_tpu_torch.render.backend import resolve_device
from loltracer_tpu_torch.render.fused_train import make_training_renderer
from loltracer_tpu_torch.render.instanced_train import make_instanced_training_renderer
from loltracer_tpu_torch.scene import FIELDS, Scene, SceneParams, SceneStructure, params_to
from loltracer_tpu_torch.utils.profiling import block_row_costs

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
DEVICE_TIME_COUNTS = (2, 4, 8)
WALL_COUNTS = (1, 2, 4, 8)
ASSIGNMENTS = ("lpt", "snake", "contiguous")
# The kernel launched between two samples of the device-time ladder
# (torch.cuda._sleep's): the profile is split at it.
MARKER = "spin_kernel"


@dataclasses.dataclass(frozen=True)
class Settings:
    """bench_scaling.py's settings (module docstring), parsed."""

    rows: int = 128
    width: int = 768
    mode: str = "fwdbwd"
    scene: str = "examples/scene4.lol"
    clamp: Optional[float] = 2.0  # instanced scenes only
    reps: int = 3
    assign: str = "lpt"
    device_time: bool = False
    platform: str = ""
    out: Optional[str] = None  # None: out_path's default

    @classmethod
    def from_env(cls, env: Mapping[str, str]) -> "Settings":
        clamp = env.get("SCALE_CLAMP", "2.0")
        return cls(
            rows=int(env.get("SCALE_ROWS", cls.rows)),
            width=int(env.get("SCALE_W", cls.width)),
            mode=env.get("SCALE_MODE", cls.mode),
            scene=env.get("SCALE_SCENE", cls.scene),
            clamp=None if clamp.lower() in ("", "none", "0") else float(clamp),
            reps=int(env.get("SCALE_REPS", cls.reps)),
            assign=env.get("SCALE_ASSIGN", cls.assign),
            device_time=env.get("SCALE_DEVICE_TIME") == "1",
            platform=env.get("SCALE_PLATFORM", cls.platform),
            out=env.get("SCALE_OUT") or None,
        )

    @property
    def on_cpu(self) -> bool:
        return "cpu" in self.platform

    @property
    def out_path(self) -> str:
        if self.out:
            return self.out
        return str(ARTIFACTS / ("scaling_cpu.json" if self.on_cpu else "scaling_gpu.json"))


def _device(s: Settings, who: str) -> torch.device:
    """The CPU under SCALE_PLATFORM=cpu, else this process's card; raises
    without CUDA."""
    if s.on_cpu:
        return torch.device("cpu")
    resolve_device("cuda", who)
    return torch.device("cuda", torch.cuda.current_device())


def _step_clamp(s: Settings, structure: SceneStructure) -> Optional[float]:
    return s.clamp if structure.instanced else None


def _card(dev: torch.device) -> Optional[str]:
    return bench.card_line() if dev.type == "cuda" else None


# --- the device-time ladder ---------------------------------------------------------


def deal(structure: SceneStructure, params: SceneParams, height: int, width: int, n: int,
         cfg: RenderConfig, assign: str) -> Tuple[str, np.ndarray]:
    """(the deal made, perm) of bench_scaling.py:119-130: perm[i] is the
    image row at sharded position i, shard k's rows perm[k*R:(k+1)*R];
    "contiguous" where asked or where the height does not split into
    n * G blocks."""
    if assign not in ASSIGNMENTS:
        raise ValueError(f"SCALE_ASSIGN must be one of {ASSIGNMENTS}, got {assign!r}")
    if assign == "contiguous":
        return "contiguous", np.arange(height)
    G = row_granularity(structure)
    bc = (block_row_costs(structure, params, height, width, G, cfg)
          if assign == "lpt" else None)
    pi = interleave_rows(height, n, G, block_costs=bc)
    return ("contiguous", np.arange(height)) if pi is None else (assign, pi[0])


def shard_tables(perm: np.ndarray, n: int, rows: int, G: int, device) -> List[torch.Tensor]:
    """Each shard's row table: its rows perm[i*R:(i+1)*R] every G-th, f32
    (bench_scaling.py:133-135)."""
    return [torch.as_tensor(perm[i * rows:(i + 1) * rows][::G], dtype=torch.float32,
                            device=device) for i in range(n)]


def band_renderer(structure: SceneStructure, rows: int, width: int, height: int,
                  cfg: RenderConfig, device) -> Callable[[SceneParams, torch.Tensor], torch.Tensor]:
    """`(params, rowtab) -> [rows, W, 3]`: one shard of a `height`-row image
    through the fused training tier with a row table (parallel/sharded.py's
    construction)."""
    make = (make_instanced_training_renderer if structure.instanced
            else make_training_renderer)
    return make(structure, rows, width, cfg, device=device, full_height=height,
                with_row_table=True)


def band_kernels(structure: SceneStructure) -> Tuple[Tuple[str, str], ...]:
    """(counter family, kernel) of a band frame on the card."""
    if structure.instanced:
        return (("instanced_train", "lol_instanced_fwd"), ("instanced_train", "lol_instanced_bwd"))
    return (("fused_train", "lol_train_fwd"), ("fused_train", "lol_train_bwd"))


def device_time_record(n: int, height: int, assign: str, band_s: Sequence[float]) -> dict:
    """bench_scaling.py:145-153's record of one rung."""
    eff = sum(band_s) / (n * max(band_s))
    return {
        "devices": n,
        "height": height,
        "assignment": assign,
        "band_s": [round(t, 5) for t in band_s],
        "efficiency_device_time": round(eff, 4),
        "mode": "fwdbwd",
    }


def device_time_ladder(s: Settings, clamp: Optional[float], backend: str,
                       records: list) -> dict:
    """bench_scaling.py:158-163's ladder; backend "pallas" on the card (the
    hand-written kernels), "cpu" for the plain versions."""
    return {"platform": f"device_time-{s.assign}", "backend": backend,
            "rows_per_device": s.rows, "width": s.width, "scene": s.scene, "mode": "fwdbwd",
            "step_clamp": clamp, "records": records}


class KernelClock:
    """Device time of many samples from ONE torch.profiler session (a second
    session in one process has been seen to record no device event): a
    marker kernel before each sample (`mark`) and after the last, and
    after the session each sample's sum of kernel durations, Memcpy /
    Memset and the markers left out (`samples_ms`). A session has been
    seen to drop its first and its last kernel, so spare markers open and
    close it: a run of markers with no kernel between them is no sample."""

    def __init__(self, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.cost_s = {}  # the host seconds the session's stop and its reading took
        # the card's activity alone: no CPU op is recorded, which keeps the
        # session's cost on the host and the events to read small
        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self) -> "KernelClock":
        torch.cuda.synchronize(self.device)
        self.prof.__enter__()
        self.mark()
        return self

    def mark(self) -> None:
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(self.device)

    def __exit__(self, *exc) -> None:
        for _ in range(3):
            self.mark()
        t0 = time.perf_counter()
        self.prof.__exit__(*exc)
        self.cost_s["stop"] = time.perf_counter() - t0

    def kernels(self) -> List[Tuple[int, int, str]]:
        """(start ns, duration ns, name) of every kernel recorded, in start
        order: the card's events but copies, fills and synchronizations."""
        from torch.autograd import DeviceType

        t0 = time.perf_counter()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if (e.device_type() == DeviceType.CUDA and not name.startswith(("Memcpy", "Memset"))
                    and "Sync" not in name):
                out.append((e.start_ns(), e.duration_ns(), name))
        out.sort()
        self.cost_s["read"] = time.perf_counter() - t0
        return out

    def samples_ms(self, n: int) -> List[float]:
        """The device ms of the session's `n` samples: the kernels between
        two markers, runs of markers taken as one; raises unless there are
        exactly n such groups."""
        groups, cur = [], []
        for _, dur, name in self.kernels():
            if MARKER in name:
                if cur:
                    groups.append(cur)
                cur = []
            else:
                cur.append(dur)
        if cur:
            groups.append(cur)
        if len(groups) != n:
            raise RuntimeError(f"the profile holds {len(groups)} groups of kernels between "
                               f"markers where {n} samples ran: no device time to read")
        return [sum(g) / 1e6 for g in groups]


@dataclasses.dataclass
class Rung:
    """One rung of the device-time ladder: its deal, each shard's table
    and frame (`frames[i]()` one fwd + bwd frame of band i, returning its
    scalar), and what was measured."""

    n: int
    height: int
    assignment: str
    tables: List[torch.Tensor]
    frames: List[Callable[[], torch.Tensor]]
    windows_ms: List[List[float]] = dataclasses.field(default_factory=list)
    device_ms: List[List[float]] = dataclasses.field(default_factory=list)
    launches: List[Dict[str, int]] = dataclasses.field(default_factory=list)


def _counts(kernels) -> Dict[str, int]:
    c = bench.launch_counts()
    return {f"{fam}.{k}": c[fam][k] for fam, k in kernels}


def build_rungs(s: Settings, scene: Scene, device) -> Tuple[List[Rung], RenderConfig, int]:
    """(rungs, cfg, frames a sample) of the device-time ladder: each rung's
    deal (its cost model run here, before any timing) and its bands."""
    st = scene.structure
    params = params_to(scene.params, device=device, dtype=torch.float32)
    cfg = RenderConfig(shadow_grad="envelope", step_clamp=_step_clamp(s, st))
    G = row_granularity(st)
    rungs = []
    for n in DEVICE_TIME_COUNTS:
        height = s.rows * n
        got, perm = deal(st, params, height, s.width, n, cfg, s.assign)
        tables = shard_tables(perm, n, s.rows, G, device)
        band = band_renderer(st, s.rows, s.width, height, cfg, device)
        frames = [bench.fwdbwd_frame(lambda p, t=t: band(p, t), params)[1] for t in tables]
        rungs.append(Rung(n, height, got, tables, frames))
    return rungs, cfg, 1 if st.instanced else 32


def measure_rungs(rungs: List[Rung], frames: int, reps: int, device: torch.device,
                  kernels) -> Dict[str, float]:
    """Every band of every rung: one untimed sample, then `reps` samples
    (their windows, and on the card their device time from one
    KernelClock session); each band's launch counters over its samples.
    Returns the profiler's own host seconds (KernelClock.cost_s; none on
    the CPU)."""
    for r in rungs:
        for frame in r.frames:
            bench.reset_counts()
            bench.window_ms(frame, frames, device)  # builds the kernels at first use
            r.launches.append(_counts(kernels))
    clock = KernelClock(device) if device.type == "cuda" else None
    with clock or contextlib.nullcontext():
        for r in rungs:
            for i, frame in enumerate(r.frames):
                bench.reset_counts()
                w = []
                for _ in range(reps):
                    if clock is not None:
                        clock.mark()
                    w.append(bench.window_ms(frame, frames, device))
                r.windows_ms.append(w)
                c = _counts(kernels)
                r.launches[i] = {k: v + c[k] for k, v in r.launches[i].items()}
    if clock is None:
        for r in rungs:
            r.device_ms = r.windows_ms
        return {}
    dev_ms = iter(clock.samples_ms(sum(r.n for r in rungs) * reps))
    for r in rungs:
        r.device_ms = [[next(dev_ms) for _ in range(reps)] for _ in range(r.n)]
    return clock.cost_s


def device_time_main(s: Settings, scene: Optional[Scene] = None, emit=print) -> List[dict]:
    """The device-time ladder (module docstring): prints each rung's detail
    line and record, merges the ladder into s.out_path, returns the
    records. `scene` replaces `bench.load_scene(s.scene)`."""
    device = _device(s, "bench_scaling")
    if scene is None:
        scene = bench.load_scene(s.scene, device)
    st = scene.structure
    kernels = band_kernels(st)
    rungs, cfg, frames = build_rungs(s, scene, device)
    profiler_s = measure_rungs(rungs, frames, s.reps, device, kernels)
    card = _card(device)
    records = []
    for r in rungs:
        if device.type == "cuda":
            missing = [k for counts in r.launches for k, v in counts.items() if v == 0]
            if missing:
                raise RuntimeError(f"n={r.n}: the band kernels {sorted(set(missing))} did "
                                   "not launch")
        band_s = [min(ms) / 1e3 for ms in r.device_ms]
        rec = device_time_record(r.n, r.height, r.assignment, band_s)
        emit(json.dumps({"devices": r.n, "deal": r.assignment, "asked": s.assign,
                         "tables": [[int(v) for v in t.tolist()] for t in r.tables],
                         "frames": frames, "band_device_ms": r.device_ms,
                         "band_window_ms": r.windows_ms, "launches": r.launches,
                         "profiler_s": profiler_s, "card": card}))
        emit(json.dumps(rec))
        sys.stdout.flush()
        records.append(rec)
    _merge_ladder(s.out_path, device_time_ladder(
        s, cfg.step_clamp, "pallas" if device.type == "cuda" else "cpu", records))
    return records


# --- the wall ladder ------------------------------------------------------------------


def wall_record(n: int, height: int, rays_per_s: float, base: float, mode: str) -> dict:
    """bench_scaling.py:281-289's record of one rung."""
    return {
        "devices": n,
        "height": height,
        "rays_per_s": round(rays_per_s, 1),
        "efficiency": round(rays_per_s / (base * n), 3),
        "mode": mode,
    }


def wall_ladder(s: Settings, platform: str, clamp: Optional[float], records: list) -> dict:
    """bench_scaling.py:296-301's ladder; platform the device type."""
    return {"platform": platform, "rows_per_device": s.rows, "width": s.width,
            "scene": s.scene, "mode": s.mode, "step_clamp": clamp, "records": records}


def _wall_kernels(structure: SceneStructure, cfg: RenderConfig, mode: str):
    """(counter family, kernel) a wall rung launches on the card: the
    training pair (fwdbwd), or the march kernels of the differentiable
    renderer (fwd, exact shadows: K3 / K3i)."""
    if mode == "fwdbwd":
        return band_kernels(structure)
    return bench._march_family(structure, cfg)


def _settle(device: torch.device, group) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if group is not None:
        dist.barrier(group=group)


def wall_rung(s: Settings, scene: Scene, mesh, n: int, cfg: RenderConfig,
              device: torch.device) -> Tuple[List[float], List[float]]:
    """(seconds of each timed step, the scalar of every run: the warm-up
    first) of one rung, on a rank of its mesh: bench_scaling.py:226-272."""
    st = scene.structure
    height = s.rows * n
    fused = "interpret" if device.type == "cpu" else "auto"
    group = mesh.get_group(0) if n > 1 else None
    params = params_to(scene.params, device=device, dtype=torch.float32)
    render = make_sharded_renderer(st, mesh, height, s.width, cfg, fused=fused, device=device)
    if s.mode == "fwd":
        def run():
            return render(params).sum()

        restore = None
    else:
        leaves = trainable_leaves(params, DEFAULT_TRAINABLE)
        optimizer = masked_optimizer(leaves, DEFAULT_TRAINABLE, lr=1e-3)
        step = make_sharded_train_step(st, mesh, height, s.width, optimizer, cfg, fused=fused,
                                       device=device)
        target = render(params)
        start = {f: getattr(leaves, f).detach().clone() for f in FIELDS}
        state0 = optimizer.state_dict()

        def restore():
            with torch.no_grad():
                for f in FIELDS:
                    getattr(leaves, f).copy_(start[f])
            optimizer.load_state_dict(state0)

        def run():
            return step(leaves, target)

    seconds, values = [], []
    for rep in range(1 + s.reps):  # the warm-up first
        if restore is not None:
            restore()
        _settle(device, group)
        t0 = time.perf_counter()
        v = run()
        _settle(device, group)
        if rep:
            seconds.append(time.perf_counter() - t0)
        values.append(float(v))
    return seconds, values


def wall_main(s: Settings, scene: Optional[Scene] = None, emit=print) -> List[dict]:
    """The wall ladder (module docstring) over the world; rank 0 prints each
    rung's detail line and record and merges the ladder into s.out_path.
    Returns the records of the rungs this rank was in (rank 0: the
    ladder's)."""
    if s.mode not in ("fwd", "fwdbwd"):
        raise ValueError(f"SCALE_MODE must be fwd or fwdbwd, got {s.mode!r}")
    device = _device(s, "bench_scaling")
    had_world = dist.is_available() and dist.is_initialized()
    if maybe_initialize():
        print(json.dumps(process_info()), file=sys.stderr)
    if scene is None:
        scene = bench.load_scene(s.scene, device)
    st = scene.structure
    cfg = RenderConfig(shadow_grad="envelope" if s.mode == "fwdbwd" else "exact",
                       step_clamp=_step_clamp(s, st))
    kernels = _wall_kernels(st, cfg, s.mode)
    ensure_world(device)  # from the environment, else a world of this process
    world, rank = dist.get_world_size(), dist.get_rank()
    card = _card(device) if rank == 0 else None
    records, base = [], None
    try:
        for n in (c for c in WALL_COUNTS if c <= world):
            mesh = make_mesh(n, device=device.type)  # every rank: the groups are collective
            if rank < n:
                bench.reset_counts()
                seconds, values = wall_rung(s, scene, mesh, n, cfg, device)
                counts = _counts(kernels)
                if device.type == "cuda" and not all(counts.values()):
                    raise RuntimeError(f"n={n}: the kernels of the path did not all launch: "
                                       f"{counts}")
                height = s.rows * n
                rps = height * s.width / min(seconds)
                base = rps if base is None else base
                rec = wall_record(n, height, rps, base, s.mode)
                records.append(rec)
                if rank == 0:
                    emit(json.dumps({"devices": n, "samples_s": seconds,
                                     "loss" if s.mode == "fwdbwd" else "sum": values,
                                     "launches": counts, "card": card}))
                    emit(json.dumps(rec))
                    sys.stdout.flush()
            dist.barrier()  # ranks past n wait here
        if rank == 0:
            _merge_ladder(s.out_path, wall_ladder(s, device.type, cfg.step_clamp, records))
    finally:
        if not had_world:
            dist.destroy_process_group()
    return records


def _merge_ladder(out: str, ladder: dict) -> None:
    """bench_scaling.py's `_merge_ladder`: the ladders in `out` (a file
    that does not parse holds none) with the one of the same (scene,
    platform, mode) replaced by `ladder`, appended last."""
    ladders = []
    if os.path.exists(out):
        try:
            with open(out) as f:
                prev = json.load(f)
            ladders = prev.get("ladders", [prev] if "records" in prev else [])
        except (json.JSONDecodeError, OSError):
            ladders = []

    def key(lad):
        return lad.get("scene"), lad.get("platform"), lad.get("mode")

    ladders = [lad for lad in ladders if key(lad) != key(ladder)] + [ladder]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"ladders": ladders}, f, indent=2)


def main(env: Optional[Mapping[str, str]] = None) -> int:
    """The ladder `env`'s settings (default os.environ) ask for."""
    s = Settings.from_env(os.environ if env is None else env)
    if s.reps < 1:
        raise ValueError(f"SCALE_REPS must be >= 1, got {s.reps}")
    if s.device_time:
        device_time_main(s)
    else:
        wall_main(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
