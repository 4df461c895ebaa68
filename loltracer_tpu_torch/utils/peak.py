"""The measured FP32 ceiling of the card (`loltracer_tpu/utils/peak.py`).

The bounds of the port's kernels divide their FP32 operations by the
modelled ceiling 132 SMs x 128 lanes x 2 flops x the card's maximum SM
clock. This module measures the rate the card reaches, which must come
within a few per cent of that ceiling for the ceiling to stand:
`lol_peak_fma` and `lol_peak_sqrt` (csrc/peak.cuh) do nothing but run
independent chains of 16 steps per iteration, a = a * c + d or a =
sqrt(a + 1), long enough (~100 ms a call) that launch overhead is noise.

- `measure_peak(kind)` times one kind on the card with CUDA events (best
  of `reps`): "fma" is the `__fmaf_rn` chain (2 flops per instruction: the
  card's ceiling), "muladd" the same chain as a separately rounded
  multiply and add (what the port's `--fmad=false` kernels issue), "sqrt"
  the sqrt chain (1 evaluation per step). The iterations are sized from a
  short first call, then again from a call of that size, so that a call
  lasts ~TARGET_MS.
- `measure_vpu_peak()` is the record the JAX package writes, under its
  keys: `fma_flops_per_s` (the fused chain), `sqrt_evals_per_s`,
  `transcendental_weight` (FMA slots one sqrt costs) and `detail` (all
  three kinds), plus the card's name, power limit and maximum SM clock
  from nvidia-smi and the modelled ceiling 132 SMs x 128 lanes x 2 flops x
  that clock.
- `PEAK_ARTIFACT` (artifacts/gpu_peak.json under the repository's root,
  wherever the caller runs) is where `cli peak` writes the record by
  default; `load_measured_peak` reads its FMA ceiling back. The JAX
  package's artifacts/vpu_peak.json is the TPU's and is never written here.

On CPU tensors `peak_chain` runs `peak_chain_reference`, the chain in
plain torch ops, bitwise the kernels: "muladd" as two separately rounded
ops, "fma" rounded once per step (through float64, rounded to odd), "sqrt"
as torch.sqrt. `measure_peak(..., device="cpu")` times that on the host
clock; its numbers are the CPU's, never the card's.

`launches` counts kernel launches per entry; the plain chain never adds
to it.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import os
import subprocess
import time
from typing import Dict, Optional

import torch

from loltracer_tpu_torch import _build
from loltracer_tpu_torch.render.backend import resolve_backend, resolve_device

__all__ = [
    "KINDS",
    "LANES",
    "PEAK_ARTIFACT",
    "card_info",
    "launches",
    "library",
    "load_measured_peak",
    "measure_peak",
    "measure_vpu_peak",
    "peak_chain",
    "peak_chain_reference",
]

KINDS = ("fma", "muladd", "sqrt")
STEPS = 16  # chained steps per iteration (csrc/peak.cuh kPeakSteps)
BLOCK, CHAINS = 256, 4  # threads per block, chains per thread (csrc/peak.cuh)
PEAK_ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts", "gpu_peak.json")
FMA, SQRT = "lol_peak_fma", "lol_peak_sqrt"

launches = {FMA: 0, SQRT: 0}


def _source() -> str:
    from loltracer_tpu_torch.render.cuda_scene import CSRC

    return "#include <cuda_runtime.h>\n#include <math.h>\n" + (CSRC / "peak.cuh").read_text()


@functools.lru_cache(maxsize=None)
def library() -> _build.Library:
    """The built lol_peak_fma / lol_peak_sqrt (compiled at first use with the
    port's flags, then loaded from the build cache)."""
    built = _build.build(_source(), "peak")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    built.lib.lol_peak_fma.argtypes = [ptr, ptr, i64, i32, i32, ptr]
    built.lib.lol_peak_sqrt.argtypes = [ptr, ptr, i64, i32, ptr]
    for fn in (built.lib.lol_peak_fma, built.lib.lol_peak_sqrt):
        fn.restype = ctypes.c_int
    return built


# Lanes of a full-size call: 4 waves of the 8 resident 256-thread blocks on
# each of the H100's 132 SMs, CHAINS lanes per thread.
LANES = 4 * 132 * 8 * BLOCK * CHAINS
# Milliseconds a full-size call is sized to last: launch overhead is noise.
TARGET_MS = 100.0


def peak_chain_reference(x: torch.Tensor, kind: str, iters: int) -> torch.Tensor:
    """The plain version: x's lanes after `iters` iterations of STEPS chain
    steps, in torch ops on x's device: "muladd" as a multiply and an add,
    separately rounded; "fma" rounded once per step (`_fma_rn`); "sqrt" as
    sqrt(a + 1)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: one of {KINDS}")
    a = x.clone()
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if kind == "sqrt":
        for _ in range(iters * STEPS):
            a = torch.sqrt(a + one)
        return a
    c = torch.full((), 0.9999999, dtype=torch.float32, device=x.device)
    d = a * torch.full((), 1e-7, dtype=torch.float32, device=x.device)
    if kind == "muladd":
        for _ in range(iters * STEPS):
            a = a * c + d
        return a
    c64, d64 = c.double(), d.double()
    for _ in range(iters * STEPS):
        a = _fma_rn(a, c64, d64)
    return a


def _fma_rn(a: torch.Tensor, c64: torch.Tensor, d64: torch.Tensor) -> torch.Tensor:
    """f32 a * c + d rounded once, as __fmaf_rn, for c and d f32 values held
    in f64: the product of two f32 is exact in f64; the f64 sum is rounded
    to odd (its exact error from TwoSum says whether the sum was inexact,
    and then the odd one of the two neighbours is taken), and a number
    rounded to odd with 53 bits rounds to 24 as the exact one would."""
    p = a.double() * c64
    s = p + d64
    bp = s - p
    err = (p - (s - bp)) + (d64 - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def peak_chain(x: torch.Tensor, kind: str, iters: int) -> torch.Tensor:
    """x's lanes after the chain: lol_peak_fma (kind "fma" fused, "muladd"
    not) or lol_peak_sqrt for a CUDA tensor, which must be contiguous f32
    with a multiple of BLOCK * CHAINS lanes; the plain version for a CPU
    tensor."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: one of {KINDS}")
    if resolve_backend(x) == "torch":
        return peak_chain_reference(x, kind, iters)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() % (BLOCK * CHAINS):
        raise ValueError(f"x: want contiguous f32 of a multiple of {BLOCK * CHAINS} lanes, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    out = torch.empty_like(x)
    lib = library().lib
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "sqrt":
            rc, name = lib.lol_peak_sqrt(x.data_ptr(), out.data_ptr(), x.numel(), iters,
                                         stream), SQRT
        else:
            rc, name = lib.lol_peak_fma(x.data_ptr(), out.data_ptr(), x.numel(), iters,
                                        int(kind == "fma"), stream), FMA
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launches[name] += 1
    return out


def _timed(fn, device: torch.device) -> float:
    """Seconds of one call of fn: CUDA events on the card, the host clock on
    the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def measure_peak(
    kind: str = "fma",
    lanes: Optional[int] = None,
    iters: Optional[int] = None,
    reps: int = 5,
    device="cuda",
) -> Dict:
    """Rate of one kind's chain: flops (2 per FMA step, 1 per multiply or add
    of "muladd", 1 per sqrt) and evaluations (steps) per second of the best
    of `reps` calls, each timed alone; with `iters` None, iterations sized
    from a short first call and again from a sized one, so that a call
    lasts ~TARGET_MS. Inputs are
    lanes evenly spaced in [1, 2], as the JAX package's."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}: one of {KINDS}")
    device = resolve_device(device, "measure_peak")
    if lanes is None:
        lanes = LANES if device.type == "cuda" else BLOCK * CHAINS
    x = torch.linspace(1.0, 2.0, lanes, dtype=torch.float32, device=device)
    if iters is None:
        iters = 64
        peak_chain(x, kind, iters)  # build, load, warm
        for _ in range(2):  # from a short call, then again from the sized one
            dt = _timed(lambda: peak_chain(x, kind, iters), device)
            iters = max(1, int(iters * TARGET_MS / 1e3 / max(dt, 1e-9)))
    total = 0.0
    times = []
    for _ in range(reps + 1):  # the first call warms up
        holder = []
        times.append(_timed(lambda: holder.append(peak_chain(x, kind, iters)), device))
        total = float(holder[0].sum())  # the TPU kernel's one scalar
    best = min(times[1:])
    evals = float(lanes) * iters * STEPS
    return {
        "kind": kind,
        "lanes": lanes,
        "block": BLOCK,
        "chains_per_thread": CHAINS,
        "iters": iters,
        "best_seconds": best,
        "evals_per_s": evals / best,
        "flops_per_s": evals * (1.0 if kind == "sqrt" else 2.0) / best,
        "sum": total,
    }


def card_info() -> Dict:
    """The card's name, power limit and maximum SM clock (nvidia-smi), and
    the modelled FP32 ceiling 132 SMs x 128 lanes x 2 flops x that clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit, clock = (s.strip() for s in out.split(","))
    mhz = float(clock)
    return {"name": name, "power_limit_w": float(limit), "max_sm_clock_mhz": mhz,
            "modelled_fma_flops_per_s": 132 * 128 * 2 * mhz * 1e6}


def measure_vpu_peak(reps: int = 5, device="cuda") -> Dict:
    """The ceiling record (module docstring). On the CPU it carries
    "platform": "cpu" and no card."""
    device = resolve_device(device, "measure_vpu_peak")
    detail = {k: measure_peak(k, reps=reps, device=device) for k in KINDS}
    fma, sqrt = detail["fma"], detail["sqrt"]
    rec = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "fma_flops_per_s": fma["flops_per_s"],
        "muladd_flops_per_s": detail["muladd"]["flops_per_s"],
        "sqrt_evals_per_s": sqrt["evals_per_s"],
        # one sqrt occupies this many add/mul SLOTS (fma = 2 slots)
        "transcendental_weight": (fma["flops_per_s"] / 2.0) / sqrt["evals_per_s"],
        "detail": detail,
    }
    if device.type == "cuda":
        rec["device"] = card_info()
        rec["device"]["torch_name"] = torch.cuda.get_device_name(device)
    return rec


def load_measured_peak(path: str = PEAK_ARTIFACT) -> Optional[float]:
    """The measured FMA ceiling in flops/s from the card's record at
    `path`, or None without it (or for a record the CPU wrote)."""
    try:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("platform") != "gpu":
            return None
        return float(rec["fma_flops_per_s"])
    except (OSError, KeyError, ValueError, TypeError):
        return None
