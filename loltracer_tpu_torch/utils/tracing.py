"""Spans and counters of the port: where the host's time goes inside a step
or a frame, on the clock of the device trace.

- `span(name, unit=None, index=None)`: a context manager around one piece
  of the host's work. It is on while a `torch.profiler` session is active
  in the process, whatever that session's activities are (a CUDA-only one
  included), and inside `recording()`; whether a span is recorded is
  decided when it opens. Off, it returns one shared null context after a
  single check: no allocation and no clock read. Under a profiler it also
  enters the profiler's record function of `name` (`_RecordFunctionFast`,
  or `torch.profiler.record_function` where torch lacks it), so a profile
  with CPU and CUDA activity shows the span over the kernels it launched;
  the span's stamps lie inside that event.
- A recorded span holds its name, its start and end in ns on the epoch
  clock that `torch.profiler`'s kineto events report (`now_ns`:
  `perf_counter_ns` plus one offset taken at import), its parent (the
  innermost span open on the same thread), its thread (the native id) and
  its unit of work: the `unit` and `index` of the innermost span, on any
  thread, that named one (a fit's job and step, a renderer's frame). The
  store keeps at most `MAX_SPANS` spans and counts those dropped.
- Counters: sources that the modules register (`register_counters`);
  `snapshot()` reads them. `cell_grid.entries` and `cell_grid.builds`,
  and `shading.exact_kernel` / `shading.exact_loop` (the exact shadow
  marches of each route, render/shading.py), are module counts, always
  on; the counts of K5's counting twin
  (`instanced_render.*`, launched on the first recorded frame of a
  recording, render/cuda_renderer.py) are kept on the card and read only
  here.
- `snapshot(reset=False)`: the spans, the count dropped and the counters;
  `summary(reset=False)`: per span name its count, total ms and self ms
  (its duration less what its children cover). With `reset` both clear
  the spans and the counts kept only while spans are on.

The spans' names and places are listed in PERF.md §3.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 18

# the profiler's event of a span: the fast path where torch has it (no
# dispatcher call, so the event and the span's stamps agree to ~20 us)
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)


def _epoch_offset() -> int:
    """epoch ns - perf_counter_ns, from the closest of a few paired reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


_OFFSET_NS = _epoch_offset()


def now_ns() -> int:
    """The spans' clock: epoch ns, monotonic within the process."""
    return time.perf_counter_ns() + _OFFSET_NS


_recording = 0  # depth of open recording() blocks
_lock = threading.Lock()
_ids = itertools.count()
_spans: List[tuple] = []
_dropped = 0
_unit = (None, None)  # (unit, index) of the innermost open span that named one
_sources: Dict[str, tuple] = {}


def on() -> bool:
    """Whether a span opened now is recorded."""
    return bool(_recording or _profiler._is_profiler_enabled)


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Spans are on inside the block, with or without a profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class _Thread(threading.local):
    """Per thread: its open spans, innermost last, and its native id."""

    def __init__(self):
        self.stack: List["_Span"] = []
        self.tid = threading.get_native_id()


_local = _Thread()


class _Span:
    __slots__ = ("name", "unit", "index", "id", "parent", "saved", "start", "rf", "thread")

    def __init__(self, name: str, unit, index):
        self.name, self.unit, self.index = name, unit, index

    def __enter__(self):
        global _unit
        thread = self.thread = _local
        stack = thread.stack
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.saved = None
        if self.unit is None:
            self.unit, self.index = _unit
        else:
            self.saved, _unit = _unit, (self.unit, self.index)
        stack.append(self)
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _record_function(self.name)
            self.rf.__enter__()
        self.start = now_ns()
        return self

    def __exit__(self, *exc):
        global _unit, _dropped
        end = now_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.thread.stack.pop()
        if self.saved is not None:
            _unit = self.saved
        rec = (self.id, self.name, self.start, end, self.parent, self.thread.tid, self.unit,
               self.index)
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _dropped += 1
        return False


_NULL = contextlib.nullcontext()


def span(name: str, unit=None, index=None):
    """A span named `name` over the block (module docstring); `unit` and
    `index` name the unit of work of it and of the spans inside it."""
    if not (_recording or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, unit, index)


def register_counters(name: str, read: Callable[[], Dict[str, float]],
                      reset: Optional[Callable[[], None]] = None) -> None:
    """A counter source: `read()` gives its counts by name, `reset()` (if
    any) clears what it keeps only while spans are on."""
    _sources[name] = (read, reset)


def counters() -> Dict[str, float]:
    """Every registered source's counts."""
    out: Dict[str, float] = {}
    for read, _ in _sources.values():
        out.update(read())
    return out


def _take(reset: bool):
    """(spans, dropped); with `reset`, the store and the sources cleared."""
    global _spans, _dropped
    with _lock:
        spans, dropped = list(_spans), _dropped
        if reset:
            _spans, _dropped = [], 0
    if reset:
        for _, clear in _sources.values():
            if clear is not None:
                clear()
    return spans, dropped


def snapshot(reset: bool = False) -> dict:
    """{"spans": [...], "dropped": n, "counters": {...}}; each span a dict
    of id, name, start_ns, end_ns, parent, thread, unit, index."""
    keys = ("id", "name", "start_ns", "end_ns", "parent", "thread", "unit", "index")
    counts = counters()
    spans, dropped = _take(reset)
    return {"spans": [dict(zip(keys, s)) for s in spans], "dropped": dropped,
            "counters": counts}


def summary(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Per span name: count, total_ms, self_ms."""
    spans, _ = _take(reset)
    child_ns: Dict[int, int] = {}
    for s in spans:
        if s[4] is not None:
            child_ns[s[4]] = child_ns.get(s[4], 0) + (s[3] - s[2])
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        d = s[3] - s[2]
        e = out.setdefault(s[1], {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        e["count"] += 1
        e["total_ms"] += d / 1e6
        e["self_ms"] += (d - child_ns.get(s[0], 0)) / 1e6
    return out
