"""Device time from one torch.profiler session over a bounded sub-window of
a traced run, and the rule that tells the program's kernels from torch's.

A session records the card's activity alone (no CPU op), which keeps its
cost on the host and the events to read small. A session has been seen to
drop its first and its last kernel on the card, so marker kernels
(`torch.cuda._sleep`) open it and close it, and everything between the
last opening marker and the first closing one is the sub-window: a copy
of the marker technique of the port's weak-scaling harness.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


def is_port_kernel(name: str) -> bool:
    """The program's kernels are those of its CUDA sources, all inside the
    `lol::` namespace; every other kernel, copy or fill is torch's."""
    return "lol::" in name


class Session:
    """One profiler session: `start()` before the sub-window's first unit
    of work, `stop()` after its last, then `summary(units)`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None

    def _mark(self) -> None:
        torch.cuda.synchronize(self.device)
        with torch.cuda.device(self.device):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(2):
            self._mark()

    def stop(self) -> None:
        for _ in range(3):
            self._mark()
        self.prof.stop()

    def events(self) -> Tuple[List[Tuple[int, int, str]], List[Tuple[int, int, str]]]:
        """(device ops, host runtime calls): (start ns, end ns, name) in
        start order. Device ops are kernels, copies and fills; the card's
        synchronisations are left out."""
        from torch.autograd import DeviceType

        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            span = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
            if e.device_type() == DeviceType.CUDA:
                if "Sync" not in name:
                    dev.append(span)
            else:
                host.append(span)
        dev.sort()
        host.sort()
        return dev, host

    def summary(self, units: int) -> dict:
        return summarize(*self.events(), units)


def _window(dev):
    """(start ns, end ns, ops) of the sub-window: the ops strictly between
    the opening run of markers and the closing one."""
    marks = [i for i, (_, _, n) in enumerate(dev) if MARKER in n]
    if len(marks) < 2:
        return None
    inner = [i for i in range(len(marks) - 1) if marks[i + 1] - marks[i] > 1]
    if len(inner) != 1:
        return None
    a, b = marks[inner[0]], marks[inner[0] + 1]
    return dev[a][1], dev[b][0], dev[a + 1:b]


def summarize(dev, host, units: int) -> dict:
    """Per unit of work (a step or a frame) over the sub-window: the device
    ms of the program's kernels and of torch's ops, torch's launches, the
    device's busy and idle time, the ops that took most time and the
    longest idle gaps, each named by the host's runtime call in flight at
    its middle (or "host", none) and the device op that ended it."""
    w = _window(dev)
    if w is None or units <= 0:
        return {}
    start, end, ops = w
    port_ns = sum(e - s for s, e, n in ops if is_port_kernel(n))
    torch_ops = [(s, e, n) for s, e, n in ops if not is_port_kernel(n)]
    busy, gaps, cur = 0, [], start
    by_name: Dict[str, int] = {}
    for s, e, n in ops:
        by_name[n] = by_name.get(n, 0) + (e - s)
        if s > cur:
            gaps.append((cur, s, n))
        busy += max(0, e - max(s, cur))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end, "the window's close"))
    span = end - start

    def host_at(t):
        inside = [n for s, e, n in host if s <= t <= e]
        return inside[-1] if inside else "host"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "units": units,
        "port_ms": port_ns / 1e6 / units,
        "torch_ms": sum(e - s for s, e, _ in torch_ops) / 1e6 / units,
        "torch_launches": len(torch_ops) / units,
        "busy_s": busy / 1e9,
        "window_s": span / 1e9,
        "idle_pct": 100.0 * (span - busy) / span if span > 0 else None,
        "device_ops": [[n[:120], ns / 1e9] for n, ns in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[f"{host_at((s + e) // 2)[:60]} before {n[:60]}", (e - s) / 1e9]
                      for s, e, n in gaps[:10]],
    }
