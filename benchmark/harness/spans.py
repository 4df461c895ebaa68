"""The program's own spans and counters over a traced run's sub-window.
Besides port.py, the only module of the benchmark that imports the program,
and of it only `loltracer_tpu_torch.utils.tracing`, imported inside the
calls: its spans record while a torch.profiler session is active, so a
window opened just after the session starts and closed just before it
stops holds the spans of the session's sub-window. A span or counter the
program lacks is absent from the readings, and the metrics that read it
find nothing."""

from __future__ import annotations


class Window:
    """`start()` after the profiler session's start, `stop(units)` before
    its stop: then {"units", "spans": {name: {count, total_ms, self_ms}},
    "counters": {name: the change over the window}}."""

    def __init__(self):
        self.before = None

    def start(self) -> None:
        from loltracer_tpu_torch.utils import tracing

        tracing.summary(reset=True)  # what was recorded before the window
        self.before = tracing.counters()

    def stop(self, units: int) -> dict:
        from loltracer_tpu_torch.utils import tracing

        spans = tracing.summary(reset=True)
        after = tracing.counters()
        return {"units": units, "spans": spans,
                "counters": {k: v - self.before.get(k, 0) for k, v in after.items()}}
