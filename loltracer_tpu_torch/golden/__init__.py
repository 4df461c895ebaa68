"""Float64 reference tracer: the correctness oracle for the port's renderers
and kernels (`loltracer_tpu/golden/`)."""

from loltracer_tpu_torch.golden.tracer import (
    render_golden,
    render_golden_scalar,
    trace_pixel,
)

__all__ = ["render_golden", "render_golden_scalar", "trace_pixel"]
