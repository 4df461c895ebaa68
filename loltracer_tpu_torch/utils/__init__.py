"""Host-side utilities: image output (image.py), the measured FP32 ceiling
(peak.py), profiling and the row-sharding cost model (profiling.py), the
roofline model (roofline.py), spans and counters (tracing.py).

profiling.py's names load at first use: the renderers import tracing.py,
and profiling.py imports the renderers."""

from loltracer_tpu_torch.utils.image import image_to_u8, write_npy, write_png

__all__ = [
    "image_to_u8",
    "march_step_counts",
    "march_step_stats",
    "trace",
    "write_npy",
    "write_png",
]


def __getattr__(name):
    if name in ("march_step_counts", "march_step_stats", "trace"):
        from loltracer_tpu_torch.utils import profiling

        return getattr(profiling, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
