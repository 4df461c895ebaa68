"""Host-side utilities: image output (image.py), the measured FP32 ceiling
(peak.py), profiling and the row-sharding cost model (profiling.py), the
roofline model (roofline.py)."""

from loltracer_tpu_torch.utils.image import image_to_u8, write_npy, write_png
from loltracer_tpu_torch.utils.profiling import march_step_counts, march_step_stats, trace

__all__ = [
    "image_to_u8",
    "march_step_counts",
    "march_step_stats",
    "trace",
    "write_npy",
    "write_png",
]
