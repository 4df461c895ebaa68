"""loltracer-tpu-torch: the PyTorch / CUDA port of `loltracer_tpu`.

The JAX package `loltracer_tpu` is the reference; this package renders the
same compiled `.lol` scenes on an NVIDIA H100 through a hand-written CUDA
kernel (render/fused_fwd.py, csrc/fused_fwd.cuh), and differentiates them
through a second one (render/fused_train.py, csrc/fused_bwd.cuh; opt/ fits
scenes with Adam); instanced scenes of 10k+ spheres render and train through
their own pair (render/instanced_fwd.py, render/instanced_train.py,
csrc/instanced_scene.cuh, csrc/instanced_bwd.cuh). A plain PyTorch version
of the same pipeline sits beside each kernel for CPU tensors; a float64
NumPy oracle (golden/) is what both are held against. bench.py (`cli
bench`) times the JAX package's benchmark routes on the card. It imports
torch and never jax.
"""

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.lol.parser import parse_scene, parse_scene_file
from loltracer_tpu_torch.scene import Scene, build_scene

__all__ = [
    "RenderConfig",
    "parse_scene",
    "parse_scene_file",
    "build_scene",
    "Scene",
]

__version__ = "0.1.0"
