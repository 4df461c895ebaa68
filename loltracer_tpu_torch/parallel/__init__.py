"""Multi-device rendering over torch.distributed: meshes of ranks
(mesh.py), the multi-process bootstrap (distributed.py), row-sharded
rendering, loss and training (sharded.py) and object-axis sharding of
instanced scenes (objects.py)."""

from loltracer_tpu_torch.parallel.distributed import maybe_initialize, process_info
from loltracer_tpu_torch.parallel.mesh import AXIS, CHIPS_AXIS, HOSTS_AXIS, make_mesh, make_mesh_2d
from loltracer_tpu_torch.parallel.objects import (
    OBJ_AXIS,
    make_object_sharded_renderer,
    pad_spheres_for_sharding,
)
from loltracer_tpu_torch.parallel.sharded import (
    make_sharded_loss,
    make_sharded_renderer,
    make_sharded_train_step,
)

__all__ = [
    "AXIS",
    "CHIPS_AXIS",
    "HOSTS_AXIS",
    "OBJ_AXIS",
    "make_mesh",
    "make_mesh_2d",
    "make_object_sharded_renderer",
    "make_sharded_loss",
    "make_sharded_renderer",
    "make_sharded_train_step",
    "maybe_initialize",
    "pad_spheres_for_sharding",
    "process_info",
]
