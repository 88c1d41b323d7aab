"""Data-parallel and diversity-sample-sharded training over torch.distributed; counterpart of ``ndivplanning_tpu/parallel/__init__.py``.

A ``(dp, div)`` mesh of process-group ranks (``mesh.py``), the sharded
NDiv and the sharded train step (``sharded_step.py``).  The JAX package's
sharded planners (``sharded_plan.py``) are not ported yet.
"""

from ndivplanning_tpu_torch.parallel.mesh import make_mesh
from ndivplanning_tpu_torch.parallel.sharded_step import (
    make_sharded_train_step,
    ndiv_loss_sharded,
    shard_state,
)

__all__ = [
    "make_mesh",
    "make_sharded_train_step",
    "ndiv_loss_sharded",
    "shard_state",
]
