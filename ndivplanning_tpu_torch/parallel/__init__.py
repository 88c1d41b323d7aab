"""Data-parallel and diversity-sample-sharded training, and candidate-sharded planning, over torch.distributed; counterpart of ``ndivplanning_tpu/parallel/__init__.py``.

A ``(dp, div)`` mesh of process-group ranks (``mesh.py``), the sharded
NDiv and the sharded train step (``sharded_step.py``), and the six
planners with one scene's candidates split over the mesh
(``sharded_plan.py``).
"""

from ndivplanning_tpu_torch.parallel.mesh import make_mesh
from ndivplanning_tpu_torch.parallel.sharded_plan import (
    make_sharded_cem,
    make_sharded_cem_trajopt,
    make_sharded_grad,
    make_sharded_ilqr,
    make_sharded_plan,
    make_sharded_trajopt,
)
from ndivplanning_tpu_torch.parallel.sharded_step import (
    make_sharded_train_step,
    ndiv_loss_sharded,
    shard_state,
)

__all__ = [
    "make_mesh",
    "make_sharded_cem",
    "make_sharded_cem_trajopt",
    "make_sharded_grad",
    "make_sharded_ilqr",
    "make_sharded_plan",
    "make_sharded_train_step",
    "make_sharded_trajopt",
    "ndiv_loss_sharded",
    "shard_state",
]
