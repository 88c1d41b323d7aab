"""PyTorch and CUDA port of ``ndivplanning_tpu`` for NVIDIA Hopper; counterpart of ``ndivplanning_tpu/__init__.py``.

Imports torch and numpy only, never JAX or the JAX package.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from ndivplanning_tpu_torch.envs.rollout import ScoreWeights, score_candidates
from ndivplanning_tpu_torch.envs.types import EnvParams, Scene
from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss, ndiv_loss_reference
from ndivplanning_tpu_torch.planning.planner import PlanResult, plan, plan_batch
from ndivplanning_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    gen_params,
)
from ndivplanning_tpu_torch.train.step import train_step_fused, train_step_impl
from ndivplanning_tpu_torch.utils.config import PRESETS, Config, get_config

__all__ = [
    "Config", "EnvParams", "PRESETS", "PlanResult", "Scene", "ScoreWeights",
    "TrainState", "create_train_state", "gen_params", "get_config",
    "ndiv_loss", "ndiv_loss_reference", "plan", "plan_batch",
    "score_candidates",
    "train_step_fused", "train_step_impl",
]
