"""Environment registry; counterpart of ``ndivplanning_tpu/envs/registry.py``.

``Config.env`` names the family; the rollout, the planner, eval and the
task samplers look its functions up here.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

FAMILIES = ("pointmass", "unicycle", "reacher", "quadrotor", "arm3")


class EnvAPI(NamedTuple):
    """The functional surface every environment family exposes."""

    make_params: Callable  # () -> params
    reset: Callable  # (params, scene, n) -> state of n candidates
    step: Callable  # (params, scene, state, action) -> (state, StepInfo)
    waypoint_control: Callable  # (params, state, target) -> action


def get_env(name: str) -> EnvAPI:
    if name == "pointmass":
        from ndivplanning_tpu_torch.envs import pointmass as module
        from ndivplanning_tpu_torch.envs.types import EnvParams as params_cls
    elif name == "unicycle":
        from ndivplanning_tpu_torch.envs import unicycle as module
        params_cls = module.UnicycleParams
    elif name == "reacher":
        from ndivplanning_tpu_torch.envs import reacher as module
        params_cls = module.ReacherParams
    elif name == "quadrotor":
        from ndivplanning_tpu_torch.envs import quadrotor as module
        params_cls = module.QuadrotorParams
    elif name == "arm3":
        from ndivplanning_tpu_torch.envs import arm3 as module
        params_cls = module.Arm3Params
    else:
        raise ValueError(f"unknown env {name!r}; expected "
                         f"{' | '.join(FAMILIES)}")
    return EnvAPI(make_params=params_cls.create, reset=module.reset,
                  step=module.step, waypoint_control=module.waypoint_control)


@functools.lru_cache(maxsize=len(FAMILIES))
def action_dim(name: str) -> int:
    """A family's action width, read off its own ``waypoint_control``: one
    candidate of one scene reset and controlled on the CPU, once a family
    (the action-mode sampler asks at every batch)."""
    import torch

    from ndivplanning_tpu_torch.envs.types import Scene

    api = get_env(name)
    params = api.make_params()
    scene = Scene.create(torch.zeros(2), torch.ones(2))
    out = api.waypoint_control(params, api.reset(params, scene, 1),
                               scene.goal)
    if out.shape[:-1] != (1,):
        raise ValueError(f"env {name!r}: waypoint_control must emit one "
                         f"[du] action a candidate, got {tuple(out.shape)}")
    return int(out.shape[-1])
