"""Candidate rollouts and scoring; counterpart of ``ndivplanning_tpu/envs/rollout.py``.

Scenes and candidates are batch axes and the horizon is a Python loop, so
one pass scores every candidate of every scene.  ``tau[t]``
is either the acceleration at step t ("actions") or a PD-tracked position
target ("waypoints").  Score (lower is better): final goal distance +
collision penalty + control-effort cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.types import EnvParams, EnvState, Scene


class RolloutResult(NamedTuple):
    """Outcome of rolling N trajectories per scene through the env; the
    scene's axes ``[...]`` lead every field."""

    final_state: EnvState
    positions: torch.Tensor  # [..., N, H, 2] visited positions
    score: torch.Tensor  # [..., N] cost, lower is better
    goal_dist: torch.Tensor  # [..., N] final distance to goal
    collided: torch.Tensor  # [..., N] 1.0 if any step collided
    reached: torch.Tensor  # [..., N] 1.0 if goal reached within horizon
    control_cost: torch.Tensor  # [..., N] sum ||a_t||^2


class ScoreWeights(NamedTuple):
    """Cost weights for candidate scoring."""

    goal: float = 1.0
    collision: float = 1.0
    control: float = 0.01


def score_candidates(params: EnvParams, scene: Scene, taus: torch.Tensor,
                     mode: str = "waypoints",
                     weights: ScoreWeights = ScoreWeights(),
                     env: str = "pointmass") -> RolloutResult:
    """Score N candidate trajectories per scene, ``taus [..., N, H, 2]``,
    from the start of their scene (whose axes are ``[...]``)."""
    if mode not in ("actions", "waypoints"):
        raise ValueError(f"unknown rollout mode {mode!r}")
    api = get_env(env)
    n, horizon = taus.shape[-3:-1]
    state = api.reset(params, scene, n)
    positions, ctrl = [], []
    for t in range(horizon):
        tau_t = taus[..., t, :]
        a = tau_t if mode == "actions" else api.waypoint_control(
            params, state, tau_t)
        ctrl.append(torch.sum(a * a, dim=-1) * (1.0 - state.done))
        state, _ = api.step(params, scene, state, a)
        positions.append(state.pos)
    goal_dist = torch.sqrt(torch.sum(
        torch.square(state.pos - scene.goal[..., None, :]), dim=-1))
    control_cost = torch.sum(torch.stack(ctrl, dim=-1), dim=-1)
    score = (weights.goal * goal_dist + weights.collision * state.collided
             + weights.control * control_cost)
    return RolloutResult(final_state=state,
                         positions=torch.stack(positions, dim=-2),
                         score=score, goal_dist=goal_dist,
                         collided=state.collided, reached=state.done,
                         control_cost=control_cost)
