"""Candidate rollouts and scoring; counterpart of ``ndivplanning_tpu/envs/rollout.py``.

Scenes and candidates are batch axes and the horizon is a Python loop, so
one pass scores every candidate of every scene.  ``tau[t]`` is either the
family's action at step t ("actions", ``[du]``: 3 joint accelerations for
arm3, 2 elsewhere) or a position target ``[2]`` tracked by the family's
waypoint controller ("waypoints").  Score (lower is better): final goal
distance + collision penalty + control-effort cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.types import (
    EnvParams,
    EnvState,
    Scene,
    broadcast_candidates,
)


class RolloutResult(NamedTuple):
    """Outcome of rolling N trajectories per scene through the env; the
    scene's axes ``[...]`` lead every field."""

    final_state: EnvState  # the family's state
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
                     env: str = "pointmass",
                     state0=None) -> RolloutResult:
    """Score N candidate trajectories per scene, ``taus [..., N, H, 2]``
    (waypoints) or ``[..., N, H, du]`` (actions), from the start of their
    scene (whose axes are ``[...]``).

    ``state0``, a family state of one candidate per scene (``[..., 1]``),
    replaces the reset: every candidate starts from it, with its ``t``,
    ``done`` and ``collided`` (receding-horizon replanning scores from the
    live state, ``planning/mpc.py``).  A candidate that starts done costs
    no control."""
    if mode not in ("actions", "waypoints"):
        raise ValueError(f"unknown rollout mode {mode!r}")
    api = get_env(env)
    n, horizon = taus.shape[-3:-1]
    state = (api.reset(params, scene, n) if state0 is None
             else broadcast_candidates(state0, n))
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


def distill_actions(params, scene: Scene, waypoints: torch.Tensor,
                    env: str = "pointmass") -> torch.Tensor:
    """The actions ``[..., N, H, du]`` that the family's waypoint controller
    takes along waypoint paths ``[..., N, H, 2]`` from the start of their
    scene: expert actions for action-space training.  Rolled back in
    "actions" mode they reproduce the waypoint rollout bitwise (the same
    controller output, the same dynamics)."""
    api = get_env(env)
    state = api.reset(params, scene, waypoints.shape[-3])
    actions = []
    for t in range(waypoints.shape[-2]):
        a = api.waypoint_control(params, state, waypoints[..., t, :])
        state, _ = api.step(params, scene, state, a)
        actions.append(a)
    return torch.stack(actions, dim=-2)
