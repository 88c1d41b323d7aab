"""Candidate rollouts and scoring; counterpart of ``ndivplanning_tpu/envs/rollout.py``.

Scenes and candidates are batch axes and the horizon is a Python loop, so
one pass scores every candidate of every scene.  :func:`time_loop` runs
the time loops: a Python loop, or, where it is traced (its inputs are
fake tensors, as under the deployment export, ``utils/export.py``) and
autograd does not record, one ``scan`` of the same step, so an exported
program holds one step's graph instead of H copies; the scan runs the
same ops step by step, bitwise the loop.  ``tau[t]`` is either the
family's action at step t ("actions", ``[du]``: 3 joint accelerations for
arm3, 2 elsewhere) or a position target ``[2]`` tracked by the family's
waypoint controller ("waypoints").  Score (lower is better): final goal
distance + collision penalty + control-effort cost.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

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


def traced(t: torch.Tensor) -> bool:
    """Whether ``t`` is a tracer's fake tensor (it holds no data)."""
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def _leaves(state) -> list:
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


def _scan(body, state, xs: torch.Tensor, scene: Scene):
    """``body`` over ``xs``' leading axis as one ``scan``: the family state
    flattened to its fields, the scene's tensors passed in (a scan's body
    may close over no traced tensor).  A scan's outputs may alias neither
    its inputs nor each other, so a field a step leaves as it is and every
    per-step output are copied."""
    from torch._higher_order_ops.scan import scan_op

    names = [f.name for f in dataclasses.fields(state)]
    scene_names = [f.name for f in dataclasses.fields(scene)]
    n = len(names)
    # Integer fields (the step counter) ride as float32, exact for any
    # count of steps: scan's backward takes a tangent for every carry.
    dtypes = [t.dtype for t in _leaves(state)]

    def unpack(carry):
        return dataclasses.replace(state, **{
            name: t.to(dtype) for name, t, dtype in zip(names, carry, dtypes)})

    def pack(leaves):
        return [t if t.is_floating_point() else t.to(torch.float32)
                for t in leaves]

    def combine(*args):
        carry, x, rest = args[:n], args[n], args[n + 1:]
        new, ys = body(unpack(carry), x,
                       Scene(**dict(zip(scene_names, rest))))
        seen = {id(t) for t in args}
        out = []
        for t in pack(_leaves(new)):
            out.append(t.clone() if id(t) in seen else t)
            seen.add(id(t))
        return [*out, *(y.clone() for y in ys)]

    flat = scan_op(combine, pack(_leaves(state)), [xs],
                   additional_inputs=tuple(_leaves(scene)))
    return unpack(flat[:n]), flat[n:]


def time_loop(body: Callable, state, xs: torch.Tensor, dims: tuple,
              scene: Scene):
    """``body(state, x_t, scene) -> (state, (y_t, ...))`` over ``xs``'
    leading axis; returns the last state and each ``y`` stacked on its axis
    of ``dims``.  ``scene`` is the body's scene (its only tensor input
    besides the state and ``x_t``)."""
    if traced(xs) and not torch.is_grad_enabled():
        # Scan's backward does not trace with a symbolic batch, so a loop
        # under autograd unrolls.
        state, ys = _scan(body, state, xs, scene)
        return state, tuple(y.movedim(0, d).contiguous()
                            for y, d in zip(ys, dims))
    outs = []
    for x in xs.unbind(0):
        state, ys = body(state, x, scene)
        outs.append(ys)
    return state, tuple(torch.stack(list(col), dim=d)
                        for col, d in zip(zip(*outs), dims))


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

    def step(state, tau_t, scene):
        a = tau_t if mode == "actions" else api.waypoint_control(
            params, state, tau_t)
        ctrl = torch.sum(a * a, dim=-1) * (1.0 - state.done)
        state, _ = api.step(params, scene, state, a)
        return state, (state.pos, ctrl)

    state, (positions, ctrl) = time_loop(step, state, taus.movedim(-2, 0),
                                         (-2, -1), scene)
    goal_dist = torch.sqrt(torch.sum(
        torch.square(state.pos - scene.goal[..., None, :]), dim=-1))
    control_cost = torch.sum(ctrl, dim=-1)
    score = (weights.goal * goal_dist + weights.collision * state.collided
             + weights.control * control_cost)
    return RolloutResult(final_state=state, positions=positions,
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

    def step(state, wp, scene):
        a = api.waypoint_control(params, state, wp)
        return api.step(params, scene, state, a)[0], (a,)

    _, (actions,) = time_loop(step, api.reset(params, scene,
                                              waypoints.shape[-3]),
                              waypoints.movedim(-2, 0), (-2,), scene)
    return actions
