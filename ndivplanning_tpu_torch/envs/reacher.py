"""Two-link planar arm ("reacher"); counterpart of ``ndivplanning_tpu/envs/reacher.py``.

The state is joint space; ``pos`` is the end-effector, the forward
kinematics of the joint angles, so scoring, the planner and eval read it
as they read the other families'.  Over the candidate axis ``[..., N]`` of
a scene's axes ``[...]``; ``action = (qdd1, qdd2)``:

  qd' = clip(qd + clip(a, +-max_accel) dt, +-max_qd);  q' = q + qd' dt
  ee  = FK(q'); collided latches on the swept end-effector segment or
        either link meeting a live obstacle; done latches inside
        goal_radius of the end-effector, and a done state is frozen

``reset`` places the end-effector on the scene's start by closed-form
inverse kinematics (elbow up), and ``waypoint_control`` resolves a desired
workspace velocity through the damped least-squares inverse of the
Jacobian, a 2x2 solve done in closed form over the batch axes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ndivplanning_tpu_torch.envs.pointmass import _collision
from ndivplanning_tpu_torch.envs.types import Scene, StepInfo, latch_step
from ndivplanning_tpu_torch.ops.clip import clip


@dataclasses.dataclass
class ReacherState:
    """Joint angles ``q`` and velocities ``qd`` ``[..., N, 2]``, the
    end-effector ``pos = FK(q)`` ``[..., N, 2]``, ``t [..., N]`` int32 and
    the ``done, collided`` latches ``[..., N]``."""

    q: torch.Tensor
    qd: torch.Tensor
    pos: torch.Tensor
    t: torch.Tensor
    done: torch.Tensor
    collided: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ReacherParams:
    """Two-link arm parameters (float32 values held as Python floats; the
    anchor ``base`` as a pair)."""

    dt: float
    l1: float
    l2: float
    base: tuple
    max_accel: float  # joint acceleration limit, rad/s^2
    max_qd: float  # joint speed limit, rad/s
    goal_radius: float

    @classmethod
    def create(cls, dt=0.1, l1=0.4, l2=0.4, base=(0.5, 0.5),
               max_accel=40.0, max_qd=4.0,
               goal_radius=0.05) -> "ReacherParams":
        return cls(dt=dt, l1=l1, l2=l2, base=tuple(base),
                   max_accel=max_accel, max_qd=max_qd,
                   goal_radius=goal_radius)


@functools.lru_cache(maxsize=16)
def _anchor(base: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(base, dtype=torch.float32, device=device)


def anchor(params, like: torch.Tensor) -> torch.Tensor:
    """The arm's base as a ``[2]`` float32 tensor on ``like``'s device,
    copied there once per device: a copy a step would wait on the host.
    Traced (``like`` a fake tensor) it is made by fills, since a traced
    scan body may hold no tensor constant."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(like):
        return torch.stack([like.new_full((), b, dtype=torch.float32)
                            for b in params.base])
    return _anchor(params.base, like.device)


def _unit(angle: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def forward_kinematics(params: ReacherParams, q: torch.Tensor):
    """(elbow, end-effector) ``[..., 2]`` for joint angles ``q [..., 2]``."""
    elbow = anchor(params, q) + params.l1 * _unit(q[..., 0])
    ee = elbow + params.l2 * _unit(q[..., 0] + q[..., 1])
    return elbow, ee


def two_link_ik(base: torch.Tensor, l1: float, l2: float,
                target: torch.Tensor) -> torch.Tensor:
    """Closed-form two-link inverse kinematics, elbow up: ``(q1, q2)``
    ``[..., 2]`` whose end-effector lands on ``target [..., 2]``, clamped
    into the reachable annulus.  The link constants are rounded to float32
    one operation at a time, as the JAX package computes them."""
    l1_, l2_ = np.float32(l1), np.float32(l2)
    rel = target - base
    c2 = ((torch.sum(rel * rel, dim=-1) - float(l1_ * l1_)
           - float(l2_ * l2_)) / float(np.float32(2.0) * l1_ * l2_))
    # Epsilon inside [-1, 1]: full extension stays finite.
    c2 = torch.clamp(c2, -1.0, 1.0 - 1e-7)
    q2 = torch.acos(c2)
    q1 = torch.atan2(rel[..., 1], rel[..., 0]) - torch.atan2(
        l2 * torch.sin(q2), l1 + l2 * c2)
    return torch.stack([q1, q2], dim=-1)


def inverse_kinematics(params: ReacherParams,
                       target: torch.Tensor) -> torch.Tensor:
    """Joint angles ``[..., 2]`` whose FK lands on ``target [..., 2]``."""
    return two_link_ik(anchor(params, target), params.l1, params.l2, target)


def reset(params: ReacherParams, scene: Scene, n: int) -> ReacherState:
    """``n`` candidates per scene with the end-effector on its start (by
    IK), at rest."""
    lead = scene.start.shape[:-1]
    q = inverse_kinematics(params, scene.start)[..., None, :].expand(
        *lead, n, 2).contiguous()
    _, ee = forward_kinematics(params, q)  # FK(q): self-consistent state
    zeros = torch.zeros((*lead, n), dtype=torch.float32, device=q.device)
    return ReacherState(q=q, qd=torch.zeros_like(q), pos=ee,
                        t=torch.zeros((*lead, n), dtype=torch.int32,
                                      device=q.device),
                        done=zeros, collided=zeros.clone())


def step(params: ReacherParams, scene: Scene, state: ReacherState,
         action: torch.Tensor) -> tuple[ReacherState, StepInfo]:
    """One dynamics step of every candidate, ``action [..., N, 2]``."""
    a = clip(action, -params.max_accel, params.max_accel)
    qd = clip(state.qd + a * params.dt, -params.max_qd, params.max_qd)
    q = state.q + qd * params.dt
    elbow, ee = forward_kinematics(params, q)
    # The swept tip and both links: a link can sweep an obstacle the tip
    # never touches.
    collided_now = torch.maximum(
        _collision(state.pos, ee, scene),
        torch.maximum(_collision(anchor(params, q), elbow, scene),
                      _collision(elbow, ee, scene)))
    return latch_step(state, {"q": q, "qd": qd, "pos": ee}, scene,
                      params.goal_radius, collided_now)


def jacobian(params: ReacherParams, q: torch.Tensor) -> torch.Tensor:
    """The end-effector Jacobian d(ee)/d(q), ``[..., 2, 2]``."""
    s1, c1 = torch.sin(q[..., 0]), torch.cos(q[..., 0])
    s12, c12 = torch.sin(q[..., 0] + q[..., 1]), torch.cos(q[..., 0]
                                                            + q[..., 1])
    return torch.stack([
        torch.stack([-params.l1 * s1 - params.l2 * s12, -params.l2 * s12],
                    dim=-1),
        torch.stack([params.l1 * c1 + params.l2 * c12, params.l2 * c12],
                    dim=-1)], dim=-2)


def dls_control(jac: torch.Tensor, state, target: torch.Tensor, kv: float,
                kacc: float, lam: float) -> torch.Tensor:
    """Damped least squares: ``kacc (J^T (J J^T + lam I)^-1 kv err - qd)``
    for ``jac [..., 2, n]``.

    ``J J^T + lam I`` is symmetric positive definite, so the 2x2 system is
    solved in closed form by its adjugate, elementwise over the batch axes:
    no factorisation library call and no host check of its status."""
    err = kv * (target - state.pos)
    j0, j1 = jac[..., 0, :], jac[..., 1, :]
    a = torch.sum(j0 * j0, dim=-1) + lam
    b = torch.sum(j0 * j1, dim=-1)
    d = torch.sum(j1 * j1, dim=-1) + lam
    det = a * d - b * b
    y0 = (d * err[..., 0] - b * err[..., 1]) / det
    y1 = (a * err[..., 1] - b * err[..., 0]) / det
    qd_star = j0 * y0[..., None] + j1 * y1[..., None]
    return kacc * (qd_star - state.qd)


def waypoint_control(params: ReacherParams, state: ReacherState,
                     target: torch.Tensor, kv: float = 6.0,
                     kacc: float = 10.0, lam: float = 0.02) -> torch.Tensor:
    """Damped-least-squares velocity-resolved waypoint tracking: the desired
    workspace velocity ``kv * err`` through ``J^T (J J^T + lam I)^-1``;
    ``lam`` keeps it bounded through the straight- and folded-arm
    singularities."""
    return dls_control(jacobian(params, state.q), state, target, kv, kacc,
                       lam)
