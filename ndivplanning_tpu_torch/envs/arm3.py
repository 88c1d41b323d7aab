"""Three-link planar arm ("arm3"); counterpart of ``ndivplanning_tpu/envs/arm3.py``.

The reacher's scheme (``envs/reacher.py``) with a third link: 3-D joint
space and actions, a 2-D end-effector ``pos``.  Kinematically redundant,
so the damped least-squares controller picks the minimum-norm joint
velocity; its normal equations stay 2x2.  ``reset`` zeroes the distal
joint and solves the two-link IK over the virtual links (l1, l2 + l3).
Collision tests the swept end-effector segment and all three links.

  qd' = clip(qd + clip(a, +-max_accel) dt, +-max_qd);  q' = q + qd' dt
  ee  = FK(q'); collided latches; done latches inside goal_radius, and a
        done state is frozen
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ndivplanning_tpu_torch.envs.pointmass import _collision
from ndivplanning_tpu_torch.envs.reacher import (
    _unit,
    anchor,
    dls_control,
    two_link_ik,
)
from ndivplanning_tpu_torch.envs.types import Scene, StepInfo, latch_step
from ndivplanning_tpu_torch.ops.clip import clip


@dataclasses.dataclass
class Arm3State:
    """Joint angles ``q`` and velocities ``qd`` ``[..., N, 3]``, the
    end-effector ``pos = FK(q)`` ``[..., N, 2]``, ``t [..., N]`` int32 and
    the ``done, collided`` latches ``[..., N]``."""

    q: torch.Tensor
    qd: torch.Tensor
    pos: torch.Tensor
    t: torch.Tensor
    done: torch.Tensor
    collided: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Arm3Params:
    """Three-link arm parameters (float32 values held as Python floats; the
    anchor ``base`` as a pair)."""

    dt: float
    l1: float
    l2: float
    l3: float
    base: tuple
    max_accel: float  # joint acceleration limit, rad/s^2
    max_qd: float  # joint speed limit, rad/s
    goal_radius: float

    @classmethod
    def create(cls, dt=0.1, l1=0.4, l2=0.2, l3=0.2, base=(0.5, 0.5),
               max_accel=40.0, max_qd=4.0,
               goal_radius=0.05) -> "Arm3Params":
        return cls(dt=dt, l1=l1, l2=l2, l3=l3, base=tuple(base),
                   max_accel=max_accel, max_qd=max_qd,
                   goal_radius=goal_radius)


def _angles(q: torch.Tensor):
    """The links' absolute angles ``q1``, ``q1 + q2``, ``q1 + q2 + q3``."""
    a2 = q[..., 0] + q[..., 1]
    return q[..., 0], a2, a2 + q[..., 2]


def forward_kinematics(params: Arm3Params, q: torch.Tensor):
    """(joint 1, joint 2, end-effector) ``[..., 2]`` for ``q [..., 3]``."""
    a1, a2, a3 = _angles(q)
    j1 = anchor(params, q) + params.l1 * _unit(a1)
    j2 = j1 + params.l2 * _unit(a2)
    return j1, j2, j2 + params.l3 * _unit(a3)


def inverse_kinematics(params: Arm3Params,
                       target: torch.Tensor) -> torch.Tensor:
    """Joint angles ``[..., 3]`` with the distal joint at 0: the two-link IK
    over (l1, l2 + l3), elbow up."""
    lv = float(np.float32(params.l2) + np.float32(params.l3))
    q12 = two_link_ik(anchor(params, target), params.l1, lv, target)
    return torch.cat([q12, torch.zeros_like(q12[..., :1])], dim=-1)


def reset(params: Arm3Params, scene: Scene, n: int) -> Arm3State:
    """``n`` candidates per scene with the end-effector on its start (by
    IK), at rest."""
    lead = scene.start.shape[:-1]
    q = inverse_kinematics(params, scene.start)[..., None, :].expand(
        *lead, n, 3).contiguous()
    _, _, ee = forward_kinematics(params, q)  # FK(q): self-consistent state
    zeros = torch.zeros((*lead, n), dtype=torch.float32, device=q.device)
    return Arm3State(q=q, qd=torch.zeros_like(q), pos=ee,
                     t=torch.zeros((*lead, n), dtype=torch.int32,
                                   device=q.device),
                     done=zeros, collided=zeros.clone())


def step(params: Arm3Params, scene: Scene, state: Arm3State,
         action: torch.Tensor) -> tuple[Arm3State, StepInfo]:
    """One dynamics step of every candidate, ``action [..., N, 3]``."""
    a = clip(action, -params.max_accel, params.max_accel)
    qd = clip(state.qd + a * params.dt, -params.max_qd, params.max_qd)
    q = state.q + qd * params.dt
    j1, j2, ee = forward_kinematics(params, q)
    collided_now = torch.maximum(
        torch.maximum(_collision(state.pos, ee, scene),
                      _collision(anchor(params, q), j1, scene)),
        torch.maximum(_collision(j1, j2, scene), _collision(j2, ee, scene)))
    return latch_step(state, {"q": q, "qd": qd, "pos": ee}, scene,
                      params.goal_radius, collided_now)


def jacobian(params: Arm3Params, q: torch.Tensor) -> torch.Tensor:
    """The end-effector Jacobian d(ee)/d(q), ``[..., 2, 3]``: column j sums
    the link vectors distal to joint j, turned by 90 degrees."""
    a1, a2, a3 = _angles(q)
    s1, c1 = torch.sin(a1), torch.cos(a1)
    s2, c2 = torch.sin(a2), torch.cos(a2)
    s3, c3 = torch.sin(a3), torch.cos(a3)
    l1, l2, l3 = params.l1, params.l2, params.l3
    return torch.stack([
        torch.stack([-l1 * s1 - l2 * s2 - l3 * s3, -l2 * s2 - l3 * s3,
                     -l3 * s3], dim=-1),
        torch.stack([l1 * c1 + l2 * c2 + l3 * c3, l2 * c2 + l3 * c3,
                     l3 * c3], dim=-1)], dim=-2)


def waypoint_control(params: Arm3Params, state: Arm3State,
                     target: torch.Tensor, kv: float = 6.0,
                     kacc: float = 10.0, lam: float = 0.02) -> torch.Tensor:
    """The reacher's damped least squares at a ``[2, 3]`` Jacobian: ``[..., 3]``
    joint accelerations, the minimum-norm joint velocity of the redundant
    family."""
    return dls_control(jacobian(params, state.q), state, target, kv, kacc,
                       lam)
