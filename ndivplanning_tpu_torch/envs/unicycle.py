"""Unicycle dynamics; counterpart of ``ndivplanning_tpu/envs/unicycle.py``.

A planar pose, a heading and a forward speed, over the candidate axis
``[..., N]`` of a scene's axes ``[...]``; ``action = (accel, steer_rate)``:

  w' = clip(action[1], +-max_steer);  heading' = heading + w' dt
  v' = clip(v + clip(action[0], +-max_accel) dt, 0, max_speed)
  p' = clip(p + v' [cos heading', sin heading'] dt, bounds); the speed is
       zeroed where a wall clipped ANY component (absorbing walls)
  collided latches on the swept segment p -> p'; done latches inside
  goal_radius, and a done state is frozen
"""

from __future__ import annotations

import dataclasses

import torch

from ndivplanning_tpu_torch.envs.pointmass import _collision
from ndivplanning_tpu_torch.envs.types import Scene, StepInfo, latch_step
from ndivplanning_tpu_torch.ops.clip import clip


@dataclasses.dataclass
class UnicycleState:
    """``pos [..., N, 2]``, ``heading`` (radians, unwrapped) and ``speed``
    (>= 0) ``[..., N]``, ``t [..., N]`` int32 and the ``done, collided``
    latches ``[..., N]``."""

    pos: torch.Tensor
    heading: torch.Tensor
    speed: torch.Tensor
    t: torch.Tensor
    done: torch.Tensor
    collided: torch.Tensor


@dataclasses.dataclass(frozen=True)
class UnicycleParams:
    """Unicycle parameters (float32 values held as Python floats)."""

    dt: float
    max_speed: float
    max_accel: float
    max_steer: float  # rad/s steering-rate limit
    bounds_lo: float
    bounds_hi: float
    goal_radius: float

    @classmethod
    def create(cls, dt=0.1, max_speed=1.5, max_accel=4.0, max_steer=4.0,
               bounds_lo=0.0, bounds_hi=1.0,
               goal_radius=0.05) -> "UnicycleParams":
        return cls(dt=dt, max_speed=max_speed, max_accel=max_accel,
                   max_steer=max_steer, bounds_lo=bounds_lo,
                   bounds_hi=bounds_hi, goal_radius=goal_radius)


def reset(params: UnicycleParams, scene: Scene, n: int) -> UnicycleState:
    """``n`` candidates per scene at its start, at rest, facing the goal."""
    del params
    lead = scene.start.shape[:-1]
    pos = scene.start[..., None, :].expand(*lead, n, 2).clone()
    d = scene.goal - scene.start
    heading = torch.atan2(d[..., 1], d[..., 0])[..., None].expand(
        *lead, n).clone()
    zeros = torch.zeros((*lead, n), dtype=torch.float32, device=pos.device)
    return UnicycleState(pos=pos, heading=heading, speed=zeros,
                         t=torch.zeros((*lead, n), dtype=torch.int32,
                                       device=pos.device),
                         done=zeros.clone(), collided=zeros.clone())


def step(params: UnicycleParams, scene: Scene, state: UnicycleState,
         action: torch.Tensor) -> tuple[UnicycleState, StepInfo]:
    """One dynamics step of every candidate, ``action [..., N, 2]``."""
    a = clip(action[..., 0], -params.max_accel, params.max_accel)
    w = clip(action[..., 1], -params.max_steer, params.max_steer)
    heading = state.heading + w * params.dt
    speed = clip(state.speed + a * params.dt, 0.0, params.max_speed)
    direction = torch.stack([torch.cos(heading), torch.sin(heading)], dim=-1)
    raw_pos = state.pos + speed[..., None] * direction * params.dt
    pos = clip(raw_pos, params.bounds_lo, params.bounds_hi)
    # Absorbing walls: one clipped component stops the vehicle.
    speed = torch.where(torch.all(pos == raw_pos, dim=-1), speed,
                        torch.zeros_like(speed))
    return latch_step(state, {"pos": pos, "heading": heading, "speed": speed},
                      scene, params.goal_radius,
                      _collision(state.pos, pos, scene))


def waypoint_control(params: UnicycleParams, state: UnicycleState,
                     target: torch.Tensor, kp: float = 8.0, kd: float = 2.0,
                     kh: float = 4.0) -> torch.Tensor:
    """Steer towards the target's bearing and accelerate on its distance:
    PD on the range, P on the heading error wrapped to (-pi, pi]."""
    del params
    delta = target - state.pos
    err = torch.atan2(delta[..., 1], delta[..., 0]) - state.heading
    err = torch.atan2(torch.sin(err), torch.cos(err))
    dist = torch.sqrt(torch.sum(delta * delta, dim=-1))
    return torch.stack([kp * dist - kd * state.speed, kh * err], dim=-1)
