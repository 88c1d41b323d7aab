"""Planar quadrotor dynamics; counterpart of ``ndivplanning_tpu/envs/quadrotor.py``.

Underactuated, with attitude dynamics and gravity, over the candidate axis
``[..., N]`` of a scene's axes ``[...]``; ``action = (u1, u2)`` rotor
thrusts, each clipped to [0, max_thrust]:

  torque = (u2' - u1') arm;  omega' = clip(omega + torque / I dt, +-max_omega)
  theta' = theta + omega' dt
  a  = (u1' + u2') / m [-sin theta', cos theta'] + [0, -gravity]
  v' = clip(v + a dt, +-max_speed) per component
  p' = clip(p + v' dt, bounds); the velocity is zeroed per COMPONENT where
       a wall clipped it (unlike the unicycle: the floor stops the fall,
       not the slide)
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
class QuadrotorState:
    """``pos, vel [..., N, 2]``, the tilt ``theta`` (0 = level) and its rate
    ``omega`` ``[..., N]``, ``t [..., N]`` int32 and the ``done, collided``
    latches ``[..., N]``."""

    pos: torch.Tensor
    vel: torch.Tensor
    theta: torch.Tensor
    omega: torch.Tensor
    t: torch.Tensor
    done: torch.Tensor
    collided: torch.Tensor


@dataclasses.dataclass(frozen=True)
class QuadrotorParams:
    """Planar quadrotor parameters (float32 values held as Python floats)."""

    dt: float
    mass: float
    inertia: float
    arm: float  # rotor moment arm
    gravity: float
    max_thrust: float  # per rotor
    max_speed: float  # per velocity component
    max_omega: float
    bounds_lo: float
    bounds_hi: float
    goal_radius: float

    @classmethod
    def create(cls, dt=0.1, mass=1.0, inertia=0.005, arm=0.1, gravity=0.5,
               max_thrust=1.5, max_speed=2.0, max_omega=8.0,
               bounds_lo=0.0, bounds_hi=1.0,
               goal_radius=0.05) -> "QuadrotorParams":
        return cls(dt=dt, mass=mass, inertia=inertia, arm=arm,
                   gravity=gravity, max_thrust=max_thrust,
                   max_speed=max_speed, max_omega=max_omega,
                   bounds_lo=bounds_lo, bounds_hi=bounds_hi,
                   goal_radius=goal_radius)


def reset(params: QuadrotorParams, scene: Scene, n: int) -> QuadrotorState:
    """``n`` candidates per scene at its start, level and at rest."""
    del params
    lead = scene.start.shape[:-1]
    pos = scene.start[..., None, :].expand(*lead, n, 2).clone()
    zeros = torch.zeros((*lead, n), dtype=torch.float32, device=pos.device)
    return QuadrotorState(pos=pos, vel=torch.zeros_like(pos), theta=zeros,
                          omega=zeros.clone(),
                          t=torch.zeros((*lead, n), dtype=torch.int32,
                                        device=pos.device),
                          done=zeros.clone(), collided=zeros.clone())


def _up(theta: torch.Tensor) -> torch.Tensor:
    """The body's up axis ``[..., 2]`` at tilt ``theta``."""
    return torch.stack([-torch.sin(theta), torch.cos(theta)], dim=-1)


def step(params: QuadrotorParams, scene: Scene, state: QuadrotorState,
         action: torch.Tensor) -> tuple[QuadrotorState, StepInfo]:
    """One dynamics step of every candidate, ``action [..., N, 2]``."""
    u1 = clip(action[..., 0], 0.0, params.max_thrust)
    u2 = clip(action[..., 1], 0.0, params.max_thrust)
    torque = (u2 - u1) * params.arm
    omega = clip(state.omega + torque / params.inertia * params.dt,
                        -params.max_omega, params.max_omega)
    theta = state.theta + omega * params.dt
    acc = ((u1 + u2) / params.mass)[..., None] * _up(theta)
    acc = torch.stack([acc[..., 0], acc[..., 1] - params.gravity], dim=-1)
    vel = clip(state.vel + acc * params.dt, -params.max_speed,
                      params.max_speed)
    raw_pos = state.pos + vel * params.dt
    pos = clip(raw_pos, params.bounds_lo, params.bounds_hi)
    vel = torch.where(pos == raw_pos, vel, torch.zeros_like(vel))
    return latch_step(state, {"pos": pos, "vel": vel, "theta": theta,
                              "omega": omega},
                      scene, params.goal_radius,
                      _collision(state.pos, pos, scene))


def waypoint_control(params: QuadrotorParams, state: QuadrotorState,
                     target: torch.Tensor, kp: float = 6.0, kd: float = 3.0,
                     kth: float = 20.0, kom: float = 5.0) -> torch.Tensor:
    """The cascaded controller: position PD plus gravity compensation gives
    the desired acceleration; the thrust is its projection on the current
    up axis (never negative); an attitude PD towards the acceleration's
    direction gives the torque; the two are mixed into rotor commands,
    clipped to the actuators' range here so that the scorer's control cost
    sees what the rotors can do."""
    a_des = kp * (target - state.pos) - kd * state.vel
    a_des = torch.stack([a_des[..., 0], a_des[..., 1] + params.gravity],
                        dim=-1)
    thrust = clip(
        params.mass * torch.sum(a_des * _up(state.theta), dim=-1), 0.0)
    err = torch.atan2(-a_des[..., 0], a_des[..., 1]) - state.theta
    err = torch.atan2(torch.sin(err), torch.cos(err))  # wrap to (-pi, pi]
    half = (kth * err - kom * state.omega) / params.arm / 2.0
    return clip(torch.stack([thrust / 2.0 - half, thrust / 2.0 + half],
                            dim=-1), 0.0, params.max_thrust)
