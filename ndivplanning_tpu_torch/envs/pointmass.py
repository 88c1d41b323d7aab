"""Point-mass dynamics ``reset`` / ``step``; counterpart of ``ndivplanning_tpu/envs/pointmass.py``.

Branchless over the candidate axis ``[..., N]`` of a scene's axes ``[...]``
(none for one scene, ``[B]`` for a stack of them):

  v' = clip_speed(v + clip(a, +-max_accel) * dt, max_speed)
  p' = clip(p + v' * dt, bounds); velocity zeroed where a wall clipped it
  collided latches when the segment p -> p' enters a live obstacle disc
  done latches when ||p' - goal|| < goal_radius; a done state is frozen
"""

from __future__ import annotations

import torch

from ndivplanning_tpu_torch.envs.types import (
    EnvParams,
    EnvState,
    Scene,
    StepInfo,
    latch_step,
)
from ndivplanning_tpu_torch.ops.clip import clip


def reset(params: EnvParams, scene: Scene, n: int) -> EnvState:
    """``n`` candidates per scene at its start, at rest."""
    del params
    lead = scene.start.shape[:-1]
    pos = scene.start[..., None, :].expand(*lead, n, 2).clone()
    zeros = torch.zeros((*lead, n), dtype=torch.float32, device=pos.device)
    return EnvState(pos=pos, vel=torch.zeros_like(pos),
                    t=torch.zeros((*lead, n), dtype=torch.int32,
                                  device=pos.device),
                    done=zeros, collided=zeros.clone())


def _clip_speed(vel: torch.Tensor, max_speed: float) -> torch.Tensor:
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1, keepdim=True))
    scale = torch.where(speed > max_speed,
                        max_speed / clip(speed, 1e-12),
                        torch.ones_like(speed))
    return vel * scale


def _collision(prev_pos: torch.Tensor, pos: torch.Tensor,
               scene: Scene) -> torch.Tensor:
    """``[..., N]`` 1.0 where the segment prev_pos -> pos meets a live
    obstacle of its scene.  ``prev_pos`` may also be a ``[2]`` point shared
    by every candidate (an arm's base).

    Swept, not a point check: one step moves up to max_speed * dt = 0.2,
    more than the smallest obstacle diameter."""
    a = prev_pos[..., None, :]  # [..., N, 1, 2]
    d = (pos - prev_pos)[..., None, :]
    obs = scene.obstacles[..., None, :, :]  # [..., 1, M, 3]
    c = obs[..., :2]
    len2 = torch.sum(d * d, dim=-1)  # [..., N, 1]
    t = torch.sum((c - a) * d, dim=-1) / torch.clamp(len2, min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)[..., None]  # [..., N, M, 1]
    closest = a + t * d  # [..., N, M, 2]
    dist2 = torch.sum(torch.square(c - closest), dim=-1)
    inside = dist2 < torch.square(obs[..., 2])
    hit = torch.any(inside & (scene.obstacle_mask[..., None, :] > 0.5), dim=-1)
    return hit.float()


def waypoint_control(params: EnvParams, state: EnvState, target: torch.Tensor,
                     kp: float = 8.0, kd: float = 2.0) -> torch.Tensor:
    """PD waypoint tracking: ``a = kp (target - pos) - kd vel``."""
    del params
    return kp * (target - state.pos) - kd * state.vel


def step(params: EnvParams, scene: Scene, state: EnvState,
         action: torch.Tensor) -> tuple[EnvState, StepInfo]:
    """One dynamics step of every candidate."""
    a = clip(action, -params.max_accel, params.max_accel)
    vel = _clip_speed(state.vel + a * params.dt, params.max_speed)
    raw_pos = state.pos + vel * params.dt
    pos = clip(raw_pos, params.bounds_lo, params.bounds_hi)
    vel = torch.where(pos == raw_pos, vel, torch.zeros_like(vel))  # absorbing walls
    return latch_step(state, {"pos": pos, "vel": vel}, scene,
                      params.goal_radius, _collision(state.pos, pos, scene))
