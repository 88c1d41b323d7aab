"""Scene, state and dynamics parameters; counterpart of ``ndivplanning_tpu/envs/types.py``.

Dataclasses of tensors.  A :class:`Scene` may carry leading scene axes (a
training batch's or a served chunk's scenes); an :class:`EnvState`, and
every family's state, carries the scene's axes and then a candidate axis
``[..., N]``, since the rollout batches scenes and candidates instead of
``vmap``-ing.  Obstacles live in a fixed ``[MAX_OBSTACLES, 3]`` buffer with
a mask.  Every family's state has the fields ``pos [..., N, 2]``, ``t``,
``done`` and ``collided``, so scoring, the planner and eval read any of
them alike; :func:`latch_step` ends every family's ``step``.
"""

from __future__ import annotations

import dataclasses

import torch

from ndivplanning_tpu_torch.utils.device import resolve_device

MAX_OBSTACLES = 8


@dataclasses.dataclass
class Scene:
    """Start ``[..., 2]``, goal ``[..., 2]``, obstacles ``[..., MAX_OBSTACLES, 3]``
    rows of (x, y, radius) and their mask ``[..., MAX_OBSTACLES]``."""

    start: torch.Tensor
    goal: torch.Tensor
    obstacles: torch.Tensor
    obstacle_mask: torch.Tensor

    @classmethod
    def create(cls, start, goal, obstacles=None, device=None) -> "Scene":
        """One scene from concrete values, padding the obstacle buffer.

        ``device=None`` takes ``start``'s device when it is a tensor, else
        the CUDA card."""
        if device is None and isinstance(start, torch.Tensor):
            device = start.device
        device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=device)
        start = torch.as_tensor(start, **f32)
        goal = torch.as_tensor(goal, **f32)
        # Validate eagerly: a wrong-shaped scene would only fail later,
        # inside a batched program.
        if start.shape != (2,) or goal.shape != (2,):
            raise ValueError(
                f"start/goal must be 2D points, got shapes "
                f"{tuple(start.shape)}/{tuple(goal.shape)}")
        obs = torch.zeros((MAX_OBSTACLES, 3), **f32)
        mask = torch.zeros((MAX_OBSTACLES,), **f32)
        if obstacles is not None:
            obstacles = torch.as_tensor(obstacles, **f32).reshape(-1, 3)
            n = obstacles.shape[0]
            if n > MAX_OBSTACLES:
                raise ValueError(f"at most {MAX_OBSTACLES} obstacles, got {n}")
            obs[:n] = obstacles
            mask[:n] = 1.0
        return cls(start=start, goal=goal, obstacles=obs, obstacle_mask=mask)

    @classmethod
    def stack(cls, scenes: list["Scene"]) -> "Scene":
        """Scenes stacked along a new leading axis."""
        return cls(**{f.name: torch.stack([getattr(s, f.name) for s in scenes])
                      for f in dataclasses.fields(cls)})

    def map(self, fn) -> "Scene":
        """The scene with ``fn`` applied to every field."""
        return Scene(**{f.name: fn(getattr(self, f.name))
                        for f in dataclasses.fields(self)})

    @classmethod
    def create_batch(cls, start: torch.Tensor, goal: torch.Tensor) -> "Scene":
        """Obstacle-free scenes for ``start, goal [B, 2]``."""
        b = start.shape[0]
        f32 = dict(dtype=torch.float32, device=start.device)
        return cls(start=start, goal=goal,
                   obstacles=torch.zeros((b, MAX_OBSTACLES, 3), **f32),
                   obstacle_mask=torch.zeros((b, MAX_OBSTACLES), **f32))


@dataclasses.dataclass
class EnvState:
    """Point-mass state of N candidates per scene: ``pos, vel [..., N, 2]``,
    ``t [..., N]`` int32, and float {0, 1} latches ``done, collided
    [..., N]``."""

    pos: torch.Tensor
    vel: torch.Tensor
    t: torch.Tensor
    done: torch.Tensor
    collided: torch.Tensor


@dataclasses.dataclass
class StepInfo:
    """Per-step diagnostics emitted by ``step``."""

    dist_to_goal: torch.Tensor
    collided_now: torch.Tensor
    reached_now: torch.Tensor


def latch_step(state, moved: dict, scene: Scene, goal_radius: float,
               collided_now: torch.Tensor):
    """The end of every family's step: the goal test on ``moved["pos"]``,
    then the new state, frozen where it was already done, with its ``t``,
    ``done`` and ``collided`` latches, and the step's :class:`StepInfo`.

    ``moved`` holds the new value of every evolving field, ``[..., N]`` or
    ``[..., N, d]``.  ``where`` (not arithmetic) keeps live steps bitwise
    the moved values."""
    dist_to_goal = torch.sqrt(torch.sum(
        torch.square(moved["pos"] - scene.goal[..., None, :]), dim=-1))
    reached_now = (dist_to_goal < goal_radius).float()
    alive = state.done < 0.5
    live = alive.float()
    frozen = {name: torch.where(alive.view(*alive.shape,
                                           *(1,) * (v.dim() - alive.dim())),
                                v, getattr(state, name))
              for name, v in moved.items()}
    new_state = dataclasses.replace(
        state, **frozen, t=state.t + alive.int(),
        done=torch.maximum(state.done, live * reached_now),
        collided=torch.maximum(state.collided, live * collided_now))
    info = StepInfo(dist_to_goal=dist_to_goal,
                    collided_now=live * collided_now,
                    reached_now=live * reached_now)
    return new_state, info


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Point-mass dynamics parameters (float32 values held as Python floats)."""

    dt: float
    max_speed: float
    max_accel: float
    bounds_lo: float
    bounds_hi: float
    goal_radius: float

    @classmethod
    def create(cls, dt=0.1, max_speed=2.0, max_accel=4.0, bounds_lo=0.0,
               bounds_hi=1.0, goal_radius=0.05) -> "EnvParams":
        return cls(dt=dt, max_speed=max_speed, max_accel=max_accel,
                   bounds_lo=bounds_lo, bounds_hi=bounds_hi,
                   goal_radius=goal_radius)
