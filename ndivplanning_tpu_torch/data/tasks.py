"""On-device synthetic task samplers; counterpart of ``ndivplanning_tpu/data/tasks.py``.

Each sampler draws from a ``torch.Generator`` on the device, so the batch
never crosses from the host.

- ``pointmass2d``: paths from the box centre to one of 8 anchor modes.
- ``goalcond``: minimum-jerk start->goal paths with a left or right detour.
- ``imagecond`` / ``planning``: random obstacle scenes as images; expert
  paths are quadratic Beziers whose control point detours perpendicular on
  a random side.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from ndivplanning_tpu_torch.data.scenes import (
    rasterize_batch,
    random_scene_batch,
)
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.utils.config import Config


@dataclasses.dataclass
class Batch:
    """``conditions`` ``[B, 0]`` (none), ``[B, 4]`` (startgoal) or
    ``[B, S, S, 3]`` (image); ``real_traj [B, horizon, state_dim]``; the
    batch's ``scenes``."""

    conditions: torch.Tensor
    real_traj: torch.Tensor
    scenes: Scene

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Batch":
        """The batch with ``fn`` applied to every tensor (a device move,
        a slice of rows)."""
        return Batch(conditions=fn(self.conditions),
                     real_traj=fn(self.real_traj),
                     scenes=self.scenes.map(fn))


@dataclasses.dataclass(frozen=True)
class Task:
    """A batch sampler ``(generator, batch) -> Batch`` plus its conditioning."""

    name: str
    conditioning: str
    sample: Callable[[torch.Generator, int], Batch]


def _timegrid(horizon: int, device) -> torch.Tensor:
    """[H] time points in (0, 1], matching waypoint-rollout semantics."""
    return (torch.arange(horizon, dtype=torch.float32, device=device)
            + 1.0) / horizon


def _min_jerk(t: torch.Tensor) -> torch.Tensor:
    return 10.0 * t**3 - 15.0 * t**4 + 6.0 * t**5


def _detour_path(start, goal, t, side_amp):
    """Min-jerk start->goal paths ``[B, H, 2]`` plus a perpendicular sine
    detour of signed amplitude ``side_amp [B]``."""
    s = _min_jerk(t)[None, :, None]
    base = start[:, None, :] + s * (goal - start)[:, None, :]
    d = goal - start
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)
    perp = torch.stack([-d[:, 1], d[:, 0]], dim=-1) / norm
    bump = side_amp[:, None] * torch.sin(math.pi * t)[None, :]
    return base + bump[:, :, None] * perp[:, None, :]


def _uniform(gen, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _sample_pointmass2d(gen: torch.Generator, batch: int, horizon: int,
                        n_modes: int = 8) -> Batch:
    device = gen.device
    centre = torch.tensor([0.5, 0.5], device=device)
    mode = torch.randint(0, n_modes, (batch,), generator=gen, device=device)
    angle = 2.0 * math.pi * mode.float() / n_modes
    goals = centre + 0.35 * torch.stack([torch.cos(angle), torch.sin(angle)],
                                        dim=-1)
    t = _timegrid(horizon, device)
    amp = 0.05 * _normal(gen, (batch,))
    starts = centre.expand(batch, 2)
    traj = _detour_path(starts, goals, t, amp)
    traj = traj + 0.01 * _normal(gen, traj.shape)
    return Batch(conditions=torch.zeros((batch, 0), device=device),
                 real_traj=traj,
                 scenes=Scene.create_batch(starts.contiguous(), goals))


def _sample_goalcond(gen: torch.Generator, batch: int, horizon: int) -> Batch:
    device = gen.device
    start = _uniform(gen, (batch, 2), 0.05, 0.45)
    goal = _uniform(gen, (batch, 2), 0.55, 0.95)
    side = 2.0 * (torch.rand((batch,), generator=gen, device=device)
                  < 0.5).float() - 1.0
    amp = side * _uniform(gen, (batch,), 0.05, 0.25)
    t = _timegrid(horizon, device)
    traj = _detour_path(start, goal, t, amp)
    traj = torch.clamp(traj + 0.005 * _normal(gen, traj.shape), 0.0, 1.0)
    return Batch(conditions=torch.cat([start, goal], dim=-1), real_traj=traj,
                 scenes=Scene.create_batch(start, goal))


def _bezier(start, ctrl, goal, t):
    """Quadratic Beziers ``[B, H, 2]`` through ``[B, 2]`` points."""
    u = t[None, :, None]
    return ((1 - u) ** 2 * start[:, None, :]
            + 2 * (1 - u) * u * ctrl[:, None, :] + u**2 * goal[:, None, :])


def imagecond_batch(scenes: Scene, amp: torch.Tensor, noise: torch.Tensor,
                    image_size: int) -> Batch:
    """The imagecond batch of given scenes, signed detour amplitudes
    ``amp [B]`` and unit path noise ``noise [B, H, 2]``."""
    t = _timegrid(noise.shape[1], noise.device)
    d = scenes.goal - scenes.start
    norm = torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True) + 1e-12)
    perp = torch.stack([-d[:, 1], d[:, 0]], dim=-1) / norm
    ctrl = (scenes.start + scenes.goal) / 2.0 + amp[:, None] * perp
    traj = _bezier(scenes.start, ctrl, scenes.goal, t)
    return Batch(conditions=rasterize_batch(scenes, size=image_size),
                 real_traj=torch.clamp(traj + 0.005 * noise, 0.0, 1.0),
                 scenes=scenes)


def _sample_imagecond(gen: torch.Generator, batch: int, horizon: int,
                      image_size: int) -> Batch:
    scenes = random_scene_batch(gen, batch)
    side = 2.0 * (torch.rand((batch,), generator=gen, device=gen.device)
                  < 0.5).float() - 1.0
    amp = side * _uniform(gen, (batch,), 0.1, 0.35)
    return imagecond_batch(scenes, amp, _normal(gen, (batch, horizon, 2)),
                           image_size)


def task_fingerprint(cfg: Config) -> tuple:
    """Every Config field :func:`make_task` and its samplers read: the
    frozen eval suite's cache key (``train/evaluate.py``), the same fields
    as the JAX package's."""
    return (cfg.conditioning, cfg.horizon, cfg.image_size, cfg.env,
            cfg.rollout_mode)


def make_task(cfg: Config) -> Task:
    """The task sampler for a config."""
    if cfg.rollout_mode != "waypoints":
        raise NotImplementedError(
            f"rollout_mode={cfg.rollout_mode!r} training data is not ported "
            "yet (only 'waypoints')")
    if cfg.conditioning == "none":
        return Task("pointmass2d", "none",
                    functools.partial(_sample_pointmass2d,
                                      horizon=cfg.horizon))
    if cfg.conditioning == "startgoal":
        return Task("goalcond", "startgoal",
                    functools.partial(_sample_goalcond, horizon=cfg.horizon))
    if cfg.conditioning == "image":
        return Task("imagecond", "image",
                    functools.partial(_sample_imagecond, horizon=cfg.horizon,
                                      image_size=cfg.image_size))
    raise ValueError(f"unknown conditioning {cfg.conditioning!r}")
