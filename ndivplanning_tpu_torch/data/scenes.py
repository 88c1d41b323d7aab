"""Random scenes and their occupancy images; counterpart of ``ndivplanning_tpu/data/scenes.py``.

Scenes are drawn on the device from a ``torch.Generator``, with the batch
axis written out instead of ``vmap``.  The rasteriser draws the live
obstacle discs plus Gaussian start/goal blobs into ``[..., S, S, 3]``
images (NHWC, as the JAX package lays them out): the conv encoder's input
for the image-conditioned presets.
"""

from __future__ import annotations

import torch

from ndivplanning_tpu_torch.envs.types import MAX_OBSTACLES, Scene

IMAGE_CHANNELS = 3  # occupancy, start blob, goal blob


def _uniform(gen: torch.Generator, shape, lo: float, hi: float):
    return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                       device=gen.device)


def random_scene_batch(gen: torch.Generator, batch: int, n_obstacles: int = 3,
                       min_radius: float = 0.06,
                       max_radius: float = 0.14) -> Scene:
    """``batch`` random scenes: start in the lower-left corner, goal in the
    upper-right, and ``n_obstacles`` live discs of the ``MAX_OBSTACLES``
    buffer in the central band, so straight paths usually collide."""
    start = _uniform(gen, (batch, 2), 0.05, 0.25)
    goal = _uniform(gen, (batch, 2), 0.75, 0.95)
    centers = _uniform(gen, (batch, MAX_OBSTACLES, 2), 0.3, 0.7)
    radii = _uniform(gen, (batch, MAX_OBSTACLES, 1), min_radius, max_radius)
    live = torch.arange(MAX_OBSTACLES, device=gen.device) < n_obstacles
    return Scene(start=start, goal=goal,
                 obstacles=torch.cat([centers, radii], dim=-1),
                 obstacle_mask=live.float().expand(batch, MAX_OBSTACLES)
                 .contiguous())


def random_scene(gen: torch.Generator, **kw) -> Scene:
    """One random scene (see :func:`random_scene_batch`)."""
    s = random_scene_batch(gen, 1, **kw)
    return Scene(start=s.start[0], goal=s.goal[0], obstacles=s.obstacles[0],
                 obstacle_mask=s.obstacle_mask[0])


def rasterize_batch(scenes: Scene, size: int = 32) -> torch.Tensor:
    """Render scenes with any leading axes to ``[..., size, size, 3]``.

    Channels: 0 = obstacle occupancy (1 inside any live disc), 1 = start
    blob, 2 = goal blob (Gaussians, sigma = 1.5 px).  Image row 0 is y=0
    (index [iy, ix] maps to world (x, y) = ((ix+.5)/S, (iy+.5)/S)).
    """
    coords = (torch.arange(size, dtype=torch.float32,
                           device=scenes.start.device) + 0.5) / size
    xs = coords[None, :, None]  # [1, S, 1]
    ys = coords[:, None, None]  # [S, 1, 1]
    obs = scenes.obstacles[..., None, None, :, :]  # [..., 1, 1, M, 3]
    d2 = (xs - obs[..., 0]) ** 2 + (ys - obs[..., 1]) ** 2  # [..., S, S, M]
    inside = ((d2 < obs[..., 2] * obs[..., 2])
              & (scenes.obstacle_mask[..., None, None, :] > 0.5))
    occupancy = torch.any(inside, dim=-1).float()
    sigma = 1.5 / size

    def blob(p):
        d2p = ((xs[..., 0] - p[..., 0, None, None]) ** 2
               + (ys[..., 0] - p[..., 1, None, None]) ** 2)
        return torch.exp(-d2p / (2.0 * sigma * sigma))

    return torch.stack([occupancy, blob(scenes.start), blob(scenes.goal)],
                       dim=-1)


def rasterize_scene(scene: Scene, size: int = 32) -> torch.Tensor:
    """Render one scene to a ``[size, size, 3]`` image."""
    return rasterize_batch(scene, size)
