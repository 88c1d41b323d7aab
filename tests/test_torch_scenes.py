"""The torch port's scene sampler and rasteriser against the JAX package.

Scenes are drawn with numpy and fed to both rasterisers: the images agree
to 1e-6 absolute (the blobs' ``exp`` may differ by an ulp; the occupancy
channel is 0 or 1 on both sides).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.scenes import rasterize_batch as jax_rasterize_batch
from ndivplanning_tpu.data.scenes import rasterize_scene as jax_rasterize_scene
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu_torch.data.scenes import (
    random_scene,
    random_scene_batch,
    rasterize_batch,
    rasterize_scene,
)
from ndivplanning_tpu_torch.envs.types import MAX_OBSTACLES, Scene

IMAGE_TOL = dict(rtol=0.0, atol=1e-6)


def shared_scenes(seed: int, batch: int):
    """(numpy fields, port Scene, JAX Scene) of ``batch`` random scenes,
    with live-obstacle counts 0..MAX_OBSTACLES and discs that reach past
    the image's edge."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    fields = dict(
        start=rng.uniform(0.0, 1.0, (batch, 2)).astype(f32),
        goal=rng.uniform(0.0, 1.0, (batch, 2)).astype(f32),
        obstacles=np.concatenate(
            [rng.uniform(-0.1, 1.1, (batch, MAX_OBSTACLES, 2)),
             rng.uniform(0.02, 0.3, (batch, MAX_OBSTACLES, 1))],
            axis=-1).astype(f32),
        obstacle_mask=(np.arange(MAX_OBSTACLES)[None, :]
                       < rng.integers(0, MAX_OBSTACLES + 1, (batch, 1))
                       ).astype(f32),
    )
    port = Scene(**{k: torch.from_numpy(v) for k, v in fields.items()})
    jax_scene = JaxScene(**{k: jnp.asarray(v) for k, v in fields.items()})
    return fields, port, jax_scene


@pytest.mark.parametrize("size", [16, 32])
def test_rasterize_batch_matches_jax(size):
    _, scenes, jscenes = shared_scenes(size, 8)
    got = rasterize_batch(scenes, size=size)
    want = np.asarray(jax_rasterize_batch(jscenes, size=size))
    assert got.shape == (8, size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, **IMAGE_TOL)
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    # The scenes cover empty images, full discs and blobs near the edge.
    assert 0.0 < float(got[..., 0].mean()) < 1.0


def test_rasterize_scene_matches_jax_and_puts_row_zero_at_y_zero():
    fields, _, _ = shared_scenes(3, 1)
    one = {k: v[0] for k, v in fields.items()}
    one["start"] = np.asarray([0.1, 0.9], np.float32)  # low x, high y
    got = rasterize_scene(
        Scene(**{k: torch.from_numpy(v) for k, v in one.items()}), size=32)
    want = jax_rasterize_scene(
        JaxScene(**{k: jnp.asarray(v) for k, v in one.items()}), size=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IMAGE_TOL)
    iy, ix = np.unravel_index(int(torch.argmax(got[..., 1])), (32, 32))
    assert (iy, ix) == (28, 3)  # (y, x) = (0.9, 0.1): a high row index


def test_random_scenes_follow_the_reference_layout():
    gen = torch.Generator().manual_seed(0)
    scenes = random_scene_batch(gen, 256)
    assert scenes.obstacles.shape == (256, MAX_OBSTACLES, 3)
    np.testing.assert_array_equal(scenes.obstacle_mask.sum(dim=1).numpy(),
                                  np.full(256, 3.0))
    for name, lo, hi in (("start", 0.05, 0.25), ("goal", 0.75, 0.95)):
        v = getattr(scenes, name)
        assert lo <= float(v.min()) and float(v.max()) <= hi, name
    centers, radii = scenes.obstacles[..., :2], scenes.obstacles[..., 2]
    assert 0.3 <= float(centers.min()) and float(centers.max()) <= 0.7
    assert 0.06 <= float(radii.min()) and float(radii.max()) <= 0.14
    one = random_scene(torch.Generator().manual_seed(1), n_obstacles=5)
    assert one.start.shape == (2,) and one.obstacles.shape == (8, 3)
    assert float(one.obstacle_mask.sum()) == 5.0
    assert rasterize_scene(one).shape == (32, 32, 3)
