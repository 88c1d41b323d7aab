"""The port's native host-data library (``native/ndiv_host.cc``) against the
JAX package's NumPy versions, the port's own and the rasterisers.

The ported behaviours of ``tests/test_native.py``, then what the port adds:
its library is built from the source into the package's ``_build/`` (never
JAX's ``native/libndivhost.so``), and a failed build raises.
"""

import os

import jax
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data import native as jax_native
from ndivplanning_tpu.data.scenes import random_scene_batch as jax_scenes
from ndivplanning_tpu_torch.data import native
from ndivplanning_tpu_torch.data.native import (
    collision_mask_host,
    collision_mask_numpy,
    native_available,
    rasterize_scenes_host,
    rasterize_scenes_numpy,
)
from ndivplanning_tpu_torch.data.scenes import rasterize_batch
from ndivplanning_tpu_torch.envs.types import Scene

# The library and the rasterisers compute exp() in different libraries.
RASTER_TOL = dict(rtol=1e-5, atol=1e-6)


def _scenes(n=6, seed=0):
    s = jax_scenes(jax.random.PRNGKey(seed), n)
    return (np.asarray(s.obstacles), np.asarray(s.obstacle_mask),
            np.asarray(s.start), np.asarray(s.goal))


def _jax_numpy(fn, *args, **kw):
    """A JAX-package function with its library switched off: its NumPy
    version."""
    lib, failed = jax_native._lib, jax_native._lib_failed
    jax_native._lib, jax_native._lib_failed = None, True
    try:
        return fn(*args, **kw)
    finally:
        jax_native._lib, jax_native._lib_failed = lib, failed


def test_native_builds_into_the_package():
    assert native_available()
    path = native.build()
    assert os.path.dirname(path) == native._BUILD_DIR
    assert os.path.basename(path).startswith("libndivhost_")
    assert native._SRC.endswith(os.path.join("native", "ndiv_host.cc"))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build()
    with pytest.raises(RuntimeError, match="error"):
        collision_mask_host(np.zeros((1, 2, 2)), np.zeros((1, 8, 3)),
                            np.zeros((1, 8)))
    assert not native_available()
    assert os.listdir(tmp_path / "build") == []  # no half-built library


@pytest.mark.parametrize("size", [16, 32])
def test_rasterize_matches_the_rasterisers_and_jax(size):
    obstacles, mask, starts, goals = _scenes()
    got = rasterize_scenes_host(obstacles, mask, starts, goals, size=size)
    scenes = Scene(*(torch.tensor(a) for a in (starts, goals, obstacles,
                                                   mask)))
    np.testing.assert_allclose(got, rasterize_batch(scenes, size).numpy(),
                               **RASTER_TOL)
    np.testing.assert_allclose(
        got, rasterize_scenes_numpy(obstacles, mask, starts, goals, size),
        **RASTER_TOL)
    np.testing.assert_allclose(
        got, _jax_numpy(jax_native.rasterize_scenes_host, obstacles, mask,
                        starts, goals, size=size), **RASTER_TOL)


def test_collision_mask():
    obstacles = np.zeros((2, 8, 3), np.float32)
    obstacles[:, 0] = [0.5, 0.5, 0.1]
    mask = np.zeros((2, 8), np.float32)
    mask[:, 0] = 1.0
    trajs = np.zeros((2, 4, 2), np.float32)
    trajs[0] = [[0.1, 0.1], [0.3, 0.3], [0.5, 0.5], [0.9, 0.9]]  # hits
    trajs[1] = [[0.1, 0.1], [0.1, 0.9], [0.9, 0.9], [0.9, 0.1]]  # misses
    np.testing.assert_array_equal(
        collision_mask_host(trajs, obstacles, mask), [1, 0])
    np.testing.assert_array_equal(
        collision_mask_numpy(trajs, obstacles, mask), [1, 0])


@pytest.mark.parametrize("seed", [3, 4])
def test_collision_mask_matches_jax_numpy_and_the_port_numpy(seed):
    rng = np.random.default_rng(seed)
    obstacles, mask, starts, goals = _scenes(32, seed)
    # start -> goal lines bent by a random sideways detour
    t = np.linspace(0.0, 1.0, 16, dtype=np.float32)[None, :, None]
    side = rng.uniform(-0.5, 0.5, size=(32, 1, 1)) * np.sin(np.pi * t)
    trajs = (starts[:, None] + t * (goals - starts)[:, None]
             + side * np.array([1.0, -1.0])).astype(np.float32)
    got = collision_mask_host(trajs, obstacles, mask)
    assert 0 < got.sum() < 32  # both outcomes occur
    np.testing.assert_array_equal(
        got, _jax_numpy(jax_native.collision_mask_host, trajs, obstacles,
                        mask))
    np.testing.assert_array_equal(got,
                                  collision_mask_numpy(trajs, obstacles, mask))


def test_mismatched_shapes_are_refused_before_the_library():
    obstacles, mask, starts, goals = _scenes(4)
    with pytest.raises(ValueError, match="obstacles has shape"):
        rasterize_scenes_host(obstacles[:3], mask, starts, goals)
    with pytest.raises(ValueError, match="trajs has shape"):
        collision_mask_host(np.zeros((4, 8, 3)), obstacles, mask)
    with pytest.raises(ValueError, match="obstacle_mask has shape"):
        collision_mask_host(np.zeros((4, 8, 2)), obstacles, mask[:3])


def test_multithreaded_matches_single():
    obstacles, mask, starts, goals = _scenes(16)
    a = rasterize_scenes_host(obstacles, mask, starts, goals, size=24,
                              n_threads=1)
    b = rasterize_scenes_host(obstacles, mask, starts, goals, size=24,
                              n_threads=8)
    np.testing.assert_array_equal(a, b)
    trajs = np.random.default_rng(0).uniform(size=(16, 8, 2))
    np.testing.assert_array_equal(
        collision_mask_host(trajs, obstacles, mask, n_threads=1),
        collision_mask_host(trajs, obstacles, mask, n_threads=8))
