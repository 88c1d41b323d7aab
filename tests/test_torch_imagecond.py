"""The image-conditioned slice of the torch port against the JAX package:
the expert sampler, one train step, the image-conditioned plan, and the
imagecond and planning presets end to end on the CPU.

As in ``test_torch_train_step.py``, both packages start from one converted
JAX state and see the same batch and latents (the JAX step's own draws,
reproduced here), since their random streams never agree.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.scenes import rasterize_scene as jax_rasterize
from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu.planning.planner import plan as jax_plan
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.train.step import train_step as jax_train_step
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.scenes import rasterize_scene
from ndivplanning_tpu_torch.data.tasks import (
    Batch,
    imagecond_batch,
    make_task,
)
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.ops import ndiv_cuda
from ndivplanning_tpu_torch.planning.planner import plan
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.train.step import (
    train_step_fused,
    train_step_impl,
)
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import (
    params_from_flax,
    train_state_from_flax,
)
from test_torch_train_step import (
    _assert_metrics_close,
    _assert_state_close,
    _jax_tree,
)

SMALL = dict(batch_size=8, k=4, horizon=8, image_size=16, g_hidden=(32, 32),
             d_hidden=(32, 32))
OBSTACLES = [[0.5, 0.5, 0.12], [0.3, 0.7, 0.08], [0.7, 0.3, 0.1]]
START, GOAL = [0.1, 0.1], [0.9, 0.9]


def _torch_scenes(jscenes) -> Scene:
    return Scene(**{name: torch.tensor(np.asarray(getattr(jscenes, name)))
                    for name in ("start", "goal", "obstacles",
                                 "obstacle_mask")})


def _torch_batch(jbatch) -> Batch:
    return Batch(conditions=torch.tensor(np.asarray(jbatch.conditions)),
                 real_traj=torch.tensor(np.asarray(jbatch.real_traj)),
                 scenes=_torch_scenes(jbatch.scenes))


def test_imagecond_expert_paths_match_jax():
    """The JAX sampler's own scenes, amplitudes and noise (its key splits,
    reproduced) through the port's batch builder: images and expert paths."""
    jcfg = jax_get_config("imagecond", horizon=32, image_size=16)
    key = jax.random.PRNGKey(7)
    jbatch = jax_make_task(jcfg).sample(key, 6)
    _, k_side, k_amp, k_noise = jax.random.split(key, 4)
    side = 2.0 * jax.random.bernoulli(k_side, 0.5, (6,)) - 1.0
    amp = side * jax.random.uniform(k_amp, (6,), minval=0.1, maxval=0.35)
    noise = jax.random.normal(k_noise, (6, 32, 2))
    got = imagecond_batch(_torch_scenes(jbatch.scenes),
                          torch.tensor(np.asarray(amp)),
                          torch.tensor(np.asarray(noise)), image_size=16)
    assert got.conditions.shape == (6, 16, 16, 3)
    np.testing.assert_allclose(got.conditions.numpy(),
                               np.asarray(jbatch.conditions), rtol=0.0,
                               atol=1e-6)
    np.testing.assert_allclose(got.real_traj.numpy(),
                               np.asarray(jbatch.real_traj), rtol=1e-6,
                               atol=1e-6)


def _one_step(cfg, jcfg, jstate, seed):
    jbatch = jax_make_task(jcfg).sample(jax.random.PRNGKey(seed),
                                        cfg.batch_size)
    z = jax.random.normal(jax.random.split(jstate.rng)[1],
                          (cfg.batch_size, cfg.k, cfg.latent_dim),
                          jnp.float32)
    return _torch_batch(jbatch), torch.tensor(np.asarray(z)), jbatch


def test_one_imagecond_step_matches_jax():
    jcfg = jax_get_config("imagecond", **SMALL)
    cfg = get_config("imagecond", **SMALL)
    jstate = jax_create(jcfg, seed=0)
    state = train_state_from_flax(cfg, _jax_tree(jstate), device="cpu")
    batch, z, jbatch = _one_step(cfg, jcfg, jstate, 100)
    jstate, jm = jax_train_step(jcfg, jstate, jbatch)
    state, m = train_step_impl(cfg, state, batch, z=z)
    jm = {k: float(v) for k, v in jm.items()}
    m = {k: float(v) for k, v in m.items()}
    assert set(m) == set(jm)
    _assert_metrics_close(m, jm, m.keys())
    assert m["g_ndiv"] > 0.0
    _assert_state_close(jstate, state, 1)


# (variant, JOINT): the four NDiv routes other than the default (block,
# joint), each through its autograd Function and the plain versions.
ROUTES = [("block", False), ("group", True), ("group", False),
          ("packed", True)]


@pytest.mark.parametrize("variant,joint", ROUTES)
def test_imagecond_step_agrees_under_every_ndiv_route(monkeypatch, variant,
                                                      joint):
    cfg = get_config("imagecond", ndiv_impl="pallas", **SMALL)
    state = create_train_state(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(4)
    batch = make_task(cfg).sample(gen, cfg.batch_size)
    z = torch.randn((cfg.batch_size, cfg.k, cfg.latent_dim), generator=gen)
    ref_state, ref = train_step_impl(cfg, copy.deepcopy(state), batch, z=z)
    monkeypatch.setattr(ndiv_cuda, "VARIANT", variant)
    monkeypatch.setattr(ndiv_cuda, "JOINT", joint)
    state, got = train_step_impl(cfg, state, batch, z=z)
    for key, value in ref.items():
        torch.testing.assert_close(got[key], value, rtol=1e-6, atol=0.0)
    for name, mu in ref_state.g_opt.mu.items():
        torch.testing.assert_close(state.g_opt.mu[name], mu, rtol=1e-4,
                                   atol=1e-5 * float(mu.abs().max()))


def test_image_conditioned_plan_matches_jax():
    """EMA generator, 64 candidates on a rasterised scene, the JAX plan's
    own latent draw."""
    overrides = dict(image_size=16, g_hidden=(32, 32), d_hidden=(32, 32))
    jcfg = jax_get_config("imagecond", **overrides)
    cfg = get_config("imagecond", **overrides)
    jstate = jax_create(jcfg, seed=5)
    state = create_train_state(cfg, device="cpu")
    state.g_ema.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jstate.g_ema_params)))
    jscene = JaxScene.create(jnp.asarray(START), jnp.asarray(GOAL),
                             jnp.asarray(OBSTACLES))
    scene = Scene.create(START, GOAL, OBSTACLES, device="cpu")
    image = rasterize_scene(scene, size=16)
    np.testing.assert_allclose(image.numpy(),
                               np.asarray(jax_rasterize(jscene, size=16)),
                               rtol=0.0, atol=1e-6)
    key = jax.random.PRNGKey(11)
    want = jax_plan(jcfg, jstate, jscene, jax_rasterize(jscene, size=16), key,
                    n_candidates=64)
    z = np.asarray(jax.random.normal(key, (1, 64, cfg.latent_dim)))
    got = plan(cfg, state, scene, image, n_candidates=64, z=torch.tensor(z))
    np.testing.assert_allclose(got.taus.numpy(), np.asarray(want.taus),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.diverse_idx.numpy(),
                                  np.asarray(want.diverse_idx))
    assert int(torch.argmin(got.scores)) == int(np.argmin(want.scores))


@pytest.mark.parametrize("preset", ["imagecond", "planning"])
def test_image_presets_train_and_plan_at_full_width_on_cpu(preset):
    cfg = get_config(preset)
    state = create_train_state(cfg, seed=0, device="cpu")
    before = [p.detach().clone() for p in state.g.parameters()]
    state, metrics = train_step_fused(cfg, state)
    assert state.step == 1
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert metrics["g_ndiv"] > 0.0
    assert not torch.equal(before[0], next(state.g.encoder.parameters()))
    scene = Scene.create(START, GOAL, OBSTACLES, device="cpu")
    result = plan(cfg, state, scene, rasterize_scene(scene, cfg.image_size),
                  torch.Generator().manual_seed(0))
    assert result.taus.shape == (cfg.n_candidates, cfg.horizon, 2)
    assert bool(torch.isfinite(result.scores).all())
    assert len(set(result.diverse_idx.tolist())) == 8
