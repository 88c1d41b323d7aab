"""The vendored planning model through the torch port, on the CPU.

``checkpoints/planning512`` (the deployable image-conditioned planning
model) is restored by the JAX package's own checkpoint code, its EMA
generator carried across by ``utils/convert.py``, and then G's outputs and
a 64-candidate plan are held against the JAX package's.  This checks the
converter on trained conv weights, and that the port builds the models of
a config whose LR schedule (cosine) it cannot train with yet.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.scenes import rasterize_batch as jax_rasterize
from ndivplanning_tpu.data.scenes import rasterize_scene as jax_rasterize_one
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu.planning.planner import plan as jax_plan
from ndivplanning_tpu.train.state import build_models as jax_build_models
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils import checkpoint as ckpt
from ndivplanning_tpu.utils.config import load_config
from ndivplanning_tpu_torch.data.scenes import (
    rasterize_batch,
    rasterize_scene,
)
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.planner import plan
from ndivplanning_tpu_torch.train.state import TrainState, build_models
from ndivplanning_tpu_torch.utils.config import Config
from ndivplanning_tpu_torch.utils.convert import params_from_flax
from test_torch_scenes import shared_scenes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(REPO, "checkpoints", "planning512")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(WORKDIR), reason="vendored checkpoint not present")


@pytest.fixture(scope="module")
def planning512():
    """(JAX config, restored JAX state, the port's config and EMA G)."""
    jcfg = load_config(WORKDIR)
    best = ckpt.restore_latest(os.path.join(WORKDIR, "best"), jax_create(jcfg))
    assert best is not None and int(best.step) == 55000
    cfg = Config().replace(**dataclasses.asdict(jcfg))
    assert cfg.lr_schedule == "cosine" and cfg.conditioning == "image"
    g, d = build_models(cfg)
    g.load_state_dict(params_from_flax(jax.tree.map(np.asarray,
                                                    best.g_ema_params)))
    # Planning reads only the EMA generator; the optimizers of a cosine
    # schedule are not ported, so the state carries none.
    state = TrainState(step=int(best.step), rng=torch.Generator(), g=g, d=d,
                       g_opt=None, d_opt=None, g_ema=g, ada={})
    return jcfg, best, cfg, state


def test_vendored_generator_matches_jax_on_rasterised_scenes(planning512):
    jcfg, best, cfg, state = planning512
    _, scenes, jscenes = shared_scenes(512, 8)
    images = rasterize_batch(scenes, size=cfg.image_size)
    jimages = jax_rasterize(jscenes, size=cfg.image_size)
    z = np.random.default_rng(8).normal(size=(8, 8, 2)).astype(np.float32)
    jg, _ = jax_build_models(jcfg)
    want = np.asarray(jg.apply(best.g_ema_params, jimages, jnp.asarray(z)))
    with torch.no_grad():
        got = state.g_ema(images, torch.from_numpy(z))
    assert got.shape == (8, 8, 32, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # A trained generator: the 8 latents of a scene give distinct paths.
    assert float(got.std(dim=1).mean()) > 1e-3


def test_vendored_model_plans_as_jax(planning512):
    jcfg, best, cfg, state = planning512
    obstacles = [[0.5, 0.5, 0.12], [0.35, 0.65, 0.08], [0.65, 0.35, 0.1]]
    jscene = JaxScene.create(jnp.asarray([0.1, 0.1]), jnp.asarray([0.9, 0.9]),
                             jnp.asarray(obstacles))
    scene = Scene.create([0.1, 0.1], [0.9, 0.9], obstacles, device="cpu")
    key = jax.random.PRNGKey(3)
    jimage = jax_rasterize_one(jscene, size=cfg.image_size)
    image = rasterize_scene(scene, size=cfg.image_size)
    want = jax_plan(jcfg, best, jscene, jimage, key, n_candidates=64)
    z = np.asarray(jax.random.normal(key, (1, 64, cfg.latent_dim)))
    got = plan(cfg, state, scene, image, n_candidates=64, z=torch.tensor(z))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.diverse_idx.numpy(),
                                  np.asarray(want.diverse_idx))
    assert int(torch.argmin(got.scores)) == int(np.argmin(want.scores))
    assert float(got.best_reached) == float(want.best_reached) == 1.0
