"""The torch port's env, rollout scoring and planner against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.envs.rollout import ScoreWeights as JaxScoreWeights
from ndivplanning_tpu.envs.rollout import score_candidates as jax_score
from ndivplanning_tpu.envs.types import EnvParams as JaxEnvParams
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu.planning.planner import _diverse_top_m as jax_diverse
from ndivplanning_tpu.planning.planner import plan as jax_plan
from ndivplanning_tpu.planning.planner import plan_batch as jax_plan_batch
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.rollout import ScoreWeights, score_candidates
from ndivplanning_tpu_torch.envs.types import MAX_OBSTACLES, EnvParams, Scene
from ndivplanning_tpu_torch.data.scenes import rasterize_batch
from ndivplanning_tpu_torch.planning.planner import (
    _diverse_top_m,
    plan,
    plan_batch,
)
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import params_from_flax

OBSTACLES = [[0.5, 0.5, 0.12], [0.3, 0.7, 0.08], [0.7, 0.3, 0.1]]
START, GOAL = [0.1, 0.1], [0.9, 0.9]
# plan_batch against JAX's on the vendored model: every score within
# rtol/atol 1e-4 (float32 G and rollout, two packages), best and diverse
# picks equal.
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
# Four scenes of one batch: a start or goal off the corners, 0-3 obstacles.
BATCH_SCENES = [
    ([0.1, 0.1], [0.9, 0.9], OBSTACLES),
    ([0.2, 0.05], [0.85, 0.9], OBSTACLES[:1]),
    ([0.05, 0.3], [0.9, 0.6], None),
    ([0.15, 0.2], [0.8, 0.95], OBSTACLES[1:]),
]


def _scenes():
    return (JaxScene.create(jnp.asarray(START), jnp.asarray(GOAL),
                            jnp.asarray(OBSTACLES)),
            Scene.create(START, GOAL, OBSTACLES, device="cpu"))


@pytest.mark.parametrize("mode", ["waypoints", "actions"])
def test_rollout_scores_and_latches_match_jax(mode):
    rng = np.random.default_rng(3)
    if mode == "waypoints":  # straight-ish paths through the obstacles
        t = np.linspace(0.0, 1.0, 32, dtype=np.float32)[None, :, None]
        taus = (np.asarray(START) + t * (np.asarray(GOAL) - np.asarray(START))
                + 0.15 * rng.normal(size=(256, 1, 2)) * np.sin(np.pi * t))
    else:  # accelerations, some past max_accel to exercise the clip
        taus = 3.0 * rng.normal(size=(256, 32, 2))
    taus = taus.astype(np.float32)
    jscene, scene = _scenes()
    want = jax_score(JaxEnvParams.create(), jscene, jnp.asarray(taus),
                     mode=mode, weights=JaxScoreWeights())
    got = score_candidates(EnvParams.create(), scene, torch.from_numpy(taus),
                           mode=mode, weights=ScoreWeights())
    np.testing.assert_array_equal(got.collided.numpy(),
                                  np.asarray(want.collided))
    np.testing.assert_array_equal(got.reached.numpy(), np.asarray(want.reached))
    np.testing.assert_array_equal(got.final_state.t.numpy(),
                                  np.asarray(want.final_state.t))
    # Every latch state occurs, so the comparison exercises each branch.
    assert 0 < float(got.collided.mean()) < 1
    if mode == "waypoints":
        assert 0 < float(got.reached.mean()) < 1
    for key in ("score", "goal_dist", "control_cost", "positions"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_scene_create_validates_like_jax():
    scene = Scene.create(START, GOAL, OBSTACLES[:1], device="cpu")
    assert scene.obstacles.shape == (MAX_OBSTACLES, 3)
    assert scene.obstacle_mask.tolist() == [1.0] + [0.0] * (MAX_OBSTACLES - 1)
    with pytest.raises(ValueError):
        Scene.create([0.1, 0.1, 0.1], GOAL, device="cpu")
    with pytest.raises(ValueError):
        Scene.create(START, GOAL, [[0.5, 0.5, 0.1]] * (MAX_OBSTACLES + 1),
                     device="cpu")


@pytest.mark.parametrize("env", ["unicycle", "reacher", "arm3"])
def test_plan_matches_jax_in_the_other_families(env):
    """The goalcond EMA generator's 64 candidates planned in another env
    family with the JAX plan's own latents: scores at the families'
    rollout tolerance (tests/test_torch_envs.py: the arms' DLS gains scale
    an ulp of their 2x2 solve), the same best and diverse picks.  The
    quadrotor's 32-step rollouts agree only in aggregate (its attitude
    loop magnifies ulps), so it is held there and in its frozen suite."""
    overrides = dict(horizon=32, g_hidden=(32, 32), d_hidden=(32, 32),
                     env=env)
    jcfg = jax_get_config("goalcond", **overrides)
    cfg = get_config("goalcond", **overrides)
    jstate = jax_create(jcfg, seed=4)
    state = create_train_state(cfg, device="cpu")
    state.g_ema.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jstate.g_ema_params)))
    jscene, scene = _scenes()
    condition = np.asarray(START + GOAL, np.float32)
    key = jax.random.PRNGKey(12)
    want = jax_plan(jcfg, jstate, jscene, jnp.asarray(condition), key,
                    n_candidates=64)
    z = np.asarray(jax.random.normal(key, (1, 64, cfg.latent_dim)))
    got = plan(cfg, state, scene, torch.from_numpy(condition),
               n_candidates=64, z=torch.tensor(z))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=5e-5, atol=1e-4)
    assert int(torch.argmin(got.scores)) == int(np.argmin(want.scores))
    assert float(got.best_reached) == float(want.best_reached)
    np.testing.assert_array_equal(got.diverse_idx.numpy(),
                                  np.asarray(want.diverse_idx))


@pytest.mark.parametrize("env", ["unicycle", "reacher", "quadrotor", "arm3"])
def test_stacked_scenes_roll_out_as_each_scene_alone_in_every_family(env):
    """The families' states and the arms' shared base broadcast over a
    leading scene axis: every row of a stacked 12-step rollout is the
    one-scene rollout, its latches equal and the rest within 1e-5.  Not
    bitwise on the CPU: torch's CPU kernels take SLEEF's vectorised sin,
    cos and atan2 on full vector blocks and the scalar libm ones on a
    shorter tensor, an ulp apart."""
    rng = np.random.default_rng(6)
    t = np.linspace(0.0, 1.0, 12, dtype=np.float32)[None, None, :, None]
    taus = (0.1 + 0.8 * t + 0.2 * rng.normal(size=(4, 16, 1, 2))
            * np.sin(np.pi * t)).astype(np.float32)
    params = get_env(env).make_params()
    got = score_candidates(params, _stacked(BATCH_SCENES),
                           torch.from_numpy(taus), env=env)
    for i, (st, go, ob) in enumerate(BATCH_SCENES):
        one = score_candidates(params, Scene.create(st, go, ob, device="cpu"),
                               torch.from_numpy(taus[i]), env=env)
        for key in ("collided", "reached"):
            assert torch.equal(getattr(got, key)[i], getattr(one, key)), key
        for key in ("score", "positions"):
            torch.testing.assert_close(getattr(got, key)[i],
                                       getattr(one, key), rtol=1e-5,
                                       atol=1e-5)


def test_diverse_top_m_matches_jax_with_ties_and_nan_safe_scores():
    rng = np.random.default_rng(9)
    flat = rng.normal(size=(40, 6)).astype(np.float32)
    scores = rng.uniform(size=40).astype(np.float32)
    # Tied best scores: the stable sort keeps index order, so the first
    # pick is index 3.
    scores[[3, 5, 7, 11]] = -1.0
    scores[[0, 13]] = np.inf  # non-finite scores, as plan() maps them
    for m in (1, 4, 8, 30):
        np.testing.assert_array_equal(
            _diverse_top_m(torch.from_numpy(flat), torch.from_numpy(scores),
                           m).numpy(),
            np.asarray(jax_diverse(jnp.asarray(flat), jnp.asarray(scores), m)))


def test_plan_matches_jax_with_injected_latents():
    """goalcond EMA generator, 64 candidates, the JAX plan's own latent draw."""
    overrides = dict(horizon=32, g_hidden=(32, 32), d_hidden=(32, 32))
    jcfg = jax_get_config("goalcond", **overrides)
    cfg = get_config("goalcond", **overrides)
    jstate = jax_create(jcfg, seed=4)
    state = create_train_state(cfg, device="cpu")
    state.g_ema.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jstate.g_ema_params)))
    jscene, scene = _scenes()
    condition = np.asarray(START + GOAL, np.float32)
    key = jax.random.PRNGKey(11)
    want = jax_plan(jcfg, jstate, jscene, jnp.asarray(condition), key,
                    n_candidates=64)
    z = np.asarray(jax.random.normal(key, (1, 64, cfg.latent_dim)))
    got = plan(cfg, state, scene, torch.from_numpy(condition),
               n_candidates=64, z=torch.tensor(z))
    np.testing.assert_allclose(got.taus.numpy(), np.asarray(want.taus),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
    assert int(torch.argmin(got.scores)) == int(np.argmin(want.scores))
    np.testing.assert_allclose(float(got.best_score), float(want.best_score),
                               rtol=1e-5)
    assert float(got.best_reached) == float(want.best_reached)
    np.testing.assert_array_equal(got.diverse_idx.numpy(),
                                  np.asarray(want.diverse_idx))
    np.testing.assert_allclose(got.diverse_trajs.numpy(),
                               np.asarray(want.diverse_trajs), rtol=1e-5,
                               atol=1e-6)


def test_plan_draws_its_own_latents_from_a_generator():
    cfg = get_config("goalcond", horizon=8, g_hidden=(16,), d_hidden=(16,))
    state = create_train_state(cfg, device="cpu")
    scene = Scene.create(START, GOAL, device="cpu")
    cond = torch.tensor(START + GOAL)
    a = plan(cfg, state, scene, cond, torch.Generator().manual_seed(0),
             n_candidates=32)
    b = plan(cfg, state, scene, cond, torch.Generator().manual_seed(0),
             n_candidates=32)
    assert a.taus.shape == (32, 8, 2) and a.diverse_idx.shape == (8,)
    assert len(set(a.diverse_idx.tolist())) == 8
    np.testing.assert_array_equal(a.scores.numpy(), b.scores.numpy())


def _stacked(scenes):
    return Scene.stack([Scene.create(st, go, ob, device="cpu")
                        for st, go, ob in scenes])


def test_stacked_scenes_roll_out_as_each_scene_alone_bitwise():
    """Positions [B, N, 2] against obstacles [B, 1, M, 3]: every row of a
    stacked rollout is bitwise the one-scene rollout."""
    rng = np.random.default_rng(5)
    t = np.linspace(0.0, 1.0, 32, dtype=np.float32)[None, None, :, None]
    taus = (0.1 + 0.8 * t + 0.2 * rng.normal(size=(4, 64, 1, 2))
            * np.sin(np.pi * t)).astype(np.float32)
    scenes = _stacked(BATCH_SCENES)
    got = score_candidates(EnvParams.create(), scenes, torch.from_numpy(taus))
    assert got.positions.shape == (4, 64, 32, 2)
    for i, (st, go, ob) in enumerate(BATCH_SCENES):
        one = score_candidates(EnvParams.create(),
                               Scene.create(st, go, ob, device="cpu"),
                               torch.from_numpy(taus[i]))
        for key in ("score", "positions", "collided", "reached"):
            assert torch.equal(getattr(got, key)[i], getattr(one, key)), key
    assert 0 < float(got.collided.mean()) < 1


def test_batched_diverse_top_m_is_each_row_alone():
    rng = np.random.default_rng(2)
    flat = torch.from_numpy(rng.normal(size=(3, 40, 6)).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(size=(3, 40)).astype(np.float32))
    scores[1, [3, 5, 7]] = -1.0  # ties in one row only
    for m in (1, 4, 8):
        got = _diverse_top_m(flat, scores, m)
        assert got.shape == (3, m)
        for i in range(3):
            assert torch.equal(got[i], _diverse_top_m(flat[i], scores[i], m))


def _jax_batch_inputs(key, n_scenes, n, zdim):
    """JAX's per-scene keys, and the latents plan_batch draws from them."""
    keys = jax.random.split(key, n_scenes)
    z = np.stack([np.asarray(jax.random.normal(k, (1, n, zdim)))[0]
                  for k in keys])
    return keys, torch.from_numpy(z)


def test_plan_batch_matches_jax_on_planning512():
    from ndivplanning_tpu.data.scenes import rasterize_batch as jax_raster
    from test_torch_checkpoint import jax_planning512, torch_planning512

    jcfg, jstate = jax_planning512()
    cfg, state = torch_planning512()
    scenes = _stacked(BATCH_SCENES)
    jscenes = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        JaxScene.create(jnp.asarray(st), jnp.asarray(go),
                        None if ob is None else jnp.asarray(ob))
        for st, go, ob in BATCH_SCENES])
    keys, z = _jax_batch_inputs(jax.random.PRNGKey(21), 4, 64, cfg.latent_dim)
    want = jax_plan_batch(jcfg, jstate, jscenes,
                          jax_raster(jscenes, size=cfg.image_size), keys,
                          n_candidates=64, n_diverse=4)
    got = plan_batch(cfg, state, scenes,
                     rasterize_batch(scenes, cfg.image_size), n_candidates=64,
                     n_diverse=4, z=z)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **SCORE_TOL)
    np.testing.assert_array_equal(got.diverse_idx.numpy(),
                                  np.asarray(want.diverse_idx))
    np.testing.assert_array_equal(got.scores.argmin(dim=1).numpy(),
                                  np.asarray(want.scores).argmin(axis=1))
    np.testing.assert_array_equal(got.best_reached.numpy(),
                                  np.asarray(want.best_reached))
    np.testing.assert_allclose(got.best_traj.numpy(),
                               np.asarray(want.best_traj), rtol=1e-5,
                               atol=1e-5)
    assert len({tuple(r) for r in got.best_traj[:, 0].tolist()}) == 4


def test_plan_batch_row_matches_plan():
    """Row i of plan_batch against plan on scene i with its latents, at
    SCORE_TOL: G's GEMM over [B N] rows may sum in another order than over
    [N] rows (it does on the CPU already), so not bitwise."""
    cfg = get_config("planning", g_hidden=(32, 32), d_hidden=(16,),
                     cond_embed_dim=8, image_size=16)
    state = create_train_state(cfg, device="cpu")
    scenes = _stacked(BATCH_SCENES)
    images = rasterize_batch(scenes, cfg.image_size)
    z = torch.randn((4, 64, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(1))
    batch = plan_batch(cfg, state, scenes, images, n_candidates=64,
                       n_diverse=4, z=z)
    assert batch.taus.shape == (4, 64, 32, 2)
    assert batch.diverse_trajs.shape == (4, 4, 32, 2)
    for i, (st, go, ob) in enumerate(BATCH_SCENES):
        one = plan(cfg, state, Scene.create(st, go, ob, device="cpu"),
                   images[i], n_candidates=64, n_diverse=4, z=z[i:i + 1])
        np.testing.assert_allclose(batch.scores[i].numpy(),
                                   one.scores.numpy(), **SCORE_TOL)
        assert torch.equal(batch.diverse_idx[i], one.diverse_idx)
        assert int(batch.scores[i].argmin()) == int(one.scores.argmin())
        np.testing.assert_allclose(float(batch.best_score[i]),
                                   float(one.best_score), **SCORE_TOL)
