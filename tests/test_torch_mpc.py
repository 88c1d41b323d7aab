"""Closed-loop MPC and scoring from a live state, the torch port against the JAX package, on the CPU.

``score_rollouts(state0=)`` starts every candidate from a scene's live
state; ``planning/mpc.py`` replans from it every ``replan_every`` steps.
JAX's threefry stream and torch's Philox never agree, so the tests replay
JAX's key schedule and inject the draws: per episode, each cycle splits
``key, k_plan = split(key)`` and draws ``normal(k_plan, (1, N, zdim))``.

Sizes: G/D 32x32, N = 16 candidates, 3 scenes, 16 steps, a replan every
4.  Tolerances: positions within 1e-5 (float32 G and rollouts in two
packages, as ``tests/test_torch_planner.py`` holds them), the latches
equal.  The quadrotor's attitude loop multiplies an ulp by ~100 a step
(``tests/test_torch_envs.py``), so its live-state scoring is held
pointwise over 12 steps and in aggregate over 32, and its closed loop is
left to the card's smoke, held in aggregate there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.envs.registry import get_env as jax_get_env
from ndivplanning_tpu.envs.rollout import ScoreWeights as JaxScoreWeights
from ndivplanning_tpu.envs.rollout import _rollout_scan as jax_rollout_scan
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu.planning import mpc as jax_mpc
from ndivplanning_tpu.planning.planner import score_rollouts as jax_score
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.envs.registry import FAMILIES, get_env
from ndivplanning_tpu_torch.envs.rollout import ScoreWeights
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning import mpc
from ndivplanning_tpu_torch.planning.planner import score_rollouts
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import params_from_flax
from test_torch_envs import (
    POS_ATOL,
    QUAD_PARITY_H,
    SCORE_RTOL,
    _both,
    _scenes,
    _waypoints,
)

N, STEPS, REPLAN, SCENES = 16, 16, 4, 3
MPC_ATOL = 1e-5
LIVE_TOL = dict(rtol=1e-5, atol=1e-5)
# Scenes whose start lies near a random G's waypoints (sigmoid outputs
# around the middle of the box) so that some episodes reach the goal, and
# obstacles on the way so that some collide: both latches are exercised.
MPC_SCENES = [([0.3, 0.3], [0.52, 0.5], None),
              ([0.2, 0.6], [0.5, 0.45], [[0.35, 0.52, 0.06]]),
              ([0.7, 0.2], [0.48, 0.55], [[0.6, 0.35, 0.05],
                                          [0.3, 0.8, 0.1]])]


def _cfgs(env, **overrides):
    kw = dict(g_hidden=(32, 32), d_hidden=(32, 32), env=env, **overrides)
    return jax_get_config("goalcond", **kw), get_config("goalcond", **kw)


def _models(jcfg, cfg, seed=5):
    """A random JAX state and the port's state with its EMA G."""
    jstate = jax_create(jcfg, seed=seed)
    state = create_train_state(cfg, device="cpu")
    state.g_ema.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jstate.g_ema_params)))
    return jstate, state


def _mpc_scenes():
    """(the port's stacked scenes, JAX's, conditions as numpy)."""
    scenes = [Scene.create(s, g, o, device="cpu") for s, g, o in MPC_SCENES]
    stacked = Scene.stack(scenes)
    jscenes = JaxScene(**{f.name: jnp.asarray(getattr(stacked, f.name).numpy())
                          for f in dataclasses.fields(stacked)})
    conds = np.concatenate([stacked.start.numpy(), stacked.goal.numpy()], 1)
    return stacked, jscenes, conds


def jax_cycle_latents(key, n_cycles, n, zdim):
    """``[n_cycles, n, zdim]``: the draws of JAX's MPC from one episode key."""
    out = []
    for _ in range(n_cycles):
        key, k_plan = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k_plan, (1, n, zdim)))[0])
    return np.stack(out)


def _live_states(env, jscenes, n_scenes, rng):
    """A live state of each scene (JAX): 5 steps of a noisy path from its
    reset.  Returns (JAX's states ``[S]``, the port's ``[S, 1]``)."""
    params = jax_get_env(env).make_params()
    lead = _waypoints(rng, np.asarray(jscenes.start), np.asarray(jscenes.goal),
                      1, 5)[:, 0]
    states = jax.vmap(lambda sc, t: jax_rollout_scan(
        params, sc, t, "waypoints", JaxScoreWeights(), env=env).final_state)(
            jscenes, jnp.asarray(lead))
    fields = {f.name: np.array(getattr(states, f.name))
              for f in dataclasses.fields(states)}
    fields["done"][0] = 1.0  # one scene's live state is already done
    states = states.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    port = get_env(env).reset(get_env(env).make_params(),
                              Scene.create([0.1, 0.1], [0.9, 0.9],
                                           device="cpu"), 1)
    port = type(port)(**{k: torch.from_numpy(v.copy())[:, None]
                         for k, v in fields.items()})
    return states, port


def _score_from(env, n_scenes, horizon, seed):
    rng = np.random.default_rng(seed)
    arrays = _scenes(rng, n_scenes)
    scenes, jscenes = _both(arrays)
    jstates, states = _live_states(env, jscenes, n_scenes, rng)
    taus = _waypoints(rng, arrays[0], arrays[1], 32, horizon)
    cfg = get_config("goalcond", env=env, horizon=horizon)
    jcfg = jax_get_config("goalcond", env=env, horizon=horizon)
    got = score_rollouts(cfg, scenes, torch.from_numpy(taus), ScoreWeights(),
                         state0=states)
    want = jax.vmap(lambda sc, t, s0: jax_score(
        jcfg, sc, t, JaxScoreWeights(), state0=s0))(
            jscenes, jnp.asarray(taus), jstates)
    return got, want, states, taus.shape


@pytest.mark.parametrize("env", FAMILIES)
def test_scoring_from_a_live_state_matches_jax(env):
    """4 scenes x 32 candidates from a live state (5 steps in, one scene's
    already done): positions, scores and goal distances within LIVE_TOL
    (measured: 8e-7 at most, the quadrotor's 12 steps 7e-6); control
    costs, sums of squared controller outputs whose gains scale an ulp
    (the quadrotor's by ~100), at tests/test_torch_envs.py's SCORE_RTOL;
    the latches and ``t`` equal; the done scene costs no control and stays
    where it was."""
    horizon = QUAD_PARITY_H if env == "quadrotor" else 32
    got, want, states, shape = _score_from(env, 4, horizon, 30)
    assert got.positions.shape == (*shape[:3], 2)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), **LIVE_TOL)
    for key in ("score", "goal_dist"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   **LIVE_TOL, err_msg=key)
    np.testing.assert_allclose(got.control_cost.numpy(),
                               np.asarray(want.control_cost),
                               rtol=SCORE_RTOL, atol=LIVE_TOL["atol"])
    for key in ("collided", "reached"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)))
    np.testing.assert_array_equal(got.final_state.t.numpy(),
                                  np.asarray(want.final_state.t))
    assert float(got.control_cost[0].abs().max()) == 0.0
    assert torch.equal(got.positions[0],
                       states.pos[0, :, None].expand_as(got.positions[0]))
    # Started 5 steps in: every live candidate's clock runs on from there.
    assert bool((got.final_state.t[1:] == states.t[1:] + horizon).any())


def test_quadrotor_scoring_from_a_live_state_agrees_in_aggregate():
    """32 steps from a live state: reach and collision counts within 2 of
    JAX's 128 candidates, the mean score within 1%, 80% of the paths
    within POS_ATOL (tests/test_torch_envs.py's aggregate rule)."""
    got, want, _, shape = _score_from("quadrotor", 4, 32, 31)
    for key in ("reached", "collided"):
        assert abs(float(getattr(got, key).sum())
                   - float(getattr(want, key).sum())) <= 2, key
    np.testing.assert_allclose(float(got.score.mean()),
                               float(want.score.mean()), rtol=1e-2)
    gap = np.abs(got.positions.numpy() - np.asarray(want.positions)).max(
        axis=(-1, -2))
    assert (gap <= POS_ATOL).sum() >= 0.8 * shape[0] * shape[1]


def _old_score_candidates(params, scene, taus, mode, weights, env):
    """The rollout as it stood before ``state0``: reset, then the loop."""
    api = get_env(env)
    n, horizon = taus.shape[-3:-1]
    state = api.reset(params, scene, n)
    positions, ctrl = [], []
    for t in range(horizon):
        tau_t = taus[..., t, :]
        a = tau_t if mode == "actions" else api.waypoint_control(
            params, state, tau_t)
        ctrl.append(torch.sum(a * a, dim=-1) * (1.0 - state.done))
        state, _ = api.step(params, scene, state, a)
        positions.append(state.pos)
    goal_dist = torch.sqrt(torch.sum(
        torch.square(state.pos - scene.goal[..., None, :]), dim=-1))
    control_cost = torch.sum(torch.stack(ctrl, dim=-1), dim=-1)
    score = (weights.goal * goal_dist + weights.collision * state.collided
             + weights.control * control_cost)
    return torch.stack(positions, dim=-2), score, state


@pytest.mark.parametrize("env", FAMILIES)
def test_scoring_without_state0_is_the_reset_path_bitwise(env):
    rng = np.random.default_rng(32)
    arrays = _scenes(rng, 3)
    scenes, _ = _both(arrays)
    taus = torch.from_numpy(_waypoints(rng, arrays[0], arrays[1], 24, 32))
    cfg = get_config("goalcond", env=env)
    got = score_rollouts(cfg, scenes, taus, ScoreWeights())
    positions, score, state = _old_score_candidates(
        get_env(env).make_params(), scenes, taus, "waypoints",
        ScoreWeights(), env)
    assert torch.equal(got.positions, positions)
    assert torch.equal(got.score, score)
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(got.final_state, f.name),
                           getattr(state, f.name)), f.name


def test_state0_is_copied_not_aliased():
    """Every candidate gets its own copy of the live state: the caller's
    state is unchanged and the broadcast fields are contiguous."""
    cfg = get_config("goalcond", env="unicycle")
    api = get_env("unicycle")
    scenes = Scene.stack([Scene.create([0.2, 0.2], [0.8, 0.8],
                                       device="cpu")] * 2)
    live = api.reset(api.make_params(), scenes, 1)
    before = {f.name: getattr(live, f.name).clone()
              for f in dataclasses.fields(live)}
    taus = torch.rand((2, 8, 6, 2), generator=torch.Generator().manual_seed(0))
    out = score_rollouts(cfg, scenes, taus, ScoreWeights(), state0=live)
    for name, value in before.items():
        assert torch.equal(getattr(live, name), value), name
    assert out.final_state.pos.shape == (2, 8, 2)
    with pytest.raises(ValueError, match="one candidate"):
        score_rollouts(cfg, scenes, taus, ScoreWeights(),
                       state0=api.reset(api.make_params(), scenes, 8))


@pytest.mark.parametrize("env", ["pointmass", "unicycle", "reacher"])
def test_mpc_rollout_batch_matches_jax(env):
    """3 episodes of 16 steps, a replan every 4 from 16 candidates, JAX's
    latents injected: the same picks (the executed paths within MPC_ATOL
    of JAX's), the same reached and collided flags and replans."""
    jcfg, cfg = _cfgs(env)
    jstate, state = _models(jcfg, cfg)
    scenes, jscenes, conds = _mpc_scenes()
    keys = jax.random.split(jax.random.PRNGKey(9), SCENES)
    want = jax_mpc.mpc_rollout_batch(jcfg, jstate, jscenes,
                                     jnp.asarray(conds), keys,
                                     total_steps=STEPS, replan_every=REPLAN,
                                     n_candidates=N)
    z = np.stack([jax_cycle_latents(k, STEPS // REPLAN, N, cfg.latent_dim)
                  for k in keys])
    got = mpc.mpc_rollout_batch(cfg, state, scenes, torch.from_numpy(conds),
                                total_steps=STEPS, replan_every=REPLAN,
                                n_candidates=N, z=torch.from_numpy(z))
    assert got.positions.shape == (SCENES, STEPS, 2)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), atol=MPC_ATOL)
    np.testing.assert_array_equal(got.reached.numpy(),
                                  np.asarray(want.reached))
    np.testing.assert_array_equal(got.collided.numpy(),
                                  np.asarray(want.collided))
    np.testing.assert_array_equal(got.final_state.t[:, 0].numpy(),
                                  np.asarray(want.final_state.t))
    assert got.n_replans == want.n_replans == STEPS // REPLAN
    # Not a vacuous comparison: some episodes reach, some collide.
    assert 0 < float(got.reached.sum()) and 0 < float(got.collided.sum())


@pytest.mark.parametrize("env", ["pointmass", "unicycle", "reacher"])
def test_mpc_rollout_with_a_short_last_cycle_matches_jax(env):
    """The host loop of one scene over 14 steps with a replan every 4: the
    last cycle executes 2 steps; JAX's ``mpc_rollout`` with its latents."""
    jcfg, cfg = _cfgs(env)
    jstate, state = _models(jcfg, cfg, seed=6)
    scenes, jscenes, conds = _mpc_scenes()
    jscene = jax.tree.map(lambda a: a[1], jscenes)
    key = jax.random.PRNGKey(4)
    want = jax_mpc.mpc_rollout(jcfg, jstate, jscene, jnp.asarray(conds[1]),
                               key, total_steps=14, replan_every=REPLAN,
                               n_candidates=N)
    z = jax_cycle_latents(key, 4, N, cfg.latent_dim)
    got = mpc.mpc_rollout(cfg, state, scenes.map(lambda t: t[1]),
                          torch.from_numpy(conds[1]), total_steps=14,
                          replan_every=REPLAN, n_candidates=N,
                          z=torch.from_numpy(z))
    assert got.positions.shape == (14, 2) and got.n_replans == 4
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), atol=MPC_ATOL)
    assert float(got.reached) == float(want.reached)
    assert float(got.collided) == float(want.collided)


def test_fused_mpc_rejects_a_ragged_episode_as_jax_does():
    jcfg, cfg = _cfgs("pointmass")
    jstate, state = _models(jcfg, cfg)
    scenes, jscenes, conds = _mpc_scenes()
    scene = scenes.map(lambda t: t[0])
    with pytest.raises(ValueError, match="14 % 4") as want:
        jax_mpc.mpc_rollout_fused(jcfg, jstate,
                                  jax.tree.map(lambda a: a[0], jscenes),
                                  jnp.asarray(conds[0]),
                                  jax.random.PRNGKey(0), total_steps=14,
                                  replan_every=REPLAN, n_candidates=N)
    with pytest.raises(ValueError) as got:
        mpc.mpc_rollout_fused(cfg, state, scene, torch.from_numpy(conds[0]),
                              torch.Generator().manual_seed(0),
                              total_steps=14, replan_every=REPLAN,
                              n_candidates=N)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="14 % 4"):
        mpc.mpc_rollout_batch(cfg, state, scenes, torch.from_numpy(conds),
                              total_steps=14, replan_every=REPLAN)
    fused = mpc.mpc_rollout_fused(cfg, state, scene,
                                  torch.from_numpy(conds[0]),
                                  torch.Generator().manual_seed(1),
                                  total_steps=8, replan_every=REPLAN,
                                  n_candidates=N)
    loop = mpc.mpc_rollout(cfg, state, scene, torch.from_numpy(conds[0]),
                           torch.Generator().manual_seed(1), total_steps=8,
                           replan_every=REPLAN, n_candidates=N)
    assert torch.equal(fused.positions, loop.positions)


def test_mpc_draws_each_cycle_from_the_generator():
    """Without ``z``, cycle c draws ``[B, N, zdim]`` from the generator in
    order: the same seed gives the same episodes, and injecting those
    draws gives them bitwise."""
    _, cfg = _cfgs("pointmass")
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    conds = torch.from_numpy(conds)
    run = lambda seed: mpc.mpc_rollout_batch(
        cfg, state, scenes, conds, torch.Generator().manual_seed(seed),
        total_steps=8, replan_every=REPLAN, n_candidates=N)
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a.positions, b.positions)
    assert not torch.equal(a.positions, c.positions)
    gen = torch.Generator().manual_seed(3)
    z = torch.stack([torch.randn((SCENES, N, cfg.latent_dim), generator=gen)
                     for _ in range(2)], dim=1)
    injected = mpc.mpc_rollout_batch(cfg, state, scenes, conds,
                                     total_steps=8, replan_every=REPLAN,
                                     n_candidates=N, z=z)
    assert torch.equal(injected.positions, a.positions)


def test_nan_candidates_never_execute():
    """A G whose candidates are all NaN but one per scene: the argmin over
    the +inf-sanitised scores executes the finite one."""
    _, cfg = _cfgs("pointmass")
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    inner = state.g_ema.forward

    def poisoned(c, z):
        taus = inner(c, z).clone()
        taus[:, 1:] = float("nan")
        return taus

    state.g_ema.forward = poisoned
    out = mpc.mpc_rollout_batch(cfg, state, scenes, torch.from_numpy(conds),
                                torch.Generator().manual_seed(0),
                                total_steps=8, replan_every=REPLAN,
                                n_candidates=N)
    assert torch.isfinite(out.positions).all()
