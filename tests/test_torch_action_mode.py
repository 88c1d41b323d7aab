"""Action-space training in the torch port (``rollout_mode="actions"``), against the JAX package on the CPU.

``envs/rollout.py::distill_actions`` records each family's waypoint
controller along expert paths; replayed in "actions" mode the actions give
the waypoint rollout bitwise.  ``data/tasks.py`` samples such actions as
the real data under action mode, and arm3 trains G at its action width 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.data.tasks import task_fingerprint as jax_fingerprint
from ndivplanning_tpu.envs.registry import get_env as jax_get_env
from ndivplanning_tpu.envs.rollout import distill_actions as jax_distill
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.tasks import make_task, task_fingerprint
from ndivplanning_tpu_torch.envs.registry import FAMILIES, get_env
from ndivplanning_tpu_torch.envs.rollout import (
    distill_actions,
    score_candidates,
)
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.utils.config import get_config
from test_torch_train_step import (
    SMALL,
    _assert_metrics_close,
    _assert_state_close,
    _run_both,
)

# Actions distilled by the two packages' controllers (float32; the arms'
# DLS gains scale an ulp of the solve by kv kacc = 60).  The quadrotor's
# attitude loop multiplies ulps by 100 a step (tests/test_torch_envs.py),
# so its distillation is held over its first 12 steps.
DISTILL_RTOL, DISTILL_ATOL = 1e-5, 1e-3
QUAD_STEPS = 12
ARM3_ACTIONS = dict(env="arm3", rollout_mode="actions", state_dim=3,
                    generator_output="linear")


def _paths(n, horizon, seed=0):
    """A scene with one obstacle and ``[n, H, 2]`` noisy straight paths
    across it (numpy)."""
    rng = np.random.default_rng(seed)
    start, goal = np.array([0.15, 0.2]), np.array([0.85, 0.8])
    t = np.linspace(0.1, 1.0, horizon)[:, None]
    line = (1 - t) * start + t * goal
    paths = line + 0.02 * rng.normal(size=(n, horizon, 2))
    return start, goal, [[0.5, 0.55, 0.1]], paths.astype(np.float32)


@pytest.mark.parametrize("env", FAMILIES)
def test_distilled_actions_replay_the_waypoint_rollout_bitwise(env):
    start, goal, obstacles, paths = _paths(16, 32)
    scene = Scene.create(start, goal, obstacles, device="cpu")
    params = get_env(env).make_params()
    waypoints = torch.from_numpy(paths)
    actions = distill_actions(params, scene, waypoints, env)
    assert actions.shape == (16, 32, 3 if env == "arm3" else 2)
    via_waypoints = score_candidates(params, scene, waypoints, "waypoints",
                                     env=env)
    via_actions = score_candidates(params, scene, actions, "actions",
                                   env=env)
    for key in ("positions", "score", "goal_dist", "collided", "reached",
                "control_cost"):
        assert torch.equal(getattr(via_waypoints, key),
                           getattr(via_actions, key)), key
    # Against JAX's distillation of the same paths.
    steps = QUAD_STEPS if env == "quadrotor" else 32
    jscene = JaxScene.create(start, goal, obstacles)
    want = jax.vmap(lambda w: jax_distill(jax_get_env(env).make_params(),
                                          jscene, w, env))(
        jnp.asarray(paths[:, :steps]))
    np.testing.assert_allclose(actions[:, :steps].numpy(), np.asarray(want),
                               rtol=DISTILL_RTOL, atol=DISTILL_ATOL)


def test_action_task_sampler_shapes_and_fingerprint():
    """The action sampler wraps the waypoint one: the same scenes and
    conditions, the real data the family's expert actions (the quadrotor's
    within its rotors' range), and the fingerprint tells the two apart."""
    cfg_w = get_config("goalcond", batch_size=8, k=4, env="quadrotor")
    cfg_a = cfg_w.replace(rollout_mode="actions")
    assert task_fingerprint(cfg_w) != task_fingerprint(cfg_a)
    b_w = make_task(cfg_w).sample(torch.Generator().manual_seed(0), 8)
    b_a = make_task(cfg_a).sample(torch.Generator().manual_seed(0), 8)
    assert make_task(cfg_a).name == "goalcond+actions"
    assert b_a.real_traj.shape == b_w.real_traj.shape
    assert torch.equal(b_a.conditions, b_w.conditions)
    assert float((b_a.real_traj - b_w.real_traj).abs().max()) > 0.05
    params = get_env("quadrotor").make_params()
    assert float(b_a.real_traj.min()) >= 0.0
    assert float(b_a.real_traj.max()) <= params.max_thrust
    # The real actions are the distillation of the waypoint batch's paths.
    want = distill_actions(params, b_w.scenes, b_w.real_traj[:, None],
                           "quadrotor")[:, 0]
    assert torch.equal(b_a.real_traj, want)


def test_arm3_action_sampler_needs_its_action_width():
    with pytest.raises(ValueError, match="action_dim == 3"):
        make_task(get_config("goalcond", env="arm3", rollout_mode="actions"))
    cfg = get_config("goalcond", batch_size=8, k=4, **ARM3_ACTIONS)
    batch = make_task(cfg).sample(torch.Generator().manual_seed(0), 8)
    assert batch.real_traj.shape == (8, cfg.horizon, 3)
    with pytest.raises(ValueError, match="unknown rollout_mode 'bogus'"):
        make_task(cfg.replace(rollout_mode="bogus"))


@pytest.mark.parametrize("env", ["unicycle", "arm3"])
def test_action_batches_distill_as_jax(env):
    """JAX's action batch is its waypoint batch of the same key, distilled:
    the port's distillation of that waypoint batch gives JAX's actions."""
    kw = dict(batch_size=8, k=4, env=env,
              state_dim=3 if env == "arm3" else 2)
    jcfg_w = jax_get_config("goalcond", **kw)
    jcfg_a = jax_get_config("goalcond", rollout_mode="actions", **kw)
    assert jax_fingerprint(jcfg_a) == task_fingerprint(
        get_config("goalcond", rollout_mode="actions", **kw))
    key = jax.random.PRNGKey(3)
    jw = jax_make_task(jcfg_w).sample(key, 8)
    ja = jax_make_task(jcfg_a).sample(key, 8)
    scenes = Scene.create_batch(torch.from_numpy(np.array(jw.scenes.start)),
                                torch.from_numpy(np.array(jw.scenes.goal)))
    got = distill_actions(get_env(env).make_params(), scenes,
                          torch.from_numpy(np.array(jw.real_traj))[:, None],
                          env)[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ja.real_traj),
                               rtol=DISTILL_RTOL, atol=DISTILL_ATOL)


def test_arm3_action_mode_step_matches_jax():
    """One train step on arm3 in action mode (G and D over [B, k, H, 3]
    action sequences, JAX's distilled batch) against JAX's, at the
    tolerances of tests/test_torch_train_step.py."""
    jm, m, jstate, state = _run_both(1, **SMALL, **ARM3_ACTIONS)
    assert set(m[0]) == set(jm[0])
    _assert_metrics_close(m[0], jm[0], m[0].keys())
    assert m[0]["g_ndiv"] > 0.0
    _assert_state_close(jstate, state, 1)
    assert state.g.generator.head.weight.shape[0] == SMALL["horizon"] * 3
