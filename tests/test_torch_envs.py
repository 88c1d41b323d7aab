"""The torch port's env families against the JAX package and the NumPy twin, on the CPU.

Every family (``envs/{pointmass,unicycle,reacher,quadrotor,arm3}.py``):
``reset``, ``step`` on open-loop action sequences (also against
``tests/python_env_twin.py``, at the JAX golden tests' tolerances),
``waypoint_control`` on random states, and ``score_candidates`` over
scenes and candidates, all on numpy-seeded inputs.

The two packages round ``sin``, ``cos``, ``atan2`` and ``acos`` apart by
an ulp or so, and XLA solves the arms' 2x2 systems by LU where the port
uses the adjugate, so float32 results agree to tolerances, not bitwise.
Latches (``done``, ``collided``) are discontinuous, so the parity inputs
keep away from their thresholds, and a separate test puts candidates on a
threshold and accepts either side.  The quadrotor's attitude loop
multiplies a heading error by kth / arm / 2 = 100 each step until its
rotors clip, so over 32 steps one ulp grows past any tolerance for some
candidates (the JAX package's own rollouts move by more than 1e-4 in ~5%
of candidates when an input moves by one ulp): its pointwise parity runs
over 12 steps, and the full horizon is held in aggregate.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.envs import arm3 as jax_arm3
from ndivplanning_tpu.envs import reacher as jax_reacher
from ndivplanning_tpu.envs.registry import action_dim as jax_action_dim
from ndivplanning_tpu.envs.registry import get_env as jax_get_env
from ndivplanning_tpu.envs.rollout import score_candidates as jax_score
from ndivplanning_tpu.envs.types import Scene as JaxScene
from ndivplanning_tpu_torch.envs import arm3, reacher
from ndivplanning_tpu_torch.envs.registry import FAMILIES, action_dim, get_env
from ndivplanning_tpu_torch.envs.rollout import score_candidates
from ndivplanning_tpu_torch.envs.types import Scene
from tests.python_env_twin import (
    PyArm3Env,
    PyPointMassEnv,
    PyQuadrotorEnv,
    PyReacherEnv,
    PyUnicycleEnv,
)

TWINS = {"pointmass": PyPointMassEnv, "unicycle": PyUnicycleEnv,
         "reacher": PyReacherEnv, "quadrotor": PyQuadrotorEnv,
         "arm3": PyArm3Env}
# Open-loop actions as the JAX golden tests draw them (tests/test_*.py):
# (scale, offset) of the normal draw; thrusts around hover.
ACTION_DRAW = {"pointmass": (2.0, 0.0), "unicycle": (2.0, 0.0),
               "reacher": (20.0, 0.0), "quadrotor": (0.5, 0.25),
               "arm3": (20.0, 0.0)}
# Port against the twin: the JAX golden tests' own tolerances (the arms
# chain sin/cos through unwrapped angles).
TWIN_ATOL = {"pointmass": 2e-5, "unicycle": 2e-5, "reacher": 5e-5,
             "quadrotor": 2e-5, "arm3": 5e-5}
TWIN_RTOL = 1e-5
# Port against JAX, positions over a rollout (measured: 2e-7 particles,
# 4e-5 arms and the quadrotor's 12 steps).
POS_ATOL = 1e-4
# Scores and control costs: sums of squared controller outputs, whose
# ulp differences the arms' DLS gains (kv kacc = 60) scale up (measured
# 8e-6 relative).
SCORE_RTOL = 5e-5
# One controller call on random states: the arms' 2x2 solve (adjugate
# against LU) and the transcendentals; the quadrotor scales its heading
# error's ulp by 100 into rotor commands of ~1.
CONTROL_RTOL = 1e-5
CONTROL_ATOL = {"pointmass": 1e-5, "unicycle": 1e-5, "reacher": 1e-4,
                "quadrotor": 1e-4, "arm3": 1e-4}
QUAD_PARITY_H = 12
SCENE_KEYS = ("start", "goal", "obstacles", "obstacle_mask")


def _scenes(rng, n):
    """``n`` scenes (numpy): starts and goals in opposite corners, three
    live obstacles of radius 0.04-0.1."""
    obs = np.zeros((n, 8, 3), np.float32)
    obs[:, :3, :2] = rng.uniform(0.2, 0.8, (n, 3, 2))
    obs[:, :3, 2] = rng.uniform(0.04, 0.1, (n, 3))
    mask = np.zeros((n, 8), np.float32)
    mask[:, :3] = 1.0
    return (rng.uniform(0.1, 0.4, (n, 2)).astype(np.float32),
            rng.uniform(0.6, 0.9, (n, 2)).astype(np.float32), obs, mask)


def _both(arrays):
    """(the port's Scene, the JAX package's) of numpy scene arrays."""
    return (Scene(*(torch.from_numpy(a) for a in arrays)),
            JaxScene(**dict(zip(SCENE_KEYS, map(jnp.asarray, arrays)))))


def _waypoints(rng, starts, goals, n, horizon, noise=0.03):
    """``[S, n, H, 2]`` noisy straight paths from start to goal."""
    t = (np.arange(horizon) + 1.0) / horizon
    line = (starts[:, None, None, :] + t[None, None, :, None]
            * (goals - starts)[:, None, None, :])
    noisy = line + noise * rng.normal(size=(len(starts), n, horizon, 2))
    return np.clip(noisy, 0.05, 0.95).astype(np.float32)


def _jax_score(env, jscenes, taus, mode="waypoints"):
    params = jax_get_env(env).make_params()
    return jax.vmap(lambda sc, t: jax_score(params, sc, t, mode=mode,
                                            env=env))(jscenes,
                                                      jnp.asarray(taus))


def test_registry_serves_every_family_with_its_action_width():
    assert FAMILIES == ("pointmass", "unicycle", "reacher", "quadrotor",
                        "arm3")
    for env in FAMILIES:
        api = get_env(env)
        assert all(callable(fn) for fn in api)
        assert action_dim(env) == jax_action_dim(env) == (
            3 if env == "arm3" else 2)
    with pytest.raises(ValueError, match="unknown env 'bogus'"):
        get_env("bogus")


@pytest.mark.parametrize("env", FAMILIES)
def test_reset_matches_jax(env):
    """Every field of the reset state, on 16 scenes whose starts and goals
    cover the box (the arms' IK included)."""
    rng = np.random.default_rng(1)
    arrays = _scenes(rng, 16)
    arrays = (rng.uniform(0.02, 0.98, (16, 2)).astype(np.float32),
              *arrays[1:])
    scenes, jscenes = _both(arrays)
    api, japi = get_env(env), jax_get_env(env)
    got = api.reset(api.make_params(), scenes, 3)
    want = jax.vmap(lambda sc: japi.reset(japi.make_params(), sc))(jscenes)
    for field in dataclasses.fields(got):
        g = getattr(got, field.name).numpy()
        w = np.asarray(getattr(want, field.name))
        w = np.broadcast_to(w[:, None], g.shape)  # 3 candidates a scene
        assert g.dtype == w.dtype, field.name
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                   err_msg=field.name)
    # The arms start with the end-effector on the scene's start.
    np.testing.assert_allclose(got.pos.numpy(), np.broadcast_to(
        arrays[0][:, None], got.pos.shape), atol=2e-6)


def _twin_positions(env, scene_dict, actions):
    twin = TWINS[env]()
    twin.reset(scene_dict)
    return np.stack([twin.step(a) for a in actions]), twin


@pytest.mark.parametrize("env", FAMILIES)
def test_step_matches_jax_and_the_twin(env):
    """Open-loop action sequences of 40 steps from three seeds, one
    candidate each, through the port's ``step``, JAX's and the twin's: the
    port's positions within the JAX golden tests' tolerance of the twin's
    and within 1e-5 of JAX's, the latches equal."""
    scene_dict = {"start": [0.3, 0.6], "goal": [0.9, 0.9],
                  "obstacles": [[0.5, 0.5, 0.1], [0.3, 0.2, 0.08]]}
    scale, offset = ACTION_DRAW[env]
    du = action_dim(env)
    actions = np.stack([
        offset + np.random.default_rng(seed).normal(scale=scale,
                                                    size=(40, du))
        for seed in range(3)]).astype(np.float32)  # [3, 40, du]
    scene = Scene.create(scene_dict["start"], scene_dict["goal"],
                         scene_dict["obstacles"], device="cpu")
    api = get_env(env)
    params = api.make_params()
    state = api.reset(params, scene, 3)
    got = []
    for t in range(actions.shape[1]):
        state, _ = api.step(params, scene, state, torch.from_numpy(
            actions[:, t]))
        got.append(state.pos)
    got = torch.stack(got, dim=1).numpy()
    jscene = JaxScene.create(scene_dict["start"], scene_dict["goal"],
                             scene_dict["obstacles"])
    want = _jax_score(env, jax.tree.map(lambda a: a[None], jscene),
                      actions[None], mode="actions")
    np.testing.assert_allclose(got, np.asarray(want.positions)[0], rtol=1e-5,
                               atol=1e-5)
    for c in range(3):
        twin_pos, twin = _twin_positions(env, scene_dict, actions[c])
        np.testing.assert_allclose(got[c], twin_pos, rtol=TWIN_RTOL,
                                   atol=TWIN_ATOL[env])
        assert bool(state.collided[c] > 0.5) == twin.collided
        assert bool(state.done[c] > 0.5) == twin.done
    np.testing.assert_array_equal(state.collided.numpy(),
                                  np.asarray(want.collided)[0])
    np.testing.assert_array_equal(state.done.numpy(),
                                  np.asarray(want.reached)[0])


def _random_state(env, rng, n):
    """A family's state fields (numpy) for ``n`` candidates, drawn over the
    ranges its dynamics reach."""
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, (n, *shape)).astype(  # noqa: E731
        np.float32)
    fields = {"pos": u(0.0, 1.0, 2)}
    if env in ("pointmass", "quadrotor"):
        fields["vel"] = u(-2.0, 2.0, 2)
    if env == "unicycle":
        fields.update(heading=u(-np.pi, np.pi), speed=u(0.0, 1.5))
    if env == "quadrotor":
        fields.update(theta=u(-1.0, 1.0), omega=u(-8.0, 8.0))
    if env in ("reacher", "arm3"):
        dq = action_dim(env)
        fields.update(q=u(-np.pi, np.pi, dq), qd=u(-4.0, 4.0, dq))
    return fields


@pytest.mark.parametrize("env", FAMILIES)
def test_waypoint_control_matches_jax(env):
    """One controller call on 256 random states and targets.  Where a
    heading error wraps at +-pi the controller jumps, so draws whose
    error lies within 1e-3 of the wrap are redrawn away from it."""
    rng = np.random.default_rng(FAMILIES.index(env))
    n = 256
    fields = _random_state(env, rng, n)
    target = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    api, japi = get_env(env), jax_get_env(env)
    params, jparams = api.make_params(), japi.make_params()
    scene, jscene = Scene.create([0.1, 0.1], [0.9, 0.9], device="cpu"), \
        JaxScene.create([0.1, 0.1], [0.9, 0.9])
    state = dataclasses.replace(api.reset(params, scene, n), **{
        k: torch.from_numpy(v) for k, v in fields.items()})
    jstate = jax.vmap(lambda _: japi.reset(jparams, jscene))(
        jnp.arange(n)).replace(**{k: jnp.asarray(v)
                                  for k, v in fields.items()})
    got = api.waypoint_control(params, state, torch.from_numpy(target))
    want = np.asarray(jax.vmap(lambda s, t: japi.waypoint_control(
        jparams, s, t))(jstate, jnp.asarray(target)))
    keep = np.ones(n, bool)
    if env == "unicycle":
        d = target - fields["pos"]
        err = np.arctan2(d[:, 1], d[:, 0]) - fields["heading"]
        keep = np.abs(np.abs(np.angle(np.exp(1j * err))) - np.pi) > 1e-3
    elif env == "quadrotor":
        a = 6.0 * (target - fields["pos"]) - 3.0 * fields["vel"]
        err = np.arctan2(-a[:, 0], a[:, 1] + 0.5) - fields["theta"]
        keep = np.abs(np.abs(np.angle(np.exp(1j * err))) - np.pi) > 1e-3
    assert keep.mean() > 0.95
    assert got.shape == (n, action_dim(env))
    np.testing.assert_allclose(got.numpy()[keep], want[keep],
                               rtol=CONTROL_RTOL, atol=CONTROL_ATOL[env])


@pytest.mark.parametrize("env", FAMILIES)
def test_score_candidates_matches_jax(env):
    """Waypoint-mode scoring of 4 scenes x 32 candidates: positions and goal
    distances within POS_ATOL, scores at SCORE_RTOL, the latches equal
    (the draws keep the latches off their thresholds: the latches of
    every candidate here are the twin-checked JAX package's)."""
    rng = np.random.default_rng(10 + FAMILIES.index(env))
    arrays = _scenes(rng, 4)
    horizon = QUAD_PARITY_H if env == "quadrotor" else 32
    taus = _waypoints(rng, arrays[0], arrays[1], 32, horizon)
    scenes, jscenes = _both(arrays)
    got = score_candidates(get_env(env).make_params(), scenes,
                           torch.from_numpy(taus), env=env)
    want = _jax_score(env, jscenes, taus)
    assert got.positions.shape == (4, 32, horizon, 2)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), atol=POS_ATOL)
    # A goal distance moves with its end position.
    for key in ("score", "goal_dist", "control_cost"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   rtol=SCORE_RTOL, atol=POS_ATOL,
                                   err_msg=key)
    for key in ("collided", "reached"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)))
    # Not a vacuous check: both latches take both values over the draws.
    assert 0 < float(want.reached.mean()) < 1 or env == "quadrotor"
    assert 0 < float(want.collided.mean())


def test_quadrotor_full_horizon_agrees_in_aggregate():
    """Over 32 steps the attitude loop magnifies ulps (module docstring):
    the port's reach and collision rates within 2 of JAX's 256
    candidates, its mean score within 1% and at least 80% of candidates
    within POS_ATOL of JAX's path."""
    rng = np.random.default_rng(20)
    arrays = _scenes(rng, 4)
    taus = _waypoints(rng, arrays[0], arrays[1], 64, 32)
    scenes, jscenes = _both(arrays)
    got = score_candidates(get_env("quadrotor").make_params(), scenes,
                           torch.from_numpy(taus), env="quadrotor")
    want = _jax_score("quadrotor", jscenes, taus)
    n = taus.shape[0] * taus.shape[1]
    for key in ("reached", "collided"):
        assert abs(float(getattr(got, key).sum())
                   - float(getattr(want, key).sum())) <= 2, key
    np.testing.assert_allclose(float(got.score.mean()),
                               float(want.score.mean()), rtol=1e-2)
    gap = np.abs(got.positions.numpy() - np.asarray(want.positions)).max(
        axis=(-1, -2))
    assert (gap <= POS_ATOL).sum() >= 0.8 * n


def _on_goal_threshold(env, n=8):
    """One step of ``n`` candidates (fixed actions), then a goal placed at
    exactly goal_radius from each candidate's JAX end position (to float32
    rounding): the reach test sits on its threshold."""
    japi = jax_get_env(env)
    jparams = japi.make_params()
    du = action_dim(env)
    actions = np.random.default_rng(3).normal(
        scale=ACTION_DRAW[env][0], size=(n, du)).astype(np.float32)
    if env == "unicycle":
        # It starts facing the goal, which moves its first step: braking
        # keeps it on the start whatever the goal.
        actions[:, 0] = -1.0
    start = np.array([0.3, 0.4], np.float32)
    probe = JaxScene.create(start, [0.9, 0.9])
    pos1 = np.asarray(jax.vmap(lambda a: japi.step(
        jparams, probe, japi.reset(jparams, probe), a)[0].pos)(
            jnp.asarray(actions)))
    angle = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    goals = (pos1 + 0.05 * np.stack([np.cos(angle), np.sin(angle)], -1)
             ).astype(np.float32)
    return start, goals, actions


@pytest.mark.parametrize("env", FAMILIES)
def test_latches_on_their_threshold_accept_either_side(env):
    """Candidates whose first step ends on the reach threshold: each
    package's latch is its own distance's verdict (either side of the
    threshold), and where the two distances fall on one side the latches
    agree."""
    start, goals, actions = _on_goal_threshold(env)
    n = len(goals)
    api, japi = get_env(env), jax_get_env(env)
    params, jparams = api.make_params(), japi.make_params()
    scenes = Scene.create_batch(torch.from_numpy(np.tile(start, (n, 1))),
                                torch.from_numpy(goals))
    state = api.reset(params, scenes, 1)
    state, info = api.step(params, scenes, state,
                           torch.from_numpy(actions)[:, None])
    jscenes = jax.vmap(JaxScene.create)(jnp.tile(start, (n, 1)),
                                        jnp.asarray(goals))
    jstate, jinfo = jax.vmap(lambda sc, a: japi.step(
        jparams, sc, japi.reset(jparams, sc), a))(jscenes,
                                                  jnp.asarray(actions))
    dist = info.dist_to_goal[:, 0].numpy()
    jdist = np.asarray(jinfo.dist_to_goal)
    radius = np.float32(params.goal_radius)
    np.testing.assert_allclose(dist, radius, atol=1e-6)  # on the threshold
    np.testing.assert_array_equal(state.done[:, 0].numpy(),
                                  (dist < radius).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(jstate.done),
                                  (jdist < radius).astype(np.float32))
    same_side = (dist < radius) == (jdist < radius)
    np.testing.assert_array_equal(state.done[:, 0].numpy()[same_side],
                                  np.asarray(jstate.done)[same_side])


@pytest.mark.parametrize("arm,jarm", [(reacher, jax_reacher),
                                      (arm3, jax_arm3)])
def test_arm_kinematics_match_jax(arm, jarm):
    """FK(IK(target)) lands on the target over the unit box (the JAX
    test's 2e-6), IK, FK and the Jacobian agree with JAX's, and the
    Jacobian is FK's derivative."""
    name = arm.__name__.rsplit(".", 1)[-1]
    params = get_env(name).make_params()
    jparams = jax_get_env(name).make_params()
    targets = np.random.default_rng(0).uniform(0.02, 0.98, (128, 2)).astype(
        np.float32)
    q = arm.inverse_kinematics(params, torch.from_numpy(targets))
    ee = arm.forward_kinematics(params, q)[-1]
    np.testing.assert_allclose(ee.numpy(), targets, atol=2e-6)
    jq = jax.vmap(lambda t: jarm.inverse_kinematics(jparams, t))(
        jnp.asarray(targets))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6,
                               atol=1e-6)
    qs = np.random.default_rng(1).uniform(-np.pi, np.pi, q.shape).astype(
        np.float32)
    for got, want in zip(
            arm.forward_kinematics(params, torch.from_numpy(qs)),
            jax.vmap(lambda qq: jarm.forward_kinematics(jparams, qq))(
                jnp.asarray(qs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    jac = arm.jacobian(params, torch.from_numpy(qs))
    np.testing.assert_allclose(jac.numpy(), np.asarray(jax.vmap(
        lambda qq: jarm.jacobian(jparams, qq))(jnp.asarray(qs))),
        atol=1e-6)
    fk = lambda qq: arm.forward_kinematics(params, qq)[-1]  # noqa: E731
    auto = torch.func.vmap(torch.func.jacrev(fk))(torch.from_numpy(
        qs).double())
    np.testing.assert_allclose(jac.numpy(), auto.numpy(), atol=1e-5)


def test_dls_solve_matches_float64_lu():
    """The adjugate solve of ``J J^T + lam I`` against float64 LU
    (``torch.linalg.solve``) on random arm states, straight and folded
    arms included: within 1e-5 of the largest command."""
    rng = np.random.default_rng(5)
    for arm, n_q in ((reacher, 2), (arm3, 3)):
        params = arm.__dict__[
            "ReacherParams" if n_q == 2 else "Arm3Params"].create()
        q = rng.uniform(-np.pi, np.pi, (256, n_q)).astype(np.float32)
        q[:8, 1:] = 0.0  # straight
        q[8:16, 1] = np.pi  # folded
        state = arm.reset(params, Scene.create([0.2, 0.2], [0.8, 0.8],
                                               device="cpu"), 256)
        state = dataclasses.replace(state, q=torch.from_numpy(q),
                                    qd=torch.zeros((256, n_q)))
        target = torch.from_numpy(rng.uniform(0, 1, (256, 2)).astype(
            np.float32))
        got = arm.waypoint_control(params, state, target)
        jac = arm.jacobian(params, state.q).double()
        damped = jac @ jac.transpose(-1, -2) + 0.02 * torch.eye(
            2, dtype=torch.float64)
        y = torch.linalg.solve(damped, 6.0 * (target - state.pos).double())
        want = 10.0 * (jac.transpose(-1, -2) @ y[..., None])[..., 0]
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
