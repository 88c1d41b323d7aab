"""Candidate-sharded planning, the torch port against the JAX package, on gloo ranks.

``parallel/sharded_plan.py``'s six factories on spawned CPU ranks
(``parallel/spawn.py::run_ranks``, a ``FileStore`` in ``tmp_path``, no TCP
port; one spawn a world, every planner inside it): world 2 as the meshes
(2, 1) and (1, 2), world 3 as (3, 1), whose splits are uneven (and at 4
iLQR warm starts leave rank 2 only padding), at budgets of n = 64 and
n = 100 candidates with JAX's noise injected.  Each planner is held
against JAX's ``make_sharded_*`` on the 8 virtual CPU devices
(``conftest.py``; mesh (4, 2) at n = 64, (8, 1) at n = 100) and against
the port's unsharded planner on the same noise, at the tolerances of its
parity test:

- plan: ``tests/test_torch_planner.py``, candidates at rtol 1e-5 / atol
  1e-6, scores at 1e-5, the best and diverse picks equal;
- CEM: ``tests/test_torch_cem.py``, everything at 1e-5, the best pick and
  the first diverse pick equal (past it the refined population's
  farthest-point choices are near-ties, so for every refiner);
- grad: ``tests/test_torch_grad_refine.py``, everything at 1e-5;
- trajopt and cem+trajopt: ``tests/test_torch_trajopt.py`` holds the first
  10 Adam steps at rtol 1e-5; these run 6, so the curve, the best score
  and the candidates at 1e-5;
- iLQR: ``tests/test_torch_ilqr.py``, the curve at rtol 1e-5 (arm3's at
  1e-4), the scores of the union and the best at that rtol and atol 1e-5,
  the pick a near-tie of the reference's best.

The ranks' results are bitwise equal to each other (the selection runs on
every rank over the gathered candidates), and one rank's bitwise the
unsharded planner's.  Sizes: goalcond, G/D 32x32, a horizon of 16, one
scene with an obstacle; 3 CEM iterations, 4 grad and 6 trajopt Adam
steps, 3 iLQR iterations.  A rank imports this module for its worker and
runs no JAX.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.parallel import sharded_plan as jax_sp
from ndivplanning_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ndivplanning_tpu.parallel.sharded_step import (
    shard_state as jax_shard_state,
)
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.parallel.sharded_plan import BY_REFINE
from ndivplanning_tpu_torch.parallel.spawn import run_ranks
from ndivplanning_tpu_torch.planning.planner import PlanResult, plan
from ndivplanning_tpu_torch.planning.refine import (
    noise_shape,
    plan_refined_batch,
)
from test_torch_cem import jax_cem_noise
from test_torch_mpc import _cfgs, _models, _mpc_scenes

PLANNERS = ("plan", "cem", "grad", "trajopt", "ilqr", "cem+trajopt")
BUDGETS = (64, 100)
WORLDS = {1: [(1, 1)], 2: [(2, 1), (1, 2)], 3: [(3, 1)]}
JAX_MESH = {64: (4, 2), 100: (8, 1)}
SMALL = dict(horizon=16, cem_iters=3, grad_refine_steps=4, trajopt_steps=6,
             ilqr_iters=3)
ARM3 = dict(rollout_mode="actions", generator_output="linear", state_dim=3)
SCENE = 1  # test_torch_mpc.MPC_SCENES[1]: an obstacle between start and goal

# Per planner: (candidates' and curve's rtol, atol, scores' rtol, atol).
TOL = {"plan": (1e-5, 1e-6, 1e-5, 1e-5), "cem": (1e-5, 1e-5, 1e-5, 1e-5),
       "grad": (1e-5, 1e-5, 1e-5, 1e-5), "trajopt": (1e-5, 1e-5, 1e-5, 1e-5),
       "cem+trajopt": (1e-5, 1e-5, 1e-5, 1e-5),
       "ilqr": (1e-5, 1e-5, 1e-5, 1e-5), "ilqr_arm3": (1e-4, 1e-5, 1e-4, 1e-5)}


def _case_cfgs(env, n):
    extra = ARM3 if env == "arm3" else {}
    return _cfgs(env, n_candidates=n, **SMALL, **extra)


def _cases():
    """name -> (planner, env, n): the six at both budgets, iLQR on arm3."""
    cases = {f"{p}_{n}": (p, "pointmass", n) for p in PLANNERS
             for n in BUDGETS}
    cases["ilqr_arm3_64"] = ("ilqr", "arm3", 64)
    return cases


# ------------------------------------------------------------- the ranks


def _numpy(out):
    """A planner's result (and curve) as numpy."""
    if isinstance(out, PlanResult):
        return PlanResult(*(f.numpy().copy() for f in out)), None
    result, curve = out
    return _numpy(result)[0], curve.numpy().copy()


def sharded_worker(meshes, runs):
    """Every run ``(name, planner, cfg, g_ema weights, scene fields,
    condition, noise)`` on every mesh ``(dp, div)``: {(mesh, name):
    (PlanResult, curve) as numpy}."""
    from ndivplanning_tpu_torch.parallel import make_mesh
    from ndivplanning_tpu_torch.train.state import create_train_state

    out = {}
    for dp, div in meshes:
        mesh = make_mesh(dp=dp, div=div)
        for name, planner, cfg, weights, scene, condition, noise in runs:
            state = create_train_state(cfg, device="cpu")
            state.g_ema.load_state_dict({k: torch.from_numpy(v)
                                         for k, v in weights.items()})
            fn, _ = BY_REFINE["none" if planner == "plan" else planner](
                cfg, mesh)
            out[(dp, div), name] = _numpy(fn(
                state, Scene(*(torch.from_numpy(f) for f in scene)),
                torch.from_numpy(condition), noise=torch.from_numpy(noise)))
    return out


# ------------------------------------------------------ the references


def _jax_noise(planner, cfg, key):
    """The draws of JAX's sharded ``planner`` from ``key``, as the port's
    ``noise`` (``planning/refine.py::noise_shape``)."""
    if planner == "plan":
        return np.asarray(jax.random.normal(
            key, (1, cfg.n_candidates, cfg.latent_dim)))[0]
    shape = noise_shape(cfg, planner)
    if planner in ("cem", "cem+trajopt"):
        k = key if planner == "cem" else jax.random.split(key)[0]
        return jax_cem_noise(k, shape[0] - 1, shape[1], shape[2])
    return np.asarray(jax.random.normal(key, shape))


JAX_FACTORY = {"plan": jax_sp.make_sharded_plan,
               "cem": jax_sp.make_sharded_cem,
               "grad": jax_sp.make_sharded_grad,
               "trajopt": jax_sp.make_sharded_trajopt,
               "ilqr": jax_sp.make_sharded_ilqr,
               "cem+trajopt": jax_sp.make_sharded_cem_trajopt}


def _jax_numpy(out):
    if isinstance(out, tuple) and not hasattr(out, "_fields"):
        return PlanResult(*(np.asarray(f) for f in out[0])), np.asarray(
            out[1])
    return PlanResult(*(np.asarray(f) for f in out)), None


def _unsharded(planner, cfg, state, scene, condition, noise):
    """The port's unsharded single-scene ``planner`` on ``noise``."""
    if planner == "plan":
        return plan(cfg, state, scene, condition, z=noise[None])
    result, curve = plan_refined_batch(cfg, state, Scene.stack([scene]),
                                       condition[None], planner,
                                       noise=noise[None])
    return PlanResult(*(f[0] for f in result)), curve[0]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(ranks, refs)``: world -> its ranks' results of every case on its
    meshes; name -> (JAX's sharded result, the port's unsharded one).  The
    worlds run one after another in a thread while the references are
    computed here."""
    scenes, jscenes, conds = _mpc_scenes()
    scene = scenes.map(lambda t: t[SCENE])
    jscene = jax.tree.map(lambda a: a[SCENE], jscenes)
    condition = conds[SCENE]
    key = jax.random.PRNGKey(7)
    cases = {}
    for name, (planner, env, n) in _cases().items():
        jcfg, cfg = _case_cfgs(env, n)
        jstate, state = _models(jcfg, cfg)
        cases[name] = (planner, jcfg, jstate, cfg, state,
                       np.array(_jax_noise(planner, cfg, key)))
    runs = [(name, planner, cfg,
             {k: v.numpy() for k, v in state.g_ema.state_dict().items()},
             tuple(getattr(scene, f.name).numpy()
                   for f in dataclasses.fields(scene)), condition, noise)
            for name, (planner, _, _, cfg, state, noise) in cases.items()]
    ranks, errors = {}, []

    def spawn():
        try:
            for world, meshes in WORLDS.items():
                ranks[world] = run_ranks(
                    sharded_worker, world,
                    tmp_path_factory.mktemp(f"world{world}"), meshes, runs,
                    timeout=600)
        except RuntimeError as e:  # raised below, in the test's thread
            errors.append(e)

    thread = threading.Thread(target=spawn)
    thread.start()
    refs = {}
    for name, (planner, jcfg, jstate, cfg, state, noise) in cases.items():
        mesh = jax_make_mesh(*JAX_MESH[cfg.n_candidates])
        jfn, _ = JAX_FACTORY[planner](jcfg, mesh)
        refs[name] = (
            _jax_numpy(jfn(jax_shard_state(jstate, mesh), jscene,
                           jnp.asarray(condition), key)),
            _numpy(_unsharded(planner, cfg, state, scene,
                              torch.from_numpy(condition),
                              torch.from_numpy(noise))))
    thread.join(timeout=1200)
    if errors:
        raise errors[0]
    assert set(ranks) == set(WORLDS), "the ranks did not finish"
    return ranks, refs


# ----------------------------------------------------------------- tests


def _assert_close(planner, name, got, want, what):
    (res, curve), (wres, wcurve) = got, want
    rtol, atol, s_rtol, s_atol = TOL["ilqr_arm3" if "arm3" in name
                                     else planner]
    if curve is not None:
        np.testing.assert_allclose(curve, wcurve, rtol=rtol, atol=atol,
                                   err_msg=f"{what} curve")
    if planner != "ilqr":  # tests/test_torch_ilqr.py holds its scores
        for key in ("taus", "best_traj"):
            np.testing.assert_allclose(getattr(res, key), getattr(wres, key),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{what} {key}")
    np.testing.assert_allclose(res.scores, wres.scores, rtol=s_rtol,
                               atol=s_atol, err_msg=f"{what} scores")
    np.testing.assert_allclose(res.best_score, wres.best_score, rtol=s_rtol,
                               atol=s_atol, err_msg=f"{what} best")
    if planner == "ilqr":
        # Refined warm starts converge onto one optimum: the pick is a
        # near-tie of the reference's best.
        np.testing.assert_allclose(wres.scores[res.diverse_idx[0]],
                                   wres.best_score, rtol=s_rtol,
                                   atol=s_atol, err_msg=f"{what} pick")
    else:
        assert res.diverse_idx[0] == wres.diverse_idx[0], what
    if planner == "plan":
        # The refiners' candidates cluster: past the first pick the
        # farthest-point choices are near-ties (tests/test_torch_cem.py).
        np.testing.assert_array_equal(res.diverse_idx, wres.diverse_idx,
                                      err_msg=f"{what} diverse")
        np.testing.assert_allclose(res.diverse_trajs, wres.diverse_trajs,
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} diverse_trajs")
    assert res.best_reached == wres.best_reached, what


def _bitwise(a, b) -> bool:
    (res, curve), (wres, wcurve) = a, b
    return all(np.array_equal(x, y) for x, y in zip(res, wres)) and (
        curve is None or np.array_equal(curve, wcurve))


MESH_CASES = [(world, mesh) for world in (2, 3) for mesh in WORLDS[world]]


@pytest.mark.parametrize("name", list(_cases()))
@pytest.mark.parametrize("world,mesh", MESH_CASES,
                         ids=[f"{dp}x{div}" for _, (dp, div) in MESH_CASES])
def test_sharded_planner_matches_jax_and_the_unsharded_one(
        results, world, mesh, name):
    """Every rank returns the same bits; they lie within the planner's
    tolerance of JAX's sharded planner and of the port's unsharded one."""
    ranks, refs = results
    planner = _cases()[name][0]
    got = [rank_out[mesh, name] for rank_out in ranks[world]]
    for other in got[1:]:
        assert _bitwise(other, got[0]), f"{name} ranks differ"
    jax_want, want = refs[name]
    _assert_close(planner, name, got[0], jax_want, f"{name} vs JAX")
    _assert_close(planner, name, got[0], want, f"{name} vs unsharded")
    assert got[0][0].scores.shape == jax_want[0].scores.shape


@pytest.mark.parametrize("planner", PLANNERS)
def test_one_rank_is_bitwise_the_unsharded_planner(results, planner):
    """The hook's identity: on a 1x1 mesh the split is the whole axis and
    the gather and the sum copy it, so every field and the curve are
    bitwise the default (``shard=None``) planner's, at both budgets."""
    ranks, refs = results
    for n in BUDGETS:
        name = f"{planner}_{n}"
        (got,) = [rank_out[(1, 1), name] for rank_out in ranks[1]]
        assert _bitwise(got, refs[name][1]), name
