"""The torch port's evaluation (``train/evaluate.py``) against the JAX package's, on the CPU.

``evaluate_on_batch`` takes JAX's batch and latents (its threefry streams
cannot be reproduced in torch), as numpy, and converted weights.  The
planning512 anchor feeds JAX's frozen suite and latents to the committed
torch model and holds its success rate to JAX's ``evaluate_fixed`` on the
JAX checkpoint.  Then the ported behaviours of the frozen suite
(``tests/test_evaluate_plan.py``) and the one-shot planner ladder.
"""

import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from ndivplanning_tpu.data.tasks import make_task as jax_make_task
from ndivplanning_tpu.train import evaluate as jax_ev
from ndivplanning_tpu.train.state import create_train_state as jax_create
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.data.tasks import Batch, task_fingerprint
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.planner import plan_batch
from ndivplanning_tpu_torch.train import evaluate as ev
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils.config import get_config
from ndivplanning_tpu_torch.utils.convert import params_from_flax

# Continuous metrics at rtol 1e-5 (float32 G and rollouts in two packages).
# eval_ndiv: the Gram-form distances of an untrained generator's
# near-duplicate samples lose digits in any float32 ordering, so it is held
# at the train step's g_ndiv tolerance, 1e-2; on the trained planning512
# model, whose samples are spread, at 1e-5.
RTOL = 1e-5
NDIV_RTOL_UNTRAINED = 1e-2
CONTINUOUS = ("eval_mean_pairwise_dist", "eval_endpoint_err",
              "eval_mean_score", "eval_mode_coverage")
RATES = ("eval_success_rate", "eval_collision_rate")
SMALL = dict(batch_size=16, k=4, g_hidden=(32, 32), d_hidden=(32,),
             cond_embed_dim=8, image_size=16, g_ema_decay=0.9)
PRESETS = ["pointmass2d", "goalcond", "imagecond"]


def _to_torch_batch(jbatch) -> Batch:
    arrays = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jbatch)
    return Batch(conditions=arrays.conditions, real_traj=arrays.real_traj,
                 scenes=Scene(**{f.name: getattr(arrays.scenes, f.name)
                                 for f in dataclasses.fields(Scene)}))


def _jax_states(jcfg, seed):
    """A JAX state whose EMA generator differs from its raw one, and the
    port's state with both generators converted from it."""
    jstate = jax_create(jcfg, seed=seed)
    jstate = jstate.replace(
        g_ema_params=jax_create(jcfg, seed=seed + 1).g_params)
    cfg = get_config(jcfg.name, **{k: getattr(jcfg, k) for k in SMALL})
    state = create_train_state(cfg, device="cpu")
    for module, tree in ((state.g, jstate.g_params),
                         (state.g_ema, jstate.g_ema_params)):
        module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, tree)))
    return jstate, cfg, state


def assert_metrics_match(got, want, n_samples, ndiv_rtol):
    """``got`` (the port's) against ``want`` (JAX's): the same keys,
    continuous metrics at RTOL, eval_ndiv at ``ndiv_rtol``, and each rate
    within one flipped sample of the ``n_samples``."""
    got = {k: float(v) for k, v in got.items()}
    want = {k: float(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key in CONTINUOUS:
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)
    np.testing.assert_allclose(got["eval_ndiv"], want["eval_ndiv"],
                               rtol=ndiv_rtol)
    for key in RATES:
        assert abs(got[key] - want[key]) <= 1.0 / n_samples + 1e-7, key
    return got


@pytest.mark.parametrize("use_ema", [True, False])
@pytest.mark.parametrize("preset", PRESETS)
def test_evaluate_on_batch_matches_jax(preset, use_ema):
    jcfg = jax_get_config(preset, **SMALL)
    jstate, cfg, state = _jax_states(jcfg, seed=PRESETS.index(preset))
    key = jax.random.PRNGKey(5)
    jbatch = jax_make_task(jcfg).sample(jax.random.PRNGKey(4),
                                        jcfg.batch_size)
    want = jax_ev.evaluate_on_batch(jcfg, jstate, key, jbatch,
                                    use_ema=use_ema)
    z = np.array(jax.random.normal(key, (jcfg.batch_size, jcfg.k,
                                           jcfg.latent_dim)))
    got = ev.evaluate_on_batch(cfg, state, None, _to_torch_batch(jbatch),
                               use_ema=use_ema, z=torch.from_numpy(z))
    got = assert_metrics_match(got, want, jcfg.batch_size * jcfg.k,
                               NDIV_RTOL_UNTRAINED)
    assert ("eval_mode_coverage" in got) == (preset == "pointmass2d")
    # The raw and EMA legs evaluate different generators.
    other = ev.evaluate_on_batch(cfg, state, None, _to_torch_batch(jbatch),
                                 use_ema=not use_ema, z=torch.from_numpy(z))
    assert float(other["eval_mean_pairwise_dist"]) != got[
        "eval_mean_pairwise_dist"]


def test_planning512_frozen_suite_matches_jax():
    """JAX's frozen suite (512 scenes) and latents through the committed
    torch planning512 model: its success rate within 2 of the 4096 samples
    of JAX's evaluate_fixed on the JAX checkpoint, every other metric as in
    the small parity test, eval_ndiv at RTOL."""
    from test_torch_checkpoint import jax_planning512, torch_planning512

    jcfg, jstate = jax_planning512()
    cfg, state = torch_planning512()
    want = jax_ev.evaluate_fixed(jcfg, jstate, n_scenes=512)
    suite = jax_ev.make_eval_suite(jcfg, 512)
    z = np.array(jax.random.normal(
        jax.random.PRNGKey(jax_ev.EVAL_SUITE_SEED + 1), (512, cfg.k,
                                                         cfg.latent_dim)))
    got = ev.evaluate_on_batch(cfg, state, None, _to_torch_batch(suite),
                               z=torch.from_numpy(z))
    n = 512 * cfg.k
    got = assert_metrics_match(got, want, n, RTOL)
    assert abs(got["eval_success_rate"]
               - float(want["eval_success_rate"])) <= 2.0 / n
    # The trained model reaches most goals: the anchor is no empty check.
    assert got["eval_success_rate"] > 0.5


def _small(preset="goalcond", **kw):
    return get_config(preset, **{**SMALL, **kw})


def test_fixed_eval_suite_reproducible():
    """The frozen protocol reproduces to the digit across calls and does
    not depend on the training seed."""
    cfg_a = _small(seed=0)
    state = create_train_state(cfg_a, device="cpu")
    out1 = {k: float(v) for k, v in
            ev.evaluate_fixed(cfg_a, state, n_scenes=64).items()}
    out2 = {k: float(v) for k, v in
            ev.evaluate_fixed(cfg_a, state, n_scenes=64).items()}
    assert out1 == out2  # bitwise: same program, same frozen inputs
    # The same weights under another training seed's config and generator
    # see the identical suite and latents.
    cfg_b = _small(seed=123)
    state.rng = create_train_state(cfg_b, device="cpu").rng
    out3 = {k: float(v) for k, v in
            ev.evaluate_fixed(cfg_b, state, n_scenes=64).items()}
    assert out1 == out3


def test_eval_suite_cache_shared_across_irrelevant_fields():
    """Configs differing only in fields the suite does not read share one
    cache slot; a field it reads splits the cache, and so does the device."""
    cfg_a = get_config("goalcond", workdir="/tmp/a", steps=100, seed=0)
    cfg_b = get_config("goalcond", workdir="/tmp/b", steps=999, seed=7,
                       lr_schedule="cosine")
    assert task_fingerprint(cfg_a) == task_fingerprint(cfg_b)
    suite_a = ev.make_eval_suite(cfg_a, n_scenes=32, device="cpu")
    suite_b = ev.make_eval_suite(cfg_b, n_scenes=32, device="cpu")
    assert suite_a is suite_b  # the same object: one cache entry
    cfg_c = get_config("goalcond", workdir="/tmp/a",
                       horizon=cfg_a.horizon + 1)
    suite_c = ev.make_eval_suite(cfg_c, n_scenes=32, device="cpu")
    assert suite_c.real_traj.shape != suite_a.real_traj.shape
    key = (task_fingerprint(cfg_a), 32, ev.EVAL_SUITE_SEED, "cpu")
    assert ev._SUITE_CACHE[key] is suite_a


def test_eval_suite_cache_is_a_fifo_of_eight():
    cfg = _small()
    first = ev.make_eval_suite(cfg, n_scenes=4, seed=1000, device="cpu")
    for seed in range(1001, 1001 + ev._SUITE_CACHE_MAX):
        ev.make_eval_suite(cfg, n_scenes=4, seed=seed, device="cpu")
    assert len(ev._SUITE_CACHE) == ev._SUITE_CACHE_MAX
    again = ev.make_eval_suite(cfg, n_scenes=4, seed=1000, device="cpu")
    assert again is not first  # evicted, then drawn anew
    torch.testing.assert_close(again.real_traj, first.real_traj, rtol=0,
                               atol=0)


def test_frozen_suite_is_drawn_on_the_cpu_from_its_seed():
    """The suite is make_task's batch from a CPU generator seeded with
    EVAL_SUITE_SEED, and the latents are the next seed's first draw: the
    same on every device."""
    from ndivplanning_tpu_torch.data.tasks import make_task

    cfg = _small("imagecond")
    state = create_train_state(cfg, device="cpu")
    want_suite = make_task(cfg).sample(
        torch.Generator().manual_seed(ev.EVAL_SUITE_SEED), 8)
    suite = ev.make_eval_suite(cfg, n_scenes=8, device="cpu")
    for got, want in ((suite.conditions, want_suite.conditions),
                      (suite.real_traj, want_suite.real_traj),
                      (suite.scenes.obstacles, want_suite.scenes.obstacles)):
        assert torch.equal(got, want)
    z = torch.randn((8, cfg.k, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(
                        ev.EVAL_SUITE_SEED + 1))
    want = ev.evaluate_on_batch(cfg, state, None, want_suite, z=z)
    got = ev.evaluate_fixed(cfg, state, n_scenes=8)
    assert {k: float(v) for k, v in got.items()} == {
        k: float(v) for k, v in want.items()}


def test_sampled_evaluate_draws_batch_then_latents_from_one_generator():
    cfg = _small()
    state = create_train_state(cfg, device="cpu")
    a = ev.evaluate(cfg, state, torch.Generator().manual_seed(2), 16)
    b = ev.evaluate(cfg, state, torch.Generator().manual_seed(2), 16)
    assert {k: float(v) for k, v in a.items()} == {
        k: float(v) for k, v in b.items()}
    assert set(a) == {"eval_mean_pairwise_dist", "eval_ndiv",
                      "eval_endpoint_err", "eval_success_rate",
                      "eval_collision_rate", "eval_mean_score"}
    assert all(np.isfinite(float(v)) for v in a.values())


def test_oneshot_planner_ladder_does_not_depend_on_the_chunk():
    """evaluate_fixed_planner("oneshot") is plan_batch over the whole suite
    with the latents of seed + 3, whatever the scenes per dispatch."""
    cfg = _small("imagecond", n_candidates=24)
    state = create_train_state(cfg, device="cpu")
    outs = [ev.evaluate_fixed_planner(cfg, state, n_scenes=10, seed=3,
                                      scene_chunk=chunk)
            for chunk in (None, 4, 10)]
    assert outs[0] == outs[1] == outs[2]
    suite = ev.make_eval_suite(cfg, 10, 3, device="cpu")
    z = torch.randn((10, 24, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(6))
    result = plan_batch(cfg, state, suite.scenes, suite.conditions, z=z)
    score, reached = ev.plan_batch_result(result)
    assert outs[0] == {
        "eval_plan_best_score": float(np.mean(score.numpy())),
        "eval_plan_reach_rate": float(np.mean(reached.numpy())),
        "eval_plan_n_scenes": 10.0, "eval_planner": "oneshot"}


@pytest.mark.parametrize("planner", ["grad", "trajopt", "ilqr",
                                     "cem+trajopt"])
def test_refining_planners_are_not_ported_yet(planner):
    """The gradient refiners are ported now (the name is kept from when
    they raised): evaluate_fixed_planner(planner) is the refiner's batched
    planner over the whole suite with the noise of seed + 3
    (``planning/refine.py::noise_shape``), whatever the scenes per
    dispatch; an unknown planner is a ValueError naming it.  The mean best
    score within rtol 1e-6: on the CPU a reduction over a path's steps
    and obstacles sums in an order that depends on the tensor's size, and
    the refiners' iterations carry that ulp (measured 2.4e-7)."""
    from ndivplanning_tpu_torch.planning.refine import (
        noise_shape,
        plan_refined_batch,
    )

    cfg = _small("goalcond", n_candidates=48, trajopt_steps=6,
                 grad_refine_steps=6, ilqr_iters=3)
    state = create_train_state(cfg, device="cpu")
    outs = [ev.evaluate_fixed_planner(cfg, state, planner, n_scenes=6,
                                      seed=3, scene_chunk=chunk)
            for chunk in (None, 4)]
    suite = ev.make_eval_suite(cfg, 6, 3, device="cpu")
    noise = torch.randn((6, *noise_shape(cfg, planner)),
                        generator=torch.Generator().manual_seed(6))
    result, _ = plan_refined_batch(cfg, state, suite.scenes,
                                   suite.conditions, planner, noise=noise)
    score, reached = ev.plan_batch_result(result)
    for out in outs:
        best = out.pop("eval_plan_best_score")
        np.testing.assert_allclose(best, float(np.mean(score.numpy())),
                                   rtol=1e-6)
        assert out == {"eval_plan_reach_rate": float(np.mean(
            reached.numpy())), "eval_plan_n_scenes": 6.0,
            "eval_planner": planner}
    with pytest.raises(ValueError, match="unknown planner 'bogus'"):
        ev.evaluate_fixed_planner(cfg, state, planner="bogus", n_scenes=2)


def test_cem_planner_ladder_does_not_depend_on_the_chunk():
    """evaluate_fixed_planner("cem") is plan_cem_batch over the whole
    suite with the noise of seed + 3, whatever the scenes per dispatch."""
    from ndivplanning_tpu_torch.planning.cem import (
        cem_population,
        plan_cem_batch,
    )

    cfg = _small("goalcond", n_candidates=48)
    state = create_train_state(cfg, device="cpu")
    outs = [ev.evaluate_fixed_planner(cfg, state, "cem", n_scenes=10,
                                      seed=3, scene_chunk=chunk)
            for chunk in (None, 4, 10)]
    assert outs[0] == outs[1] == outs[2]
    n, _, iters = cem_population(cfg)
    suite = ev.make_eval_suite(cfg, 10, 3, device="cpu")
    eps = torch.randn((10, iters + 1, n, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(6))
    result, _ = plan_cem_batch(cfg, state, suite.scenes, suite.conditions,
                               eps=eps)
    score, reached = ev.plan_batch_result(result)
    assert outs[0] == {
        "eval_plan_best_score": float(np.mean(score.numpy())),
        "eval_plan_reach_rate": float(np.mean(reached.numpy())),
        "eval_plan_n_scenes": 10.0, "eval_planner": "cem"}


MPC_EPISODE = dict(total_steps=16, replan_every=4, n_candidates=16)
UNICYCLE_EPISODE = dict(total_steps=32, replan_every=8, n_candidates=16)


def test_mpc_suite_does_not_depend_on_the_chunk():
    """evaluate_fixed_mpc is mpc_rollout_batch over the whole suite with
    the latents of seed + 2 drawn at once, whatever the chunk; the keys
    are JAX's."""
    from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch

    cfg = _small("goalcond")
    state = create_train_state(cfg, device="cpu")
    outs = [ev.evaluate_fixed_mpc(cfg, state, n_scenes=10, seed=3,
                                  scene_chunk=chunk, **MPC_EPISODE)
            for chunk in (128, 3, 10)]
    assert outs[0] == outs[1] == outs[2]
    assert set(outs[0]) == {"eval_mpc_success_rate",
                            "eval_mpc_collision_rate", "eval_mpc_total_steps",
                            "eval_mpc_replan_every", "eval_mpc_candidates"}
    suite = ev.make_eval_suite(cfg, 10, 3, device="cpu")
    z = torch.randn((10, 4, 16, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(5))
    result = mpc_rollout_batch(cfg, state, suite.scenes, suite.conditions,
                               z=z, **MPC_EPISODE)
    assert outs[0]["eval_mpc_success_rate"] == float(np.mean(
        result.reached.numpy()))
    assert outs[0]["eval_mpc_collision_rate"] == float(np.mean(
        result.collided.numpy()))
    assert (outs[0]["eval_mpc_total_steps"], outs[0]["eval_mpc_replan_every"],
            outs[0]["eval_mpc_candidates"]) == (16.0, 4.0, 16.0)
    with pytest.raises(ValueError, match="scene_chunk"):
        ev.evaluate_fixed_mpc(cfg, state, n_scenes=2, scene_chunk=0)


def test_mpc_suite_matches_jax_on_unicycle150k():
    """JAX's frozen suite (8 scenes) and its per-scene MPC keys through the
    committed unicycle150k, 32-step episodes replanning every 8 from 16
    candidates: every episode's reached and collided flags
    equal JAX's evaluate_fixed_mpc episodes (mpc_rollout_batch), paths
    within 1e-5, and so its rates."""
    import os

    from ndivplanning_tpu.planning.mpc import (
        mpc_rollout_batch as jax_mpc_batch,
    )
    from ndivplanning_tpu.utils import checkpoint as jax_ckpt
    from ndivplanning_tpu.utils.config import load_config as jax_load_config
    from ndivplanning_tpu_torch.cli import _load_state
    from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch
    from ndivplanning_tpu_torch.utils.config import load_config
    from test_torch_mpc import jax_cycle_latents

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    name, n_scenes = "unicycle150k", 8
    jcfg = jax_load_config(os.path.join(root, "checkpoints", name))
    jstate = jax_ckpt.restore_latest(
        os.path.join(root, "checkpoints", name, "best"), jax_create(jcfg))
    workdir = os.path.join(root, "checkpoints_torch", name)
    state = _load_state(load_config(workdir).replace(workdir=workdir), "cpu")
    cfg = load_config(workdir)
    want_rates = jax_ev.evaluate_fixed_mpc(jcfg, jstate, n_scenes=n_scenes,
                                           **UNICYCLE_EPISODE)
    suite = jax_ev.make_eval_suite(jcfg, n_scenes)
    keys = jax.random.split(jax.random.PRNGKey(jax_ev.EVAL_SUITE_SEED + 2),
                            n_scenes)
    want = jax_mpc_batch(jcfg, jstate, suite.scenes, suite.conditions, keys,
                         **UNICYCLE_EPISODE)
    z = np.stack([jax_cycle_latents(k, 4, 16, cfg.latent_dim)
                  for k in keys])
    batch = _to_torch_batch(suite)
    got = mpc_rollout_batch(cfg, state, batch.scenes, batch.conditions,
                            z=torch.from_numpy(z), **UNICYCLE_EPISODE)
    np.testing.assert_allclose(got.positions.numpy(),
                               np.asarray(want.positions), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.reached.numpy(),
                                  np.asarray(want.reached))
    np.testing.assert_array_equal(got.collided.numpy(),
                                  np.asarray(want.collided))
    assert float(np.mean(got.reached.numpy())) == want_rates[
        "eval_mpc_success_rate"]
    assert float(np.mean(got.collided.numpy())) == want_rates[
        "eval_mpc_collision_rate"]
    assert want_rates["eval_mpc_success_rate"] > 0.0


@pytest.mark.parametrize("env", ["quadrotor", "arm3"])
def test_action_mode_eval_matches_jax(env):
    """Action mode (G emits action sequences; arm3's are 3-D): JAX's
    distilled action batch and latents through converted weights, against
    JAX's evaluate_on_batch.  The endpoint error and the endpoints come
    from the rollout's goal distances and final positions."""
    kw = dict(SMALL, env=env, rollout_mode="actions",
              generator_output="linear", state_dim=3 if env == "arm3" else 2)
    jcfg = jax_get_config("goalcond", **kw)
    jstate = jax_create(jcfg, seed=7)
    cfg = get_config("goalcond", **kw)
    state = create_train_state(cfg, device="cpu")
    for module in (state.g, state.g_ema):
        module.load_state_dict(params_from_flax(
            jax.tree.map(np.asarray, jstate.g_params)))
    key = jax.random.PRNGKey(5)
    jbatch = jax_make_task(jcfg).sample(jax.random.PRNGKey(4),
                                        jcfg.batch_size)
    assert jbatch.real_traj.shape[-1] == cfg.state_dim
    want = jax_ev.evaluate_on_batch(jcfg, jstate, key, jbatch)
    z = np.array(jax.random.normal(key, (jcfg.batch_size, jcfg.k,
                                           jcfg.latent_dim)))
    got = ev.evaluate_on_batch(cfg, state, None, _to_torch_batch(jbatch),
                               z=torch.from_numpy(z))
    assert_metrics_match(got, want, jcfg.batch_size * jcfg.k,
                         NDIV_RTOL_UNTRAINED)
    # Not the waypoint formula: the last action is no position.
    taus = state.g_ema(_to_torch_batch(jbatch).conditions,
                       torch.from_numpy(z))
    last = float(torch.sqrt(torch.sum(torch.square(
        taus[:, :, -1, :2] - torch.from_numpy(np.array(
            jbatch.scenes.goal))[:, None]), dim=-1)).mean())
    assert abs(float(got["eval_endpoint_err"]) - last) > 1e-3


# The vendored family models through JAX's frozen suite and latents: the
# rates within 2 of the suite's samples, the continuous metrics at RTOL,
# but the quadrotor's mean score at 1e-4 (its attitude loop magnifies an
# ulp over 32 steps: measured 1.8e-5 relative).
FAMILY_MODELS = {"unicycle150k": ("unicycle", 120000, RTOL),
                 "reacher150k": ("reacher", 105000, RTOL),
                 "quadrotor150k": ("quadrotor", 30000, 1e-4)}


@pytest.mark.parametrize("name", sorted(FAMILY_MODELS))
def test_family_frozen_suite_matches_jax(name):
    """JAX's frozen suite (128 scenes, the recipes' eval_suite_scenes) and
    latents through the committed torch model, against JAX's
    evaluate_fixed on the JAX checkpoint."""
    import os

    from ndivplanning_tpu.utils import checkpoint as jax_ckpt
    from ndivplanning_tpu.utils.config import load_config as jax_load_config
    from ndivplanning_tpu_torch.cli import _load_state
    from ndivplanning_tpu_torch.utils.config import load_config

    env, step, score_rtol = FAMILY_MODELS[name]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jcfg = jax_load_config(os.path.join(root, "checkpoints", name))
    jstate = jax_ckpt.restore_latest(
        os.path.join(root, "checkpoints", name, "best"), jax_create(jcfg))
    workdir = os.path.join(root, "checkpoints_torch", name)
    cfg = load_config(workdir).replace(workdir=workdir)
    state = _load_state(cfg, "cpu")
    assert cfg.env == env and state.step == step == int(jstate.step)
    n_scenes = cfg.eval_suite_scenes
    want = jax_ev.evaluate_fixed(jcfg, jstate, n_scenes=n_scenes)
    suite = jax_ev.make_eval_suite(jcfg, n_scenes)
    z = np.array(jax.random.normal(
        jax.random.PRNGKey(jax_ev.EVAL_SUITE_SEED + 1),
        (n_scenes, cfg.k, cfg.latent_dim)))
    got = ev.evaluate_on_batch(cfg, state, None, _to_torch_batch(suite),
                               z=torch.from_numpy(z))
    n = n_scenes * cfg.k
    got = {k: float(v) for k, v in got.items()}
    want = {k: float(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key in CONTINUOUS:
        if key in want:
            np.testing.assert_allclose(
                got[key], want[key], err_msg=key,
                rtol=score_rtol if key == "eval_mean_score" else RTOL)
    np.testing.assert_allclose(got["eval_ndiv"], want["eval_ndiv"],
                               rtol=RTOL)
    for key in RATES:
        assert abs(got[key] - want[key]) <= 2.0 / n + 1e-7, key
    # The trained models reach their goals (JAX's recorded best-of-both
    # values: unicycle 1.0, reacher 0.985, quadrotor 0.31).
    assert got["eval_success_rate"] > (0.25 if env == "quadrotor" else 0.9)
