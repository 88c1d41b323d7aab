"""Direct trajectory optimisation and the CEM -> trajopt hybrid, the torch port against the JAX package, on the CPU.

``planning/trajopt.py::plan_trajopt_batch`` against JAX's with its latents
injected, and ``plan_cem_trajopt_batch`` with JAX's noise replayed: the
hybrid splits each scene's key once, ``k_cem, _ = split(key)``, and CEM
draws from ``k_cem`` as ``tests/test_torch_cem.py`` replays it.

60 Adam steps at lr 0.05 on trajectories amplify an ulp: Adam normalises
each coordinate's step, hinge kinks and clip switches fork the paths, and
JAX's own result moves as far under a one-ulp change of its warm starts as
the port lies from it (measured: the curve 6e-4 in both).  So the first
10 steps of the loss curve are held at rtol 1e-5, and the whole curve,
the best scores and the candidates within ``SELF_FACTOR`` times JAX's own
largest move under the warm starts one ulp up and one ulp down, plus
1e-5.  The union contract and the hybrid's seeds (CEM's final population
in ``jax.lax.top_k``'s order) are held exactly.

Sizes: 64 candidates (16 warm starts; the hybrid's CEM population 10 and
its 2 seeds), a horizon of 16, G/D 32x32, 3 scenes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.envs.rollout import ScoreWeights as JaxScoreWeights
from ndivplanning_tpu.planning import cem as jax_cem
from ndivplanning_tpu.planning import grad_refine as jax_gr
from ndivplanning_tpu.planning import trajopt as jax_to
from ndivplanning_tpu_torch.planning import trajopt as to
from ndivplanning_tpu_torch.train.state import create_train_state
from test_torch_cem import jax_cem_noise
from test_torch_grad_refine import jax_latents
from test_torch_mpc import _cfgs, _models, _mpc_scenes

H, CANDIDATES, SCENES = 16, 64, 3
HEAD_STEPS = 10
CURVE_RTOL = 1e-5
SELF_FACTOR = 4.0
SLACK = 1e-5


def _jax_core(jcfg, jscenes, tau0, steps, lr):
    """JAX's ``_trajopt_core`` over the scenes from warm starts ``tau0``."""
    core = functools.partial(jax_to._trajopt_core, jcfg, n_steps=steps,
                             lr=lr, soft=jax_gr.SoftWeights(), n_diverse=8,
                             weights=JaxScoreWeights())
    return jax.jit(jax.vmap(lambda sc, t: core(sc, t)))(jscenes, tau0)


def _self_moves(jcfg, jscenes, tau0, steps, lr, want, want_curve):
    """JAX's own largest move of the curve, the best scores and the
    candidates under its warm starts one ulp up and one ulp down."""
    moves = {"curve": 0.0, "best": 0.0, "taus": 0.0}
    for direction in (jnp.inf, -jnp.inf):
        moved, curve = _jax_core(jcfg, jscenes,
                                 jnp.nextafter(tau0, direction), steps, lr)
        for key, a, b in (("curve", curve, want_curve),
                          ("best", moved.best_score, want.best_score),
                          ("taus", moved.taus, want.taus)):
            moves[key] = max(moves[key], float(jnp.abs(a - b).max()))
    return moves


def _assert_within_self_moves(got, curve, want, want_curve, moves):
    want_curve = np.asarray(want_curve)
    np.testing.assert_allclose(curve[:, :HEAD_STEPS].numpy(),
                               want_curve[:, :HEAD_STEPS], rtol=CURVE_RTOL)
    for key, a, b in (("curve", curve.numpy(), want_curve),
                      ("best", got.best_score.numpy(),
                       np.asarray(want.best_score)),
                      ("taus", got.taus.numpy(), np.asarray(want.taus))):
        gap = float(np.abs(a - b).max())
        assert gap <= SELF_FACTOR * moves[key] + SLACK, (key, gap, moves)


def _union_holds(plan, n):
    """The best of the union is no worse than the warm starts' best."""
    return bool((plan.best_score
                 <= plan.scores[:, :n].min(dim=1).values).all())


def test_budget_is_jax():
    for kw in ({}, dict(n_candidates=64), dict(trajopt_steps=7,
                                               trajopt_lr=0.2)):
        jcfg, cfg = _cfgs("unicycle", **kw)
        assert to.resolve_budget(cfg) == jax_to.resolve_budget(jcfg)
        assert to.resolve_budget(cfg, 8, 3, 0.5) == (8, 3, 0.5)
    assert to.resolve_budget(cfg) == (250, 7, 0.2)


@pytest.mark.parametrize("env,mode", [("pointmass", "waypoints"),
                                      ("unicycle", "waypoints"),
                                      ("reacher", "waypoints"),
                                      ("unicycle", "actions")])
def test_plan_trajopt_batch_matches_jax(env, mode):
    extra = (dict(rollout_mode="actions", generator_output="linear")
             if mode == "actions" else {})
    jcfg, cfg = _cfgs(env, n_candidates=CANDIDATES, horizon=H, **extra)
    jstate, state = _models(jcfg, cfg)
    scenes, jscenes, conds = _mpc_scenes()
    keys = jax.random.split(jax.random.PRNGKey(3), SCENES)
    want, want_curve = jax_to.plan_trajopt_batch(jcfg, jstate, jscenes,
                                                 jnp.asarray(conds), keys)
    n, steps, lr = to.resolve_budget(cfg)
    z = jax_latents(keys, n, cfg.latent_dim)
    got, curve = to.plan_trajopt_batch(cfg, state, scenes,
                                       torch.from_numpy(conds),
                                       z=torch.from_numpy(z))
    assert curve.shape == (SCENES, steps) and got.taus.shape[1] == 2 * n
    # The warm starts are G's candidates of the injected latents.
    np.testing.assert_allclose(got.taus[:, :n].numpy(),
                               np.asarray(want.taus)[:, :n], rtol=1e-5,
                               atol=1e-6)
    moves = _self_moves(jcfg, jscenes, want.taus[:, :n], steps, lr, want,
                        want_curve)
    _assert_within_self_moves(got, curve, want, want_curve, moves)
    assert _union_holds(got, n)


def test_plan_cem_trajopt_batch_matches_jax():
    """The hybrid on the quadrotor, JAX's family for it: CEM's noise from
    ``k_cem``, the seeds (the union's first m candidates) JAX's top_k of
    CEM's final population, then the trajopt stage as above."""
    jcfg, cfg = _cfgs("quadrotor", n_candidates=CANDIDATES, horizon=H)
    jstate, state = _models(jcfg, cfg)
    scenes, jscenes, conds = _mpc_scenes()
    keys = jax.random.split(jax.random.PRNGKey(5), SCENES)
    want, want_curve = jax_to.plan_cem_trajopt_batch(
        jcfg, jstate, jscenes, jnp.asarray(conds), keys)
    n, _, iters = to.cem_population(cfg)
    m = to.cem_seed_count(cfg)
    assert (n, m) == (10, 2)
    eps = np.stack([jax_cem_noise(jax.random.split(k)[0], iters, n,
                                  cfg.latent_dim) for k in keys])
    got, curve = to.plan_cem_trajopt_batch(cfg, state, scenes,
                                           torch.from_numpy(conds),
                                           eps=torch.from_numpy(eps))
    jcem, _ = jax_cem.plan_cem_batch(
        jcfg, jstate, jscenes, jnp.asarray(conds),
        jax.vmap(lambda k: jax.random.split(k)[0])(keys))
    sel = jnp.where(jnp.isfinite(jcem.scores), jcem.scores, jnp.inf)
    _, top = jax.lax.top_k(-sel, m)
    seeds = jnp.take_along_axis(jcem.taus, top[:, :, None, None], axis=1)
    np.testing.assert_allclose(got.taus[:, :m].numpy(), np.asarray(seeds),
                               rtol=1e-5, atol=1e-6)
    _, steps, lr = to.resolve_budget(cfg)
    moves = _self_moves(jcfg, jscenes, seeds, steps, lr, want, want_curve)
    _assert_within_self_moves(got, curve, want, want_curve, moves)
    assert _union_holds(got, m)


def test_plan_trajopt_is_a_row_of_the_batch():
    _, cfg = _cfgs("unicycle", n_candidates=CANDIDATES, horizon=H,
                   trajopt_steps=10)
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    z = torch.randn((SCENES, 16, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(2))
    batch, curves = to.plan_trajopt_batch(cfg, state, scenes,
                                          torch.from_numpy(conds), z=z)
    one, curve = to.plan_trajopt(cfg, state, scenes.map(lambda t: t[2]),
                                 torch.from_numpy(conds[2]), z=z[2])
    torch.testing.assert_close(curve, curves[2], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(one.taus, batch.taus[2], rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(one.diverse_idx, batch.diverse_idx[2])
    assert _union_holds(batch, 16)


def test_plan_cem_trajopt_is_a_row_of_the_batch():
    _, cfg = _cfgs("pointmass", n_candidates=CANDIDATES, horizon=H,
                   trajopt_steps=10)
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    n, _, iters = to.cem_population(cfg)
    eps = torch.randn((SCENES, iters + 1, n, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(6))
    batch, curves = to.plan_cem_trajopt_batch(
        cfg, state, scenes, torch.from_numpy(conds), eps=eps)
    one, curve = to.plan_cem_trajopt(cfg, state, scenes.map(lambda t: t[0]),
                                     torch.from_numpy(conds[0]), eps=eps[0])
    torch.testing.assert_close(curve, curves[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(one.best_score, batch.best_score[0],
                               rtol=1e-5, atol=1e-5)
    assert curves.shape == (SCENES, 10)
