"""CEM latent refinement, the torch port against the JAX package, on the CPU.

``planning/cem.py::plan_cem_batch`` against JAX's with JAX's noise
injected: each scene's key splits ``key, sub = split(key)`` once an
iteration and once more for the final population, and each draws
``normal(sub, (n, zdim))``.  Then the traps of the refit: ties in the
elite, NaN candidates, the best-so-far tracker and slot 0 of the final
population.

Sizes: G/D 32x32, 96 candidates over 5 iterations + 1 (a population of 16,
an elite of 2), 3 scenes.  Tolerance: trajectories, scores and the curve
within 1e-5 (float32 G and rollouts in two packages), the best pick
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.planning import cem as jax_cem
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning import cem
from ndivplanning_tpu_torch.train.state import create_train_state
from test_torch_mpc import SCENES, _cfgs, _models, _mpc_scenes

CEM_TOL = dict(rtol=1e-5, atol=1e-5)
CANDIDATES = 96


def jax_cem_noise(key, iters, n, zdim):
    """``[iters + 1, n, zdim]``: the draws of JAX's CEM from one scene key."""
    out = []
    for _ in range(iters + 1):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (n, zdim))))
    return np.stack(out)


def test_population_split_is_jax():
    for n_cand, iters, want in [(1000, 5, (166, 16, 5)), (96, 5, (16, 2, 5)),
                                (5, 5, (2, 2, 5)), (1000, 0, (1000, 100, 0))]:
        jcfg, cfg = _cfgs("pointmass", n_candidates=n_cand, cem_iters=iters)
        assert cem.cem_population(cfg) == jax_cem.cem_population(jcfg) == want
    assert cem.cem_population(cfg, 30, 2) == jax_cem.cem_population(
        jcfg, 30, 2) == (30, 3, 2)


@pytest.mark.parametrize("env", ["pointmass", "unicycle", "reacher"])
def test_plan_cem_batch_matches_jax(env):
    jcfg, cfg = _cfgs(env, n_candidates=CANDIDATES)
    jstate, state = _models(jcfg, cfg)
    scenes, jscenes, conds = _mpc_scenes()
    keys = jax.random.split(jax.random.PRNGKey(21), SCENES)
    want, want_curve = jax_cem.plan_cem_batch(jcfg, jstate, jscenes,
                                              jnp.asarray(conds), keys)
    n, _, iters = cem.cem_population(cfg)
    eps = np.stack([jax_cem_noise(k, iters, n, cfg.latent_dim)
                    for k in keys])
    got, curve = cem.plan_cem_batch(cfg, state, scenes,
                                    torch.from_numpy(conds),
                                    eps=torch.from_numpy(eps))
    assert curve.shape == (SCENES, iters) and got.taus.shape[1] == n
    np.testing.assert_allclose(curve.numpy(), np.asarray(want_curve),
                               **CEM_TOL)
    for key in ("best_traj", "best_score", "scores", "taus"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   **CEM_TOL, err_msg=key)
    np.testing.assert_array_equal(got.best_reached.numpy(),
                                  np.asarray(want.best_reached))
    # The refined population clusters within ~1e-3, where the Gram-form
    # distances of the diverse pick (both packages) round at about that
    # size: past the first pick (the best) the farthest-point choices are
    # near-ties, in JAX as in the port.  Both take m picks from the
    # better-scoring half.
    want_idx = np.asarray(want.diverse_idx)
    assert got.diverse_idx.shape == want_idx.shape
    np.testing.assert_array_equal(got.diverse_idx[:, 0].numpy(),
                                  want_idx[:, 0])
    ranks = torch.argsort(torch.argsort(got.scores, dim=1, stable=True), 1)
    assert (torch.gather(ranks, 1, got.diverse_idx) < n // 2).all()


def test_plan_cem_is_a_row_of_the_batch():
    _, cfg = _cfgs("unicycle", n_candidates=CANDIDATES)
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    eps = torch.randn((SCENES, 6, 16, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(2))
    batch, curves = cem.plan_cem_batch(cfg, state, scenes,
                                       torch.from_numpy(conds), eps=eps)
    one, curve = cem.plan_cem(cfg, state, scenes.map(lambda t: t[1]),
                              torch.from_numpy(conds[1]), eps=eps[1])
    torch.testing.assert_close(curve, curves[1], **CEM_TOL)
    torch.testing.assert_close(one.best_traj, batch.best_traj[1], **CEM_TOL)
    assert torch.equal(one.diverse_idx, batch.diverse_idx[1])


def test_elite_takes_top_k_order_on_ties():
    """Tied and +inf scores: the elite is ``jax.lax.top_k(-scores)``'s,
    in its order (lowest first, ties by the lower index)."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    scores[:, ::7] = np.inf
    scores[1] = 1.0  # every candidate tied
    got = cem.elite_indices(torch.from_numpy(scores), 9)
    _, want = jax.lax.top_k(-jnp.asarray(scores), 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _poisoned(state, rows):
    """The state's EMA G with the candidates ``rows`` of every population
    made NaN (the rest unchanged)."""
    inner = state.g_ema.forward

    def forward(c, z):
        taus = inner(c, z).clone()
        taus[:, rows] = float("nan")
        return taus

    state.g_ema.forward = forward
    return state


def test_nan_candidates_never_become_elite_or_best():
    """Half of every population NaN: the refit never sees them (mu and
    sigma stay finite, so every later population is finite where G is),
    the tracker and the final pick never take them, and the curve is
    finite and non-increasing."""
    _, cfg = _cfgs("pointmass", n_candidates=CANDIDATES)
    state = _poisoned(create_train_state(cfg, device="cpu"), slice(1, None, 2))
    scenes, _, conds = _mpc_scenes()
    got, curve = cem.plan_cem_batch(cfg, state, scenes,
                                    torch.from_numpy(conds),
                                    torch.Generator().manual_seed(0))
    assert torch.isfinite(curve).all()
    assert torch.isfinite(got.best_score).all()
    assert torch.isfinite(got.best_traj).all()
    assert torch.isnan(got.scores[:, 1::2]).all()
    assert torch.isfinite(got.scores[:, ::2]).all()
    assert (got.best_score <= curve[:, -1]).all()


def test_best_curve_is_monotone_and_slot_zero_holds_the_best():
    """The best-so-far curve never rises, and the final population's slot 0
    re-decodes the tracked best latent: its score is the curve's last
    value, so the plan's best is no worse."""
    _, cfg = _cfgs("unicycle", n_candidates=CANDIDATES, cem_iters=4)
    state = create_train_state(cfg, seed=1, device="cpu")
    scenes, _, conds = _mpc_scenes()
    got, curve = cem.plan_cem_batch(cfg, state, scenes,
                                    torch.from_numpy(conds),
                                    torch.Generator().manual_seed(5))
    assert curve.shape == (SCENES, 4)
    assert (curve[:, 1:] <= curve[:, :-1]).all()
    # Within 1e-6: on the CPU a rollout's bits depend on a candidate's
    # place in the tensor (SLEEF's vector blocks against libm's tail).
    torch.testing.assert_close(got.scores[:, 0], curve[:, -1], rtol=1e-6,
                               atol=1e-6)
    assert (got.best_score <= curve[:, -1]).all()


def test_cem_draws_its_noise_from_the_generator():
    """Without ``eps``, iteration i draws ``[B, n, zdim]`` from the
    generator in order, then the final population: the same seed gives
    the same plan, and injecting those draws gives it bitwise."""
    _, cfg = _cfgs("pointmass", n_candidates=CANDIDATES)
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    conds = torch.from_numpy(conds)
    run = lambda seed: cem.plan_cem_batch(
        cfg, state, scenes, conds, torch.Generator().manual_seed(seed))
    (a, ca), (b, cb), (c, _) = run(3), run(3), run(4)
    assert torch.equal(a.taus, b.taus) and torch.equal(ca, cb)
    assert not torch.equal(a.taus, c.taus)
    gen = torch.Generator().manual_seed(3)
    eps = torch.stack([torch.randn((SCENES, 16, cfg.latent_dim),
                                   generator=gen) for _ in range(6)], dim=1)
    injected, ci = cem.plan_cem_batch(cfg, state, scenes, conds, eps=eps)
    assert torch.equal(injected.taus, a.taus) and torch.equal(ci, ca)


def test_one_iteration_samples_the_prior():
    """Iteration 1 draws from N(0, I): with no refit iteration the
    population is the noise itself, slot 0 the zero latent."""
    _, cfg = _cfgs("pointmass", n_candidates=CANDIDATES, cem_iters=0)
    state = create_train_state(cfg, device="cpu")
    scene = Scene.create([0.2, 0.2], [0.8, 0.8], device="cpu")
    cond = torch.cat([scene.start, scene.goal])
    eps = torch.randn((1, CANDIDATES, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(0))
    got, curve = cem.plan_cem(cfg, state, scene, cond, eps=eps)
    z = eps[0].clone()
    z[0] = 0.0
    want = state.g_ema(cond[None], z[None])[0]
    assert curve.shape == (0,)
    torch.testing.assert_close(got.taus, want, rtol=0, atol=0)
