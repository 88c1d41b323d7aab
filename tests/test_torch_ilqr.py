"""iLQR refinement, the torch port against the JAX package, on the CPU.

``planning/ilqr.py`` piece by piece on identical inputs: the state codec
of every family (JAX's field order, so the gains are not permuted), the
dynamics' Jacobians ``A_t``, ``B_t`` against ``jax.jacfwd`` on distilled
warm starts that sit on the quadrotor's thrust bounds (``jnp.clip``'s
slope 0.5 there, ``ops/clip.py``), the cost expansion against
``jax.grad`` / ``jax.hessian``, the Riccati gains against the JAX
package's recursion, the small solve, and the fused line-search cost
against a re-roll.  Then the whole refiner and ``plan_ilqr_batch`` against
JAX's with its latents injected.

Sizes: 64 candidates (4 warm starts) over a horizon of 16, G/D 32x32, 3
scenes, 8 iterations (36 in the JAX config; the curve's parity does not
change with the count, and each iteration costs ~0.1 s here).
Tolerances: Jacobians and cost derivatives within 1e-5 of their largest
|entry|; gains at rtol 1e-4 (a solve of Q_uu, whose conditioning scales
the ulps); the curve and the refined actions at rtol 1e-5 (the quadrotor's
attitude loop and arm3's three-joint kinematics at 1e-4; the quadrotor's
refiner over 8 iterations within JAX's own one-ulp move, see
``test_ilqr_refine_matches_jax``); the best score within 1e-5 and the pick a
near-tie of JAX's: its JAX score within 1e-5 of JAX's best (refined warm
starts converge onto one optimum, so their scores tie to ~1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ndivplanning_tpu.envs.registry import get_env as jax_get_env
from ndivplanning_tpu.planning import grad_refine as jax_gr
from ndivplanning_tpu.planning import ilqr as jax_ilqr
from ndivplanning_tpu_torch.envs.registry import FAMILIES, get_env
from ndivplanning_tpu_torch.envs.rollout import distill_actions
from ndivplanning_tpu_torch.planning import ilqr
from ndivplanning_tpu_torch.planning.grad_refine import SoftWeights
from ndivplanning_tpu_torch.train.state import create_train_state
from ndivplanning_tpu_torch.utils.config import get_config
from test_torch_envs import _both, _scenes, _waypoints
from test_torch_grad_refine import jax_latents
from test_torch_mpc import _cfgs, _models, _mpc_scenes

H, CANDIDATES, SCENES, ITERS, N = 16, 64, 3, 8, 4
DERIV_ATOL_OF_MAX = 1e-5
GAIN_RTOL = 1e-4
CURVE_RTOL = {"quadrotor": 1e-4, "arm3": 1e-4}
SELF_FACTOR = 4.0


def _warm_starts(env, seed=0, n=N, h=H):
    """Both packages' scenes and the port's distilled actions of noisy
    waypoint paths (the controller's, so the quadrotor's rotor commands sit
    on their clip bounds; ``tests/test_torch_action_mode.py`` holds them
    against JAX's): (port scenes, JAX scenes, u0 [B, n, h, du] numpy), the
    one input of both packages."""
    rng = np.random.default_rng(seed)
    arrays = _scenes(rng, SCENES)
    scenes, jscenes = _both(arrays)
    taus = _waypoints(rng, arrays[0], arrays[1], n, h, noise=0.1)
    u0 = distill_actions(get_env(env).make_params(), scenes,
                         torch.from_numpy(taus), env)
    return scenes, jscenes, u0.numpy()


def _cfg(env, **kw):
    return get_config("goalcond", env=env, horizon=H, **kw)


def _jax_f_vec(env, ravel, unravel):
    api = jax_get_env(env)
    params = api.make_params()

    def f_vec(x, u, scene, ints_from):
        new, _ = api.step(params, scene, unravel(x, ints_from), u)
        return ravel(new)
    return f_vec


@pytest.mark.parametrize("env", FAMILIES)
def test_state_codec_is_jax_on_every_family(env):
    """Dataclass order, latches included: a live state (8 steps of noisy
    paths, so every field holds its own values) ravels as JAX's does, to
    ``[B, N, dim]``; unravel inverts it, the int ``t`` from the donor."""
    scenes, jscenes, u0 = _warm_starts(env)
    api, japi = get_env(env), jax_get_env(env)
    state = api.reset(api.make_params(), scenes, N)
    for t in range(8):
        state, _ = api.step(api.make_params(), scenes, state,
                            torch.from_numpy(u0[:, :, t]))
    ravel, unravel, pos, dim = ilqr._state_codec(state)
    x = ravel(state)
    jstate = japi.reset(japi.make_params(), jax.tree.map(lambda a: a[0],
                                                         jscenes))
    jravel, _, jpos, jdim = jax_ilqr._state_codec(jstate)
    assert (dim, pos) == (jdim, jpos) and x.shape == (SCENES, N, dim)
    want = np.stack([[np.asarray(jravel(type(jstate)(**{
        f.name: jnp.asarray(getattr(state, f.name)[b, i].numpy())
        for f in dataclasses.fields(jstate)}))) for i in range(N)]
        for b in range(SCENES)])
    np.testing.assert_array_equal(x.numpy(), want)
    back = unravel(x, state)
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(back, f.name), getattr(state, f.name))
    assert torch.equal(x[..., pos], state.pos)


@pytest.mark.parametrize("env", FAMILIES)
def test_jacobians_match_jax_on_the_clip_bounds(env):
    """``A_t``, ``B_t`` of every nominal (scene, warm start, step) by one
    vmapped ``jacfwd`` against JAX's ``jacfwd`` of the same step on the
    same states.  The quadrotor's distilled rotor commands sit on their
    bounds: there ``B_t`` takes ``jnp.clip``'s slope 0.5, which
    ``torch.clamp``'s 1 would double."""
    scenes, jscenes, u0 = _warm_starts(env)
    prob = ilqr._Problem(_cfg(env), scenes, N, H, SoftWeights())
    u = torch.from_numpy(u0)
    states = prob.rollout(u)
    a_t, b_t = prob.linearize(states, u)[:2]
    jstate0 = jax_get_env(env).reset(jax_get_env(env).make_params(),
                                     jax.tree.map(lambda a: a[0], jscenes))
    jravel, junravel, _, _ = jax_ilqr._state_codec(jstate0)
    f_vec = _jax_f_vec(env, jravel, junravel)
    jac = jax.jit(jax.vmap(jax.vmap(jax.vmap(
        lambda x, uu, sc: jax.jacfwd(f_vec, (0, 1))(x, uu, sc, jstate0),
        in_axes=(0, 0, None)), in_axes=(0, 0, None))))
    xs = torch.stack([prob.ravel(s) for s in states[:-1]], dim=2)
    want_a, want_b = jac(jnp.asarray(xs.numpy()), jnp.asarray(u0), jscenes)
    for got, want in ((a_t, want_a), (b_t, want_b)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=DERIV_ATOL_OF_MAX
                                   * float(np.abs(want).max()))
    if env == "quadrotor":
        on_bound = (u0 == 0.0) | (u0 == 1.5)
        assert on_bound.mean() > 0.1
        # d vel_y' / d u of a level, live quadrotor on a bound: 0.5 dt / m.
        half = b_t.numpy()[..., 3, :][on_bound]
        assert (np.abs(half) > 0).any()
        assert np.isclose(np.abs(half[np.abs(half) > 0]).max()
                          / np.abs(b_t.numpy()[..., 3, :][~on_bound]).max(),
                          0.5, rtol=0.2)


@pytest.mark.parametrize("env", ["pointmass", "unicycle", "arm3"])
def test_cost_expansion_matches_jax(env):
    """``lx, lu, lxx, luu, lux`` of the stage cost at every nominal sample
    and ``vx, vxx`` of the terminal cost against JAX's ``grad`` /
    ``hessian`` / ``jacfwd(grad)``, with the squared hinge live."""
    scenes, jscenes, u0 = _warm_starts(env, seed=2)
    prob = ilqr._Problem(_cfg(env), scenes, N, H, SoftWeights())
    u = torch.from_numpy(u0)
    states = prob.rollout(u)
    got = prob.linearize(states, u)[2:]
    xs = torch.stack([prob.ravel(s) for s in states[:-1]], dim=2).numpy()
    soft, pos = jax_gr.SoftWeights(), prob.pos

    # JAX's stage and terminal costs, as its _ilqr_refine writes them.
    def stage(x, uu, sc):
        p = x[pos]
        dist = jnp.sqrt(jnp.sum(jnp.square(p[None] - sc.obstacles[:, :2]),
                                -1) + 1e-12)
        pen = jax.nn.relu(sc.obstacles[:, 2] + soft.margin - dist)
        return (soft.control * jnp.sum(uu * uu) + soft.obstacle
                * jnp.sum(sc.obstacle_mask * pen * pen))

    def term(x, sc):
        return 10.0 * soft.goal * jnp.sum(jnp.square(x[pos] - sc.goal))

    over = lambda f: jax.vmap(jax.vmap(jax.vmap(f, (0, 0, None)),
                                       (0, 0, None)), (0, 0, 0))
    args = (jnp.asarray(xs), jnp.asarray(u0), jscenes)
    want = [over(jax.grad(stage, 0))(*args), over(jax.grad(stage, 1))(*args),
            over(jax.hessian(stage, 0))(*args),
            over(jax.hessian(stage, 1))(*args),
            over(jax.jacfwd(jax.grad(stage, 1), 0))(*args)]
    last = jnp.asarray(prob.ravel(states[-1]).numpy())
    term_over = lambda f: jax.vmap(jax.vmap(f, (0, None)), (0, 0))
    want += [term_over(jax.grad(term))(last, jscenes),
             term_over(jax.hessian(term))(last, jscenes)]
    assert float(np.abs(np.asarray(want[2])).max()) > 20.0  # hinge live
    for name, g, w in zip(("lx", "lu", "lxx", "luu", "lux", "vx", "vxx"),
                          got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=DERIV_ATOL_OF_MAX
                                   * float(np.abs(w).max()), err_msg=name)


def _jax_riccati(a_t, b_t, lx, lu, lxx, luu, lux, vx, vxx, mu):
    """The JAX package's backward sweep (``_ilqr_refine``'s ``riccati``,
    as ``ndivplanning_tpu/planning/ilqr.py`` writes it) for one candidate."""
    du = b_t.shape[-1]

    def riccati(carry, inp):
        vx, vxx = carry
        a, b, lx_t, lu_t, lxx_t, luu_t, lux_t = inp
        qx = lx_t + a.T @ vx
        qu = lu_t + b.T @ vx
        qxx = lxx_t + a.T @ vxx @ a
        quu = luu_t + b.T @ vxx @ b + mu * jnp.eye(du)
        qux = lux_t + b.T @ vxx @ a
        k = -jnp.linalg.solve(quu, qu)
        kk = -jnp.linalg.solve(quu, qux)
        vx_n = qx + kk.T @ quu @ k + kk.T @ qu + qux.T @ k
        vxx_n = qxx + kk.T @ quu @ kk + kk.T @ qux + qux.T @ kk
        return (vx_n, 0.5 * (vxx_n + vxx_n.T)), (k, kk)

    _, (ks, kks) = jax.lax.scan(riccati, (vx, vxx),
                                (a_t, b_t, lx, lu, lxx, luu, lux),
                                reverse=True)
    return ks, kks


@pytest.mark.parametrize("env", ["unicycle", "quadrotor", "arm3"])
def test_riccati_gains_match_jax(env):
    """The gains ``k``, ``K`` of the port's batched sweep against the JAX
    package's recursion on the same expansion (2x2 and, for arm3, 3x3
    ``Q_uu``), at a per-candidate ``mu``."""
    scenes, _, u0 = _warm_starts(env, seed=4)
    prob = ilqr._Problem(_cfg(env), scenes, N, H, SoftWeights())
    u = torch.from_numpy(u0)
    derivs = prob.linearize(prob.rollout(u), u)
    mu = torch.tensor([[1.0, 0.5, 1e-3, 4.0]] * SCENES)
    ks, kks = ilqr._riccati(*derivs, mu)
    sweep = jax.jit(jax.vmap(jax.vmap(_jax_riccati)))
    want_k, want_kk = sweep(*(jnp.asarray(d.numpy()) for d in derivs),
                            jnp.asarray(mu.numpy()))
    for got, want in ((ks, want_k), (kks, want_kk)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=GAIN_RTOL,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("d", [2, 3])
def test_small_solve_matches_lu(d):
    """The unrolled elimination against float64 LU, on well-conditioned
    and on pivoting-needing (tiny leading entry) systems."""
    g = torch.Generator().manual_seed(d)
    a = torch.randn((64, d, d), generator=g) + 2.0 * torch.eye(d)
    a[::4, 0, 0] = 1e-6  # needs a row swap
    rhs = torch.randn((64, d, 1 + d), generator=g)
    want = torch.linalg.solve(a.double(), rhs.double())
    torch.testing.assert_close(ilqr._solve(a, rhs).double(), want,
                               rtol=1e-4, atol=1e-4)


def test_fused_line_search_cost_is_bitwise_the_reroll():
    """Each alpha's cost comes from the closed-loop states it visits:
    re-rolling its actions gives those states and that cost bitwise."""
    env = "quadrotor"
    scenes, _, u0 = _warm_starts(env, seed=6)
    prob = ilqr._Problem(_cfg(env), scenes, N, H, SoftWeights())
    u = torch.from_numpy(u0)
    states = prob.rollout(u)
    derivs = prob.linearize(states, u)
    ks, kks = ilqr._riccati(*derivs, torch.ones((SCENES, N)))
    xs = torch.stack([prob.ravel(s) for s in states[:-1]], dim=2)
    u_cands, costs, visited = prob.line_search(u, xs, ks, kks)
    flat = u_cands.reshape(SCENES, -1, H, u.shape[-1])
    again = prob.rollout(flat)
    for a, b in zip(visited, again):
        assert torch.equal(prob.ravel(a), prob.ravel(b))
    assert torch.equal(costs.reshape(SCENES, -1),
                       prob.traj_cost(again, flat))
    # Alpha 0 is the nominal: its actions are u itself.
    assert torch.equal(u_cands[:, -1], u)


@pytest.mark.parametrize("env", ["pointmass", "unicycle", "quadrotor"])
def test_ilqr_refine_matches_jax(env):
    """The refiner from distilled warm starts against JAX's: the cost
    after each iteration (non-increasing) and the refined actions and
    paths.  On the quadrotor an accept or an alpha can flip on an ulp and
    the attitude loop forks the path from there, in JAX too: its gaps are
    held within SELF_FACTOR times JAX's own largest move under the scenes'
    starts one ulp up and one ulp down, plus 1e-5."""
    scenes, jscenes, u0 = _warm_starts(env, seed=8)
    got = ilqr._ilqr_refine(_cfg(env), scenes, torch.from_numpy(u0), ITERS,
                            SoftWeights(), 1.0)
    jcfg = _cfgs(env, horizon=H)[0]
    refine = jax.jit(jax.vmap(jax.vmap(
        lambda sc, uu: jax_ilqr._ilqr_refine(jcfg, sc, uu, ITERS,
                                             jax_gr.SoftWeights(), 1.0),
        in_axes=(None, 0))))
    want = [np.asarray(w) for w in refine(jscenes, jnp.asarray(u0))]
    got = [g.numpy() for g in got]
    if env == "quadrotor":
        moves = [0.0] * 3
        for direction in (jnp.inf, -jnp.inf):
            moved = refine(dataclasses.replace(
                jscenes, start=jnp.nextafter(jscenes.start, direction)),
                jnp.asarray(u0))
            moves = [max(m, float(np.abs(np.asarray(a) - w).max()))
                     for m, a, w in zip(moves, moved, want)]
        for name, g, w, m in zip(("u", "positions", "curve"), got, want,
                                 moves):
            gap = float(np.abs(g - w).max())
            assert gap <= SELF_FACTOR * m + 1e-5, (name, gap, m)
    else:
        for name, g, w in zip(("u", "positions", "curve"), got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    c = got[2]
    assert (np.diff(c, axis=-1) <= 0).all() and (c[..., -1] < c[..., 0]).any()


@pytest.mark.parametrize("env,mode", [("pointmass", "waypoints"),
                                      ("quadrotor", "waypoints"),
                                      ("arm3", "actions")])
def test_plan_ilqr_batch_matches_jax(env, mode):
    extra = (dict(rollout_mode="actions", generator_output="linear",
                  state_dim=3) if mode == "actions" else {})
    jcfg, cfg = _cfgs(env, n_candidates=CANDIDATES, horizon=H,
                      ilqr_iters=ITERS, **extra)
    jstate, state = _models(jcfg, cfg)
    scenes, jscenes, conds = _mpc_scenes()
    keys = jax.random.split(jax.random.PRNGKey(3), SCENES)
    want, want_curve = jax_ilqr.plan_ilqr_batch(jcfg, jstate, jscenes,
                                                jnp.asarray(conds), keys)
    n, iters = ilqr.resolve_ilqr_budget(cfg)
    assert (n, iters) == jax_ilqr.resolve_ilqr_budget(jcfg) == (N, ITERS)
    z = jax_latents(keys, n, cfg.latent_dim)
    got, curve = ilqr.plan_ilqr_batch(cfg, state, scenes,
                                      torch.from_numpy(conds),
                                      z=torch.from_numpy(z))
    rtol = CURVE_RTOL.get(env, 1e-5)
    np.testing.assert_allclose(curve.numpy(), np.asarray(want_curve),
                               rtol=rtol)
    want_scores = np.asarray(want.scores)
    np.testing.assert_allclose(got.scores.numpy(), want_scores, rtol=rtol,
                               atol=1e-5)
    np.testing.assert_allclose(got.best_score.numpy(),
                               np.asarray(want.best_score), rtol=rtol,
                               atol=1e-5)
    picked = np.take_along_axis(want_scores,
                                got.diverse_idx[:, :1].numpy(), 1)[:, 0]
    np.testing.assert_allclose(picked, np.asarray(want.best_score),
                               rtol=rtol, atol=1e-5)
    # The pool: picks from the better-scoring half of the 2n union.
    ranks = np.argsort(np.argsort(want_scores, axis=1, kind="stable"), 1)
    assert (np.take_along_axis(ranks, got.diverse_idx.numpy(), 1)
            < n + 1).all()
    assert (got.best_score <= got.scores[:, :n].min(dim=1).values).all()


def test_plan_ilqr_is_a_row_of_the_batch():
    _, cfg = _cfgs("unicycle", n_candidates=CANDIDATES, horizon=H,
                   ilqr_iters=4)
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    z = torch.randn((SCENES, N, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(2))
    batch, curves = ilqr.plan_ilqr_batch(cfg, state, scenes,
                                         torch.from_numpy(conds), z=z)
    one, curve = ilqr.plan_ilqr(cfg, state, scenes.map(lambda t: t[1]),
                                torch.from_numpy(conds[1]), z=z[1])
    torch.testing.assert_close(curve, curves[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(one.best_score, batch.best_score[1],
                               rtol=1e-5, atol=1e-6)
    assert curves.shape == (SCENES, 4)
