"""Gradient latent refinement and its pieces, the torch port against the JAX package, on the CPU.

``planning/grad_refine.py``: the soft cost and its gradient against
``jax.value_and_grad`` in every family, the clip rule it needs
(``ops/clip.py``: ``jnp.clip``'s slope 0.5 on a bound, in reverse and
forward mode), the refiners' Adam (``train/state.py::adam_update``)
against ``optax.adam``, and ``plan_grad_batch`` against JAX's with its
latents injected (each scene's key draws ``normal(key, (n, zdim))``).

Sizes: the JAX refiner tests' budget, 64 candidates (16 latents) over a
horizon of 16, G/D 32x32, 3 scenes.  Tolerances: the soft cost at rtol
1e-5; its gradient within 1e-4 of its largest |entry| (the arms' DLS
gains scale an ulp of the rollout by ~60, measured 3e-5); the plan's
curve, scores and candidates at 1e-5 (12 Adam steps on latents stay
within 1e-6, measured); the best score at 1e-5 and the best pick equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ndivplanning_tpu.planning import grad_refine as jax_gr
from ndivplanning_tpu.utils.config import get_config as jax_get_config
from ndivplanning_tpu_torch.envs.registry import FAMILIES
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.ops.clip import clip
from ndivplanning_tpu_torch.planning import grad_refine as gr
from ndivplanning_tpu_torch.train.state import adam_update, create_train_state
from ndivplanning_tpu_torch.utils.config import get_config
from test_torch_envs import QUAD_PARITY_H, _both, _scenes, _waypoints
from test_torch_mpc import _cfgs, _models, _mpc_scenes

H, CANDIDATES, SCENES = 16, 64, 3
COST_RTOL = 1e-5
GRAD_ATOL_OF_MAX = 1e-4
PLAN_TOL = dict(rtol=1e-5, atol=1e-5)


def jax_latents(keys, n, zdim):
    """``[B, n, zdim]``: each scene key's ``normal(key, (n, zdim))``."""
    return np.stack([np.asarray(jax.random.normal(k, (n, zdim)))
                     for k in keys])


def _penetrating(rng, arrays, n, h=H):
    """Paths through the scenes' obstacles: straight lines from start to
    goal (which the random discs lie across), some bent through a disc
    centre, and one path that stands still (zero-length segments)."""
    taus = _waypoints(rng, arrays[0], arrays[1], n, h, noise=0.02)
    taus[:, 1, h // 2:] = arrays[2][:, None, 0, :2]
    taus[:, 2] = arrays[0][:, None, :]
    return taus


@pytest.mark.parametrize("env", FAMILIES)
def test_soft_cost_and_its_gradient_match_jax(env):
    """The per-scene mean soft cost of 8 paths in 3 scenes and its gradient
    against JAX's ``value_and_grad`` of ``soft_cost_taus``, through each
    family's controller and dynamics; the penetration term is live.  The
    point mass's path that stands still has a NaN gradient in both
    packages (the speed clip's sqrt at rest): NaN where JAX has NaN.  The
    quadrotor's attitude loop multiplies an ulp by ~100 a step, so it is
    held over QUAD_PARITY_H steps, as ``tests/test_torch_envs.py`` does."""
    h = QUAD_PARITY_H if env == "quadrotor" else H
    rng = np.random.default_rng(7)
    arrays = _scenes(rng, SCENES)
    scenes, jscenes = _both(arrays)
    taus = _penetrating(rng, arrays, 8, h)
    cfg = get_config("goalcond", env=env, horizon=h)
    jcfg = jax_get_config("goalcond", env=env, horizon=h)
    t = torch.from_numpy(taus).requires_grad_(True)
    cost = gr.soft_cost_taus(cfg, scenes, t, gr.SoftWeights())
    grad, = torch.autograd.grad(cost.sum(), t)
    want, want_grad = jax.vmap(lambda sc, tau: jax.value_and_grad(
        lambda x: jax_gr.soft_cost_taus(jcfg, sc, x, jax_gr.SoftWeights()))(
            tau))(jscenes, jnp.asarray(taus))
    want_grad = np.asarray(want_grad)
    assert cost.shape == (SCENES,)
    np.testing.assert_allclose(cost.detach().numpy(), np.asarray(want),
                               rtol=COST_RTOL)
    np.testing.assert_allclose(
        grad.numpy(), want_grad, rtol=1e-4,
        atol=GRAD_ATOL_OF_MAX * float(np.nanmax(np.abs(want_grad))))
    res = gr.score_rollouts(cfg, scenes, t.detach(), gr.ScoreWeights())
    assert float(gr._segments_penetration(scenes, res.positions,
                                          0.02).max()) > 0.0


def test_segments_penetration_matches_jax():
    """The swept-segment hinge of paths that cross discs, stand still and
    touch a disc's rim, against JAX's ``_segments_penetration``."""
    rng = np.random.default_rng(3)
    arrays = _scenes(rng, SCENES)
    scenes, jscenes = _both(arrays)
    pos = _penetrating(rng, arrays, 6)
    got = gr._segments_penetration(scenes, torch.from_numpy(pos), 0.02)
    want = jax.vmap(lambda sc, p: jax.vmap(
        lambda q: jax_gr._segments_penetration(sc, sc.start, q, 0.02))(p))(
            jscenes, jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert float(got.min()) == 0.0 and float(got.max()) > 0.0


CLIP_POINTS = [-2.0, -1.0, -0.5, 0.0, 0.25, 1.0, 1.5, float("nan")]


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (0.0, 1.5), (0.0, None),
                                   (None, 1.0)])
def test_clip_derivative_is_jax_on_the_bounds(lo, hi):
    """``clip`` is ``torch.clamp`` bitwise in value; its derivative is
    ``jnp.clip``'s (``jnp.maximum`` / ``jnp.minimum`` for one bound): 0.5
    on a bound, under backward, ``torch.func.jacfwd`` and ``vmap`` of it
    alike; without autograd it is ``torch.clamp`` itself."""
    x = torch.tensor(CLIP_POINTS)
    if lo is None:
        jfn = lambda v: jnp.minimum(v, hi)
    elif hi is None:
        jfn = lambda v: jnp.maximum(v, lo)
    else:
        jfn = lambda v: jnp.clip(v, lo, hi)
    want = np.asarray(jax.vmap(jax.grad(jfn))(jnp.asarray(x.numpy())))
    want_fwd = np.asarray(jax.vmap(jax.jacfwd(jfn))(jnp.asarray(x.numpy())))
    xv = x.clone().requires_grad_(True)
    y = clip(xv, lo, hi)
    assert torch.equal(y.detach().nan_to_num(7.0),
                       torch.clamp(x, lo, hi).nan_to_num(7.0))
    back, = torch.autograd.grad(y.sum(), xv)
    fwd = torch.func.vmap(torch.func.jacfwd(lambda v: clip(v, lo, hi)))(x)
    np.testing.assert_array_equal(back.numpy(), want)
    np.testing.assert_array_equal(fwd.numpy(), want_fwd)
    assert 0.5 in want.tolist()
    with torch.no_grad():
        assert clip(xv, lo, hi).grad_fn is None


def test_adam_update_is_optax_adam():
    """Twelve updates of ``adam_update`` on a ``[B, n, zdim]`` tensor from a
    gradient sequence against ``optax.adam(0.1)``: bitwise, as the train
    step's Adam is."""
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 16, 2)).astype(np.float32)
    grads = rng.normal(size=(12, 3, 16, 2)).astype(np.float32)
    grads[3] *= 1e-6  # tiny grads: the normalised step is the whole lr
    opt = optax.adam(0.1)
    jx, st = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    x = torch.from_numpy(x0.copy())
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    for i, g in enumerate(grads):
        upd, st = opt.update(jnp.asarray(g), st, jx)
        jx = optax.apply_updates(jx, upd)
        adam_update([x], [torch.from_numpy(g)], [mu], [nu], i + 1, 0.1,
                    gr.ADAM_B1, gr.ADAM_B2)
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


@pytest.mark.parametrize("env", ["pointmass", "unicycle", "reacher"])
def test_plan_grad_batch_matches_jax(env):
    jcfg, cfg = _cfgs(env, n_candidates=CANDIDATES, horizon=H)
    jstate, state = _models(jcfg, cfg)
    scenes, jscenes, conds = _mpc_scenes()
    keys = jax.random.split(jax.random.PRNGKey(3), SCENES)
    want, want_curve = jax_gr.plan_grad_batch(jcfg, jstate, jscenes,
                                              jnp.asarray(conds), keys)
    n, steps = gr.grad_budget(cfg)
    assert (n, steps) == (16, jcfg.grad_refine_steps)
    z = jax_latents(keys, n, cfg.latent_dim)
    got, curve = gr.plan_grad_batch(cfg, state, scenes,
                                    torch.from_numpy(conds),
                                    z=torch.from_numpy(z))
    assert curve.shape == (SCENES, steps) and got.taus.shape[1] == 2 * n
    np.testing.assert_allclose(curve.numpy(), np.asarray(want_curve),
                               **PLAN_TOL)
    for key in ("best_traj", "best_score", "scores", "taus"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   **PLAN_TOL, err_msg=key)
    np.testing.assert_array_equal(got.best_reached.numpy(),
                                  np.asarray(want.best_reached))
    np.testing.assert_array_equal(got.diverse_idx[:, 0].numpy(),
                                  np.asarray(want.diverse_idx)[:, 0])


def test_plan_grad_is_a_row_of_the_batch_and_never_loses_to_its_prior():
    """The single-scene planner is the batch's row; the union's best score
    is at most the prior draw's best (its first n scores), and the loss
    curve falls over the 12 steps."""
    _, cfg = _cfgs("unicycle", n_candidates=CANDIDATES, horizon=H)
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    z = torch.randn((SCENES, 16, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(2))
    batch, curves = gr.plan_grad_batch(cfg, state, scenes,
                                       torch.from_numpy(conds), z=z)
    one, curve = gr.plan_grad(cfg, state, scenes.map(lambda t: t[1]),
                              torch.from_numpy(conds[1]), z=z[1])
    torch.testing.assert_close(curve, curves[1], **PLAN_TOL)
    torch.testing.assert_close(one.best_score, batch.best_score[1],
                               **PLAN_TOL)
    assert torch.equal(one.diverse_idx, batch.diverse_idx[1])
    prior_best = batch.scores[:, :16].min(dim=1).values
    assert (batch.best_score <= prior_best).all()
    assert (curves[:, -1] < curves[:, 0]).all()


def test_plan_grad_draws_its_latents_from_the_generator():
    """Without ``z`` the latents are ``randn((B, n, zdim))`` from the
    generator: injecting that draw gives the same plan bitwise."""
    _, cfg = _cfgs("pointmass", n_candidates=CANDIDATES, horizon=H)
    state = create_train_state(cfg, device="cpu")
    scenes, _, conds = _mpc_scenes()
    conds = torch.from_numpy(conds)
    drawn, c1 = gr.plan_grad_batch(cfg, state, scenes, conds,
                                   torch.Generator().manual_seed(4))
    z = torch.randn((SCENES, 16, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(4))
    injected, c2 = gr.plan_grad_batch(cfg, state, scenes, conds, z=z)
    assert torch.equal(drawn.taus, injected.taus) and torch.equal(c1, c2)
    assert torch.equal(drawn.taus[:, :16], state.g_ema(conds, z))


def test_refiners_take_no_gradient_into_g():
    """The refiners differentiate the latents only: G's parameters get no
    ``.grad`` (the raw G plans when the config tracks no EMA)."""
    _, cfg = _cfgs("pointmass", n_candidates=CANDIDATES, horizon=H,
                   g_ema_decay=0.0)
    state = create_train_state(cfg, device="cpu")
    scenes = Scene.stack([Scene.create([0.2, 0.2], [0.8, 0.7], device="cpu")])
    cond = torch.tensor([[0.2, 0.2, 0.8, 0.7]])
    gr.plan_grad_batch(cfg, state, scenes, cond,
                       torch.Generator().manual_seed(0), n_steps=3)
    assert all(p.grad is None for p in state.g.parameters())
