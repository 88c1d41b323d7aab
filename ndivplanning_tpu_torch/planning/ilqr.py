"""iLQR trajectory refinement, second-order planning for hard dynamics; counterpart of ``ndivplanning_tpu/planning/ilqr.py``.

Each iteration linearises the true dynamics along the nominal trajectory
(``A_t``, ``B_t`` by forward-mode differentiation of the family's
``step``: ``jacfwd``, written out as ``vmap`` of ``jvp``), expands the
cost to second order, solves the time-varying LQR subproblem by a
backward Riccati sweep, and line-searches the closed-loop
update over the step sizes ``_ALPHAS`` at once.  Acceptance and the
Levenberg-style regulariser ``mu`` are branchless (``torch.where``), so an
iteration never waits on the device.  Alpha 0 reproduces the nominal, so
the cost never rises.

iLQR works in action space whatever ``cfg.rollout_mode``: G's waypoints
are bridged to actions through the family's own controller
(``distill_actions``), G's actions pass straight through.  The refined
plan goes back to the config's representation (the executed positions in
waypoint mode, the actions in action mode) and the union of warm starts
and refined candidates is hard-scored, as every refiner does.

Scenes ``[B]`` and warm starts ``n`` are batch axes, the horizon and the
iterations Python loops.  The Jacobians of all ``B n H`` nominal states
come from one ``vmap`` of a forward-mode Jacobian, the cost's gradients
and Hessians likewise.  The line search rolls the alphas out as one more candidate
axis and takes each one's cost from the closed-loop states it visits,
which are bitwise the states of re-rolling its actions (tested), so the
JAX package's second rollout of the chosen actions is not repeated.  The
env's clips take ``jnp.clip``'s derivative on their bounds
(``ops/clip.py``): distilled quadrotor actions sit on the thrust bounds.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import TYPE_CHECKING

import torch
from torch.func import grad, jvp, vmap

from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.rollout import ScoreWeights, distill_actions
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.grad_refine import (
    SoftWeights,
    draw_latents,
    union_plan,
)
from ndivplanning_tpu_torch.planning.planner import PlanResult, candidate_part
from ndivplanning_tpu_torch.train.state import TrainState, gen_params
from ndivplanning_tpu_torch.utils.config import Config

if TYPE_CHECKING:
    from ndivplanning_tpu_torch.parallel.sharded_plan import CandidateSplit

# The line search's step sizes, rolled out together; alpha 0 is the
# nominal, so the branchless accept never moves to a worse trajectory.
_ALPHAS = (1.0, 0.6, 0.3, 0.1, 0.0)


def _state_codec(template):
    """``(ravel, unravel, pos_slice, dim)`` for a family state.

    Float fields ravel in dataclass order (the ``done`` and ``collided``
    latches too) into a last axis of ``dim``: a state whose fields lead
    with the candidate axes of its ``t`` gives ``[..., dim]``.  ``unravel(x,
    ints_from)`` inverts it, taking the integer fields (the step counter,
    outside the linearisation) from a donor state."""
    names = [f.name for f in dataclasses.fields(template)]
    lead = template.t.dim()
    offsets, trails = {}, {}
    off = 0
    for name in names:
        v = getattr(template, name)
        if torch.is_floating_point(v):
            trails[name] = tuple(v.shape[lead:])
            size = max(math.prod(trails[name]), 1)
            offsets[name] = (off, off + size)
            off += size

    def ravel(state) -> torch.Tensor:
        axes = state.t.dim()
        return torch.cat([getattr(state, n).reshape(
            *getattr(state, n).shape[:axes], -1) for n in offsets], dim=-1)

    def unravel(x: torch.Tensor, ints_from):
        kw = {}
        for name in names:
            if name in offsets:
                lo, hi = offsets[name]
                kw[name] = x[..., lo:hi].reshape(*x.shape[:-1],
                                                 *trails[name])
            else:
                kw[name] = getattr(ints_from, name)
        return type(template)(**kw)

    return ravel, unravel, slice(*offsets["pos"]), off


def resolve_ilqr_budget(cfg: Config, n_candidates: int | None = None,
                        n_iters: int | None = None) -> tuple[int, int]:
    """``(n_warm_starts, iterations)``: ``n_candidates / 16`` (an iteration
    linearises H steps and rolls out every alpha) and ``cfg.ilqr_iters``."""
    n = max(cfg.n_candidates // 16, 2) if n_candidates is None else n_candidates
    return n, (cfg.ilqr_iters if n_iters is None else n_iters)


def _solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``a^-1 rhs`` for small systems ``a [..., d, d]``, ``rhs [..., d, m]``:
    Gaussian elimination with partial pivoting, unrolled over ``d`` and
    branchless over the batch, so no library call checks its status on
    the host."""
    d = a.shape[-1]
    rows = list(torch.cat([a, rhs], dim=-1).unbind(-2))
    for j in range(d):
        for i in range(j + 1, d):
            swap = (rows[i][..., j].abs() > rows[j][..., j].abs())[..., None]
            rows[j], rows[i] = (torch.where(swap, rows[i], rows[j]),
                                torch.where(swap, rows[j], rows[i]))
        for i in range(j + 1, d):
            factor = rows[i][..., j] / rows[j][..., j]
            rows[i] = rows[i] - factor[..., None] * rows[j]
    x = [None] * d
    for j in reversed(range(d)):
        acc = rows[j][..., d:]
        for k in range(j + 1, d):
            acc = acc - rows[j][..., k, None] * x[k]
        x[j] = acc / rows[j][..., j, None]
    return torch.stack(x, dim=-2)


def _jacfwd(f, n_diff: int):
    """``torch.func.jacfwd(f, argnums=range(n_diff), has_aux=True)`` for a
    function of vectors: ``f``'s output (a tensor or a tuple of them) and,
    for each output, its Jacobians against each of the first ``n_diff``
    arguments, ``[*out_shape, arg_size]``.  It runs what ``jacfwd`` runs,
    one ``jvp`` per basis direction under ``vmap``, with the basis made on
    the arguments' device: ``jacfwd`` keeps its own bookkeeping in host
    tensors, and no iteration may make one."""
    def jac(*args):
        diff, rest = args[:n_diff], args[n_diff:]
        sizes = [a.shape[-1] for a in diff]
        basis = torch.eye(sum(sizes), dtype=diff[0].dtype,
                          device=diff[0].device).split(sizes, dim=1)
        out = f(*args)
        cols = vmap(lambda *tangents: jvp(lambda *d: f(*d, *rest), diff,
                                          tangents)[1])(*basis)
        splits = [sum(sizes[:i]) for i in range(n_diff + 1)]

        def per_arg(c):
            return tuple(c[lo:hi].movedim(0, -1)
                         for lo, hi in zip(splits, splits[1:]))
        if isinstance(cols, tuple):
            return tuple(per_arg(c) for c in cols), out
        return per_arg(cols), out
    return jac


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


class _Problem:
    """iLQR's problems of one batch: the family's dynamics from the reset of
    scenes ``[B]``, the soft cost, and the programs of their derivatives.
    Candidates are ``[B, N]`` action sequences ``[B, N, H, du]``."""

    def __init__(self, cfg: Config, scenes: Scene, n: int, h: int,
                 soft: SoftWeights):
        self.api = get_env(cfg.env)
        self.params = self.api.make_params()
        self.scenes, self.n, self.h, self.soft = scenes, n, h, soft
        # The cost weights as tensors on the device: under torch.func's
        # grad a Python float in a product becomes a host tensor.
        self.w_control, self.w_obstacle, self.w_goal = (
            torch.full((), w, device=scenes.start.device)
            for w in (soft.control, soft.obstacle, 10.0 * soft.goal))
        self._resets = {}
        self.ravel, self.unravel, self.pos, self.dx = _state_codec(
            self.reset(n))
        self.jac_f = vmap(_jacfwd(self._f_one, 2))
        self.hess_stage = vmap(_jacfwd(grad(self.stage_cost,
                                            argnums=(0, 1)), 2))
        self.hess_term = vmap(_jacfwd(grad(self.term_cost), 1))

    def reset(self, n: int):
        """The reset state of ``n`` candidates a scene, made once."""
        if n not in self._resets:
            self._resets[n] = self.api.reset(self.params, self.scenes, n)
        return self._resets[n]

    def stage_cost(self, x, u, obs, msk):
        """Squared-hinge obstacle cost of the position and control effort,
        over any leading axes of ``x [..., dx]``, ``u [..., du]`` with
        obstacles ``obs [..., M, 3]``: iLQR needs the cost's curvature,
        which the plain hinge lacks."""
        pos = x[..., self.pos]
        dist = torch.sqrt(torch.sum(torch.square(
            pos[..., None, :] - obs[..., :2]), dim=-1) + 1e-12)
        pen = torch.relu(obs[..., 2] + self.soft.margin - dist)
        return (self.w_control * torch.sum(u * u, dim=-1)
                + self.w_obstacle * torch.sum(msk * pen * pen, dim=-1))

    def term_cost(self, x, goal):
        """Squared goal distance at 10x the refiner's goal weight: at 1x the
        control term parks the optimum just outside the goal radius."""
        return self.w_goal * torch.sum(
            torch.square(x[..., self.pos] - goal), dim=-1)

    def rollout(self, u: torch.Tensor) -> list:
        """The states x_0..x_H of actions ``u [B, N, H, du]``."""
        states = [self.reset(u.shape[1])]
        for t in range(self.h):
            states.append(self.api.step(self.params, self.scenes, states[-1],
                                        u[..., t, :])[0])
        return states

    def step_cost(self, state, u_t: torch.Tensor) -> torch.Tensor:
        """``[B, N]``: the stage cost of one step's states and actions."""
        return self.stage_cost(self.ravel(state), u_t,
                               self.scenes.obstacles[:, None],
                               self.scenes.obstacle_mask[:, None])

    def traj_cost(self, states: list, u: torch.Tensor) -> torch.Tensor:
        """``[B, N]``: the cost of a rollout's states and its actions."""
        stage = torch.stack([self.step_cost(states[t], u[..., t, :])
                             for t in range(self.h)], dim=-1)
        return (torch.sum(stage, dim=-1)
                + self.term_cost(self.ravel(states[-1]),
                                 self.scenes.goal[:, None]))

    def _f_one(self, x, u, t, start, goal, obs, msk):
        """One sample's next state: ``x [dx]``, ``u [du]`` in its scene."""
        scene = Scene(start=start, goal=goal, obstacles=obs,
                      obstacle_mask=msk)
        state = self.unravel(x[None], types.SimpleNamespace(t=t[None]))
        return self.ravel(self.api.step(self.params, scene, state,
                                        u[None])[0])[0]

    def linearize(self, states: list, u: torch.Tensor) -> tuple:
        """Along a nominal's states and actions ``u [B, N, H, du]``: the
        dynamics' Jacobians ``A [B, N, H, dx, dx]`` and ``B [..., dx, du]``,
        the stage cost's gradients ``lx``, ``lu`` and Hessian blocks
        ``lxx``, ``luu``, ``lux [..., du, dx]``, and the terminal cost's
        ``vx [B, N, dx]`` and ``vxx``; every (scene, candidate, step) is
        one sample of one ``vmap``."""
        b, n, h, du = u.shape
        dx = self.dx
        xs = torch.stack([self.ravel(s) for s in states[:-1]], dim=2)
        ts = torch.stack([s.t for s in states[:-1]], dim=2).reshape(-1)

        def per_sample(v: torch.Tensor) -> torch.Tensor:
            return v[:, None, None].expand(b, n, h, *v.shape[1:]).reshape(
                -1, *v.shape[1:])

        sc = self.scenes
        flat_x, flat_u = xs.reshape(-1, dx), u.reshape(-1, du)
        obs, msk = per_sample(sc.obstacles), per_sample(sc.obstacle_mask)
        with torch.enable_grad():  # clip's derivative on its bounds
            (a_t, b_t), _ = self.jac_f(flat_x, flat_u, ts,
                                       per_sample(sc.start),
                                       per_sample(sc.goal), obs, msk)
        ((lxx, _), (lux, luu)), (lx, lu) = self.hess_stage(flat_x, flat_u,
                                                           obs, msk)
        (vxx,), vx = self.hess_term(
            self.ravel(states[-1]).reshape(-1, dx),
            sc.goal[:, None].expand(b, n, 2).reshape(-1, 2))
        lead = (b, n, h)
        return (a_t.reshape(*lead, dx, dx), b_t.reshape(*lead, dx, du),
                lx.reshape(*lead, dx), lu.reshape(*lead, du),
                lxx.reshape(*lead, dx, dx), luu.reshape(*lead, du, du),
                lux.reshape(*lead, du, dx), vx.reshape(b, n, dx),
                vxx.reshape(b, n, dx, dx))

    def line_search(self, u_nom: torch.Tensor, xs: torch.Tensor,
                    ks: torch.Tensor, kks: torch.Tensor):
        """Every alpha's closed loop ``u = u_nom + alpha k + K (x - x_nom)``
        at once, as candidates ``[B, alpha * N]``; returns ``(u_cands [B,
        alpha, N, H, du], costs [B, alpha, N], states)``, each cost from
        the states it visits (``states``, bitwise the rollout of its
        actions)."""
        b, n, h, du = u_nom.shape
        n_alpha = len(_ALPHAS)
        # alpha * k for every alpha, [B, alpha, N, H, du]: Python floats,
        # so no host tensor is made.
        alpha_k = torch.stack([alpha * ks for alpha in _ALPHAS], dim=1)
        states, actions = [self.reset(n_alpha * n)], []
        for t in range(h):
            x = self.ravel(states[-1]).reshape(b, n_alpha, n, self.dx)
            u = (u_nom[:, None, :, t] + alpha_k[:, :, :, t]
                 + _mv(kks[:, None, :, t], x - xs[:, None, :, t]))
            actions.append(u.reshape(b, n_alpha * n, du))
            states.append(self.api.step(self.params, self.scenes,
                                        states[-1], actions[-1])[0])
        u_flat = torch.stack(actions, dim=2)
        costs = self.traj_cost(states, u_flat).reshape(b, n_alpha, n)
        return u_flat.reshape(b, n_alpha, n, h, du), costs, states


def _riccati(a_t, b_t, lx, lu, lxx, luu, lux, vx, vxx, mu):
    """The backward Riccati sweep of the time-varying LQR subproblem, with
    ``mu [B, N]`` added to ``Q_uu``; returns the feedforward gains ``k [B,
    N, H, du]`` and the feedback gains ``K [B, N, H, du, dx]``."""
    h, du = a_t.shape[2], b_t.shape[-1]
    reg = mu[..., None, None] * torch.eye(du, device=mu.device)
    ks, kks = [None] * h, [None] * h
    for t in reversed(range(h)):
        a, bm = a_t[:, :, t], b_t[:, :, t]
        qx = lx[:, :, t] + _mv(_t(a), vx)
        qu = lu[:, :, t] + _mv(_t(bm), vx)
        qxx = lxx[:, :, t] + _t(a) @ vxx @ a
        quu = luu[:, :, t] + _t(bm) @ vxx @ bm + reg
        qux = lux[:, :, t] + _t(bm) @ vxx @ a
        sol = -_solve(quu, torch.cat([qu[..., None], qux], dim=-1))
        k, kk = sol[..., 0], sol[..., 1:]
        ks[t], kks[t] = k, kk
        vx = qx + _mv(_t(kk) @ quu, k) + _mv(_t(kk), qu) + _mv(_t(qux), k)
        vxx = qxx + _t(kk) @ quu @ kk + _t(kk) @ qux + _t(qux) @ kk
        vxx = 0.5 * (vxx + _t(vxx))
    return torch.stack(ks, dim=2), torch.stack(kks, dim=2)


def _finite_or_inf(c: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(c), c, torch.full_like(c, math.inf))


def _ilqr_refine(cfg: Config, scenes: Scene, u0: torch.Tensor, n_iters: int,
                 soft: SoftWeights, reg0: float):
    """Refine the action sequences ``u0 [B, n, H, du]`` of scenes ``[B]``;
    returns ``(u_star [B, n, H, du], positions [B, n, H, 2], cost_curve
    [B, n, n_iters])``, the cost after each iteration."""
    b, n, h, du = u0.shape
    prob = _Problem(cfg, scenes, n, h, soft)
    u, states = u0, prob.rollout(u0)
    cost = _finite_or_inf(prob.traj_cost(states, u0))
    mu = torch.full_like(cost, reg0)
    curve = []
    for _ in range(n_iters):
        derivs = prob.linearize(states, u)
        ks, kks = _riccati(*derivs, mu)
        xs = torch.stack([prob.ravel(s) for s in states[:-1]], dim=2)
        u_cands, costs, _ = prob.line_search(u, xs, ks, kks)
        costs = _finite_or_inf(costs)
        best = torch.argmin(costs, dim=1, keepdim=True)  # [B, 1, n]
        best_cost = torch.gather(costs, 1, best)[:, 0]
        improved = best_cost < cost - 1e-9
        chosen = torch.gather(u_cands, 1, best[..., None, None].expand(
            b, 1, n, h, du))[:, 0]
        u = torch.where(improved[..., None, None], chosen, u)
        cost = torch.where(improved, best_cost, cost)
        # Levenberg-style trust region: shrink on progress, grow on a
        # rejected step.
        mu = torch.where(improved, torch.clamp(mu * 0.5, min=1e-6),
                         torch.clamp(mu * 4.0, max=1e6))
        curve.append(cost)
        states = prob.rollout(u)
    positions = torch.stack([s.pos for s in states[1:]], dim=2)
    if not curve:
        return u, positions, cost.new_zeros((b, n, 0))
    return u, positions, torch.stack(curve, dim=-1)


def _warm_start_actions(cfg: Config, scenes: Scene,
                        taus: torch.Tensor) -> torch.Tensor:
    """G's candidates ``[B, n, H, S]`` as iLQR's action sequences: as they
    are in action mode, the family's controller along the waypoints
    otherwise."""
    if cfg.rollout_mode == "actions":
        return taus
    return distill_actions(get_env(cfg.env).make_params(), scenes, taus,
                           cfg.env)


@torch.no_grad()  # the derivatives are torch.func transforms
def plan_ilqr_batch(cfg: Config, state: TrainState, scenes: Scene,
                    conditions: torch.Tensor,
                    generator: torch.Generator | None = None,
                    n_candidates: int | None = None,
                    n_iters: int | None = None,
                    soft: SoftWeights = SoftWeights(), reg0: float = 1.0,
                    n_diverse: int = 8,
                    weights: ScoreWeights = ScoreWeights(),
                    z: torch.Tensor | None = None,
                    shard: CandidateSplit | None = None
                    ) -> tuple[PlanResult, torch.Tensor]:
    """iLQR-refined plans of B stacked scenes, warm-started from G's
    candidates of ``z [B, n, zdim]`` (or a draw from ``generator``);
    returns ``(PlanResult, cost_curve [B, n_iters])``, the warm starts'
    mean cost after each iteration (non-increasing per warm start).
    ``shard`` refines each rank's warm starts of a mesh."""
    n, iters = resolve_ilqr_budget(cfg, n_candidates, n_iters)
    part = candidate_part(shard, n)
    z0 = part.local(draw_latents(cfg, conditions, n, generator, z))
    tau0 = gen_params(cfg, state)(conditions, z0)
    u0 = _warm_start_actions(cfg, scenes, tau0)
    u_star, positions, curves = _ilqr_refine(cfg, scenes, u0, iters, soft,
                                             reg0)
    refined = u_star if cfg.rollout_mode == "actions" else positions
    curve = part.total(part.mean(curves, dim=1))
    return union_plan(cfg, scenes, tau0, refined, n_diverse, weights,
                      part), curve


def plan_ilqr(cfg: Config, state: TrainState, scene: Scene,
              condition: torch.Tensor,
              generator: torch.Generator | None = None,
              n_candidates: int | None = None, n_iters: int | None = None,
              soft: SoftWeights = SoftWeights(), reg0: float = 1.0,
              n_diverse: int = 8, weights: ScoreWeights = ScoreWeights(),
              z: torch.Tensor | None = None
              ) -> tuple[PlanResult, torch.Tensor]:
    """:func:`plan_ilqr_batch` for one scene (``z [n, zdim]``)."""
    result, curve = plan_ilqr_batch(
        cfg, state, Scene.stack([scene]), condition[None], generator,
        n_candidates, n_iters, soft, reg0, n_diverse, weights,
        None if z is None else z[None])
    return PlanResult(*(field[0] for field in result)), curve[0]
