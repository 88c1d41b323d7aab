"""CEM latent refinement, iterative sim-in-the-loop planning; counterpart of ``ndivplanning_tpu/planning/cem.py``.

The cross-entropy method in the generator's latent space: each iteration
draws a population of latents from a diagonal Gaussian, decodes them
through G, scores the trajectories in the simulator and refits the
Gaussian to the elite.  Iteration 1 samples the N(0, I) prior, the
one-shot planner's proposal, and the best-so-far latent is tracked across
iterations and put at slot 0 of the final population, so the final best
score never exceeds the best of any iteration.

Scenes are a batch axis ``[B]`` and the population an axis ``n``; the
iterations are a Python loop.  The noise ``eps [B, n_iters + 1, n, zdim]``
(one slice an iteration, the last for the final population) is drawn from
the caller's generator on the conditions' device, or injected.
"""

from __future__ import annotations

import torch

from ndivplanning_tpu_torch.envs.rollout import ScoreWeights
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.planner import (
    PlanResult,
    nan_safe,
    score_rollouts,
    select_plan,
)
from ndivplanning_tpu_torch.train.state import TrainState, gen_params
from ndivplanning_tpu_torch.utils.config import Config


def cem_population(cfg: Config, n_candidates: int | None = None,
                   n_iters: int | None = None) -> tuple[int, int, int]:
    """``(population, default_elite, iters)``: the population defaults to
    ``cfg.n_candidates // (iters + 1)`` (at least 2), so the whole budget
    of ``iters + 1`` populations is the one-shot planner's; the elite is
    10% of the population, at least 2."""
    iters = cfg.cem_iters if n_iters is None else n_iters
    n = (max(cfg.n_candidates // (iters + 1), 2)
         if n_candidates is None else n_candidates)
    return n, max(n // 10, 2), iters


def elite_indices(scores: torch.Tensor, n_elite: int) -> torch.Tensor:
    """``[B, n_elite]`` indices of the lowest ``scores [B, n]`` in
    ``jax.lax.top_k(-scores, n_elite)``'s order: ascending, ties by the
    lower index (a stable sort; ``torch.topk`` promises no tie order)."""
    return torch.argsort(scores, dim=1, stable=True)[:, :n_elite]


@torch.no_grad()
def plan_cem_batch(cfg: Config, state: TrainState, scenes: Scene,
                   conditions: torch.Tensor,
                   generator: torch.Generator | None = None,
                   n_candidates: int | None = None,
                   n_elite: int | None = None, n_iters: int | None = None,
                   momentum: float = 0.25, sigma_floor: float = 0.05,
                   n_diverse: int = 8,
                   weights: ScoreWeights = ScoreWeights(),
                   eps: torch.Tensor | None = None
                   ) -> tuple[PlanResult, torch.Tensor]:
    """CEM-refined plans of B stacked scenes in one pass; returns
    ``(PlanResult, best_curve [B, n_iters])``, the best-so-far score after
    each iteration (non-increasing).  ``eps [B, n_iters + 1, n, zdim]``
    replaces the noise draws."""
    n, default_elite, iters = cem_population(cfg, n_candidates, n_iters)
    elite_n = default_elite if n_elite is None else n_elite
    b, device = conditions.shape[0], conditions.device
    zdim = cfg.latent_dim
    rows = torch.arange(b, device=device)

    def noise(i: int) -> torch.Tensor:
        if eps is not None:
            return eps[:, i].to(device)
        return torch.randn((b, n, zdim), generator=generator, device=device)

    def population(mu, sigma, i):
        return mu[:, None] + sigma[:, None] * noise(i)

    mu = torch.zeros((b, zdim), device=device)  # iteration 1: the prior
    sigma = torch.ones((b, zdim), device=device)
    best_z = torch.zeros((b, zdim), device=device)
    best_score = torch.full((b,), float("inf"), device=device)
    curve = []
    for i in range(iters):
        z = population(mu, sigma, i)
        taus = gen_params(cfg, state)(conditions, z)
        # NaN candidates become +inf: never elite, never the best.
        scores = nan_safe(score_rollouts(cfg, scenes, taus, weights).score)
        order = elite_indices(scores, elite_n)
        elite = torch.gather(z, 1, order[:, :, None].expand(-1, -1, zdim))
        new_mu = momentum * mu + (1.0 - momentum) * elite.mean(dim=1)
        new_sigma = momentum * sigma + (1.0 - momentum) * torch.clamp(
            elite.std(dim=1, correction=0), min=sigma_floor)
        it_best = torch.argmin(scores, dim=1)
        it_score = scores[rows, it_best]
        # where, not minimum: the tracker keeps a strictly better score.
        improved = it_score < best_score
        best_z = torch.where(improved[:, None], z[rows, it_best], best_z)
        best_score = torch.where(improved, it_score, best_score)
        curve.append(best_score)
        mu, sigma = new_mu, new_sigma
    z = population(mu, sigma, iters)
    z[:, 0] = best_z  # the tracked best at slot 0
    taus = gen_params(cfg, state)(conditions, z)
    plan = select_plan(taus, score_rollouts(cfg, scenes, taus, weights),
                       n_diverse)
    return plan, (torch.stack(curve, dim=1) if curve
                  else best_score.new_zeros((b, 0)))


def plan_cem(cfg: Config, state: TrainState, scene: Scene,
             condition: torch.Tensor,
             generator: torch.Generator | None = None,
             n_candidates: int | None = None, n_elite: int | None = None,
             n_iters: int | None = None, momentum: float = 0.25,
             sigma_floor: float = 0.05, n_diverse: int = 8,
             weights: ScoreWeights = ScoreWeights(),
             eps: torch.Tensor | None = None
             ) -> tuple[PlanResult, torch.Tensor]:
    """CEM-refined planning for one scene (no batch axis on ``scene`` or
    ``condition``): :func:`plan_cem_batch` on a stack of one.  ``eps
    [n_iters + 1, n, zdim]`` replaces the noise draws; returns
    ``(PlanResult, best_curve [n_iters])``."""
    result, curve = plan_cem_batch(
        cfg, state, Scene.stack([scene]), condition[None], generator,
        n_candidates, n_elite, n_iters, momentum, sigma_floor, n_diverse,
        weights, None if eps is None else eps[None])
    return PlanResult(*(field[0] for field in result)), curve[0]
