"""Sim-in-the-loop planner, generate -> rollout -> select; counterpart of ``ndivplanning_tpu/planning/planner.py``.

Diverse top-m selection: greedy farthest-point on trajectory L2 distance
among the better-scoring half of the candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.rollout import ScoreWeights, score_candidates
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.ops.pairwise import pairwise_l2
from ndivplanning_tpu_torch.train.state import TrainState, gen_params
from ndivplanning_tpu_torch.utils.config import Config


class PlanResult(NamedTuple):
    best_traj: torch.Tensor  # [H, S] lowest-cost candidate
    best_score: torch.Tensor  # scalar
    best_reached: torch.Tensor  # scalar {0, 1}
    diverse_idx: torch.Tensor  # [m] indices of the diverse top-m set
    diverse_trajs: torch.Tensor  # [m, H, S]
    scores: torch.Tensor  # [N] all candidate scores
    taus: torch.Tensor  # [N, H, S] all candidates


def _diverse_top_m(flat: torch.Tensor, scores: torch.Tensor,
                   m: int) -> torch.Tensor:
    """Greedy farthest-point selection among the best-scoring half.

    ``m`` is clamped to the pool size, so the indices are distinct.  The
    sort is stable, as ``jnp.argsort`` is, so ties keep index order."""
    n = scores.shape[0]
    half = max(n // 2, 1)
    m = min(m, half)
    order = torch.argsort(scores, stable=True)  # best first
    if m <= 1:
        return order[:1]
    pool = order[:half]
    dist = pairwise_l2(flat[pool][None])[0]  # [half, half]
    selected = torch.zeros((half,), dtype=torch.bool, device=flat.device)
    selected[0] = True
    min_dist = torch.full((half,), float("inf"), device=flat.device)
    last = torch.zeros((), dtype=torch.long, device=flat.device)
    picked = [last]
    neg_inf = torch.tensor(float("-inf"), device=flat.device)
    for _ in range(m - 1):
        min_dist = torch.minimum(min_dist, dist[last])
        last = torch.argmax(torch.where(selected, neg_inf, min_dist))
        selected = selected.index_fill(0, last[None], True)
        picked.append(last)
    return pool[torch.stack(picked)]


@torch.no_grad()
def generate_candidates(cfg: Config, state: TrainState,
                        condition: torch.Tensor, n: int,
                        generator: torch.Generator | None = None,
                        z: torch.Tensor | None = None) -> torch.Tensor:
    """n candidate trajectories ``[N, H, S]`` for one condition, from latents
    ``z [1, N, zdim]`` (drawn from ``generator`` unless given)."""
    if z is None:
        z = torch.randn((1, n, cfg.latent_dim), generator=generator,
                        device=condition.device)
    # EMA weights when tracked: planning sees the smoothed generator.
    return gen_params(cfg, state)(condition[None], z)[0]


def score_rollouts(cfg: Config, scene: Scene, taus: torch.Tensor,
                   weights: ScoreWeights):
    """Sim-in-the-loop scoring of candidates in the config's env family."""
    params = get_env(cfg.env).make_params()
    return score_candidates(params, scene, taus, cfg.rollout_mode, weights,
                            env=cfg.env)


@torch.no_grad()
def plan(cfg: Config, state: TrainState, scene: Scene,
         condition: torch.Tensor, generator: torch.Generator | None = None,
         n_candidates: int | None = None, n_diverse: int = 8,
         weights: ScoreWeights = ScoreWeights(),
         z: torch.Tensor | None = None) -> PlanResult:
    """One planning step for a single scene.

    ``condition`` is the scene's raw condition without a batch axis
    (``[0]``, ``[4]`` or the ``[S, S, 3]`` image of ``data/scenes.py``).
    ``z [1, N, zdim]`` replaces the latent draw."""
    n = cfg.n_candidates if n_candidates is None else n_candidates
    taus = generate_candidates(cfg, state, condition, n, generator, z)
    results = score_rollouts(cfg, scene, taus, weights)
    # NaN-safe selection: +inf drops non-finite scores from both picks.
    sel_scores = torch.where(torch.isfinite(results.score), results.score,
                             torch.full_like(results.score, float("inf")))
    best = torch.argmin(sel_scores)
    diverse_idx = _diverse_top_m(taus.reshape(n, -1), sel_scores, n_diverse)
    return PlanResult(best_traj=taus[best], best_score=results.score[best],
                      best_reached=results.reached[best],
                      diverse_idx=diverse_idx,
                      diverse_trajs=taus[diverse_idx], scores=results.score,
                      taus=taus)
