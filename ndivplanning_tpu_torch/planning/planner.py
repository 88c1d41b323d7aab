"""Sim-in-the-loop planner, generate -> rollout -> select; counterpart of ``ndivplanning_tpu/planning/planner.py``.

Diverse top-m selection: greedy farthest-point on trajectory L2 distance
among the better-scoring half of the candidates.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch

from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.rollout import ScoreWeights, score_candidates
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.ops.pairwise import pairwise_l2
from ndivplanning_tpu_torch.train.state import TrainState, gen_params
from ndivplanning_tpu_torch.utils.config import Config
from ndivplanning_tpu_torch.utils.profiling import check_finite

if TYPE_CHECKING:
    from ndivplanning_tpu_torch.parallel.sharded_plan import CandidateSplit


class WholeAxis:
    """The planners' shard hook when one process holds every candidate:
    :class:`parallel.sharded_plan.CandidatePart`'s operations as the
    identity, and ``torch.mean`` for its share of a mean."""

    def part(self, n: int) -> WholeAxis:
        return self

    def local(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def gather(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        return list(xs)

    def gather_scored(self, taus: torch.Tensor, results):
        return taus, results

    gather_union = gather_scored

    def mean(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return torch.mean(x, dim)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return t


WHOLE = WholeAxis()


def candidate_part(shard: CandidateSplit | None, n: int):
    """The part of an axis of ``n`` candidates that this process holds:
    all of it unless ``shard`` splits it."""
    return (WHOLE if shard is None else shard).part(n)


class PlanResult(NamedTuple):
    """One scene's plan; :func:`plan_batch` adds a leading ``[B]`` axis."""

    best_traj: torch.Tensor  # [H, S] lowest-cost candidate
    best_score: torch.Tensor  # scalar
    best_reached: torch.Tensor  # scalar {0, 1}
    diverse_idx: torch.Tensor  # [m] indices of the diverse top-m set
    diverse_trajs: torch.Tensor  # [m, H, S]
    scores: torch.Tensor  # [N] all candidate scores
    taus: torch.Tensor  # [N, H, S] all candidates


def _diverse_top_m(flat: torch.Tensor, scores: torch.Tensor,
                   m: int) -> torch.Tensor:
    """Greedy farthest-point selection among the best-scoring half, for
    ``flat [..., N, D]`` and ``scores [..., N]`` of any scene axes ``[...]``
    at once; returns ``[..., m]`` candidate indices.

    ``m`` is clamped to the pool size, so the indices are distinct.  The
    sort is stable, as ``jnp.argsort`` is, so ties keep index order, and
    ``argmax`` takes the first of equal distances, as ``jnp.argmax``."""
    lead, (n, dim) = scores.shape[:-1], flat.shape[-2:]
    flat, scores = flat.reshape(-1, n, dim), scores.reshape(-1, n)
    half = max(n // 2, 1)
    m = min(m, half)
    order = torch.argsort(scores, dim=-1, stable=True)  # best first
    if m <= 1:
        return order[:, :1].reshape(*lead, 1)
    pool = order[:, :half]  # [B, half]
    dist = pairwise_l2(torch.gather(
        flat, 1, pool[..., None].expand(-1, -1, dim)))  # [B, half, half]
    selected = (torch.arange(half, device=flat.device) == 0).expand(
        pool.shape)  # the best is picked first
    min_dist = torch.full(pool.shape, float("inf"), device=flat.device)
    last = torch.zeros((pool.shape[0], 1), dtype=torch.long,
                       device=flat.device)
    picked = [last]
    neg_inf = torch.full((), float("-inf"), device=flat.device)
    for _ in range(m - 1):
        row = torch.gather(dist, 1, last[..., None].expand(-1, 1, half))
        min_dist = torch.minimum(min_dist, row[:, 0])
        last = torch.argmax(torch.where(selected, neg_inf, min_dist), dim=1,
                            keepdim=True)
        selected = selected.scatter(1, last, True)
        picked.append(last)
    return torch.gather(pool, 1, torch.cat(picked, dim=1)).reshape(*lead, m)


def nan_safe(scores: torch.Tensor) -> torch.Tensor:
    """Scores with every non-finite one made ``+inf``: an argmin or a
    top-k over a NaN would pick it."""
    return torch.where(torch.isfinite(scores), scores,
                       torch.full_like(scores, float("inf")))


def score_rollouts(cfg: Config, scenes: Scene, taus: torch.Tensor,
                   weights: ScoreWeights, state0=None):
    """Sim-in-the-loop scoring of candidates ``taus [..., N, H, S]`` of
    scenes ``[...]`` in the config's env family, from their reset or from
    ``state0`` (one candidate per scene, ``[..., 1]``: the MPC case)."""
    params = get_env(cfg.env).make_params()
    return score_candidates(params, scenes, taus, cfg.rollout_mode, weights,
                            env=cfg.env, state0=state0)


@torch.no_grad()
def plan_batch(cfg: Config, state: TrainState, scenes: Scene,
               conditions: torch.Tensor,
               generator: torch.Generator | None = None,
               n_candidates: int | None = None, n_diverse: int = 8,
               weights: ScoreWeights = ScoreWeights(),
               z: torch.Tensor | None = None,
               shard: CandidateSplit | None = None) -> PlanResult:
    """One planning step for each of B stacked scenes, in one pass: G over
    ``[B, N]`` latents, one rollout of the B x N candidates, a NaN-safe
    best pick and the diverse top-m of every scene.  The number of kernel
    launches does not grow with B.

    ``scenes`` has a leading ``[B]`` axis (:meth:`Scene.stack`) and
    ``conditions`` is ``[B, ...]``.  ``z [B, N, zdim]`` replaces the latent
    draw from ``generator``.  Every field of the result leads with ``[B]``.
    ``shard`` splits the candidates over a mesh's ranks
    (``parallel/sharded_plan.py``)."""
    n = cfg.n_candidates if n_candidates is None else n_candidates
    b = conditions.shape[0]
    if z is None:
        z = torch.randn((b, n, cfg.latent_dim), generator=generator,
                        device=conditions.device)
    part = candidate_part(shard, n)
    # EMA weights when tracked: planning sees the smoothed generator.
    taus = gen_params(cfg, state)(conditions, part.local(z))  # [B, N, H, S]
    taus, results = part.gather_scored(
        taus, score_rollouts(cfg, scenes, taus, weights))
    return select_plan(taus, results, n_diverse)


def select_plan(taus: torch.Tensor, results, n_diverse: int) -> PlanResult:
    """The plan of scored candidates ``taus [B, N, H, S]`` (``results``:
    their ``score`` and ``reached``): a NaN-safe best pick and the diverse
    top-m of every scene."""
    sel_scores = nan_safe(results.score)  # +inf: out of both picks
    best = torch.argmin(sel_scores, dim=1, keepdim=True)  # [B, 1]
    diverse_idx = _diverse_top_m(taus.flatten(2), sel_scores, n_diverse)
    result = PlanResult(
        best_traj=_take(taus, best)[:, 0],
        best_score=torch.gather(results.score, 1, best)[:, 0],
        best_reached=torch.gather(results.reached, 1, best)[:, 0],
        diverse_idx=diverse_idx, diverse_trajs=_take(taus, diverse_idx),
        scores=results.score, taus=taus)
    check_finite("plan", result)
    return result


def _take(taus: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``taus [B, N, H, S]`` at candidate indices ``idx [B, m]``."""
    return torch.gather(taus, 1, idx[:, :, None, None].expand(
        -1, -1, *taus.shape[2:]))


def plan(cfg: Config, state: TrainState, scene: Scene,
         condition: torch.Tensor, generator: torch.Generator | None = None,
         n_candidates: int | None = None, n_diverse: int = 8,
         weights: ScoreWeights = ScoreWeights(),
         z: torch.Tensor | None = None) -> PlanResult:
    """One planning step for a single scene: :func:`plan_batch` on a stack
    of one.

    ``condition`` is the scene's raw condition without a batch axis
    (``[0]``, ``[4]`` or the ``[S, S, 3]`` image of ``data/scenes.py``).
    ``z [1, N, zdim]`` replaces the latent draw."""
    result = plan_batch(cfg, state, Scene.stack([scene]), condition[None],
                        generator, n_candidates, n_diverse, weights, z)
    return PlanResult(*(field[0] for field in result))
