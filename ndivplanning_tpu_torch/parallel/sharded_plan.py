"""Candidate-axis sharded planning, one scene's candidates over the mesh; counterpart of ``ndivplanning_tpu/parallel/sharded_plan.py``.

``plan_batch`` serves many scenes at once; a latency-critical single-scene
request leaves every rank but one idle under that layout.  These planners
split the candidates of one scene over every rank instead: generate ->
rollout (-> refine) is parallel over candidates until the selection.

The JAX package pins the candidate axis with ``with_sharding_constraint``
and lets GSPMD split the work and insert the gathers.  The port writes
that program out, through the planners' shard hook (their ``shard=``
argument, ``None`` by default, a :class:`CandidateSplit` here):

- every rank draws the whole noise, from an identically seeded generator
  (or takes it injected), and keeps its slice of the candidates: rank r
  the ``c = ceil(n / W)`` from ``r c`` on, over all ``W = dp * div``
  ranks (the div ranks join the split, as in JAX's ``P((dp, div))``).  A
  short or empty slice is padded with copies of candidate 0 to c rows, so
  every rank computes the same shapes;
- G, the rollouts and the refiners' steps run on the slice.  A mean over
  the candidates (the refiners' soft objective and curves) is each rank's
  sum of its own rows over n, summed over the world: each candidate's
  gradient is the unsharded one's;
- one all-gather brings the candidates and their scores to every rank,
  trimmed to n, and the selection (the NaN-safe best pick, the diverse
  top-m, CEM's elite refit) runs replicated, so every rank returns the
  same bits.

On one rank the slice is the whole axis and the gather and the sum copy
it: the results are bitwise the unsharded planners'.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ndivplanning_tpu_torch.envs.rollout import ScoreWeights
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_reduce_sum_,
    make_mesh,
)
from ndivplanning_tpu_torch.planning.cem import plan_cem_batch
from ndivplanning_tpu_torch.planning.grad_refine import (
    SoftWeights,
    plan_grad_batch,
)
from ndivplanning_tpu_torch.planning.ilqr import plan_ilqr_batch
from ndivplanning_tpu_torch.planning.planner import PlanResult, plan_batch
from ndivplanning_tpu_torch.planning.trajopt import (
    plan_cem_trajopt_batch,
    plan_trajopt_batch,
)
from ndivplanning_tpu_torch.utils.config import Config


class Scored(NamedTuple):
    """The gathered fields of a rollout that the selection reads."""

    score: torch.Tensor  # [B, n]
    reached: torch.Tensor  # [B, n]


class CandidateSplit:
    """The candidate axis split over every rank of ``mesh``: the planners'
    ``shard=`` hook.  Every rank must make the same calls, in order."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.world
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def part(self, n: int) -> CandidatePart:
        """This rank's part of an axis of ``n`` candidates."""
        return CandidatePart(self, n)


class CandidatePart:
    """This rank's slice of an axis of ``n`` candidates (axis 1 of ``[B,
    n, ...]``): ``size`` rows, the first ``count`` of them real."""

    def __init__(self, split: CandidateSplit, n: int):
        self.group, self.n = split.group, n
        self.size = -(-n // split.world)
        self.start = min(split.rank * self.size, n)
        self.count = min(self.size, n - self.start)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``x [B, n, ...]``, padded with candidate 0."""
        rows = x.narrow(1, self.start, self.count)
        if self.count == self.size:
            return rows
        shape = list(x.shape)
        shape[1] = self.size - self.count
        return torch.cat([rows, x.narrow(1, 0, 1).expand(shape)], dim=1)

    def gather(self, *xs: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's rows of each ``x [B, size, ...]`` (one dtype), in
        one all-gather: ``[B, n, ...]`` each, the padding dropped."""
        b = xs[0].shape[0]
        flat = [x.reshape(b, self.size, -1) for x in xs]
        widths = [f.shape[-1] for f in flat]
        full = all_gather_cat(torch.cat(flat, dim=-1), self.group, dim=1)
        parts = full.narrow(1, 0, self.n).split(widths, dim=-1)
        return [p.reshape(b, self.n, *x.shape[2:]) for p, x in zip(parts, xs)]

    def gather_scored(self, taus: torch.Tensor, results):
        """``(taus [B, n, H, S], Scored)`` of this rank's scored candidates."""
        taus, score, reached = self.gather(taus, results.score,
                                           results.reached)
        return taus, Scored(score, reached)

    def gather_union(self, taus: torch.Tensor, results):
        """The union ``[prior, refined]`` of every rank's, from this rank's
        scored ``[prior, refined]`` (``size`` rows each): ``(taus [B, 2n,
        H, S], Scored)``."""
        halves = [t.split(self.size, dim=1)
                  for t in (taus, results.score, results.reached)]
        g = self.gather(*(h for pair in halves for h in pair))
        taus, score, reached = (torch.cat(g[i:i + 2], dim=1)
                                for i in (0, 2, 4))
        return taus, Scored(score, reached)

    def mean(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's share of the mean over all n candidates on ``dim`` of
        ``x`` (its ``size`` rows there): its real rows' sum over n, so each
        candidate's gradient is the unsharded mean's; ``torch.mean`` where
        the rank holds them all.  :meth:`total` of the shares is the
        mean."""
        rows = x.narrow(dim, 0, self.count)
        if self.count == self.n:
            return torch.mean(rows, dim)
        return rows.sum(dim) / self.n

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the world, as a new tensor."""
        return all_reduce_sum_(t.detach().clone(), self.group)


def _row(result: PlanResult) -> PlanResult:
    return PlanResult(*(field[0] for field in result))


def _sharded(planner, noise_key: str, cfg: Config, mesh: Mesh | None,
             **budget):
    """``(fn, mesh)``: ``planner`` on one scene with the candidates split
    over ``mesh`` (by default ``make_mesh(cfg=cfg)``)."""
    mesh = make_mesh(cfg=cfg) if mesh is None else mesh
    split = CandidateSplit(mesh)

    def fn(state, scene: Scene, condition: torch.Tensor,
           generator: torch.Generator | None = None,
           noise: torch.Tensor | None = None):
        out = planner(cfg, state, Scene.stack([scene]), condition[None],
                      generator, shard=split, **budget,
                      **{noise_key: None if noise is None else noise[None]})
        if isinstance(out, PlanResult):
            return _row(out)
        result, curve = out
        return _row(result), curve[0]

    return fn, mesh


def make_sharded_plan(cfg: Config, mesh: Mesh | None = None,
                      n_candidates: int | None = None, n_diverse: int = 8,
                      weights: ScoreWeights = ScoreWeights()):
    """The candidate-sharded single-scene planner: ``(plan_fn, mesh)`` with
    ``plan_fn(state, scene, condition, generator=None, noise=None) ->
    PlanResult``, the unsharded ``plan``'s (``noise [n, zdim]``, the
    latents).  ``state`` is replicated (``shard_state``)."""
    return _sharded(plan_batch, "z", cfg, mesh, n_candidates=n_candidates,
                    n_diverse=n_diverse, weights=weights)


def make_sharded_cem(cfg: Config, mesh: Mesh | None = None,
                     n_candidates: int | None = None,
                     n_elite: int | None = None, n_iters: int | None = None,
                     momentum: float = 0.25, sigma_floor: float = 0.05,
                     n_diverse: int = 8,
                     weights: ScoreWeights = ScoreWeights()):
    """Candidate-sharded CEM: each population's decode and rollout split
    over the mesh, the elite refit (a top-k of the gathered scores over the
    replicated latents) on every rank.  ``(cem_fn, mesh)``;
    ``cem_fn(state, scene, condition, generator=None, noise=None) ->
    (PlanResult, best_curve)``, ``plan_cem``'s (``noise [iters + 1, n,
    zdim]``)."""
    return _sharded(plan_cem_batch, "eps", cfg, mesh,
                    n_candidates=n_candidates, n_elite=n_elite,
                    n_iters=n_iters, momentum=momentum,
                    sigma_floor=sigma_floor, n_diverse=n_diverse,
                    weights=weights)


def make_sharded_grad(cfg: Config, mesh: Mesh | None = None,
                      n_candidates: int | None = None,
                      n_steps: int | None = None, lr: float = 0.1,
                      soft: SoftWeights | None = None, n_diverse: int = 8,
                      weights: ScoreWeights = ScoreWeights()):
    """Candidate-sharded gradient refinement: each Adam step's forward and
    backward pass on the rank's latents, the union selection gathered.
    ``(grad_fn, mesh)``; ``grad_fn(...) -> (PlanResult, loss_curve)``,
    ``plan_grad``'s (``noise [n, zdim]``)."""
    return _sharded(plan_grad_batch, "z", cfg, mesh,
                    n_candidates=n_candidates, n_steps=n_steps, lr=lr,
                    soft=SoftWeights() if soft is None else soft,
                    n_diverse=n_diverse, weights=weights)


def make_sharded_trajopt(cfg: Config, mesh: Mesh | None = None,
                         n_candidates: int | None = None,
                         n_steps: int | None = None, lr: float | None = None,
                         soft: SoftWeights | None = None, n_diverse: int = 8,
                         weights: ScoreWeights = ScoreWeights()):
    """Candidate-sharded trajectory optimisation: Adam on the rank's warm
    starts, the union selection gathered.  ``(trajopt_fn, mesh)``;
    ``trajopt_fn(...) -> (PlanResult, loss_curve)``, ``plan_trajopt``'s
    (``noise [n, zdim]``)."""
    return _sharded(plan_trajopt_batch, "z", cfg, mesh,
                    n_candidates=n_candidates, n_steps=n_steps, lr=lr,
                    soft=SoftWeights() if soft is None else soft,
                    n_diverse=n_diverse, weights=weights)


def make_sharded_ilqr(cfg: Config, mesh: Mesh | None = None,
                      n_candidates: int | None = None,
                      n_iters: int | None = None, reg0: float = 1.0,
                      soft: SoftWeights | None = None, n_diverse: int = 8,
                      weights: ScoreWeights = ScoreWeights()):
    """Candidate-sharded iLQR: each rank linearises, sweeps and line-searches
    its warm starts, the heaviest per-candidate refiner; the curve's mean
    and the union selection cross ranks.  ``(ilqr_fn, mesh)``;
    ``ilqr_fn(...) -> (PlanResult, cost_curve)``, ``plan_ilqr``'s
    (``noise [n, zdim]``)."""
    return _sharded(plan_ilqr_batch, "z", cfg, mesh,
                    n_candidates=n_candidates, n_iters=n_iters,
                    soft=SoftWeights() if soft is None else soft, reg0=reg0,
                    n_diverse=n_diverse, weights=weights)


def make_sharded_cem_trajopt(cfg: Config, mesh: Mesh | None = None,
                             n_steps: int | None = None,
                             lr: float | None = None,
                             soft: SoftWeights | None = None,
                             n_diverse: int = 8,
                             weights: ScoreWeights = ScoreWeights()):
    """The candidate-sharded CEM -> trajopt hybrid: CEM's populations and
    the trajopt stage's seeds split over the mesh; the elite refit, the
    seeds' top-m and the union selection on every rank.
    ``(hybrid_fn, mesh)``; ``hybrid_fn(...) -> (PlanResult, loss_curve)``,
    ``plan_cem_trajopt``'s (``noise [iters + 1, n, zdim]``)."""
    return _sharded(plan_cem_trajopt_batch, "eps", cfg, mesh,
                    n_steps=n_steps, lr=lr,
                    soft=SoftWeights() if soft is None else soft,
                    n_diverse=n_diverse, weights=weights)


# The sharded planner of each ``--refine`` value ("none": the plain one).
BY_REFINE = {"none": make_sharded_plan, "cem": make_sharded_cem,
             "grad": make_sharded_grad, "trajopt": make_sharded_trajopt,
             "ilqr": make_sharded_ilqr,
             "cem+trajopt": make_sharded_cem_trajopt}
