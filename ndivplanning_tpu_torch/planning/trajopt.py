"""Direct trajectory optimisation, Adam on tau itself through the env; counterpart of ``ndivplanning_tpu/planning/trajopt.py``.

G only warm-starts: its decoded candidates are the initial decision
variables, and Adam then moves the trajectories themselves on the soft
objective of ``planning/grad_refine.py`` (the waypoint controller's
targets in waypoint mode, the actions in action mode), out of G's output
manifold.  The honest union selection of the latent refiner keeps the
result no worse than the prior draw.

The CEM -> trajopt hybrid (``--refine cem+trajopt``) runs latent CEM
(``planning/cem.py``) first and seeds trajopt from the top quarter of its
final population: CEM picks the basins, trajopt slides within them.
CEM's tracked best rides in its final population, so it is among the
seeds, and the union makes the hybrid no worse than CEM's population.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ndivplanning_tpu_torch.envs.rollout import ScoreWeights
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.cem import (
    cem_population,
    elite_indices,
    plan_cem_batch,
)
from ndivplanning_tpu_torch.planning.grad_refine import (
    SoftWeights,
    adam_descent,
    draw_latents,
    soft_cost_taus,
    union_plan,
)
from ndivplanning_tpu_torch.planning.planner import (
    WHOLE,
    PlanResult,
    WholeAxis,
    _take,
    candidate_part,
    nan_safe,
)
from ndivplanning_tpu_torch.train.state import TrainState, gen_params
from ndivplanning_tpu_torch.utils.config import Config

if TYPE_CHECKING:
    from ndivplanning_tpu_torch.parallel.sharded_plan import (
        CandidatePart,
        CandidateSplit,
    )


def resolve_budget(cfg: Config, n_candidates: int | None = None,
                   n_steps: int | None = None,
                   lr: float | None = None) -> tuple[int, int, float]:
    """``(n_warm_starts, adam_steps, lr)`` with the config's defaults:
    ``n_candidates / 4``, ``cfg.trajopt_steps`` and ``cfg.trajopt_lr``."""
    n = max(cfg.n_candidates // 4, 2) if n_candidates is None else n_candidates
    steps = cfg.trajopt_steps if n_steps is None else n_steps
    return n, steps, (cfg.trajopt_lr if lr is None else lr)


def trajopt_core(cfg: Config, scenes: Scene, tau0: torch.Tensor,
                 n_steps: int, lr: float, soft: SoftWeights, n_diverse: int,
                 weights: ScoreWeights,
                 part: CandidatePart | WholeAxis = WHOLE
                 ) -> tuple[PlanResult, torch.Tensor]:
    """Adam on the warm starts ``tau0 [B, n, H, S]`` and the union
    selection; returns ``(PlanResult, loss_curve [B, n_steps])``.  With
    ``part``, ``tau0`` holds this rank's warm starts."""
    tau_ref, curve = adam_descent(
        lambda t: soft_cost_taus(cfg, scenes, t, soft, part), tau0, n_steps,
        lr, part)
    return union_plan(cfg, scenes, tau0, tau_ref, n_diverse,
                      weights, part), curve


def plan_trajopt_batch(cfg: Config, state: TrainState, scenes: Scene,
                       conditions: torch.Tensor,
                       generator: torch.Generator | None = None,
                       n_candidates: int | None = None,
                       n_steps: int | None = None, lr: float | None = None,
                       soft: SoftWeights = SoftWeights(), n_diverse: int = 8,
                       weights: ScoreWeights = ScoreWeights(),
                       z: torch.Tensor | None = None,
                       shard: CandidateSplit | None = None
                       ) -> tuple[PlanResult, torch.Tensor]:
    """Trajectory-optimised plans of B stacked scenes, warm-started from G's
    candidates of ``z [B, n, zdim]`` (or a draw from ``generator``);
    returns ``(PlanResult, loss_curve [B, n_steps])``.  ``shard`` refines
    each rank's warm starts of a mesh."""
    n, steps, lr = resolve_budget(cfg, n_candidates, n_steps, lr)
    part = candidate_part(shard, n)
    z0 = part.local(draw_latents(cfg, conditions, n, generator, z))
    with torch.no_grad():
        tau0 = gen_params(cfg, state)(conditions, z0)
    return trajopt_core(cfg, scenes, tau0, steps, lr, soft, n_diverse,
                        weights, part)


def plan_trajopt(cfg: Config, state: TrainState, scene: Scene,
                 condition: torch.Tensor,
                 generator: torch.Generator | None = None,
                 n_candidates: int | None = None, n_steps: int | None = None,
                 lr: float | None = None, soft: SoftWeights = SoftWeights(),
                 n_diverse: int = 8, weights: ScoreWeights = ScoreWeights(),
                 z: torch.Tensor | None = None
                 ) -> tuple[PlanResult, torch.Tensor]:
    """:func:`plan_trajopt_batch` for one scene (``z [n, zdim]``)."""
    result, curve = plan_trajopt_batch(
        cfg, state, Scene.stack([scene]), condition[None], generator,
        n_candidates, n_steps, lr, soft, n_diverse, weights,
        None if z is None else z[None])
    return PlanResult(*(field[0] for field in result)), curve[0]


def cem_seed_count(cfg: Config) -> int:
    """The hybrid's warm starts: a quarter of CEM's population, at least 2."""
    return max(cem_population(cfg)[0] // 4, 2)


def plan_cem_trajopt_batch(cfg: Config, state: TrainState, scenes: Scene,
                           conditions: torch.Tensor,
                           generator: torch.Generator | None = None,
                           n_steps: int | None = None,
                           lr: float | None = None,
                           soft: SoftWeights = SoftWeights(),
                           n_diverse: int = 8,
                           weights: ScoreWeights = ScoreWeights(),
                           eps: torch.Tensor | None = None,
                           shard: CandidateSplit | None = None
                           ) -> tuple[PlanResult, torch.Tensor]:
    """The CEM -> trajopt hybrid for B stacked scenes: ``plan_cem_batch`` at
    its defaults (``eps [B, iters + 1, n, zdim]`` its noise), then trajopt
    from the best quarter of its final population in
    ``jax.lax.top_k``'s order.  Returns ``(PlanResult, loss_curve [B,
    n_steps])``, the trajopt stage's curve.  ``shard`` splits CEM's
    populations and then the seeds over a mesh's ranks."""
    _, steps, lr = resolve_budget(cfg, None, n_steps, lr)
    cem_plan, _ = plan_cem_batch(cfg, state, scenes, conditions, generator,
                                 n_diverse=n_diverse, weights=weights,
                                 eps=eps, shard=shard)
    m = cem_seed_count(cfg)
    tau0 = _take(cem_plan.taus, elite_indices(nan_safe(cem_plan.scores), m))
    part = candidate_part(shard, m)
    return trajopt_core(cfg, scenes, part.local(tau0), steps, lr, soft,
                        n_diverse, weights, part)


def plan_cem_trajopt(cfg: Config, state: TrainState, scene: Scene,
                     condition: torch.Tensor,
                     generator: torch.Generator | None = None,
                     n_steps: int | None = None, lr: float | None = None,
                     soft: SoftWeights = SoftWeights(), n_diverse: int = 8,
                     weights: ScoreWeights = ScoreWeights(),
                     eps: torch.Tensor | None = None
                     ) -> tuple[PlanResult, torch.Tensor]:
    """:func:`plan_cem_trajopt_batch` for one scene (``eps [iters + 1, n,
    zdim]``)."""
    result, curve = plan_cem_trajopt_batch(
        cfg, state, Scene.stack([scene]), condition[None], generator,
        n_steps, lr, soft, n_diverse, weights,
        None if eps is None else eps[None])
    return PlanResult(*(field[0] for field in result)), curve[0]
