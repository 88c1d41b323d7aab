"""Gradient latent refinement, differentiable planning through G and the env; counterpart of ``ndivplanning_tpu/planning/grad_refine.py``.

The generator, the waypoint (or action) controller and the env dynamics
are differentiable, so candidate latents are refined by Adam on a soft
planning objective:

    J(z) = goal_dist(G(c, z)) + w_obs * penetration + w_ctrl * control

``penetration`` is the smooth segment-vs-disc depth of the rolled-out
path (the hard collision check's swept-segment geometry, with a margin),
summed over steps and live obstacles: the hard score's latched collision
has no gradient.  Selection stays honest: the prior and the refined
candidates are hard-scored together and the best of the union is picked,
so a plan never loses to its own prior draw.

Scenes are a batch axis ``[B]``, the candidates an axis ``n`` and the Adam
steps a Python loop.  Each step takes the gradient of the sum over scenes
of every scene's mean soft cost, so each scene gets the JAX package's
per-scene gradient, and one Adam state covers ``[B, n, ...]``.  The env's
clips take ``jnp.clip``'s derivative on their bounds (``ops/clip.py``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, NamedTuple

import torch

from ndivplanning_tpu_torch.envs.rollout import ScoreWeights
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.ops.clip import clip
from ndivplanning_tpu_torch.planning.planner import (
    WHOLE,
    PlanResult,
    WholeAxis,
    candidate_part,
    score_rollouts,
    select_plan,
)
from ndivplanning_tpu_torch.train.state import (
    TrainState,
    adam_update,
    gen_params,
)
from ndivplanning_tpu_torch.utils.config import Config

if TYPE_CHECKING:
    from ndivplanning_tpu_torch.parallel.sharded_plan import (
        CandidatePart,
        CandidateSplit,
    )

# optax.adam's defaults.
ADAM_B1, ADAM_B2 = 0.9, 0.999


def _segments_penetration(scenes: Scene, positions: torch.Tensor,
                          margin: float) -> torch.Tensor:
    """``[..., N]`` smooth total penetration of paths ``positions [..., N,
    H, 2]`` from their scene's start into its live obstacles: the closest
    point of each step's segment to each disc centre, and the hinge
    ``relu(r + margin - dist)`` summed over steps and obstacles."""
    start = scenes.start[..., None, None, :].expand(
        *positions.shape[:-2], 1, 2)
    prev = torch.cat([start, positions[..., :-1, :]], dim=-2)  # [..., N, H, 2]
    d = positions - prev
    obs = scenes.obstacles[..., None, None, :, :]  # [..., 1, 1, M, 3]
    c, r = obs[..., :2], obs[..., 2]
    len2 = torch.sum(d * d, dim=-1)  # [..., N, H]
    # t*: each centre's projection onto each segment, clipped to it.
    proj = (torch.sum(c * d[..., None, :], dim=-1)
            - torch.sum(prev * d, dim=-1)[..., None])  # [..., N, H, M]
    t = clip(proj / clip(len2, 1e-12)[..., None], 0.0, 1.0)
    closest = prev[..., None, :] + t[..., None] * d[..., None, :]
    dist = torch.sqrt(torch.sum(torch.square(c - closest), dim=-1) + 1e-12)
    pen = torch.relu(r + margin - dist)  # [..., N, H, M]
    return torch.sum(pen * scenes.obstacle_mask[..., None, None, :],
                     dim=(-2, -1))


class SoftWeights(NamedTuple):
    """(goal, obstacle, control, margin) of the refinement objective."""

    goal: float = 1.0
    obstacle: float = 10.0
    control: float = 0.01
    margin: float = 0.02


def soft_cost_taus(cfg: Config, scenes: Scene, taus: torch.Tensor,
                   soft: SoftWeights,
                   part: CandidatePart | WholeAxis = WHOLE) -> torch.Tensor:
    """``[...]``: each scene's mean soft cost of its candidates ``taus [...,
    N, H, S]``, differentiable through the controller and the dynamics.
    The surrogate of the latent refiner and of the trajectory optimiser
    (``planning/trajopt.py``).  With ``part``, ``taus`` are this rank's
    rows and the cost its share of the mean over all ranks' candidates."""
    res = score_rollouts(cfg, scenes, taus, ScoreWeights())
    pen = _segments_penetration(scenes, res.positions, soft.margin)
    cost = (soft.goal * res.goal_dist + soft.obstacle * pen
            + soft.control * res.control_cost)
    return part.mean(cost)


def adam_descent(loss_of: Callable[[torch.Tensor], torch.Tensor],
                 x0: torch.Tensor, n_steps: int, lr: float,
                 part: CandidatePart | WholeAxis = WHOLE
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` of ``optax.adam(lr)`` on ``x0 [B, ...]`` for the per-scene
    losses ``loss_of(x) -> [B]``; returns ``(x, curve [B, n_steps])``, the
    losses before each update.  The gradient is of their sum: scenes do
    not share variables, so each scene gets its own loss's gradient.  With
    ``part``, ``x0`` holds this rank's candidates and ``loss_of`` its
    share of the losses; the curve is their sum over the ranks."""
    x = x0.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    curve = []
    for i in range(n_steps):
        with torch.enable_grad():
            xv = x.requires_grad_(True)
            losses = loss_of(xv)
            grad, = torch.autograd.grad(losses.sum(), xv)
        x = xv.detach()
        curve.append(losses.detach())
        adam_update([x], [grad], [mu], [nu], i + 1, lr, ADAM_B1, ADAM_B2)
    if not curve:
        return x, x.new_zeros((x.shape[0], 0))
    return x, part.total(torch.stack(curve, dim=1))


def union_plan(cfg: Config, scenes: Scene, prior: torch.Tensor,
               refined: torch.Tensor, n_diverse: int,
               weights: ScoreWeights,
               part: CandidatePart | WholeAxis = WHOLE) -> PlanResult:
    """Honest selection: the union ``[prior, refined]`` of candidates ``[B,
    n, H, S]`` each, hard-scored, with its NaN-safe best pick and diverse
    top-m (``PlanResult.scores`` / ``taus`` cover the ``2n``).  With
    ``part``, each rank scores its rows and the union is gathered."""
    with torch.no_grad():
        taus = torch.cat([prior, refined], dim=1)
        taus, results = part.gather_union(
            taus, score_rollouts(cfg, scenes, taus, weights))
        return select_plan(taus, results, n_diverse)


def draw_latents(cfg: Config, conditions: torch.Tensor, n: int,
                 generator: torch.Generator | None,
                 z: torch.Tensor | None) -> torch.Tensor:
    """``z [B, n, zdim]`` as given, or drawn from ``generator`` on the
    conditions' device."""
    if z is not None:
        return z.to(conditions.device)
    return torch.randn((conditions.shape[0], n, cfg.latent_dim),
                       generator=generator, device=conditions.device)


def grad_budget(cfg: Config, n_candidates: int | None = None,
                n_steps: int | None = None) -> tuple[int, int]:
    """``(n, steps)``: ``n_candidates / 4`` latents (an Adam step costs a
    forward and a backward rollout) and ``cfg.grad_refine_steps``."""
    n = max(cfg.n_candidates // 4, 2) if n_candidates is None else n_candidates
    return n, cfg.grad_refine_steps if n_steps is None else n_steps


def plan_grad_batch(cfg: Config, state: TrainState, scenes: Scene,
                    conditions: torch.Tensor,
                    generator: torch.Generator | None = None,
                    n_candidates: int | None = None,
                    n_steps: int | None = None, lr: float = 0.1,
                    soft: SoftWeights = SoftWeights(), n_diverse: int = 8,
                    weights: ScoreWeights = ScoreWeights(),
                    z: torch.Tensor | None = None,
                    shard: CandidateSplit | None = None
                    ) -> tuple[PlanResult, torch.Tensor]:
    """Gradient-refined plans of B stacked scenes in one pass; returns
    ``(PlanResult, loss_curve [B, n_steps])``, the mean soft objective
    before each Adam step.  ``PlanResult.scores`` / ``taus`` cover the
    ``2n`` union of prior and refined candidates.  ``z [B, n, zdim]``
    replaces the latent draw.  ``shard`` refines each rank's latents of a
    mesh."""
    n, steps = grad_budget(cfg, n_candidates, n_steps)
    part = candidate_part(shard, n)
    z0 = part.local(draw_latents(cfg, conditions, n, generator, z))
    gen = gen_params(cfg, state)
    z_ref, curve = adam_descent(
        lambda zv: soft_cost_taus(cfg, scenes, gen(conditions, zv), soft,
                                  part), z0, steps, lr, part)
    with torch.no_grad():
        prior, refined = gen(conditions, z0), gen(conditions, z_ref)
    return union_plan(cfg, scenes, prior, refined, n_diverse,
                      weights, part), curve


def plan_grad(cfg: Config, state: TrainState, scene: Scene,
              condition: torch.Tensor,
              generator: torch.Generator | None = None,
              n_candidates: int | None = None, n_steps: int | None = None,
              lr: float = 0.1, soft: SoftWeights = SoftWeights(),
              n_diverse: int = 8, weights: ScoreWeights = ScoreWeights(),
              z: torch.Tensor | None = None
              ) -> tuple[PlanResult, torch.Tensor]:
    """Gradient-refined planning for one scene (no batch axis on ``scene``
    or ``condition``): :func:`plan_grad_batch` on a stack of one.  ``z [n,
    zdim]`` replaces the latent draw; returns ``(PlanResult, loss_curve
    [n_steps])``."""
    result, curve = plan_grad_batch(
        cfg, state, Scene.stack([scene]), condition[None], generator,
        n_candidates, n_steps, lr, soft, n_diverse, weights,
        None if z is None else z[None])
    return PlanResult(*(field[0] for field in result)), curve[0]
