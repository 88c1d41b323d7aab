"""The refining planners by name: their noise and one batched call.

``cem``, ``grad``, ``trajopt``, ``ilqr`` and ``cem+trajopt`` (the
``--refine`` / ``--planner`` values of the JAX package's CLI, server and
eval).  Each scene's noise is one tensor of :func:`noise_shape`: the
latents of the warm starts, or CEM's population draws for ``cem`` and
``cem+trajopt``.  The server, the frozen-suite eval and the CLI draw it
(or have it injected) and call :func:`plan_refined_batch`.
"""

from __future__ import annotations

import torch

from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.cem import cem_population, plan_cem_batch
from ndivplanning_tpu_torch.planning.grad_refine import (
    grad_budget,
    plan_grad_batch,
)
from ndivplanning_tpu_torch.planning.ilqr import (
    plan_ilqr_batch,
    resolve_ilqr_budget,
)
from ndivplanning_tpu_torch.planning.planner import PlanResult
from ndivplanning_tpu_torch.planning.trajopt import (
    plan_cem_trajopt_batch,
    plan_trajopt_batch,
    resolve_budget,
)
from ndivplanning_tpu_torch.train.state import TrainState
from ndivplanning_tpu_torch.utils.config import Config

REFINERS = ("cem", "grad", "trajopt", "ilqr", "cem+trajopt")


def noise_shape(cfg: Config, refine: str) -> tuple[int, ...]:
    """One scene's noise of a refiner: ``[iters + 1, n, zdim]`` for the
    CEM population draws (``cem``, ``cem+trajopt``), ``[n, zdim]`` latents
    of the warm starts otherwise, at the config's default budget."""
    if refine in ("cem", "cem+trajopt"):
        n, _, iters = cem_population(cfg)
        return (iters + 1, n, cfg.latent_dim)
    budget = {"grad": grad_budget, "trajopt": resolve_budget,
              "ilqr": resolve_ilqr_budget}[refine]
    return (budget(cfg)[0], cfg.latent_dim)


def plan_refined_batch(cfg: Config, state: TrainState, scenes: Scene,
                       conditions: torch.Tensor, refine: str,
                       noise: torch.Tensor | None = None,
                       generator: torch.Generator | None = None,
                       n_diverse: int = 8) -> tuple[PlanResult, torch.Tensor]:
    """The refiner ``refine``'s plans of B stacked scenes at its default
    budget, with ``noise [B, *noise_shape(cfg, refine)]`` or draws from
    ``generator``; returns ``(PlanResult, curve [B, steps])``: CEM's
    best-so-far score, the others' soft loss."""
    if refine not in REFINERS:
        raise ValueError(f"unknown refiner {refine!r}; choose from "
                         f"{list(REFINERS)}")
    fn = {"cem": plan_cem_batch, "grad": plan_grad_batch,
          "trajopt": plan_trajopt_batch, "ilqr": plan_ilqr_batch,
          "cem+trajopt": plan_cem_trajopt_batch}[refine]
    key = "eps" if refine in ("cem", "cem+trajopt") else "z"
    return fn(cfg, state, scenes, conditions, generator, n_diverse=n_diverse,
              **{key: noise})
