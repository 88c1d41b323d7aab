"""Evaluation: diversity, quality and rollout-success metrics; counterpart of ``ndivplanning_tpu/train/evaluate.py``.

Sample conditions, draw k latents each, generate, then

- diversity: the mean pairwise L2 between the k trajectories of each
  condition, and the NDiv loss itself, through ``ops/ndiv.py::ndiv_loss``
  (the ``ndiv_fwd`` kernel on the card, the plain reference on the CPU;
  the JAX eval takes its reference on every backend);
- quality: the endpoint's distance to the goal;
- planning: every trajectory rolled through the env, the B scenes as the
  scene axis and the k samples as candidates, for success and collision
  rates.

The frozen suite and its latents are drawn on the CPU from fixed seeds and
then moved to the state's device, so a checkpoint's frozen-suite numbers
agree on the card and on the CPU.  JAX's threefry streams cannot be
reproduced in torch, so the suite is the port's own.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ndivplanning_tpu_torch.data.tasks import Batch, make_task, task_fingerprint
from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.rollout import ScoreWeights, score_candidates
from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss
from ndivplanning_tpu_torch.ops.pairwise import pairwise_l2
from ndivplanning_tpu_torch.train.state import TrainState, gen_params
from ndivplanning_tpu_torch.utils.config import Config
from ndivplanning_tpu_torch.utils.profiling import check_finite

# Frozen eval protocol: the suite and the eval latents come from FIXED
# seeds, independent of cfg.seed and the training step, so numbers from
# different runs at the same checkpoint agree to the digit.
EVAL_SUITE_SEED = 0xE7A1
EVAL_SUITE_SIZE = 512

# The JAX package's planner families.
PLANNERS = ("oneshot", "cem", "grad", "trajopt", "ilqr", "cem+trajopt")

# Keyed on task_fingerprint (the fields make_task consumes), not the whole
# Config: configs differing only in workdir, steps or LR share one suite.
_SUITE_CACHE: dict = {}
_SUITE_CACHE_MAX = 8


def _device(state: TrainState) -> torch.device:
    return state.rng.device


def _latents(cfg: Config, generator: torch.Generator, n: int,
             device) -> torch.Tensor:
    """``[n, k, zdim]`` latents drawn on the generator's device, then moved."""
    return torch.randn((n, cfg.k, cfg.latent_dim), generator=generator,
                       device=generator.device).to(device)


def evaluate(cfg: Config, state: TrainState, generator: torch.Generator,
             eval_batch: int = 64, use_ema: bool = True) -> dict:
    """The metrics (a dict of 0-d tensors) on a fresh batch from the task
    sampler, drawn from ``generator`` and then its latents; for a FIXED
    evaluation set use :func:`evaluate_on_batch` or :func:`evaluate_fixed`."""
    batch = make_task(cfg).sample(generator, eval_batch)
    return evaluate_on_batch(cfg, state, generator, batch, use_ema=use_ema)


def evaluate_on_batch(cfg: Config, state: TrainState,
                      generator: torch.Generator | None, batch: Batch,
                      use_ema: bool = True,
                      z: torch.Tensor | None = None) -> dict:
    """The metrics on a caller's batch (conditions and real scenes), moved
    to the state's device: success and collision use the batch's scenes.

    ``z [B, k, zdim]`` replaces the latent draw from ``generator``.
    ``use_ema=False`` evaluates the RAW generator even when the config
    tracks an EMA one: the second leg of the loop's best-of-both
    checkpoint selection."""
    device = _device(state)
    batch = batch.map(lambda t: t.to(device))
    b = batch.real_traj.shape[0]
    z = _latents(cfg, generator, b, device) if z is None else z.to(device)
    return _evaluate_impl(cfg, state, z, batch, use_ema=use_ema)


def make_eval_suite(cfg: Config, n_scenes: int = EVAL_SUITE_SIZE,
                    seed: int = EVAL_SUITE_SEED, device=None) -> Batch:
    """The preset's frozen evaluation set on ``device`` (default: the
    card): ``n_scenes`` scenes, conditions and expert trajectories drawn
    on the CPU from ``seed``, keyed only by ``task_fingerprint(cfg)``,
    ``n_scenes``, ``seed`` and the device, never by the training seed.

    Cached (a FIFO of 8): the loop calls this at every eval point."""
    from ndivplanning_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    key = (task_fingerprint(cfg), n_scenes, seed, str(device))
    suite = _SUITE_CACHE.get(key)
    if suite is None:
        while len(_SUITE_CACHE) >= _SUITE_CACHE_MAX:  # FIFO bound
            _SUITE_CACHE.pop(next(iter(_SUITE_CACHE)))
        suite = make_task(cfg).sample(torch.Generator().manual_seed(seed),
                                      n_scenes)
        suite = suite.map(lambda t: t.to(device))
        _SUITE_CACHE[key] = suite
    return suite


def evaluate_fixed(cfg: Config, state: TrainState,
                   n_scenes: int = EVAL_SUITE_SIZE,
                   seed: int = EVAL_SUITE_SEED, use_ema: bool = True) -> dict:
    """Metrics on the frozen suite with frozen latents (``seed + 1`` on the
    CPU): reproducible to the digit for a given checkpoint and device."""
    suite = make_eval_suite(cfg, n_scenes, seed, _device(state))
    return evaluate_on_batch(cfg, state, torch.Generator().manual_seed(
        seed + 1), suite, use_ema=use_ema)


def evaluate_fixed_mpc(cfg: Config, state: TrainState,
                       n_scenes: int = EVAL_SUITE_SIZE,
                       seed: int = EVAL_SUITE_SEED, total_steps: int = 64,
                       replan_every: int = 8, n_candidates: int = 256,
                       scene_chunk: int = 128) -> dict:
    """Closed-loop quality on the frozen suite: every suite scene runs as a
    receding-horizon episode (``planning/mpc.py::mpc_rollout_batch``,
    replanning from the live state every ``replan_every`` steps).

    The latents of every scene and cycle are drawn at once on the CPU from
    ``seed + 2``, so the result depends neither on ``scene_chunk`` (scenes
    per dispatch) nor on the device.  Returns ``eval_mpc_success_rate``,
    ``eval_mpc_collision_rate`` and the episode's parameters."""
    from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch

    if scene_chunk < 1:
        raise ValueError(f"scene_chunk must be >= 1, got {scene_chunk}")
    n_cycles = total_steps // replan_every
    device = _device(state)
    suite = make_eval_suite(cfg, n_scenes, seed, device)
    z = torch.randn((n_scenes, n_cycles, n_candidates, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(seed + 2))
    reached, collided = [], []
    for lo in range(0, n_scenes, scene_chunk):
        rows = slice(lo, min(lo + scene_chunk, n_scenes))
        part = suite.map(lambda t: t[rows])
        result = mpc_rollout_batch(
            cfg, state, part.scenes, part.conditions,
            total_steps=total_steps, replan_every=replan_every,
            n_candidates=n_candidates, z=z[rows].to(device))
        reached.append(result.reached)
        collided.append(result.collided)
    reached = torch.cat(reached).cpu().numpy()
    collided = torch.cat(collided).cpu().numpy()
    return {
        "eval_mpc_success_rate": float(np.mean(reached)),
        "eval_mpc_collision_rate": float(np.mean(collided)),
        "eval_mpc_total_steps": float(total_steps),
        "eval_mpc_replan_every": float(replan_every),
        "eval_mpc_candidates": float(n_candidates),
    }


def evaluate_fixed_planner(cfg: Config, state: TrainState,
                           planner: str = "oneshot",
                           n_scenes: int = EVAL_SUITE_SIZE,
                           seed: int = EVAL_SUITE_SEED,
                           scene_chunk: int | None = None) -> dict:
    """Open-loop planner quality on the frozen suite: every suite scene is
    planned once and the best candidate's score and reach are recorded.

    ``planner`` is ``"oneshot"`` (``planning/planner.py::plan_batch``,
    default chunk 128) or a refiner, ``"cem"``, ``"grad"``, ``"trajopt"``,
    ``"ilqr"`` or ``"cem+trajopt"`` (``planning/refine.py``, default chunk
    16: their plans are 10-100x heavier).  The latents (CEM: its noise) of
    every scene are drawn at once on the CPU from ``seed + 3``, so the
    result does not depend on ``scene_chunk`` (scenes per dispatch; the
    gradient refiners' only to rounding, their reductions' order following
    the tensor's size) or on the device.  Returns
    ``eval_plan_best_score`` (suite mean of the best scores, LOWER is
    better), ``eval_plan_reach_rate``, ``eval_plan_n_scenes`` and the
    planner's name."""
    from ndivplanning_tpu_torch.planning.planner import plan_batch
    from ndivplanning_tpu_torch.planning.refine import (
        noise_shape,
        plan_refined_batch,
    )

    if planner not in PLANNERS:
        raise ValueError(f"unknown planner {planner!r}; choose from "
                         f"{list(PLANNERS)}")
    if planner == "oneshot":
        shape = (cfg.n_candidates, cfg.latent_dim)
        chunk = 128 if scene_chunk is None else scene_chunk
    else:
        shape = noise_shape(cfg, planner)
        chunk = 16 if scene_chunk is None else scene_chunk
    if chunk < 1:
        raise ValueError(f"scene_chunk must be >= 1, got {chunk}")
    device = _device(state)
    suite = make_eval_suite(cfg, n_scenes, seed, device)
    z = torch.randn((n_scenes, *shape),
                    generator=torch.Generator().manual_seed(seed + 3))
    scores, reached = [], []
    for lo in range(0, n_scenes, chunk):
        rows = slice(lo, min(lo + chunk, n_scenes))
        part = suite.map(lambda t: t[rows])
        zc = z[rows].to(device)
        if planner == "oneshot":
            result = plan_batch(cfg, state, part.scenes, part.conditions,
                                z=zc)
        else:
            result, _ = plan_refined_batch(cfg, state, part.scenes,
                                           part.conditions, planner,
                                           noise=zc)
        s, r = plan_batch_result(result)
        scores.append(s)
        reached.append(r)
    scores = torch.cat(scores).cpu().numpy()
    reached = torch.cat(reached).cpu().numpy()
    return {
        "eval_plan_best_score": float(np.mean(scores)),
        "eval_plan_reach_rate": float(np.mean(reached)),
        "eval_plan_n_scenes": float(n_scenes),
        "eval_planner": planner,
    }


def plan_batch_result(result):
    """(best_score [B], best_reached [B]) of a batched PlanResult."""
    return result.best_score, result.best_reached


@torch.no_grad()
def _evaluate_impl(cfg: Config, state: TrainState, z: torch.Tensor,
                   batch: Batch, use_ema: bool = True) -> dict:
    b, k = batch.real_traj.shape[0], cfg.k
    gen = gen_params(cfg, state) if use_ema else state.g
    taus = gen(batch.conditions, z)  # [B, k, H, S]
    flat = taus.reshape(b, k, -1)

    # Diversity
    pd = pairwise_l2(flat)  # [B, k, k]
    off = ~torch.eye(k, dtype=torch.bool, device=flat.device)
    mean_pairwise = torch.sum(torch.where(off, pd, 0.0)) / (b * k * (k - 1))
    ndiv = ndiv_loss(z, flat, cfg.ndiv_alpha, impl=cfg.ndiv_impl)

    # Sim-in-the-loop: the B scenes, each with its k samples as candidates.
    per_cond = score_candidates(get_env(cfg.env).make_params(), batch.scenes,
                                taus, cfg.rollout_mode, ScoreWeights(),
                                env=cfg.env)
    # Quality: the endpoint against the scene's goal.  Waypoint mode takes
    # the last waypoint; in action mode the entries are actions, so the
    # rollout's final positions and goal distances stand in.
    if cfg.rollout_mode == "waypoints":
        endpoints = taus[:, :, -1, :]  # [B, k, S]
        endpoint_err = torch.mean(torch.sqrt(torch.sum(
            torch.square(endpoints - batch.scenes.goal[:, None, :]), dim=-1)))
    else:
        endpoints = per_cond.positions[:, :, -1, :]  # [B, k, 2]
        endpoint_err = torch.mean(per_cond.goal_dist)
    out = {
        "eval_mean_pairwise_dist": mean_pairwise,
        "eval_ndiv": ndiv,
        "eval_endpoint_err": endpoint_err,
        "eval_success_rate": torch.mean(per_cond.reached),
        "eval_collision_rate": torch.mean(per_cond.collided),
        "eval_mean_score": torch.mean(per_cond.score),
    }
    if cfg.conditioning == "none":
        # Mode coverage: the unconditioned task's 8 anchor goals sit on a
        # circle around (.5, .5); the share of angular bins, centred on the
        # anchors, that the k samples of a condition hit.
        n_modes = 8
        ang = torch.atan2(endpoints[..., 1] - 0.5, endpoints[..., 0] - 0.5)
        bins = torch.floor(ang / (2.0 * math.pi / n_modes) + 0.5)
        bins = torch.remainder(bins, n_modes).long()  # [B, k]
        hit = F.one_hot(bins, n_modes).amax(dim=1)  # [B, n_modes]
        out["eval_mode_coverage"] = torch.mean(
            hit.sum(dim=-1).float() / n_modes)
    check_finite("eval", out)
    return out
