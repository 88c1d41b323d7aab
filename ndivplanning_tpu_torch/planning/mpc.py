"""Receding-horizon (MPC) closed-loop planning; counterpart of ``ndivplanning_tpu/planning/mpc.py``.

Instead of executing one open-loop trajectory, the controller replans
every ``replan_every`` steps, scoring N candidates of G from the live
state of its scene, and executes the next slice of the winner.  At
episode time t only a candidate's remaining tail ``tau[t:]`` lies ahead,
so scoring and execution both use the tail, shifted to the front and
padded with the last waypoint by an index tensor (one shape every cycle).

The scenes are a batch axis ``[B]`` and the candidates an axis ``N``, as
in ``planning/planner.py``; the cycles and the executed steps are Python
loops.  A cycle's latents ``[B, N, zdim]`` are drawn from the caller's
generator on the conditions' device, or injected: ``z [B, n_cycles, N,
zdim]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.rollout import ScoreWeights, time_loop
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.planning.planner import (
    nan_safe,
    score_rollouts,
)
from ndivplanning_tpu_torch.train.state import TrainState, gen_params
from ndivplanning_tpu_torch.utils.config import Config
from ndivplanning_tpu_torch.utils.profiling import check_finite


class MPCResult(NamedTuple):
    """Closed-loop episodes; :func:`mpc_rollout_batch` leads positions and
    flags with ``[B]``, the one-scene entry points do not."""

    positions: torch.Tensor  # [B, T, 2] executed closed-loop path
    final_state: object  # the family's state, one candidate: [B, 1]
    #   ([1, 1] from the one-scene entry points)
    reached: torch.Tensor  # [B] {0, 1}
    collided: torch.Tensor  # [B] {0, 1}
    n_replans: int


@torch.no_grad()
def _episodes(cfg: Config, state: TrainState, scenes: Scene,
              conditions: torch.Tensor, generator: torch.Generator | None,
              z: torch.Tensor | None, total_steps: int, replan_every: int,
              n_candidates: int, weights: ScoreWeights) -> MPCResult:
    """B episodes in one pass, the last cycle short when ``replan_every``
    does not divide ``total_steps``."""
    api = get_env(cfg.env)
    params = api.make_params()
    b, device = conditions.shape[0], conditions.device
    horizon = cfg.horizon
    arange_h = torch.arange(horizon, device=device)
    rows = torch.arange(b, device=device)
    env_state = api.reset(params, scenes, 1)  # [B, 1]
    positions = []
    starts = range(0, total_steps, replan_every)
    for cycle, t0 in enumerate(starts):
        zc = (torch.randn((b, n_candidates, cfg.latent_dim),
                          generator=generator, device=device)
              if z is None else z[:, cycle].to(device))
        taus = gen_params(cfg, state)(conditions, zc)  # [B, N, H, S]
        # The remaining tail shifted to the front, end-padded.
        idx = torch.clamp(arange_h + min(t0, horizon - 1), max=horizon - 1)
        taus = taus.index_select(2, idx)
        results = score_rollouts(cfg, scenes, taus, weights,
                                 state0=env_state)
        best = torch.argmin(nan_safe(results.score), dim=1)  # [B]
        n_exec = min(replan_every, total_steps - t0)
        wp_idx = torch.clamp(torch.arange(n_exec, device=device),
                             max=horizon - 1)
        slice_ = taus[rows, best].index_select(1, wp_idx)  # [B, n, S]

        def execute(env_state, wp, scenes):
            wp = wp[:, None, :]  # [B, 1, S]
            a = (wp if cfg.rollout_mode == "actions"
                 else api.waypoint_control(params, env_state, wp))
            env_state, _ = api.step(params, scenes, env_state, a)
            return env_state, (env_state.pos[:, 0],)

        env_state, (executed,) = time_loop(execute, env_state,
                                           slice_.movedim(1, 0), (1,), scenes)
        positions.append(executed)  # [B, n, 2]
    result = MPCResult(positions=torch.cat(positions, dim=1),
                       final_state=env_state, reached=env_state.done[:, 0],
                       collided=env_state.collided[:, 0],
                       n_replans=len(starts))
    check_finite("closed-loop episode", {"positions": result.positions})
    return result


def _one(result: MPCResult) -> MPCResult:
    """A one-scene batch's result without its ``[B]`` axis."""
    return result._replace(positions=result.positions[0],
                           reached=result.reached[0],
                           collided=result.collided[0])


def _check_fused(total_steps: int, replan_every: int) -> None:
    if total_steps % replan_every:
        raise ValueError(
            f"fused MPC needs total_steps % replan_every == 0 for a "
            f"uniform cycle scan, got {total_steps} % {replan_every}")


def mpc_rollout(cfg: Config, state: TrainState, scene: Scene,
                condition: torch.Tensor,
                generator: torch.Generator | None = None,
                total_steps: int = 64, replan_every: int = 8,
                n_candidates: int = 256,
                weights: ScoreWeights = ScoreWeights(),
                z: torch.Tensor | None = None) -> MPCResult:
    """One closed-loop episode of one scene (no batch axis on ``scene`` or
    ``condition``); the last cycle executes ``total_steps % replan_every``
    steps when that is not 0.  ``z [n_cycles, N, zdim]`` replaces the
    latent draws.  Returns positions ``[T, 2]`` and scalar flags."""
    return _one(_episodes(cfg, state, Scene.stack([scene]), condition[None],
                          generator, None if z is None else z[None],
                          total_steps, replan_every, n_candidates, weights))


def mpc_rollout_fused(cfg: Config, state: TrainState, scene: Scene,
                      condition: torch.Tensor,
                      generator: torch.Generator | None = None,
                      total_steps: int = 64, replan_every: int = 8,
                      n_candidates: int = 256,
                      weights: ScoreWeights = ScoreWeights(),
                      z: torch.Tensor | None = None) -> MPCResult:
    """:func:`mpc_rollout` with uniform cycles: ``total_steps`` must be a
    multiple of ``replan_every`` (the JAX package scans the cycles)."""
    _check_fused(total_steps, replan_every)
    return mpc_rollout(cfg, state, scene, condition, generator, total_steps,
                       replan_every, n_candidates, weights, z)


def mpc_rollout_batch(cfg: Config, state: TrainState, scenes: Scene,
                      conditions: torch.Tensor,
                      generator: torch.Generator | None = None,
                      total_steps: int = 64, replan_every: int = 8,
                      n_candidates: int = 256,
                      weights: ScoreWeights = ScoreWeights(),
                      z: torch.Tensor | None = None) -> MPCResult:
    """Closed-loop episodes of B stacked scenes in one pass: suite-scale
    closed-loop eval, ``plan --mpc`` and the server's ``"mpc": true``
    requests.  ``scenes`` leads with ``[B]``, ``conditions`` is ``[B,
    ...]``; ``z [B, n_cycles, N, zdim]`` replaces the latent draws.  The
    launches per cycle do not grow with B."""
    _check_fused(total_steps, replan_every)
    return _episodes(cfg, state, scenes, conditions, generator, z,
                     total_steps, replan_every, n_candidates, weights)
