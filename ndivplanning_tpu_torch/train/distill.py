"""Expert iteration: distill a planner back into G; counterpart of ``ndivplanning_tpu/train/distill.py``.

1. :func:`record_planner_dataset` runs a planner (closed-loop MPC by
   default; trajopt, iLQR, CEM -> trajopt or the one-shot planner) over
   freshly sampled scenes, executes every planned trajectory again
   OPEN-LOOP against its true scene, and records the successes as expert
   data in ``record_dataset``'s npz schema (conditions, real_traj and the
   scene ground truth).
2. :func:`expert_iteration` alternates record -> GAN fine-tune
   (``train_from_dataset``) -> frozen-suite eval, and keeps a round only
   when the tracked metric improves and the diversity stays above its
   floor: a degrading round is reported, not kept.

The open-loop check keeps the training targets honest: an MPC episode
succeeds under feedback, but its executed positions replayed as a
waypoint plan may not.  MPC records ``total_steps = cfg.horizon`` steps
by default, so executed positions map one to one onto waypoint slots.

Scenes and every chunk's planner noise are drawn on the CPU (the scenes
from ``seed``; each chunk from a generator seeded by one draw of a
generator seeded ``seed + 1``) and moved to the state's device, so a
recording is the same on the card and on the CPU up to rounding.  JAX
draws a key per row instead, so its recordings do not depend on
``scene_chunk``; the port's do.

The port's train step updates modules and Adam moments in place, so
:func:`reset_for_finetune` copies everything it carries over: a rejected
round leaves the caller's state as it was.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ndivplanning_tpu_torch.data.host_pipeline import (
    ArrayDataset,
    save_recording,
)
from ndivplanning_tpu_torch.envs.registry import get_env
from ndivplanning_tpu_torch.envs.rollout import (
    ScoreWeights,
    distill_actions,
    score_candidates,
)
from ndivplanning_tpu_torch.train.state import (
    TrainState,
    build_optimizers,
    create_train_state,
    fresh_ada,
    fresh_lecam_ema,
)
from ndivplanning_tpu_torch.utils import checkpoint as ckpt
from ndivplanning_tpu_torch.utils.config import Config
from ndivplanning_tpu_torch.utils.metrics import host_floats

# Default scene seed for expert recording, distinct from the frozen eval
# suite's EVAL_SUITE_SEED: recording on suite scenes would train the
# generator on its own test set.
RECORD_SEED = 0xD157

TEACHERS = ("mpc", "trajopt", "ilqr", "cem+trajopt", "oneshot")


@torch.no_grad()
def _verify_open_loop(cfg: Config, scenes, trajs: torch.Tensor):
    """(reached, collided) ``[B]`` of ``trajs [B, H, S]`` executed
    open-loop in ``cfg.rollout_mode`` against their true scenes."""
    result = score_candidates(get_env(cfg.env).make_params(), scenes,
                              trajs[:, None], cfg.rollout_mode,
                              ScoreWeights(), env=cfg.env)
    return result.reached[:, 0], result.collided[:, 0]


@torch.no_grad()
def _distill_actions_batch(cfg: Config, scenes,
                           waypoints: torch.Tensor) -> torch.Tensor:
    """Waypoint paths ``[B, H, 2]`` -> the family's expert actions ``[B, H,
    du]`` (``envs/rollout.py::distill_actions``), as the action-mode
    sampler makes them."""
    return distill_actions(get_env(cfg.env).make_params(), scenes,
                           waypoints[:, None], cfg.env)[:, 0]


def _subsample_to_horizon(positions: np.ndarray, horizon: int) -> np.ndarray:
    """[B, T, P] executed positions -> [B, H, P] waypoint slots: the
    positions reached at the waypoint time grid ((i+1)/H of the episode),
    the identity when T == H."""
    t = positions.shape[1]
    if t == horizon:
        return positions
    if t < horizon:
        # idx[0] would be -1: the final position in the first slot.
        raise ValueError(
            f"recorded episodes have {t} steps but the waypoint grid "
            f"needs >= horizon={horizon}; raise total_steps")
    idx = ((np.arange(horizon) + 1) * t) // horizon - 1
    return positions[:, idx, :]


def _expert_noise_shape(cfg: Config, planner: str, total_steps: int,
                        replan_every: int,
                        n_candidates: int) -> tuple[int, ...]:
    """One scene's planner noise: MPC's latents of every cycle, the
    refiners' warm-start latents (iLQR at ``max(n // 16, 2)``), CEM's
    population draws for cem+trajopt, or the one-shot candidates'."""
    from ndivplanning_tpu_torch.planning.ilqr import resolve_ilqr_budget
    from ndivplanning_tpu_torch.planning.refine import noise_shape
    from ndivplanning_tpu_torch.planning.trajopt import resolve_budget

    zdim = cfg.latent_dim
    if planner == "mpc":
        return (total_steps // replan_every, n_candidates, zdim)
    if planner == "trajopt":
        return (resolve_budget(cfg, n_candidates)[0], zdim)
    if planner == "ilqr":
        return (resolve_ilqr_budget(cfg, max(n_candidates // 16, 2))[0],
                zdim)
    if planner == "cem+trajopt":
        return noise_shape(cfg, "cem+trajopt")
    if planner == "oneshot":
        return (n_candidates, zdim)
    raise ValueError(f"unknown planner {planner!r}; choose from "
                     f"{list(TEACHERS)}")


def _chunk_noise(seeds: torch.Generator, rows: int,
                 shape: tuple[int, ...]) -> torch.Tensor:
    """One chunk's planner noise ``[rows, *shape]`` on the CPU, from a
    generator seeded by the next draw of ``seeds``."""
    gen = torch.Generator().manual_seed(int(torch.randint(
        2**62, (1,), generator=seeds)))
    return torch.randn((rows, *shape), generator=gen)


@torch.no_grad()
def _plan_expert_chunk(cfg: Config, state: TrainState, scenes, conditions,
                       noise: torch.Tensor, *, planner: str,
                       total_steps: int, replan_every: int,
                       n_candidates: int) -> np.ndarray:
    """One recording dispatch: ``[chunk, H, S]`` candidate expert
    trajectories (waypoint positions for MPC; the caller distills them to
    actions in action mode) from the chunk's ``noise``."""
    if planner == "mpc":
        from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch

        # In action mode MPC proposes and scores actions; the executed
        # positions are what is recorded either way.
        res = mpc_rollout_batch(cfg, state, scenes, conditions,
                                total_steps=total_steps,
                                replan_every=replan_every,
                                n_candidates=n_candidates, z=noise)
        return _subsample_to_horizon(res.positions.cpu().numpy(),
                                     cfg.horizon)
    if planner == "trajopt":
        from ndivplanning_tpu_torch.planning.trajopt import plan_trajopt_batch

        plan, _ = plan_trajopt_batch(cfg, state, scenes, conditions,
                                     n_candidates=noise.shape[1], z=noise)
    elif planner == "ilqr":
        # The second-order teacher: smooth, dynamically consistent optima.
        from ndivplanning_tpu_torch.planning.ilqr import plan_ilqr_batch

        plan, _ = plan_ilqr_batch(cfg, state, scenes, conditions,
                                  n_candidates=noise.shape[1], z=noise)
    elif planner == "cem+trajopt":
        from ndivplanning_tpu_torch.planning.trajopt import (
            plan_cem_trajopt_batch,
        )

        plan, _ = plan_cem_trajopt_batch(cfg, state, scenes, conditions,
                                         eps=noise)
    elif planner == "oneshot":
        # Self-distillation: the best of n_candidates of the current G,
        # its only edge over the student selection plus the open-loop
        # filter.
        from ndivplanning_tpu_torch.planning.planner import plan_batch

        plan = plan_batch(cfg, state, scenes, conditions,
                          n_candidates=noise.shape[1], z=noise)
    else:
        raise ValueError(f"unknown planner {planner!r}; choose from "
                         f"{list(TEACHERS)}")
    return plan.best_traj.cpu().numpy()


def record_planner_dataset(cfg: Config, state: TrainState, n_scenes: int,
                           path: str, *, planner: str = "mpc",
                           seed: int = RECORD_SEED, per_scene: int = 1,
                           total_steps: Optional[int] = None,
                           replan_every: int = 8, n_candidates: int = 256,
                           scene_chunk: int = 128,
                           success_only: bool = True) -> dict:
    """Record planner-made expert trajectories to ``path`` (npz).

    Scenes come from the preset's task sampler at ``seed`` (not the
    frozen suite's seed); each is planned ``per_scene`` times with its own
    noise (diverse expert draws), ``scene_chunk`` rows a dispatch, on the
    state's device.  Every trajectory is executed again open-loop against
    its true scene and, with ``success_only``, kept only if it reached the
    goal without a collision.

    Returns the kept and dropped counts, the open-loop keep rate (how much
    of the teacher's skill survives open-loop replay) and the recording's
    parameters."""
    from ndivplanning_tpu_torch.data.tasks import make_task

    if planner == "mpc":
        total = cfg.horizon if total_steps is None else total_steps
        if total % replan_every:
            raise ValueError(
                f"mpc recording needs total_steps % replan_every == 0, "
                f"got {total} % {replan_every}")
    else:
        total = total_steps or cfg.horizon
    shape = _expert_noise_shape(cfg, planner, total, replan_every,
                                n_candidates)
    device = state.rng.device
    batch = make_task(cfg).sample(torch.Generator().manual_seed(seed),
                                  n_scenes)
    if per_scene > 1:  # back-to-back copies of each scene
        batch = batch.map(lambda t: t.repeat_interleave(per_scene, dim=0))
    n_rows = n_scenes * per_scene
    seeds = torch.Generator().manual_seed(seed + 1)

    trajs, reached, collided = [], [], []
    for lo in range(0, n_rows, scene_chunk):
        rows = slice(lo, min(lo + scene_chunk, n_rows))
        part = batch.map(lambda t: t[rows].to(device))
        noise = _chunk_noise(seeds, part.conditions.shape[0], shape).to(
            device)
        tau = torch.from_numpy(_plan_expert_chunk(
            cfg, state, part.scenes, part.conditions, noise, planner=planner,
            total_steps=total, replan_every=replan_every,
            n_candidates=n_candidates)).to(device)
        if cfg.rollout_mode == "actions" and planner == "mpc":
            tau = _distill_actions_batch(cfg, part.scenes, tau)
        r, c = _verify_open_loop(cfg, part.scenes, tau)
        trajs.append(tau.float().cpu())
        reached.append(r.cpu())
        collided.append(c.cpu())

    reached = torch.cat(reached).numpy()
    collided = torch.cat(collided).numpy()
    ok = (reached > 0.5) & (collided < 0.5)
    keep = ok if success_only else np.ones(n_rows, bool)
    save_recording(path, batch.conditions, torch.cat(trajs), batch.scenes,
                   keep)
    return {
        "planner": planner,
        "n_scenes": int(n_scenes),
        "per_scene": int(per_scene),
        "kept": int(keep.sum()),
        "dropped": int((~keep).sum()),
        "open_loop_keep_rate": float(ok.mean()),
        "total_steps": int(total),
        "replan_every": int(replan_every) if planner == "mpc" else None,
        "n_candidates": int(n_candidates),
        "seed": int(seed),
        "path": path,
    }


def reset_for_finetune(cfg: Config, state: TrainState) -> TrainState:
    """A state re-based for a dataset fine-tune: step 0 (the fine-tune
    reads its step as a position in the new dataset's batch order), fresh
    Adam chains at count 0, fresh ADA and LeCam states, and COPIES of G,
    D, the EMA G and the generator's state.

    The copies are load-bearing: the step updates modules and moments in
    place, so a shared module would let a rejected round's fine-tune
    overwrite the caller's state, which the next round records from."""
    g, d = copy.deepcopy(state.g), copy.deepcopy(state.d)
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    g_opt, d_opt = build_optimizers(cfg, g, d)
    return TrainState(step=0, rng=rng, g=g, d=d, g_opt=g_opt, d_opt=d_opt,
                      g_ema=copy.deepcopy(state.g_ema),
                      ada=fresh_ada(state.rng.device),
                      lecam_ema=fresh_lecam_ema(state.rng.device))


def _suite_metrics(cfg: Config, state: TrainState, n_scenes: int,
                   planner_track: Optional[str] = None) -> dict:
    """Frozen-suite metrics, with the one-shot planner ladder's
    ``eval_plan_*`` merged when a round is adjudicated on it (families
    whose per-draw success already sits at its ceiling)."""
    from ndivplanning_tpu_torch.train.evaluate import (
        evaluate_fixed,
        evaluate_fixed_planner,
    )

    out = host_floats(evaluate_fixed(cfg, state, n_scenes=n_scenes))
    if planner_track:
        pm = evaluate_fixed_planner(cfg, state, planner=planner_track,
                                    n_scenes=n_scenes)
        out.update({k: v for k, v in pm.items() if not isinstance(v, str)})
    return out


def _write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f)


def expert_iteration(cfg: Config, state: Optional[TrainState] = None, *,
                     rounds: int = 1, scenes_per_round: int = 2048,
                     per_scene: int = 1, epochs: Optional[int] = None,
                     planner: str = "mpc", replan_every: int = 8,
                     total_steps: Optional[int] = None,
                     n_candidates: int = 256, scene_chunk: int = 128,
                     workdir: Optional[str] = None, seed: int = RECORD_SEED,
                     suite_scenes: int = 512, echo: bool = False,
                     min_diversity_frac: float = 0.5,
                     track: Optional[str] = None, device=None):
    """Iterated distillation: record the planner's successes -> GAN
    fine-tune on them -> frozen-suite eval; a round is kept only if the
    tracked metric improves (monotone expert iteration).

    ``epochs=None`` sizes each fine-tune to ~5000 optimizer steps.  The
    fine-tune evaluates at ~20 points and its best-of-both tracker keeps
    the best point above the diversity floor (``best_min_diversity``).
    A round is accepted only if ``eval_mean_pairwise_dist`` stays at least
    ``min_diversity_frac`` of the PRE-ITERATION model's (0 disables): a
    generator that won success by losing its modes is no better planner.
    Finished rounds resume from ``<round>/report_row.json`` (an accepted
    one from its ``best/`` checkpoint), a recording is reused only when
    its ``record.json`` echoes this call's parameters, and ``best/`` is
    wiped before a fine-tune.  ``state=None`` starts from
    ``create_train_state(cfg, device=device)``; the caller's state is
    never modified.  Returns ``(state, report)``, a row a round."""
    from ndivplanning_tpu_torch.train.loop import _improved, train_from_dataset

    if state is None:
        state = create_train_state(cfg, device=device)
    track = track or cfg.track_best_metric or "eval_success_rate"
    # A planner-ladder metric (eval_plan_*) is adjudicated on the one-shot
    # ladder, the student's own serving mode, whatever planner teaches.
    planner_track = "oneshot" if track.startswith("eval_plan_") else None
    workdir = workdir or os.path.join(cfg.workdir or "/tmp/ndivplanning_tpu",
                                      "distill")

    report = []
    before = _suite_metrics(cfg, state, suite_scenes, planner_track)
    best_val = before.get(track)
    # Anchored on the model before iteration: every accepted round must
    # clear it (no ratcheting down).
    div_floor = min_diversity_frac * before.get("eval_mean_pairwise_dist",
                                                0.0)
    for r in range(rounds):
        round_dir = os.path.join(workdir, f"round_{r}")
        npz = os.path.join(round_dir, "expert.npz")
        row_path = os.path.join(round_dir, "report_row.json")
        if os.path.exists(row_path):
            with open(row_path, encoding="utf-8") as f:
                row = json.load(f)
            report.append(row)
            if row.get("accepted"):
                best = ckpt.restore_latest(os.path.join(round_dir, "best"),
                                           reset_for_finetune(cfg, state))
                if best is None:
                    # Going on from the pre-round state would contradict
                    # the report's lift.
                    raise RuntimeError(
                        f"resume: round {r} is marked accepted but its "
                        f"best checkpoint under {round_dir} failed to "
                        "restore; delete report_row.json to re-run it")
                state = best
                before = row["after"]
                best_val = row["after"].get(track)
            continue
        rec_path = os.path.join(round_dir, "record.json")
        # A recording is reused only if it was made with this call's
        # parameters (record.json echoes them).
        reuse = False
        if os.path.exists(rec_path) and os.path.exists(npz):
            with open(rec_path, encoding="utf-8") as f:
                stats = json.load(f)
            want = {"planner": planner, "n_scenes": int(scenes_per_round),
                    "per_scene": int(per_scene), "seed": int(seed + r),
                    "n_candidates": int(n_candidates)}
            stale = {k: (stats.get(k), v) for k, v in want.items()
                     if stats.get(k) != v}
            if stale and echo:
                print(f"[distill] round {r}: recorded dataset is stale "
                      f"({stale}); re-recording")
            reuse = not stale
        if not reuse:
            stats = record_planner_dataset(
                cfg, state, scenes_per_round, npz, planner=planner,
                seed=seed + r, per_scene=per_scene, total_steps=total_steps,
                replan_every=replan_every, n_candidates=n_candidates,
                scene_chunk=scene_chunk)
            _write_json(rec_path, stats)
        # A crashed attempt can leave a best/ whose marker the fresh
        # fine-tune's tracker could never beat: this round owns it.
        shutil.rmtree(os.path.join(round_dir, "best"), ignore_errors=True)
        row = {"round": r, "record": stats, "before": before}
        if stats["kept"] == 0:
            row.update({"accepted": False,
                        "error": "planner recorded zero successes"})
            _write_json(row_path, row)
            report.append(row)
            continue
        ds = ArrayDataset.from_npz(npz)
        cfg_ft = cfg
        if ds.size < cfg.batch_size:
            # A heavily filtered recording can undershoot the batch:
            # shrink rather than refuse.
            cfg_ft = cfg.replace(batch_size=ds.size)
            row["batch_size"] = ds.size
        steps_per_epoch = max(ds.size // cfg_ft.batch_size, 1)
        n_epochs = epochs if epochs is not None else max(
            -(-5000 // steps_per_epoch), 1)
        row["epochs"] = n_epochs
        # ~20 eval points: a fine-tune on a small expert set peaks early
        # and then collapses, and a recorded soak's eval_every would only
        # see the end.
        cadence = max(n_epochs * steps_per_epoch // 20, 1)
        cfg_ft = cfg_ft.replace(eval_every=cadence, log_every=cadence,
                                best_min_diversity=div_floor)
        ft, _ = train_from_dataset(cfg_ft, ds, num_epochs=n_epochs,
                                   state=reset_for_finetune(cfg_ft, state),
                                   workdir=round_dir, restore=False,
                                   echo=echo, eval_suite=True)
        # The fine-tune's best-of-both checkpoint on the frozen suite, over
        # its (possibly degraded) final state.
        best = ckpt.restore_latest(os.path.join(round_dir, "best"), ft)
        cand = best if best is not None else ft
        after = _suite_metrics(cfg, cand, suite_scenes, planner_track)
        row["after"] = after
        accepted = _improved(track, after.get(track), best_val)
        div_after = after.get("eval_mean_pairwise_dist", 0.0)
        if accepted and div_after < div_floor:
            accepted = False
            row["rejected_for_diversity"] = {
                "eval_mean_pairwise_dist": div_after, "floor": div_floor}
        row["accepted"] = bool(accepted)
        if accepted:
            state = cand
            best_val = after.get(track)
            before = after
        _write_json(row_path, row)
        report.append(row)
    return state, report
