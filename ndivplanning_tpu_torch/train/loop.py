"""Host-side training loop; counterpart of ``ndivplanning_tpu/train/loop.py``.

The loop runs chunks of steps that end at the next log, checkpoint or eval
boundary, reads the chunk's metrics from the card once there, checkpoints
every N steps, evaluates on the frozen suite with best-of-both (EMA and
raw) checkpoint selection, and restores on start, so a stopped run resumes
its exact bitwise loss curve.  This is the on-device sampler's loop; the
recorded-dataset loop (``train_from_dataset``) is not ported yet.

The port runs in one process.  A config with ``dp_shards * div_shards >
1`` trains over its global batch without a mesh, as the unsharded step
does; the JAX loop routes it to the sharded step.  The JAX loop's compile
row (``kind="compile"``) has no counterpart yet.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch

from ndivplanning_tpu_torch.train.evaluate import evaluate_fixed
from ndivplanning_tpu_torch.train.state import TrainState, create_train_state
from ndivplanning_tpu_torch.train.step import train_chunk, train_step_fused
from ndivplanning_tpu_torch.utils import checkpoint as ckpt
from ndivplanning_tpu_torch.utils.config import Config, save_config
from ndivplanning_tpu_torch.utils.metrics import MetricsWriter, host_floats

# Metrics where smaller is better; everything else is maximised by the
# best-checkpoint tracker.
_LOWER_BETTER = frozenset({
    "eval_endpoint_err", "eval_collision_rate", "eval_ndiv",
    "eval_mean_score", "eval_plan_best_score",
})


def _improved(name: str, value: float, best: Optional[float]) -> bool:
    # A NaN metric must never win, nor become the bar that every later
    # finite value fails to clear (NaN comparisons are all False).
    if value is None or not math.isfinite(value):
        return False
    if best is None or not math.isfinite(best):
        return True
    return value < best if name in _LOWER_BETTER else value > best


def _load_best_metric(workdir: Optional[str], cfg: Config) -> Optional[float]:
    """The tracked metric's value recorded in <workdir>/best/best_path.json,
    or None: a resumed run's tracker continues from the saved best instead
    of letting its first eval (perhaps a trough) overwrite a better one."""
    if not workdir or not cfg.track_best_metric:
        return None
    path = os.path.join(workdir, "best", "best_path.json")
    try:
        with open(path, encoding="utf-8") as f:
            marker = json.load(f)
    except (OSError, ValueError):
        return None
    if marker.get("metric") != cfg.track_best_metric:
        return None
    value = marker.get("value")
    return float(value) if isinstance(value, (int, float)) else None


def _write_best_marker(best_dir: str, eval_path: str, metric: str,
                       value: float, step: int) -> None:
    """Record which generator (raw or EMA) won the best checkpoint's eval."""
    os.makedirs(best_dir, exist_ok=True)
    with open(os.path.join(best_dir, "best_path.json"), "w",
              encoding="utf-8") as f:
        json.dump({"eval_path": eval_path, "metric": metric,
                   "value": value, "step": step}, f)


def _best_candidates(cfg: Config, state: TrainState, ev: dict,
                     raw_eval_fn=None):
    """The (eval_path, metric value, state to save, mean pairwise distance)
    candidates of the best-checkpoint tracker at one eval point.

    With EMA tracking on, the raw generator is evaluated too
    (``raw_eval_fn() -> metrics``): the EMA curve is smoother, but its peak
    can sit below the raw generator's best.  A raw win is saved from a
    shallow copy of the state whose EMA slot is the raw generator, so every
    consumer (eval, plan and serve read the EMA slot) serves the winner.
    Training resumes from the periodic checkpoints, never from best/."""
    track = cfg.track_best_metric
    if not track:
        return []
    candidates = [("ema" if cfg.g_ema_decay > 0 else "raw",
                   ev.get(track), state,
                   ev.get("eval_mean_pairwise_dist"))]
    if cfg.g_ema_decay > 0 and raw_eval_fn is not None:
        ev_raw = raw_eval_fn()
        raw_val = float(ev_raw[track]) if track in ev_raw else None
        if raw_val is not None:
            ev["raw_" + track] = raw_val
        candidates.append(
            ("raw", raw_val, dataclasses.replace(state, g_ema=state.g),
             ev_raw.get("eval_mean_pairwise_dist")))
    return candidates


def _track_best(cfg: Config, workdir, step: int, candidates, best_metric):
    """Save <workdir>/best when the winning candidate improves on
    ``best_metric``; returns the updated best.  One save per eval point:
    the winner is picked before saving."""
    winner = None
    for eval_path, metric, cand_state, div in candidates:
        if metric is None:
            continue
        # Diversity disqualifier (best_min_diversity, off at 0): a candidate
        # that won the metric by collapsing its samples is not served.
        if (cfg.best_min_diversity > 0 and div is not None
                and div < cfg.best_min_diversity):
            continue
        if _improved(cfg.track_best_metric, metric,
                     winner[1] if winner else None):
            winner = (eval_path, metric, cand_state)
    if (workdir and winner is not None
            and _improved(cfg.track_best_metric, winner[1], best_metric)):
        best_metric = winner[1]
        best_dir = os.path.join(workdir, "best")
        # A resumed run can re-reach a step that already has a best
        # checkpoint; save_checkpoint replaces it, so the marker and the
        # weights stay consistent.
        ckpt.save_checkpoint(best_dir, winner[2])
        _write_best_marker(best_dir, winner[0], cfg.track_best_metric,
                           winner[1], step)
    return best_metric


class _LoopObserver:
    """The host-side bookkeeping at chunk boundaries: log cadence
    (steps/sec and a JSONL row), checkpoint cadence, frozen-suite eval with
    best-of-both checkpoint tracking, and the final and interrupt saves.

    ``eval_fn(state, step, use_ema) -> {metric: float}``, or None to
    disable eval."""

    def __init__(self, cfg: Config, workdir: Optional[str],
                 total_steps: int, writer: MetricsWriter, eval_fn=None):
        self.cfg = cfg
        self.workdir = workdir
        self.total = total_steps
        self.writer = writer
        self.eval_fn = eval_fn
        self.history: list[dict] = []
        self.best_metric = _load_best_metric(workdir, cfg)
        self.t_last = time.monotonic()
        self.steps_since_log = 0

    def next_boundary(self, s: int) -> int:
        """First step > s where the host must look at the run."""
        cfg = self.cfg
        cands = [self.total]
        for every in (cfg.log_every, cfg.checkpoint_every, cfg.eval_every):
            if every:
                cands.append((s // every + 1) * every)
        return min(c for c in cands if c > s)

    def at_boundary(self, state: TrainState, step: int, n: int,
                    last: dict) -> None:
        """Log, checkpoint and eval after a chunk of ``n`` steps landed the
        run at ``step``; ``last`` is the newest metrics row (steps_per_sec
        is added to it)."""
        cfg = self.cfg
        self.steps_since_log += n
        if cfg.log_every and (step % cfg.log_every == 0
                              or step >= self.total):
            now = time.monotonic()
            last["steps_per_sec"] = self.steps_since_log / max(
                now - self.t_last, 1e-9)
            self.t_last = now
            self.steps_since_log = 0
            self.writer.write(step, last)
            self.history.append({"step": step, **last})
        if (self.workdir and cfg.checkpoint_every
                and step % cfg.checkpoint_every == 0):
            ckpt.save_checkpoint(self.workdir, state)
        # The final step evals too, so a run whose quality peaks in its
        # last window can still win the best checkpoint.
        if (self.eval_fn is not None and cfg.eval_every
                and (step % cfg.eval_every == 0 or step >= self.total)):
            ev = self.eval_fn(state, step, True)
            # The raw leg runs before the row is written, so the row
            # carries the raw path's tracked metric too.
            candidates = _best_candidates(
                cfg, state, ev,
                raw_eval_fn=lambda: self.eval_fn(state, step, False))
            self.writer.write(step, ev, kind="eval")
            self.best_metric = _track_best(cfg, self.workdir, step,
                                           candidates, self.best_metric)

    def final_save(self, state: TrainState) -> None:
        if self.workdir and self.cfg.checkpoint_every:
            ckpt.save_checkpoint(self.workdir, state)

    def interrupt_save(self, state: TrainState, adam_lead: int) -> None:
        """The save on a KeyboardInterrupt.  The step updates the state in
        place, D's Adam, then G's, then the EMA, and counts the step last,
        so an interrupt inside a step leaves the Adam counts ahead of
        ``state.step + adam_lead`` (their lead at the run's start): such a
        half-updated state is not saved, and the periodic checkpoint stays
        the resume point."""
        whole = (state.d_opt.count == state.g_opt.count
                 == state.step + adam_lead)
        if self.workdir and self.cfg.checkpoint_every and whole:
            ckpt.save_checkpoint(self.workdir, state)


def _check_one_process() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1):
        raise NotImplementedError(
            "train: the multi-rank loop is not ported yet; the port's loop "
            "runs in one process (a dp_shards * div_shards > 1 config "
            "trains over its global batch there)")


def train(cfg: Config, num_steps: Optional[int] = None,
          workdir: Optional[str] = None, restore: bool = True,
          echo: bool = True, device=None):
    """Train an NDiv-GAN per ``cfg`` on ``device`` (default: the card).

    ``workdir=None`` means ``cfg.workdir``; ``""`` disables checkpoints,
    metrics and restore.  Returns (final_state, history), history the list
    of logged metric rows."""
    _check_one_process()
    num_steps = cfg.steps if num_steps is None else num_steps
    workdir = cfg.workdir if workdir is None else workdir

    state = create_train_state(cfg, device=device)
    if restore and workdir:
        restored = ckpt.restore_latest(workdir, state)
        if restored is not None:
            state = restored
    if workdir:
        # Record the config so eval, plan and serve rebuild the same
        # models without retyping flags.
        save_config(cfg, workdir)
    adam_lead = state.d_opt.count - state.step

    writer = MetricsWriter(workdir, echo=echo)
    obs = _LoopObserver(
        cfg, workdir, num_steps, writer,
        eval_fn=lambda state, step, use_ema: host_floats(evaluate_fixed(
            cfg, state, n_scenes=cfg.eval_suite_scenes, use_ema=use_ema)))

    step = state.step
    try:
        while step < num_steps:
            target = obs.next_boundary(step)
            chunk = target - step
            state, metrics = train_chunk(cfg, state, chunk)
            # The one read of the chunk's metrics: where the host waits for
            # the card, inside the try so an interrupt here still saves.
            last = host_floats({k: v[-1] for k, v in metrics.items()})
            step = target
            obs.at_boundary(state, step, chunk, last)
        obs.final_save(state)
    except KeyboardInterrupt:
        obs.interrupt_save(state, adam_lead)
        raise
    finally:
        writer.close()
    return state, obs.history


def run_steps(cfg: Config, state: TrainState, n: int):
    """Run n fused steps without any logging or IO; returns (state, the
    last step's metrics).  A helper for tests and benchmarks."""
    metrics = None
    for _ in range(n):
        state, metrics = train_step_fused(cfg, state)
    return state, metrics
