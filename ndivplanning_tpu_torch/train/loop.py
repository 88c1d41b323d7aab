"""Host-side training loops; counterpart of ``ndivplanning_tpu/train/loop.py``.

:func:`train` runs the on-device sampler's loop: chunks of steps that end
at the next log, checkpoint or eval boundary, the chunk's metrics read
from the card once there, checkpoints every N steps, frozen-suite evals
with best-of-both (EMA and raw) checkpoint selection, and a restore on
start, so a stopped run resumes its exact bitwise loss curve.
:func:`train_from_dataset` is the same loop over a recorded dataset
(``data/host_pipeline.py``): the batch order is the dataset's
deterministic epoch stream, so its step counter is a position in one
dataset, which a marker file in the workdir vouches for on resume.

Under a torch.distributed process group both loops build the
``make_mesh(cfg=cfg)`` mesh (its ``(dp_shards, div_shards)`` must fill the
world; a 1x1 group is a mesh too) and run the sharded step
(``parallel/sharded_step.py``) from rank 0's state: every rank walks the
same global batches, keeps its block, and returns the same metrics.
Rank 0 alone writes the workdir (metrics, checkpoints, the config, the
dataset marker, ``best/``), echoes and evaluates; the others wait for it
at the next step's first collective, and for its last checkpoint before
they return.  Without a process group a ``dp_shards * div_shards > 1``
config trains over its global batch in one process, as the unsharded
step does.  :func:`train` ends its metrics with a ``kind="compile"`` row:
the programs the run compiled (``utils/compile_guard.py``: the CUDA
kernels' and the host plane's builds and ``torch.compile`` graphs), as
the JAX loop counts its XLA programs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ndivplanning_tpu_torch.train.evaluate import evaluate_fixed
from ndivplanning_tpu_torch.train.state import TrainState, create_train_state
from ndivplanning_tpu_torch.train.step import (
    train_chunk,
    train_step_fused,
    train_step_impl,
)
from ndivplanning_tpu_torch.utils import checkpoint as ckpt
from ndivplanning_tpu_torch.utils.compile_guard import start_compile_count
from ndivplanning_tpu_torch.utils.config import Config, save_config
from ndivplanning_tpu_torch.utils.metrics import MetricsWriter, host_floats


def _dataset_marker_path(workdir: str) -> str:
    return os.path.join(workdir, "dataset_run.json")


def _dataset_fingerprint(dataset, cfg: Config) -> dict:
    """What ties a workdir's step counter to one dataset's batch order: the
    JAX package's dict for the same arrays and config (a content hash,
    not only shapes, so a re-recorded file of the same shape is refused)."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(dataset.arrays):
        a = np.ascontiguousarray(dataset.arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return {"dataset_size": int(dataset.size),
            "batch_size": int(cfg.batch_size),
            "seed": int(cfg.seed),
            "arrays": sorted(dataset.arrays),
            "content_blake2b": h.hexdigest()}


def _write_dataset_marker(workdir: str, dataset, cfg: Config) -> None:
    os.makedirs(workdir, exist_ok=True)
    with open(_dataset_marker_path(workdir), "w", encoding="utf-8") as f:
        json.dump(_dataset_fingerprint(dataset, cfg), f)


def _check_dataset_marker(workdir: str, dataset, cfg: Config) -> None:
    """Raise unless ``workdir``'s marker vouches for this dataset run.  Only
    the keys the stored marker has are compared, so a marker written
    before a field existed stays resumable on the same dataset."""
    path = _dataset_marker_path(workdir)
    if not os.path.exists(path):
        raise ValueError(
            f"workdir {workdir!r} holds a checkpoint but no dataset-run "
            "marker: it was trained by a different path (e.g. the "
            "on-device sampler), and its step counter cannot be used as "
            "a position in this dataset. Use a fresh --workdir or "
            "restore=False.")
    with open(path, encoding="utf-8") as f:
        marker = json.load(f)
    want = _dataset_fingerprint(dataset, cfg)
    mismatch = {k: (marker[k], want.get(k))
                for k in marker if marker[k] != want.get(k)}
    if mismatch:
        raise ValueError(
            f"workdir {workdir!r} was trained on a different dataset "
            f"run (mismatched fields: {mismatch}); resuming would "
            "misalign the deterministic batch order. Use a fresh "
            "--workdir.")


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


def _mesh_of(cfg: Config):
    """The run's mesh under a process group (``make_mesh`` raises where
    dp_shards x div_shards does not fill the world), else None."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from ndivplanning_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(cfg=cfg)


def _writes(mesh) -> bool:
    """Whether this process writes the run's files: rank 0 of a mesh."""
    return mesh is None or torch.distributed.get_rank() == 0


def _sync(mesh) -> None:
    """On a mesh, wait for every rank: rank 0's files are complete."""
    if mesh is not None:
        torch.distributed.barrier(group=mesh.world)


def train(cfg: Config, num_steps: Optional[int] = None,
          workdir: Optional[str] = None, restore: bool = True,
          echo: bool = True, device=None):
    """Train an NDiv-GAN per ``cfg`` on ``device`` (default: the card).

    ``workdir=None`` means ``cfg.workdir``; ``""`` disables checkpoints,
    metrics and restore.  Returns (final_state, history), history the list
    of logged metric rows: on a mesh the same on every rank but for
    ``steps_per_sec``, each rank's own clock."""
    num_steps = cfg.steps if num_steps is None else num_steps
    workdir = cfg.workdir if workdir is None else workdir
    # Every program this run compiles, set-up included (logged at the end).
    compile_rec, stop_compile_count = start_compile_count()

    mesh = _mesh_of(cfg)
    state = create_train_state(cfg, device=device)
    if restore and workdir:
        restored = ckpt.restore_latest(workdir, state)
        if restored is not None:
            state = restored
    chunk_steps = {}
    if mesh is not None:
        from ndivplanning_tpu_torch.parallel.sharded_step import (
            make_sharded_train_step,
            shard_state,
        )

        state = shard_state(state, mesh)

        def run_chunk(cfg, state, n):
            # One step function per chunk size, reused.
            if n not in chunk_steps:
                chunk_steps[n] = make_sharded_train_step(cfg, mesh,
                                                         chunk=n)[0]
            return chunk_steps[n](state)
    else:
        run_chunk = train_chunk
    writes = _writes(mesh)
    if not writes:
        workdir, echo = "", False
    if workdir:
        # Record the config so eval, plan and serve rebuild the same
        # models without retyping flags.
        save_config(cfg, workdir)
    adam_lead = state.d_opt.count - state.step

    writer = MetricsWriter(workdir, echo=echo)
    obs = _LoopObserver(
        cfg, workdir, num_steps, writer,
        eval_fn=None if not writes else (
            lambda state, step, use_ema: host_floats(evaluate_fixed(
                cfg, state, n_scenes=cfg.eval_suite_scenes,
                use_ema=use_ema))))

    step = state.step
    try:
        while step < num_steps:
            target = obs.next_boundary(step)
            chunk = target - step
            state, metrics = run_chunk(cfg, state, chunk)
            # The one read of the chunk's metrics: where the host waits for
            # the card, inside the try so an interrupt here still saves.
            last = host_floats({k: v[-1] for k, v in metrics.items()})
            step = target
            obs.at_boundary(state, step, chunk, last)
        stop_compile_count()
        writer.write(step, compile_rec.row(), kind="compile")
        obs.final_save(state)
    except KeyboardInterrupt:
        obs.interrupt_save(state, adam_lead)
        raise
    finally:
        stop_compile_count()
        writer.close()
    _sync(mesh)
    return state, obs.history


def train_from_dataset(cfg: Config, dataset, num_epochs: int,
                       state: TrainState | None = None, prefetch: int = 2,
                       workdir: Optional[str] = None, restore: bool = True,
                       echo: bool = False, eval_dataset=None,
                       eval_suite: bool = False, device=None):
    """Train from a recorded dataset (``data/host_pipeline.py``) instead of
    the on-device sampler, with :func:`train`'s bookkeeping.

    - Batches carry their recorded scenes (or the exact obstacle-free
      rebuild of a start/goal dataset without them).
    - Metrics go through :class:`MetricsWriter`; ``workdir`` (None: none)
      gets checkpoints every ``cfg.checkpoint_every`` steps, the dataset
      marker and the config.  A restore on start resumes the batch order
      (epoch e shuffles with ``cfg.seed + e``) after the consumed prefix,
      so the resumed run is bitwise the uninterrupted one; a workdir with
      a checkpoint but no marker, or another dataset's, is refused.
    - ``eval_dataset`` (e.g. from ``train_eval_split``) is the held-out
      eval every ``cfg.eval_every`` steps: ``evaluate_on_batch`` against
      its true scenes with latents fixed from ``cfg.seed + 1``.
      ``eval_suite=True`` evaluates on the frozen suite
      (``evaluate_fixed``) instead, the expert-iteration fine-tune's
      protocol (``train/distill.py``); the two exclude each other.
    - A dataset whose converted batch (scenes included) fits
      ``NDIV_DATASET_DEVICE_MB`` (default 512; 0 disables) is uploaded to
      the device once and each step gathers its rows with
      ``index_select``; otherwise a prefetch thread streams the batches
      (``prefetch`` batches ahead: it applies to this path only).  Both
      give bitwise the same states.
    - Each step runs as its batch arrives; metrics are read from the
      device at the log, checkpoint and eval boundaries, the JAX loop's
      flush points.
    - Under a process group every rank walks the same global batches
      (device-resident or streamed, as above) through the sharded step,
      which keeps each rank's block; rank 0 alone writes and evaluates.

    ``state=None`` starts from ``create_train_state(cfg, device=device)``
    (default: the card).  Returns (state, the last metrics row)."""
    from ndivplanning_tpu_torch.data.host_pipeline import (
        batch_from_arrays,
        batch_nbytes,
        prefetch_to_device,
    )
    from ndivplanning_tpu_torch.train.evaluate import evaluate_on_batch

    if eval_suite and eval_dataset is not None:
        raise ValueError("eval_suite and eval_dataset are mutually "
                         "exclusive: pick one eval protocol")
    steps_per_epoch = dataset.size // cfg.batch_size
    if steps_per_epoch == 0:
        raise ValueError(
            f"dataset of {dataset.size} examples is smaller than one "
            f"batch ({cfg.batch_size})")
    total_steps = num_epochs * steps_per_epoch

    mesh = _mesh_of(cfg)
    if state is None:
        state = create_train_state(cfg, device=device)
    device = state.rng.device
    if restore and workdir and ckpt.latest_step(workdir) is not None:
        # The step counter is a position in this dataset's batch order:
        # refuse a checkpoint the marker does not vouch for before loading
        # it into the state.
        _check_dataset_marker(workdir, dataset, cfg)
        state = ckpt.restore_latest(workdir, state)
    if mesh is not None:
        from ndivplanning_tpu_torch.parallel.sharded_step import shard_state

        state = shard_state(state, mesh)
    writes = _writes(mesh)
    if not writes:
        workdir, echo = None, False
    if workdir:
        _write_dataset_marker(workdir, dataset, cfg)
        save_config(cfg, workdir)
    adam_lead = state.d_opt.count - state.step

    def to_batch(arrays):
        return batch_from_arrays(arrays, cfg.conditioning)

    eval_fn = None  # rank 0 alone evaluates
    if eval_suite and writes:
        def eval_fn(state, step, use_ema):
            return host_floats(evaluate_fixed(
                cfg, state, n_scenes=cfg.eval_suite_scenes, use_ema=use_ema))
    elif eval_dataset is not None and writes:
        n_eval = ((eval_dataset.size // cfg.batch_size) * cfg.batch_size
                  or eval_dataset.size)
        eval_batch = to_batch({k: v[:n_eval] for k, v in
                               eval_dataset.arrays.items()}).map(
            lambda t: t.to(device))

        def eval_fn(state, step, use_ema):
            # Latents fixed across eval points, so the best-of tracker
            # selects on the generator, not on the draw.
            return host_floats(evaluate_on_batch(
                cfg, state, torch.Generator().manual_seed(cfg.seed + 1),
                eval_batch, use_ema=use_ema))

    start_step = state.step
    if start_step >= total_steps:
        return state, {}

    def epoch_indices():
        """Each epoch's ``[steps, batch]`` indices, from the resumed step
        on."""
        for e in range(num_epochs):
            lo = max(start_step - e * steps_per_epoch, 0)
            if lo < steps_per_epoch:
                idx = np.stack(list(dataset.batch_indices(
                    cfg.batch_size, seed=cfg.seed + e)))
                yield idx[lo:]

    row_bytes = batch_nbytes(to_batch({k: v[:1] for k, v in
                                       dataset.arrays.items()}))
    dev_mb = int(os.environ.get("NDIV_DATASET_DEVICE_MB", "512"))
    if dev_mb > 0 and row_bytes * dataset.size <= (dev_mb << 20):
        # Device-resident: the converted dataset goes to the device once;
        # each epoch's order follows as one index upload.
        full = to_batch(dataset.arrays).map(lambda t: t.to(device))

        def resident():
            for idx in epoch_indices():
                idx = torch.from_numpy(idx).to(device)
                for row in idx:
                    yield full.map(lambda t: t.index_select(0, row))

        stream = resident()
    else:
        stream = prefetch_to_device(
            (to_batch({k: v[i] for k, v in dataset.arrays.items()})
             for idx in epoch_indices() for i in idx),
            buffer_size=prefetch, device=device)

    writer = MetricsWriter(workdir, echo=echo)
    obs = _LoopObserver(cfg, workdir, total_steps, writer, eval_fn=eval_fn)
    last: dict = {}
    step = seen = start_step
    target = obs.next_boundary(step)
    try:
        for batch in stream:
            state, metrics = train_step_impl(cfg, state, batch, mesh=mesh)
            step += 1
            if step < target:
                continue
            # The one read of the metrics since the last boundary.
            last = host_floats(metrics)
            obs.at_boundary(state, step, step - seen, last)
            seen, target = step, obs.next_boundary(step)
        obs.final_save(state)
    except KeyboardInterrupt:
        obs.interrupt_save(state, adam_lead)
        raise
    finally:
        writer.close()
    _sync(mesh)
    return state, last


def run_steps(cfg: Config, state: TrainState, n: int):
    """Run n fused steps without any logging or IO; returns (state, the
    last step's metrics).  A helper for tests and benchmarks."""
    metrics = None
    for _ in range(n):
        state, metrics = train_step_fused(cfg, state)
    return state, metrics
