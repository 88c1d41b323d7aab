"""Host data pipeline for recorded datasets; counterpart of ``ndivplanning_tpu/data/host_pipeline.py``.

The synthetic tasks sample on the device; this is the path for recorded
datasets (expert trajectories saved to ``.npz``): shuffled epochs on the
host, in the JAX package's batch order (numpy's
``default_rng(seed).permutation``), and a prefetch thread that stages the
next batches into pinned memory and copies them to the card on a side
stream while the current step runs.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Iterator, Mapping

import numpy as np
import torch

from ndivplanning_tpu_torch.data.tasks import Batch
from ndivplanning_tpu_torch.envs.types import MAX_OBSTACLES, Scene
from ndivplanning_tpu_torch.utils.device import resolve_device

# The arrays a recording holds, in the JAX package's schema.
RECORD_KEYS = ("conditions", "real_traj", "scene_start", "scene_goal",
               "scene_obstacles", "scene_obstacle_mask")


class ArrayDataset:
    """In-memory dataset of aligned arrays (conditions, trajectories, ...)
    sharing the leading example axis.  ``from_npz`` loads a file saved by
    ``np.savez(path, conditions=..., real_traj=...)``."""

    def __init__(self, arrays: Mapping[str, np.ndarray]):
        if not arrays:
            raise ValueError("empty dataset")
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"misaligned leading axes: {sizes}")
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        self.size = next(iter(sizes.values()))

    @classmethod
    def from_npz(cls, path: str) -> "ArrayDataset":
        with np.load(path) as f:
            return cls({k: f[k] for k in f.files})

    def batch_indices(self, batch_size: int, *, seed: int = 0,
                      drop_remainder: bool = True) -> Iterator[np.ndarray]:
        """One shuffled epoch of example-index batches, deterministic in
        ``seed``: the one source of the batch order, for :meth:`batches`
        and for the device-resident path of ``train/loop.py``."""
        order = np.random.default_rng(seed).permutation(self.size)
        stop = ((self.size // batch_size) * batch_size if drop_remainder
                else self.size)
        for i in range(0, stop, batch_size):
            yield order[i:i + batch_size]

    def batches(self, batch_size: int, *, seed: int = 0,
                drop_remainder: bool = True) -> Iterator[dict]:
        """One shuffled epoch of host batches (deterministic in ``seed``)."""
        for idx in self.batch_indices(batch_size, seed=seed,
                                      drop_remainder=drop_remainder):
            yield {k: v[idx] for k, v in self.arrays.items()}


def _tree_map(fn, item):
    """``fn`` over the arrays of a batch: a :class:`Batch`, a
    :class:`Scene`, a dict of arrays, or one array."""
    if isinstance(item, (Batch, Scene)):
        return item.map(fn)
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return fn(item)


def _leaves(item) -> list:
    out = []
    _tree_map(out.append, item)
    return out


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _host_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def prefetch_to_device(iterator: Iterator, buffer_size: int = 2,
                       device=None) -> Iterator:
    """Yield the items of ``iterator`` (batches of host arrays) as tensors
    on ``device`` (default: the card), staged by a thread ``buffer_size``
    items ahead of the consumer.

    On the card each array goes through pinned memory and is copied on a
    side stream; the consumer's stream waits on that copy's event before
    the item is yielded, and every tensor is recorded on the consumer's
    stream, so the allocator reuses no buffer the step still reads.  An
    error in the producer (a corrupt record, an out-of-memory) is raised
    again in the consumer instead of ending the stream early."""
    device = resolve_device(device)
    q: queue.Queue = queue.Queue(maxsize=max(buffer_size, 1))
    sentinel = object()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def stage(item):
        if stream is None:
            return _tree_map(lambda a: _host_tensor(a).to(device), item), None
        with torch.cuda.stream(stream):
            out = _tree_map(lambda a: _host_tensor(a).pin_memory().to(
                device, non_blocking=True), item)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def producer():
        try:
            for item in iterator:
                q.put(stage(item))
            q.put(sentinel)
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            q.put(e)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        got = q.get()
        if got is sentinel:
            return
        if isinstance(got, BaseException):
            raise got
        item, event = got
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for t in _leaves(item):
                t.record_stream(consumer)
        yield item


def epochs(dataset: ArrayDataset, batch_size: int, num_epochs: int,
           *, seed: int = 0, prefetch: int = 2, device=None) -> Iterator:
    """A prefetched stream of ``num_epochs`` epochs on ``device``; epoch e
    shuffles with ``seed + e``."""

    def host_stream():
        for e in range(num_epochs):
            yield from dataset.batches(batch_size, seed=seed + e)

    yield from prefetch_to_device(host_stream(), buffer_size=prefetch,
                                  device=device)


def scenes_from_arrays(arrays: Mapping[str, np.ndarray],
                       conditioning: str) -> Scene:
    """The batch's :class:`Scene` (float32 CPU tensors) from dataset arrays.

    Takes the recorded ``scene_*`` ground truth (:func:`record_dataset`
    writes it).  Without it, a start/goal-conditioned scene is rebuilt
    exactly from the conditions only when the task is obstacle-free
    (goalcond); anything else raises rather than evaluate against wrong
    scenes."""
    if "scene_start" in arrays:
        return Scene(start=_f32(arrays["scene_start"]),
                     goal=_f32(arrays["scene_goal"]),
                     obstacles=_f32(arrays["scene_obstacles"]),
                     obstacle_mask=_f32(arrays["scene_obstacle_mask"]))
    if conditioning == "startgoal":
        c = np.asarray(arrays["conditions"], np.float32)
        b = len(c)
        return Scene(start=_f32(c[:, :2]), goal=_f32(c[:, 2:4]),
                     obstacles=torch.zeros((b, MAX_OBSTACLES, 3)),
                     obstacle_mask=torch.zeros((b, MAX_OBSTACLES)))
    raise ValueError(
        "dataset has no scene_* arrays and scenes cannot be reconstructed "
        f"from conditioning={conditioning!r}; re-record with "
        "record_dataset (which saves scene ground truth)")


def batch_from_arrays(arrays: Mapping[str, np.ndarray],
                      conditioning: str) -> Batch:
    """A training batch of float32 CPU tensors from dataset arrays: the
    conditions, the trajectories and :func:`scenes_from_arrays`."""
    return Batch(conditions=_f32(arrays["conditions"]),
                 real_traj=_f32(arrays["real_traj"]),
                 scenes=scenes_from_arrays(arrays, conditioning))


def batch_nbytes(batch: Batch) -> int:
    """The bytes of a batch's tensors, its scenes included."""
    return sum(t.nbytes for t in _leaves(batch))


def train_eval_split(dataset: ArrayDataset, eval_fraction: float,
                     *, seed: int = 0) -> tuple[ArrayDataset, ArrayDataset]:
    """Deterministic shuffled split into (train, held-out eval) datasets."""
    if not 0.0 < eval_fraction < 1.0:
        raise ValueError(f"eval_fraction must be in (0,1), got {eval_fraction}")
    order = np.random.default_rng(seed).permutation(dataset.size)
    n_eval = max(1, int(round(dataset.size * eval_fraction)))
    ev, tr = order[:n_eval], order[n_eval:]
    return (ArrayDataset({k: v[tr] for k, v in dataset.arrays.items()}),
            ArrayDataset({k: v[ev] for k, v in dataset.arrays.items()}))


def save_recording(path: str, conditions, real_traj, scenes: Scene,
                   keep: np.ndarray) -> None:
    """Write the rows ``keep`` of a recording to ``path`` (npz) under
    :data:`RECORD_KEYS`, every array float32."""

    def rows(a):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        return np.asarray(a, np.float32)[keep]

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = dict(zip(RECORD_KEYS, (
        conditions, real_traj,
        *(getattr(scenes, f.name) for f in dataclasses.fields(Scene)))))
    np.savez(path, **{k: rows(v) for k, v in arrays.items()})


def record_dataset(cfg, n_examples: int, path: str, *, seed: int = 0,
                   filter_collisions: bool = True, device=None) -> dict:
    """Record ``n_examples`` from the task sampler on ``device`` (default:
    the card; a generator seeded from ``seed``) to ``path`` (npz), dropping
    expert trajectories that the native collision check
    (``data/native.py``) finds crossing an obstacle.  The scene ground
    truth rides along, so a run trained on the file is evaluated against
    its true scenes.  Returns {"kept": int, "dropped": int}."""
    from ndivplanning_tpu_torch.data.native import collision_mask_host
    from ndivplanning_tpu_torch.data.tasks import make_task

    device = resolve_device(device)
    batch = make_task(cfg).sample(
        torch.Generator(device=device).manual_seed(seed), n_examples)
    batch = batch.map(lambda t: t.cpu())
    if filter_collisions:
        keep = collision_mask_host(batch.real_traj.numpy(),
                                   batch.scenes.obstacles.numpy(),
                                   batch.scenes.obstacle_mask.numpy()) == 0
    else:
        keep = np.ones(n_examples, bool)
    save_recording(path, batch.conditions, batch.real_traj, batch.scenes,
                   keep)
    return {"kept": int(keep.sum()), "dropped": int((~keep).sum())}
