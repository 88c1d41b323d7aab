"""Checkpoint and resume as torch files; counterpart of ``ndivplanning_tpu/utils/checkpoint.py``.

The directory layout is the JAX package's: ``<workdir>/checkpoints/<step>/``,
the newest ``MAX_TO_KEEP`` kept, and the best-by-eval run under
``<workdir>/best/`` beside its ``best_path.json``.  Each checkpoint is one
``torch.save`` of plain tensors, ints and strings holding the whole
:class:`TrainState`: G, D, EMA G, both Adam chains, step, the ADA state,
the LeCam trackers and the state of the run's generator.  No module or config is pickled, so
it loads with ``torch.load(weights_only=True)``.  Writes go to a
temporary file first and are renamed into place, so a reader never sees a
half-written checkpoint.
"""

from __future__ import annotations

import os
import shutil

import torch

from ndivplanning_tpu_torch.train.state import (
    Adam,
    TrainState,
    fresh_lecam_ema,
)

MAX_TO_KEEP = 3
FILENAME = "state.pt"


def _root(workdir: str) -> str:
    return os.path.join(os.path.abspath(workdir), "checkpoints")


def _path(workdir: str, step: int) -> str:
    return os.path.join(_root(workdir), str(step), FILENAME)


def all_steps(workdir: str) -> list[int]:
    """Steps with a complete checkpoint in ``workdir``, oldest first."""
    root = _root(workdir)
    if not os.path.isdir(root):
        return []
    return sorted(int(name) for name in os.listdir(root)
                  if name.isdigit() and os.path.exists(_path(workdir, name)))


def latest_step(workdir: str) -> int | None:
    steps = all_steps(workdir)
    return steps[-1] if steps else None


def _cpu(tensors: dict) -> dict:
    return {name: t.detach().cpu() for name, t in tensors.items()}


def _adam_dict(opt: Adam) -> dict:
    return {"count": opt.count, "mu": _cpu(opt.mu), "nu": _cpu(opt.nu)}


def state_dict(state: TrainState) -> dict:
    """The checkpoint's contents: plain tensors (on the CPU), ints and
    strings."""
    return {
        "step": int(state.step),
        "g": _cpu(state.g.state_dict()),
        "d": _cpu(state.d.state_dict()),
        "g_ema": _cpu(state.g_ema.state_dict()),
        "g_opt": _adam_dict(state.g_opt),
        "d_opt": _adam_dict(state.d_opt),
        "ada": _cpu(state.ada),
        "lecam_ema": _cpu(state.lecam_ema),
        "rng": {"device": state.rng.device.type,
                "seed": state.rng.initial_seed(),
                "state": state.rng.get_state()},
    }


def save_checkpoint(workdir: str, state: TrainState,
                    step: int | None = None) -> str:
    """Write ``state`` as the checkpoint of ``step`` (default: its own),
    replacing one already there, and drop all but the newest
    ``MAX_TO_KEEP``.  Returns the file's path."""
    step = int(state.step) if step is None else int(step)
    path = _path(workdir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    try:
        torch.save(state_dict(state), tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    for old in all_steps(workdir)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(_root(workdir), str(old)))
    return path


def _load_adam(opt: Adam, saved: dict) -> None:
    opt.count = int(saved["count"])
    opt.mu = dict(saved["mu"])
    opt.nu = dict(saved["nu"])


def load_state_dict(state: TrainState, saved: dict) -> TrainState:
    """Copy a checkpoint's contents into ``state``, in place.

    The generator's state carries over where it was saved on the same kind
    of device; the CPU's and CUDA's generators keep states of different
    kinds, so across them the generator restarts from its saved seed.  A
    checkpoint written before the LeCam trackers were carried restores
    them as zeros, as the JAX package restores its pre-LeCam ones."""
    state.step = int(saved["step"])
    for module, key in ((state.g, "g"), (state.d, "d"),
                        (state.g_ema, "g_ema")):
        module.load_state_dict(saved[key])
    _load_adam(state.g_opt, saved["g_opt"])
    _load_adam(state.d_opt, saved["d_opt"])
    state.ada = dict(saved["ada"])
    state.lecam_ema = (dict(saved["lecam_ema"]) if "lecam_ema" in saved
                       else fresh_lecam_ema(state.rng.device))
    rng = saved["rng"]
    if rng["device"] == state.rng.device.type:
        state.rng.set_state(rng["state"].cpu())
    else:
        state.rng.manual_seed(int(rng["seed"]))
    return state


def restore_latest(workdir: str, state: TrainState) -> TrainState | None:
    """Load the newest checkpoint of ``workdir`` into ``state`` (on its
    device) and return it, or None when there is no checkpoint."""
    step = latest_step(workdir)
    if step is None:
        return None
    saved = torch.load(_path(workdir, step), map_location=state.rng.device,
                       weights_only=True)
    return load_state_dict(state, saved)
