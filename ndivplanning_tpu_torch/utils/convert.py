"""flax -> torch weight conversion (no JAX counterpart).

Takes the JAX package's parameter trees as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)``) and returns ``state_dict``s of the
port's modules.  A flax Dense kernel is ``[in, out]``; a torch
``Linear.weight`` is ``[out, in]``.  A flax Conv kernel is HWIO; a torch
``Conv2d.weight`` is OIHW.  The concat orders match already
(``[cond_embed, z]``, ``[cond_embed, flat_traj]``), and the conv encoder
flattens in NHWC order as flax does (``models/encoder.py``), so its dense
kernel carries over as any other.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ndivplanning_tpu_torch.train.state import Adam, TrainState, create_train_state
from ndivplanning_tpu_torch.utils.config import Config

_MODULES = {"ConditionEncoder_0": "encoder", "Generator_0": "generator",
            "Discriminator_0": "discriminator", "MLPTrunk_0": "trunk",
            "SceneEncoderCNN_0": "cnn"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_name(path: tuple) -> str:
    *mods, layer, leaf = path
    parts = [_MODULES[m] for m in mods]
    kind, idx = re.fullmatch(r"(Dense|Conv)_(\d+)", layer).groups()
    if kind == "Conv":
        parts += ["convs", idx]
    elif parts[-1] in ("encoder", "trunk"):
        parts += ["layers", idx]
    elif parts[-1] == "cnn":
        parts.append("dense")
    else:  # the generator's or discriminator's own Dense is its head
        parts.append("head")
    return ".".join(parts + ["weight" if leaf == "kernel" else "bias"])


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A flax G or D param tree (with or without its ``params`` level) ->
    the matching ``ConditionedGenerator`` / ``ConditionedDiscriminator``
    state_dict."""
    tree = tree.get("params", tree)
    out = {}
    for path, value in _flatten(tree):
        value = np.asarray(value, dtype=np.float32)
        if path[-1] == "kernel":  # [in, out] -> [out, in]; HWIO -> OIHW
            value = value.T if value.ndim == 2 else value.transpose(3, 2, 0, 1)
        out[_torch_name(path)] = torch.tensor(value)
    return out


def _adam_fields(opt_state) -> tuple[int, dict, dict]:
    """``(count, mu, nu)`` of one Adam chain from its optax state: a
    ``ScaleByAdamState`` followed by an ``EmptyState`` (constant LR) or a
    ``ScaleByScheduleState`` (a schedule), whose count must agree."""
    adam, *rest = opt_state
    count = int(adam.count)
    for extra in rest:  # NamedTuples; a tuple's own .count is a method
        if "count" in extra._fields and int(extra.count) != count:
            raise ValueError(
                f"the schedule's count {int(extra.count)} disagrees with "
                f"Adam's {count}")
    return count, adam.mu, adam.nu


def _load_adam(opt: Adam, opt_state, device) -> None:
    opt.count, mu, nu = _adam_fields(opt_state)
    for moments, tree in ((opt.mu, mu), (opt.nu, nu)):
        for name, value in params_from_flax(tree).items():
            moments[name] = value.to(device)


def train_state_from_flax(cfg: Config, tree: dict, device=None) -> TrainState:
    """A TrainState carrying a JAX TrainState's params, Adam moments, EMA
    params, step and ADA tracker.

    ``tree`` holds numpy leaves under ``step``, ``g_params``, ``d_params``,
    ``g_ema_params``, ``ada`` and ``g_adam`` / ``d_adam``, each the optax
    chain state of its optimizer (see :func:`_adam_fields`).  The port's ``rng`` is seeded from
    ``cfg.seed``: the two packages' random streams never agree, so callers
    inject draws where they must match."""
    state = create_train_state(cfg, device=device)
    device = state.rng.device
    for module, key in ((state.g, "g_params"), (state.d, "d_params"),
                        (state.g_ema, "g_ema_params")):
        module.load_state_dict(params_from_flax(tree[key]))
    _load_adam(state.g_opt, tree["g_adam"], device)
    _load_adam(state.d_opt, tree["d_adam"], device)
    state.step = int(tree["step"])
    state.ada = {k: torch.tensor(np.asarray(v, np.float32), device=device)
                 for k, v in tree["ada"].items()}
    return state
