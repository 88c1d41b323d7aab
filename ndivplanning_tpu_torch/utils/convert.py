"""flax -> torch weight conversion (no JAX counterpart).

Takes the JAX package's parameter trees as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, tree)``) and returns ``state_dict``s of the
port's modules.  A flax Dense (or SNDense) kernel is ``[in, out]``; a torch
``Linear.weight`` is ``[out, in]``.  A flax Conv kernel is HWIO; a torch
``Conv2d.weight`` is OIHW.  A LayerNorm's ``scale`` is torch's ``weight``.
The concat orders match already (``[cond_embed, z]``,
``[cond_embed, flat_traj]``), and the conv encoder flattens in NHWC order
as flax does (``models/encoder.py``), so its dense kernel carries over as
any other.
"""

from __future__ import annotations

import numpy as np
import torch

from ndivplanning_tpu_torch.train.state import Adam, TrainState, create_train_state
from ndivplanning_tpu_torch.utils.config import Config

_MODULES = {"ConditionEncoder_0": "encoder", "Generator_0": "generator",
            "TrajectoryTransformer_0": "generator",
            "Discriminator_0": "discriminator", "MLPTrunk_0": "trunk",
            "SceneEncoderCNN_0": "cnn",
            "MultiHeadDotProductAttention_0": "attn"}
# The layers of the transformer family, named in their parent module.
_SUBLAYERS = {"TrajectoryTransformer": {"Dense_0": "shift", "Dense_1": "head",
                                        "LayerNorm_0": "norm"},
              "_Block": {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
                         "Dense_0": "fc1", "Dense_1": "fc2"}}
_ATTENTION = ("query", "key", "value", "out")
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "pos_embed": "pos_embed"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_name(path: tuple) -> str:
    *mods, leaf = path
    parts, parent = [], ""
    for mod in mods:
        kind, _, idx = mod.rpartition("_")
        if mod in _MODULES:
            parts.append(_MODULES[mod])
        elif kind == "_Block":
            parts += ["blocks", idx]
        elif parent in _SUBLAYERS:
            parts.append(_SUBLAYERS[parent][mod])
        elif mod in _ATTENTION:
            parts.append(mod)
        elif kind == "Conv":
            parts += ["convs", idx]
        elif kind in ("Dense", "SNDense") and parts[-1] in ("encoder",
                                                            "trunk"):
            parts += ["layers", idx]
        elif kind == "Dense" and parts[-1] == "cnn":
            parts.append("dense")
        elif kind in ("Dense", "SNDense"):
            # The generator's or discriminator's own dense layer: its head.
            parts.append("head")
        else:
            raise KeyError(f"no torch name for flax path {'/'.join(path)}")
        parent = kind
    return ".".join(parts + [_LEAVES[leaf]])


def _torch_value(path: tuple, value: np.ndarray) -> np.ndarray:
    """A flax leaf in torch's layout.  Dense kernels ``[in, out]`` become
    ``[out, in]``; conv kernels HWIO become OIHW; attention's
    ``[in, heads, head_dim]`` projections and ``[heads, head_dim, out]``
    output map flatten their heads (head-major) first, and their
    ``[heads, head_dim]`` biases flatten."""
    if path[-1] == "kernel":
        if value.ndim == 4:
            return value.transpose(3, 2, 0, 1)
        if value.ndim == 3:
            value = (value.reshape(-1, value.shape[-1]) if path[-2] == "out"
                     else value.reshape(value.shape[0], -1))
        return value.T
    return value.reshape(-1) if path[-2] in _ATTENTION else value


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A flax G or D param tree (with or without its ``params`` level) ->
    the matching ``ConditionedGenerator`` / ``ConditionedDiscriminator``
    state_dict."""
    tree = tree.get("params", tree)
    return {_torch_name(path): torch.tensor(
                _torch_value(path, np.asarray(value, dtype=np.float32)))
            for path, value in _flatten(tree)}


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
    params, step, ADA state and LeCam trackers.

    ``tree`` holds numpy leaves under ``step``, ``g_params``, ``d_params``,
    ``g_ema_params``, ``ada``, ``lecam_ema`` (optional: zeros without it)
    and ``g_adam`` / ``d_adam``, each the optax chain state of its
    optimizer (see :func:`_adam_fields`).  The port's ``rng`` is seeded from
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
    for field in ("ada", "lecam_ema"):
        if field in tree:
            setattr(state, field, {
                k: torch.tensor(np.asarray(v, np.float32), device=device)
                for k, v in tree[field].items()})
    return state
