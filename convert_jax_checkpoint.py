"""Convert a JAX run directory's best checkpoint into the torch port's format.

    python convert_jax_checkpoint.py SRC_WORKDIR DST_WORKDIR
    python convert_jax_checkpoint.py checkpoints/planning512 checkpoints_torch/planning512

Reads ``SRC_WORKDIR/config.json`` and the newest orbax checkpoint under
``SRC_WORKDIR/best`` with the JAX package, carries the whole train state
across with ``ndivplanning_tpu_torch/utils/convert.py`` and writes
``DST_WORKDIR/config.json`` (the same format) and
``DST_WORKDIR/best/{best_path.json, checkpoints/<step>/state.pt}`` with
``ndivplanning_tpu_torch/utils/checkpoint.py``.  The result loads with
torch alone.

This script sits outside both packages and is the only file besides the
tests that imports them both: it needs JAX, flax, optax and orbax, and
runs on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from ndivplanning_tpu.train.state import create_train_state as jax_create  # noqa: E402
from ndivplanning_tpu.utils import checkpoint as jax_checkpoint  # noqa: E402
from ndivplanning_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from ndivplanning_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402
from ndivplanning_tpu_torch.utils.config import config_from_dict, save_config  # noqa: E402
from ndivplanning_tpu_torch.utils.convert import train_state_from_flax  # noqa: E402

BEST_MARKER = "best_path.json"


def convert(src: str, dst: str) -> int:
    """Write the torch form of ``src``'s best checkpoint under ``dst``;
    returns its step."""
    jcfg = jax_load_config(src)
    if jcfg is None:
        raise FileNotFoundError(f"no config.json in {src!r}")
    jstate = jax_checkpoint.restore_latest(os.path.join(src, "best"),
                                           jax_create(jcfg))
    if jstate is None:
        raise FileNotFoundError(f"no checkpoint under {src!r}/best")
    tree = jax.tree.map(np.asarray, {
        "step": jstate.step, "g_params": jstate.g_params,
        "d_params": jstate.d_params, "g_ema_params": jstate.g_ema_params,
        "ada": jstate.ada, "lecam_ema": jstate.lecam_ema,
        "g_adam": jstate.g_opt_state,
        "d_adam": jstate.d_opt_state})
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    state = train_state_from_flax(cfg, tree, device="cpu")
    save_config(cfg, dst)
    save_checkpoint(os.path.join(dst, "best"), state)
    marker = os.path.join(src, "best", BEST_MARKER)
    if os.path.exists(marker):
        shutil.copyfile(marker, os.path.join(dst, "best", BEST_MARKER))
    return state.step


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    step = convert(*argv)
    print(f"converted step {step}: {argv[0]} -> {argv[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
