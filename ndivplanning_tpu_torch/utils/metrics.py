"""Structured metrics logging; counterpart of ``ndivplanning_tpu/utils/metrics.py``.

A small JSONL writer: one row per log event, written on the host from
values the loop has already read from the card once per boundary.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Mapping

import torch


class MetricsWriter:
    """Append-only JSONL metrics stream, an optional echo to stderr and
    optional TensorBoard summaries (``tensorboard=True``, through
    ``torch.utils.tensorboard``, imported only then)."""

    def __init__(self, workdir: str | None = None, echo: bool = True,
                 filename: str = "metrics.jsonl", tensorboard: bool = False):
        self._echo = echo
        self._fh: IO[str] | None = None
        self._tb = None
        # "" and None both mean no persistence (train(workdir="")).
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError as e:
                    raise ImportError(
                        "MetricsWriter(tensorboard=True) needs the "
                        f"'tensorboard' package for torch.utils.tensorboard: "
                        f"{e}") from e
                self._tb = SummaryWriter(os.path.join(workdir, "tb"))
            self._fh = open(os.path.join(workdir, filename), "a",
                            encoding="utf-8")
        self._t0 = time.monotonic()

    def write(self, step: int, scalars: Mapping[str, float], **extra) -> None:
        row = {
            "step": int(step),
            "wall_s": round(time.monotonic() - self._t0, 3),
            **{k: float(v) for k, v in scalars.items()},
            **extra,
        }
        if self._fh is not None:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        if self._echo:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k != "wall_s"
            )
            print(f"[metrics] {parts}", file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None


def host_floats(values: dict) -> dict:
    """Scalars (0-d tensors or numbers) as Python floats; the tensors come
    from the card in one transfer."""
    keys = [k for k, v in values.items() if isinstance(v, torch.Tensor)]
    read = dict(zip(keys, torch.stack(
        [values[k].detach().float() for k in keys]).tolist())) if keys else {}
    return {k: read[k] if k in read else float(v) for k, v in values.items()}
