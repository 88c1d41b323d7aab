"""Compile-budget observability; counterpart of ``ndivplanning_tpu/utils/compile_guard.py``.

The port compiles three kinds of programs at run time, each a cost a run
pays before its first step:

- ``cuda_build``: ``ops/ndiv_cuda.py`` running nvcc on ``csrc/ndiv.cu``
  (a library already in ``_build/`` for the source's hash is loaded, not
  counted);
- ``native_build``: ``data/native.py`` compiling the host data plane;
- ``dynamo_graph``: a graph compiled by ``torch.compile`` (dynamo's
  ``unique_graphs`` counter over the region).

:func:`count_compiles` counts them in a region, and the train loop writes
the total as its ``kind="compile"`` row.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys

_LISTENERS: list = []


def record_compile(kind: str, name: str, seconds: float) -> None:
    """Called by a build that actually ran its compiler."""
    for listener in list(_LISTENERS):
        listener(kind, name, seconds)


def _dynamo_graphs() -> int:
    # Read only where torch.compile has been imported: nothing compiled
    # a graph otherwise.
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is None:
        return 0
    return int(utils.counters["stats"]["unique_graphs"])


@dataclasses.dataclass
class CompileCount:
    """Mutable record of the compilations observed in a region: one entry
    of ``kinds``/``names``/``durations`` per build (dynamo graphs are
    counted, not timed)."""

    count: int = 0
    kinds: list = dataclasses.field(default_factory=list)
    names: list = dataclasses.field(default_factory=list)
    durations: list = dataclasses.field(default_factory=list)
    dynamo_graphs: int = 0

    def of_kind(self, kind: str) -> int:
        return self.kinds.count(kind)

    def total_secs(self) -> float:
        return float(sum(self.durations))

    def row(self) -> dict:
        """The train loop's ``kind="compile"`` row."""
        return {"compiles": self.count,
                "cuda_builds": self.of_kind("cuda_build"),
                "native_builds": self.of_kind("native_build"),
                "dynamo_graphs": self.dynamo_graphs,
                "compile_secs": round(self.total_secs(), 2)}


def start_compile_count():
    """Begin counting; returns ``(rec, stop_fn)`` — call ``stop_fn()`` to
    stop (idempotent)."""
    rec = CompileCount()
    graphs0 = _dynamo_graphs()

    def listener(kind: str, name: str, seconds: float) -> None:
        rec.count += 1
        rec.kinds.append(kind)
        rec.names.append(name)
        rec.durations.append(seconds)

    _LISTENERS.append(listener)
    stopped = [False]

    def stop() -> None:
        if not stopped[0]:
            stopped[0] = True
            _LISTENERS.remove(listener)
            rec.dynamo_graphs = _dynamo_graphs() - graphs0
            rec.count += rec.dynamo_graphs

    return rec, stop


@contextlib.contextmanager
def count_compiles():
    """``with count_compiles() as rec: ...`` — ``rec.count`` is the number
    of compilations in the region."""
    rec, stop = start_compile_count()
    try:
        yield rec
    finally:
        stop()
