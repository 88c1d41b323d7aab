"""Ranks of one host as spawned processes, for meshes on a single machine.

:func:`run_ranks` starts one process per rank, joins each to a process
group through a ``FileStore`` (no TCP port, so concurrent runs never
collide), runs a function in every rank and returns the ranks' results.
Each rank runs one CPU thread.  The function must be importable by name
from a fresh interpreter (a module-level function), as ``spawn`` requires.
"""

from __future__ import annotations

import os
import queue
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 120.0


def _entry(fn, rank, world, store_path, backend, cuda_device, args, results):
    torch.set_num_threads(1)
    try:
        if cuda_device is not None:
            torch.cuda.set_device(cuda_device)
        dist.init_process_group(backend,
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, store_dir, *args, backend: str = "gloo",
              cuda_device: int | None = None,
              timeout: float = JOIN_TIMEOUT_S) -> list:
    """``fn(*args)`` on ``world`` ranks of a ``backend`` process group;
    the results in rank order.

    ``store_dir`` holds the rendezvous file.  With ``cuda_device`` every
    rank makes that card its current device (gloo lets several ranks share
    one card; NCCL does not).  Raises ``RuntimeError``, killing every rank,
    if one raises or the ranks do not finish within ``timeout`` seconds.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_path = os.path.join(str(store_dir), f"store_{fn.__name__}")
    procs = [ctx.Process(target=_entry,
                         args=(fn, rank, world, store_path, backend,
                               cuda_device, args, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):  # drain the queue before joining
            rank, ok, value = results.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=timeout)
            if p.is_alive():
                raise RuntimeError(f"rank {procs.index(p)} did not exit")
    except queue.Empty:
        raise RuntimeError(f"the ranks did not finish in {timeout} s") \
            from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]
