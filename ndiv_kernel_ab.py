"""The port's NDiv kernels of two trees of this repository, in turns on one card.

    python3 ndiv_kernel_ab.py A_DIR B_DIR      # A, B, B, A

Each directory is a checkout of the repository (for example a parent
commit unpacked with ``git archive``).  Each turn runs in a subprocess
that imports that tree's ``ndivplanning_tpu_torch``, builds its
``csrc/ndiv.cu`` and, under each layout (block, group and packed; the
packed layout has no joint call) at the imagecond step's 512x8x2x64,
pod_dp's per-rank 8192x32x2x64 and both at k=64 (512x64x2x64,
8192x64x2x64):

- times ``ndiv_fwd``, ``ndiv_bwd`` (at g = 1) and ``ndiv_joint``: the
  median of five windows of back-to-back calls behind a sleep kernel,
  CUDA events (device time, not launch overhead);
- counts the profiler's NDiv kernel launches of one call of each;
- hashes each output's bytes, so the trees can be compared bitwise.

At k > 32 it also times the tile kernel's fwd and bwd ("tile fwd block
..."): ``_launch(..., impl="tile")`` in a tree that has it, and the block
call in one that has not (whose dispatch served k > 32 with the tile
kernel).

The inputs are the same in every turn: spread latents and Gaussian
outputs from one seeded CUDA generator.  Prints one JSON line per turn,
then the summary (each tree's medians over its turns, and which outputs
are bitwise equal across the trees), then the card's name and power
limit.  Exits non-zero without a card.
"""

from __future__ import annotations

import functools
import json
import math
import os
import statistics
import subprocess
import sys

SHAPES = [(512, 8, 2, 64), (8192, 32, 2, 64), (512, 64, 2, 64),
          (8192, 64, 2, 64)]
ROUTES = [(kernel, variant) for kernel in ("fwd", "bwd", "joint")
          for variant in ("block", "group", "packed")
          if (kernel, variant) != ("joint", "packed")]
ALPHA = 0.8
# (calls per window, sleep cycles ahead of them) by batch: enough queued
# work that the sleep outlasts the host's launches, and few calls where a
# call may take milliseconds.
TIMING = {512: (100, 50_000_000), 8192: (10, 50_000_000)}


def _device_ms(torch, fn, n, sleep_cycles, repeats=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _launches(torch, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and ("ndiv" in e.key or "sum_partials" in e.key))


def _inputs(torch, b, k, dz, dx, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    side = math.ceil(k ** (1.0 / dz)) + 1
    axis = torch.arange(side, dtype=torch.float32, device="cuda")
    grid = torch.cartesian_prod(*[axis] * dz).reshape(-1, dz)
    pick = torch.argsort(torch.rand((b, side ** dz), generator=gen,
                                    device="cuda"), dim=1)[:, :k]
    jitter = 0.5 * (torch.rand((b, k, dz), generator=gen, device="cuda")
                    - 0.5)
    z = (grid[pick] + jitter - 0.5 * (side - 1)).contiguous()
    return z, torch.randn((b, k, dx), generator=gen, device="cuda")


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def _tile_call(ndiv_cuda, kernel, args):
    """The tile kernel's ``ndiv_<kernel>`` under the block layout."""
    import inspect

    if "impl" in inspect.signature(ndiv_cuda._launch).parameters:
        g = args[3] if kernel == "bwd" else None
        return functools.partial(ndiv_cuda._launch, kernel, "block",
                                 *args[:3], g, impl="tile")
    return functools.partial(getattr(ndiv_cuda, f"ndiv_{kernel}"), *args,
                             variant="block")


def child() -> int:
    """One turn in the tree this process runs from."""
    sys.path.insert(0, os.getcwd())  # ahead of this script's own tree
    import torch

    from ndivplanning_tpu_torch.ops import ndiv_cuda

    ndiv_cuda.load()
    g = torch.ones((), device="cuda")
    # A first profiler run can miss kernels while the tracer starts.
    _launches(torch, lambda: g + 1)
    out = {"tree": os.getcwd(), "module": ndiv_cuda.__file__, "times": {},
           "launches": {}, "digests": {}}
    for b, k, dz, dx in SHAPES:
        z, x = _inputs(torch, b, k, dz, dx, seed=b + k)
        label = f"{b}x{k}x{dz}x{dx}"
        routes = [(kernel, variant, None) for kernel, variant in ROUTES]
        if k > 32:
            routes += [("fwd", "block", "tile"), ("bwd", "block", "tile")]
        for kernel, variant, impl in routes:
            args = (z, x, ALPHA) + ((g,) if kernel == "bwd" else ())
            if impl == "tile":
                call = _tile_call(ndiv_cuda, kernel, args)
                key = f"tile {kernel} {variant} {label}"
            else:
                call = functools.partial(getattr(ndiv_cuda, f"ndiv_{kernel}"),
                                         *args, variant=variant)
                key = f"{kernel} {variant} {label}"
            res = call()
            res = res if isinstance(res, tuple) else (res,)
            out["digests"][key] = [_digest(t) for t in res]
            out["launches"][key] = _launches(torch, call)
            out["times"][key] = _device_ms(torch, call, *TIMING[b])
    print(json.dumps(out), flush=True)
    return 0


def main(argv) -> int:
    if argv[1:2] == ["--child"]:
        return child()
    trees = [os.path.abspath(d) for d in argv[1:3]]
    if len(trees) != 2 or not all(os.path.isdir(d) for d in trees):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ndiv_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    turns = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        env = {**os.environ, "PYTHONPATH": tree}
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child"], cwd=tree,
            env=env, capture_output=True, text=True, timeout=900, check=False)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    summary = {"trees": trees, "ms_median": {}, "launches": {},
               "bitwise_equal_across_trees": {}}
    for i, tree in enumerate(trees):
        mine = [t for t in turns if t["tree"] == tree]
        summary["ms_median"][f"tree{i}"] = {
            key: statistics.median(t["times"][key] for t in mine)
            for key in mine[0]["times"]}
        summary["launches"][f"tree{i}"] = mine[0]["launches"]
    for key, digests in turns[0]["digests"].items():
        summary["bitwise_equal_across_trees"][key] = [
            a == b for a, b in zip(digests, turns[1]["digests"][key])]
    print(json.dumps(summary), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
