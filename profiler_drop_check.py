"""Does ``torch.profiler`` lose kernel records of a short window on this card?

The card tests count NDiv kernels under ``torch.profiler``
(``tests/test_torch_cuda.py::_ndiv_launches``).  A window that holds only
the call (a few kernels of a few µs, then ``synchronize``) now and then
reports fewer kernels than ran: the CUPTI records of its last kernels,
and at times every kernel record of the window, do not reach the
profiler's result, while its host-side runtime records (the
``cudaLaunchKernel`` calls) do.  This script counts that: it profiles one
``ndiv_joint`` call (one warp-kernel launch at k = 8) in ``--sessions``
windows of each kind, taken in turns,

- ``plain``: the call, then ``synchronize``, as the tests did;
- ``padded``: a sleep kernel, the call, a sleep kernel, then
  ``synchronize`` (what the tests do now): the call's kernels are neither
  first nor last in the window;
- ``synced``: a sleep kernel run to its end, the call run to its end,
  then a sleep kernel run to its end (``chip_smoke.py``'s
  ``padded_window``, which keeps the sleeps out of its clocks);

and prints, as JSON, how many windows of each kind saw a count other
than 1, and the names of the kernels the padded windows saw.  Run on a machine with one card, from the repository root:

    python3 profiler_drop_check.py [--sessions 400]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# A sleep kernel of this many cycles (~5 ms on an H100) on either side.
PAD_CYCLES = 10_000_000


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ndivplanning_tpu_torch.ops import ndiv_cuda

    parser = argparse.ArgumentParser()
    parser.add_argument("--sessions", type=int, default=400)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profiler_drop_check: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn((64, 8, 2), generator=gen, device="cuda")
    x = torch.randn((64, 8, 16), generator=gen, device="cuda")

    def call():
        ndiv_cuda.ndiv_joint(z, x, 0.8)

    seen = {}

    def counted(kind: str) -> int:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            if kind != "plain":
                torch.cuda._sleep(PAD_CYCLES)
            if kind == "synced":
                torch.cuda.synchronize()
            call()
            if kind == "synced":
                torch.cuda.synchronize()
            if kind != "plain":
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if kind != "plain":
            for e in kernels:
                seen[e.key[:60]] = seen.get(e.key[:60], 0) + e.count
        return sum(e.count for e in kernels if "ndiv" in e.key)

    for _ in range(200):  # the card busy with many launches first
        call()
    torch.cuda.synchronize()
    off = {"plain": [], "padded": [], "synced": []}
    for i in range(args.sessions):
        for kind in off:
            n = counted(kind)
            if n != 1:
                off[kind].append([i, n])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"sessions_each": args.sessions,
                      "windows_off": {k: len(v) for k, v in off.items()},
                      "off_at": off, "padded_kernels_seen": seen,
                      "card": smi,
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
