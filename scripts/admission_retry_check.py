"""Admission bursts against `cli serve --cross-batch` on the card: how many
attempts each retrying client needs.

From the root of a checkout: measures the cross-batched server's median
latency at one closed-loop client, starts a `--max-pending 4` server whose
deadline is half of it (as chip_smoke.py's admission phase does) and one
at ``--deadline-ms 18.3``, and runs chip_smoke.py's ``admission_burst``
TRIALS times on each.  One JSON line a trial: pass or the error, the
retried burst's wall and stats, and a histogram of request lines sent a
client thread (a thread id of the first burst may be reused by the
second, whose counts then add up).  The last line sums the run.

    python3 scripts/admission_retry_check.py LABEL [TRIALS]   # default 3
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(label: str, trials: int) -> int:
    import torch

    from ndivplanning_tpu_torch.planning.client import PlanningClient

    attempts = collections.Counter()
    round_trip = PlanningClient._round_trip

    def counted(self, payload):
        attempts[threading.get_ident()] += 1
        return round_trip(self, payload)

    PlanningClient._round_trip = counted
    extra = tuple(os.environ.get("ADMISSION_EXTRA", "").split())
    cross = cs.CliTcpServer(cs.PLANNING512, "--cross-batch", extra=extra)
    cross.wait_ready()
    one = cs.closed_loop(torch, cross, 1, "C=1")
    cross.stop()
    deadline = round(one["latency_ms_median"] / 2, 1)
    out = {"label": label, "c1_latency_ms_median": one["latency_ms_median"],
           "deadline_ms": deadline, "trials": []}
    for d in (deadline, 18.3):
        admit = cs.CliTcpServer(
            cs.PLANNING512, "--cross-batch", "--max-pending",
            str(cs.ADMISSION_MAX_PENDING), "--deadline-ms", str(d),
            extra=extra)
        admit.wait_ready()
        for _ in range(trials):
            attempts.clear()
            t0 = time.perf_counter()
            try:
                r = cs.admission_burst(torch, admit, d)
                res = {"ok": True, "burst": r["burst"],
                       "retries_wall_s": r["retries"]["wall_s"],
                       "retry_deltas": r["retries"]["stats_deltas"]}
            except AssertionError as e:
                res = {"ok": False, "error": str(e)[:300]}
            res.update(deadline_ms=d, s=time.perf_counter() - t0,
                       attempts_hist=sorted(collections.Counter(
                           attempts.values()).items()))
            out["trials"].append(res)
            print(json.dumps(res), flush=True)
        admit.stop()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 3))
