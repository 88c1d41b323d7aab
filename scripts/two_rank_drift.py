"""How far two ranks' pod_dp training drifts from one rank's, step by step,
on the card: pod_dp at full width from seed 0, 20 steps of
``make_sharded_train_step`` on a 1x1 mesh of one NCCL rank, and the same
on two gloo ranks sharing the card at (2, 1) and (1, 2), in bf16 and in
float32.  One JSON line: per dtype and mesh, each step's largest relative
metric gap to the one-rank run (d_rt and d_rt_ema apart, as absolute
gaps: they are means of signs), and G's largest parameter gap at the end
in units of lr a step.

    python3 scripts/two_rank_drift.py   # from the repository root, one card
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

STEPS = 20
DTYPES = ("bf16", "f32")


def ranks_worker():
    """One of two gloo ranks: every (dtype, mesh) run, STEPS steps."""
    return {(dtype, dp, div): cs.pod_dp_run(dtype, dp, div, STEPS)
            for dtype in DTYPES for dp, div in cs.TWO_RANK_MESHES}


def gaps(ref, got, lr):
    import numpy as np

    steps = []
    for rec, want in zip(got[0], ref[0]):
        rel = {k: abs(rec[k] - w) / max(abs(w), 1e-30)
               for k, w in want.items() if k not in cs.SIGN_METRICS}
        worst = max(rel, key=rel.get)
        steps.append({"metric": worst, "rel": rel[worst],
                      "sign_abs": max(abs(rec[k] - want[k])
                                      for k in cs.SIGN_METRICS)})
    param = max(float(np.abs(got[1][n] - ref[1][n]).max()) for n in ref[1])
    return {"by_step": steps, "g_param_max_abs_over_lr_step":
            param / (lr * STEPS)}


def main() -> int:
    import torch
    import torch.distributed as dist

    from ndivplanning_tpu_torch.parallel import make_mesh
    from ndivplanning_tpu_torch.parallel.spawn import run_ranks
    from ndivplanning_tpu_torch.utils.config import get_config

    if not torch.cuda.is_available():
        print("two_rank_drift: no CUDA device", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="two_rank_drift_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
        rank=0, world_size=1)
    try:
        one = {dtype: cs.pod_dp_run(dtype, 1, 1, STEPS,
                                    make_mesh(dp=1, div=1))
               for dtype in DTYPES}
    finally:
        dist.destroy_process_group()
    two = run_ranks(ranks_worker, 2, tmp, cuda_device=0, timeout=900)[0]
    lr = get_config("pod_dp").g_lr
    print(json.dumps({
        "card": cs.nvidia_smi_line(), "steps": STEPS,
        "runs": {f"{dtype} {dp}x{div}": gaps(one[dtype], run, lr)
                 for (dtype, dp, div), run in two.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
