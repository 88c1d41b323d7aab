"""Where a refiner's bits depend on its batch, on the card: the iLQR
warm starts of chip_smoke.py's refine phase (quadrotor_distilled_ilqr, 62
warm starts, its noise) planned at once against in two halves of 31, as
two ranks of a sharded plan hold them, stage by stage: G, the warm-start
actions, the rollout, the cost, each derivative, the Riccati gains (also
from identical inputs), and 2 iterations of the refiner.  One JSON line:
per stage bitwise or not, the largest difference and the rows that
differ.

    python3 scripts/batch_bits_probe.py   # from the repository root, one card
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.planning import ilqr
    from ndivplanning_tpu_torch.planning.grad_refine import SoftWeights
    from ndivplanning_tpu_torch.train.state import gen_params
    from ndivplanning_tpu_torch.utils.device import resolve_device

    resolve_device("cuda")
    cfg, state = cs.load_model("quadrotor_distilled_ilqr")
    cfg = cfg.replace(ilqr_iters=2)
    scene, cond, noise = cs.sharded_inputs(torch, "ilqr", cfg, "cuda")
    z = noise.cuda()[None]
    n = z.shape[1]
    h = n // 2
    scenes, conds, soft = Scene.stack([scene]), cond[None], SoftWeights()
    gen = gen_params(cfg, state)

    def diff(a, b):
        return {"bitwise": bool(torch.equal(a, b)),
                "max": float((a - b).abs().max()),
                "rows_differ": int((a != b).reshape(
                    a.shape[0], a.shape[1], -1).any(-1).sum())}

    def halves(f, x):
        return torch.cat([f(x[:, :h]), f(x[:, h:])], dim=1)

    def stages(u):
        prob = ilqr._Problem(cfg, scenes, u.shape[1], u.shape[2], soft)
        states = prob.rollout(u)
        return states, prob.traj_cost(states, u), prob.linearize(states, u)

    out = {}
    with torch.no_grad():
        taus = gen(conds, z)
        out["G"] = diff(taus, halves(lambda x: gen(conds, x), z))
        u = ilqr._warm_start_actions(cfg, scenes, taus)
        out["warm_start"] = diff(u, halves(
            lambda t: ilqr._warm_start_actions(cfg, scenes, t), taus))
        full, parts = stages(u), [stages(u[:, :h]), stages(u[:, h:])]
        out["rollout"] = diff(
            torch.stack([s.pos for s in full[0][1:]], 2),
            torch.cat([torch.stack([s.pos for s in p[0][1:]], 2)
                       for p in parts], 1))
        out["cost"] = diff(full[1], torch.cat([p[1] for p in parts], 1))
        for i, name in enumerate(("A", "B", "lx", "lu", "lxx", "luu", "lux",
                                  "vx", "vxx")):
            out[name] = diff(full[2][i],
                             torch.cat([p[2][i] for p in parts], 1))
        gains = ilqr._riccati(*full[2], torch.ones_like(full[1]))
        split = [ilqr._riccati(*(d[:, lo:hi] for d in full[2]),
                               torch.ones_like(full[1][:, lo:hi]))
                 for lo, hi in ((0, h), (h, n))]
        out["riccati_k_same_inputs"] = diff(
            gains[0], torch.cat([k[0] for k in split], 1))
        refined = ilqr._ilqr_refine(cfg, scenes, u, 2, soft, 1.0)
        halved = [ilqr._ilqr_refine(cfg, scenes, u[:, lo:hi], 2, soft, 1.0)
                  for lo, hi in ((0, h), (h, n))]
        out["u_star"] = diff(refined[0],
                             torch.cat([r[0] for r in halved], 1))
        out["curves"] = diff(refined[2],
                             torch.cat([r[2] for r in halved], 1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
