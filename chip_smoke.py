"""Smoke run of the torch port on one CUDA card.

Builds the NDiv CUDA kernels from ``ndivplanning_tpu_torch/csrc``, holds
every kernel route (fwd, joint and bwd under the block, group and packed
layouts) against its plain PyTorch version, and the warp kernel bitwise
against the tile kernel.  The kernel is chosen by shape, whatever the
layout: the warp kernel serves fwd and bwd at k <= 64 and the joint at
k <= 32; the tile kernel serves the joint past k=32 and every call past
k=64, and is reached on purpose (``impl="tile"``) as the reference.  Then
it drives the port's main
paths at full width: the goalcond preset trains 20 steps, plans with 1000
candidates and evaluates NDiv without a gradient; the imagecond preset
trains 20 steps, takes one step under each other NDiv route from one state,
takes one step at k=64 under the packed route against the same step on the
tile kernel, and plans with 1000 candidates on a rasterised scene; the
pod_dp preset
(B=8192, k=32, bf16) checks the sharded NDiv call site's per-rank function
for virtual ranks, trains 10 steps through the data-parallel step on a 1x1
mesh of one NCCL rank, takes one float32 step under the NDIV_JOINT=0 route
(ndiv_fwd + ndiv_bwd) against the default one, and runs two gloo ranks on
the card against one.  Then the train loop on the recorded planning512
recipe at full width (300 steps in one run against 200 and a resume to
300: bitwise equal, one ndiv_joint launch a step and one ndiv_fwd launch
an eval leg), the CLI's train and eval in subprocesses, and the frozen
suite on the vendored planning512 model on the card against the CPU.
Last comes the serving path on the vendored
planning512 model (checkpoints_torch/, torch alone): its restore on the
card against the CPU's, 16 scenes at 1000 candidates on the card against
the CPU, two `cli serve --warmup` processes over pipes through the port's
client, and a profile of a dispatch at buckets 1 and 16.  The env
families close it: the vendored unicycle150k, reacher150k and
quadrotor150k models (checkpoints_torch/) restored, planned and evaluated
on the card against the CPU, arm3 planned at random weights, every
family's distilled actions replayed bitwise, the unicycle150k recipe
trained 100 steps and arm3 in action mode 20 through the train loop, and
`cli serve` on reacher150k and `cli eval` on quadrotor150k in
subprocesses.  Closed loop and CEM: the three family models' frozen
suites as MPC episodes on the card, and 128 of them against the CPU,
with dispatch times and profiles; `cli serve --warmup-mpc` answering
"mpc": true requests; a CEM plan against the CPU and `cli eval
--planner cem` beside oneshot; and the three distilled models' frozen
suites on the card against the CPU.
Each phase prints one JSON line; any failure raises and exits non-zero.
The last line is the device summary.

    python3 chip_smoke.py            # from the repository root, one card
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# Published H100 SXM rates at its 700 W power limit (NVIDIA's data
# sheet): HBM bandwidth, and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
ALPHA = 0.8
# The kernels the profiler counts as NDiv's: the tile kernel and its
# one-block sum of the partials, and the warp kernel (one launch, any
# mode).
NDIV_KERNELS = ("ndiv_tile_kernel", "sum_partials_kernel",
                "ndiv_warp_kernel")
# Kernel launches per train step under the profiler when every joint call
# ran the tile kernel and its one-block sum (two launches), as this script
# counted them on an NVIDIA H100 80GB HBM3 at 700.00 W.
TILE_JOINT_LAUNCHES_PER_STEP = {"goalcond": 263, "imagecond": 529,
                                "pod_dp": 456.6}
# From (7, 2, 2, 64) on they are ragged for the warp kernel: k=2 with a
# batch that fills no block of four conditions, k=31 with rows of 3 and 7,
# k=32 with more conditions than blocks resident at once (132 SMs x 6), so
# a block walks over a ragged number of them, and k=40 padded to kp = 64;
# then imagecond's widths at k=64, and 8192 conditions of them (pod_dp's
# per-rank batch); last the env families' loops: the 128-scene frozen
# suite's eval legs, and arm3's action-mode step and eval (dx = 32 x 3).
CHECK_SHAPES = [(256, 8, 2, 64), (512, 8, 2, 64), (256, 32, 2, 64),
                (1024, 32, 2, 64), (3, 5, 3, 7), (1, 256, 4, 8),
                (7, 2, 2, 64), (5, 31, 3, 7), (1001, 32, 2, 64),
                (5, 40, 3, 7), (512, 64, 2, 64), (8192, 64, 2, 64),
                (128, 8, 2, 64), (256, 8, 2, 96), (128, 8, 2, 96)]
GOALCOND_SHAPE = (256, 8, 2, 64)  # B=256, k=8, dz=2, dx=H*S=64
IMAGECOND_SHAPE = (512, 8, 2, 64)
K64_SHAPES = [(512, 64, 2, 64), (8192, 64, 2, 64)]  # imagecond's widths
# The largest k of the warp kernel in each mode, in every layout, where
# the rows fit in shared memory (as they do at every shape here).
WARP_K = {"joint": 32, "fwd": 64, "bwd": 64}
# The warp kernel against the tile kernel: grads bitwise, totals (another
# summation tree) within this.
TILE_TOTAL_RTOL = 1e-6
# Kernel against plain, elementwise: |got - want| <= rtol |want| + atol,
# with atol a share of the tensor's largest |want| (the unit grads are
# ~1/(B k (k-1)) in size, so no fixed atol means anything).
VAL_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5
G_CHECK = -2.5  # the upstream cotangent the backward kernels are checked at
TRAIN_STEPS = 20
# Every kernel route: (kernel, variant).  The JAX package has no joint
# kernel under "packed" (its _vjp_fwd sends packed to fwd + bwd).
VARIANTS = ("block", "group", "packed")
ROUTES = [("joint", "block"), ("fwd", "block"), ("bwd", "block"),
          ("joint", "group"), ("fwd", "group"), ("bwd", "group"),
          ("fwd", "packed"), ("bwd", "packed")]
# The TPU kernel each route replaces (ndivplanning_tpu/ops/ndiv_pallas.py).
REPLACES = {("joint", "block"): 266, ("fwd", "block"): 212,
            ("bwd", "block"): 229, ("joint", "group"): 266,
            ("fwd", "group"): 212, ("bwd", "group"): 229,
            ("fwd", "packed"): 126, ("bwd", "packed"): 142}
# The imagecond step's NDiv routes besides the default (block, JOINT on),
# and the launches each makes, as _vjp_fwd routes a differentiated loss.
# The last: NDiv kernels a step launches under the profiler (the warp
# kernel serves every layout at k=8, one kernel a launch).
STEP_ROUTES = [("block", False, {"fwd": 1, "bwd": 1}, 2),
               ("group", True, {"joint_group": 1}, 1),
               ("group", False, {"fwd_group": 1, "bwd_group": 1}, 2),
               ("packed", True, {"fwd_packed": 1, "bwd_packed": 1}, 2)]

# The pod_dp preset's per-rank NDiv shape on a 1x1 mesh: B=8192, k=32,
# dz=2, dx=H*S=64.  The sharded call site's per-rank function runs for
# virtual ranks at these (dp, div) and shapes, the last one ragged.
POD_DP_SHAPE = (8192, 32, 2, 64)
VIRTUAL_RANKS = [((1, 2), POD_DP_SHAPE), ((1, 4), POD_DP_SHAPE),
                 ((2, 2), POD_DP_SHAPE), ((2, 2), (6, 8, 2, 16))]
SHARDED_RTOL = 1e-6  # virtual ranks against the unsharded kernel
POD_DP_STEPS = 10
# Two ranks on one card against one: the meshes, the steps, and the
# tolerances.  f32 is tests/test_parallel.py:121-126's, with the rule of
# tests/test_torch_train_step.py: an element whose gradient is within
# rounding of zero (|Adam moment| < 1% of its tensor's largest) may flip
# its first Adam update (lr * g / |g|), so it lies within 2 lr a step.
# bf16: each rank's weight gradient rounds to bf16 on its own, 2^-9 of
# that half at most, and where the halves cancel to within that the sum
# can change sign whatever its size against the tensor's largest: such an
# element flips.  For a gradient summed from many noisy rows that is about
# 2 * 2^-9 of the elements a step; over 3 steps, with flips moving the
# next step's gradients, up to 2^-6 of G's elements may lie off, each
# within 2 lr a step.  The rest: each of the ~4 bf16 layers of the
# backward chain rounds on its own (4 x 2^-8 = 2^-6 of a gradient) and
# Adam's normalised update doubles that: 2^-5 of lr a step.  Metrics,
# means over bf16-rounded logits, move by at most one bf16 epsilon (2^-7).
# d_rt and d_rt_ema are means of sign(logit), not of logits: a real logit
# that rounds across 0 moves them by 2/B, so in bf16 they are held at one
# bf16 epsilon of their range [-1, 1], absolute (a sign flip in at most
# 0.4% of the reals).
TWO_RANK_MESHES = [(2, 1), (1, 2)]
TWO_RANK_STEPS = 3
BF16_EPS = 2.0 ** -7
METRIC_ATOL = 1e-5
SIGN_METRICS = ("d_rt", "d_rt_ema")
# "param_atol_of_lr": the params' atol as a share of lr per step;
# "off_share": the share of G's elements that may lie off (None: only
# those whose gradient is within rounding of zero, the f32 rule).
TWO_RANK_TOL = {"f32": {"metric_rtol": 1e-3, "sign_atol": METRIC_ATOL,
                        "param_rtol": 1e-3, "param_atol": 1e-5,
                        "param_atol_of_lr": 0.0, "off_share": None},
                "bf16": {"metric_rtol": BF16_EPS, "sign_atol": BF16_EPS,
                         "param_rtol": 1e-3, "param_atol": 0.0,
                         "param_atol_of_lr": 2.0 ** -5,
                         "off_share": 2.0 ** -6}}


# The serving path on the vendored planning512 model (converted once by
# convert_jax_checkpoint.py; restored here with torch alone).
PLANNING512 = os.path.join("checkpoints_torch", "planning512")
PLANNING512_STEP = 55000
SERVE_SCENES = 16  # the largest request bucket
SERVE_DIVERSE = 4  # the server's n_diverse
# The card against the CPU, from one state and one set of latents: every
# candidate's score within SERVE_RTOL |cpu| + SERVE_ATOL (float32 G and
# rollouts; cuBLAS and the CPU's GEMMs sum in other orders).  Tie rule: a
# scene's best pick may differ only where the card's pick scores, on the
# CPU, within 2 (SERVE_RTOL |s| + SERVE_ATOL) of the CPU's best (a near-tie
# that the tolerance allows to flip); its diverse picks may differ only
# where the CPU's own selection, fed the card's scores, makes the card's
# picks (the difference then comes from scores within tolerance, not from
# the selection or the trajectories).
SERVE_RTOL, SERVE_ATOL = 1e-4, 1e-4
SERVE_REPEATS = 5  # timed round trips per bucket through the CLI server
# At bucket 16 a dispatch may launch at most this many times the kernels
# of a bucket-1 dispatch: the scenes are a batch axis, never a loop.
SERVE_LAUNCH_RATIO = 1.25

# The train loop on the recorded planning512 recipe at full width: steps
# stay 150000, so the cosine LR is the recipe's.  Run A goes 0 -> 300 in
# one call; run B goes 0 -> 200, then a fresh state resumes from its
# workdir to 300.
LOOP_EVERY = dict(log_every=50, eval_every=100, checkpoint_every=100,
                  eval_suite_scenes=512)
LOOP_STEPS = 300
LOOP_RESUME_AT = 200
# The CLI's train on goalcond at full width, then its eval on that run.
CLI_TRAIN_STEPS = 100
CLI_EVERY = 50
# The frozen suite on the card against the CPU, from one checkpoint: each
# rate within 2 of the suite's 512 x 8 samples, every other metric at
# EVAL_RTOL (float32 G and rollouts; cuBLAS and the CPU sum in other
# orders).
EVAL_RATE_SAMPLES = 2
EVAL_RTOL = 1e-5
EVAL_RATES = ("eval_success_rate", "eval_collision_rate")
# The warp kernel's template argument for each mode (csrc/ndiv.cu, Mode).
WARP_MODES = {"0": "fwd", "1": "joint", "2": "bwd"}

# The env families: the vendored family models, converted once by
# convert_jax_checkpoint.py, each with its family and best step.
FAMILY_MODELS = {"unicycle150k": ("unicycle", 120000),
                 "reacher150k": ("reacher", 105000),
                 "quadrotor150k": ("quadrotor", 30000)}
FAMILY_SCENES = 16
# The card against the CPU on one set of latents.  The card's G sums its
# GEMMs in another order, its rollouts round sin, cos, atan2 and acos an
# ulp apart, and a latch (done, collided) or the quadrotor's attitude loop
# (x100 a step until its rotors clip) turns such a move into another
# outcome for some candidates.  So every count of disagreements may be at
# most twice the CPU's own count under those two moves (its rollout of
# the card's G's candidates, and of its own with every waypoint one ulp
# up), plus this slack: 16 of the 16,000 candidates' scores off
# SERVE_RTOL/ATOL, 1 scene's best score, 2 scenes' picks (near-ties), 1
# scene's reached flag; for the frozen suite's rates, 2 samples, and for
# its mean score, EVAL_RTOL.
FAMILY_SLACK = {"candidates_off": 16, "best_score_off": 1,
                "picks_differ": 2, "reached_differ": 1}
FAMILY_RATE_SAMPLES = 2
# The loops: the unicycle150k recipe at full width, 100 steps, one eval
# point; arm3 in action mode at the same widths, 20 steps, one eval point.
FAMILY_LOOP_STEPS = 100
FAMILY_LOOP_EVERY = dict(log_every=25, eval_every=100, checkpoint_every=100)
ARM3_LOOP_STEPS = 20
ARM3_LOOP_EVERY = dict(log_every=10, eval_every=20, checkpoint_every=20)
ARM3_ACTIONS = dict(env="arm3", rollout_mode="actions", state_dim=3,
                    generator_output="linear")
SERVE_FAMILY = os.path.join("checkpoints_torch", "reacher150k")
CLI_EVAL_FAMILY = os.path.join("checkpoints_torch", "quadrotor150k")

# Closed-loop MPC on the family models: the frozen 512-scene suite on the
# card (eval --mpc's defaults: 64 steps, a replan every 8 from 256
# candidates), the card against the CPU on its first MPC_CPU_SCENES scenes
# with the same CPU-drawn latents.  The quadrotor's attitude loop turns
# an ulp into another path, and closed loop compounds it over 8 replans,
# so the episodes whose outcome (reached, collided) differs may number at
# most twice those the CPU itself changes when its latents move one ulp,
# and at least 1.  JAX recorded eval --mpc success 1.000 for each
# (checkpoints/README.md, on its own suite).
MPC_CPU_SCENES = 128
MPC_EPISODE = dict(total_steps=64, replan_every=8, n_candidates=256)
MPC_JAX_RECORDED = {"unicycle150k": 1.0, "reacher150k": 1.0,
                    "quadrotor150k": 1.0}
MPC_DISPATCH_SCENES = (1, 128)  # mpc_rollout_batch timed at these B
# ... and profiled at these (the served quadrotor at both).
MPC_PROFILED = {"unicycle150k": (128,), "reacher150k": (128,),
                "quadrotor150k": (1, 128)}
# Closed-loop serving: `cli serve --warmup-mpc` on quadrotor150k, a burst
# of 16 "mpc": true lines, a mixed array of 4 closed-loop and 4 plain
# requests, and single closed-loop round trips.
MPC_SERVE_WORKDIR = os.path.join("checkpoints_torch", "quadrotor150k")
MPC_SERVE_REPEATS = 3
# CEM on unicycle150k at the default budget (1000 candidates: 5
# iterations and a final population of 166).  Its best score, card
# against CPU on the same noise, within twice the CPU's own move with the
# noise one ulp up plus SERVE_RTOL/ATOL; the planner ladder on 128 scenes.
CEM_WORKDIR = os.path.join("checkpoints_torch", "unicycle150k")
CEM_LADDER_SCENES = 128
# The distilled models (expert iteration on the quadrotor; a unicycle
# run), one-shot on the frozen suite; quadrotor_distilled_ilqr's success
# as JAX recorded it (checkpoints/README.md: best-of-both on the TPU, and
# a CPU re-eval on 512 scenes).
DISTILLED_MODELS = {"quadrotor_distilled": ("quadrotor", 504),
                    "quadrotor_distilled_ilqr": ("quadrotor", 1512),
                    "unicycle_distilled": ("unicycle", 4536)}
DISTILLED_ILQR_JAX = {"tpu_best_of_both": 0.5361, "cpu_512_scenes": 0.5144}
# Their eval_ndiv, card against CPU: fine-tuning left the hinge nearly
# inactive (quadrotor_distilled's total ~9e-5 on an NVIDIA H100), so the
# card's 1e-7 moves of G's samples move the small total by 3.3e-4 of
# itself; held at the tests' rtol for such a loss
# (tests/test_torch_evaluate.py, NDIV_RTOL_UNTRAINED).
DISTILLED_NDIV_RTOL = 1e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> float:
    return float((got - want).abs().max())


def assert_close(torch, got, want, what, rtol, atol_of_max=0.0) -> float:
    """Elementwise |got - want| <= rtol |want| + atol_of_max max|want|;
    returns the largest error as a share of max|want| (0 if want is 0)."""
    scale = float(want.abs().max())
    err = (got - want).abs()
    if bool((err > rtol * want.abs() + atol_of_max * scale).any()):
        raise AssertionError(
            f"{what}: max abs err {float(err.max()):.3e} (max |want| "
            f"{scale:.3e}) outside rtol={rtol} atol={atol_of_max} * max")
    return float(err.max()) / scale if scale > 0 else float(err.max())


def spread_latents(torch, b, k, d, gen):
    """``[b, k, d]`` latents: per condition, k random points of an integer
    grid, each moved by at most 0.25 per axis, so any two lie >= 0.5 apart.

    Gaussian latents in 2-4 dimensions hold near-duplicate pairs, where the
    Gram form of the distance cancels most of its digits: the plain
    version's float32 grads then lie up to ~3e-3 of the largest from their
    float64 value.  On these latents they stay within ~1e-6 of it.
    """
    side = math.ceil(k ** (1.0 / d)) + 1
    axis = torch.arange(side, dtype=torch.float32, device="cuda")
    grid = torch.cartesian_prod(*[axis] * d).reshape(-1, d)
    pick = torch.argsort(torch.rand((b, side ** d), generator=gen,
                                    device="cuda"), dim=1)[:, :k]
    jitter = 0.5 * (torch.rand((b, k, d), generator=gen, device="cuda") - 0.5)
    return (grid[pick] + jitter - 0.5 * (side - 1)).contiguous()


def away_from_kinks(torch, draw, b):
    """``draw(n) -> (z, x)`` for n conditions, with every condition redrawn
    that holds a pair whose hinge slack alpha nz - nx lies within 2^-16 of
    its own size from 0 (in float64).  At such a kink the subgradient takes
    either side under float32 rounding, and one flipped pair moves every
    grad of its condition by up to ~1/k of the largest."""
    from ndivplanning_tpu_torch.ops.ndiv import normalized_pairwise_l2

    z, x = draw(b)
    off = ~torch.eye(z.shape[1], dtype=torch.bool, device=z.device)
    for _ in range(100):
        nz = ALPHA * normalized_pairwise_l2(z.double())
        nx = normalized_pairwise_l2(x.double())
        kink = ((nz - nx).abs() < 2.0 ** -16 * torch.maximum(nz, nx)) & off
        bad = kink.flatten(1).any(dim=1)
        if not bool(bad.any()):
            return z, x
        z[bad], x[bad] = draw(int(bad.sum()))
    raise AssertionError("no inputs away from the hinge's kinks in 100 draws")


def check_kernels(torch, ndiv_cuda, b, k, dz, dx, gen):
    """One shape: every route against its plain version, bitwise
    repeatability, and bitwise-equal grads across layouts.  Returns the
    summary it prints, with the largest absolute error of each route."""
    z, x = away_from_kinks(torch, lambda n: (
        spread_latents(torch, n, k, dz, gen),
        torch.randn((n, k, dx), generator=gen, device="cuda")), b)
    return check_inputs(torch, ndiv_cuda, z, x, f"{b}x{k}x{dz}x{dx}")


def run_route(ndiv_cuda, kernel, variant, z, x, g):
    """(loss sum or None, gz or None, gx or None) of one kernel route."""
    if kernel == "joint":
        return ndiv_cuda.ndiv_joint(z, x, ALPHA, variant)
    if kernel == "fwd":
        return ndiv_cuda.ndiv_fwd(z, x, ALPHA, variant), None, None
    return (None, *ndiv_cuda.ndiv_bwd(z, x, ALPHA, g, variant))


def check_inputs(torch, ndiv_cuda, z, x, label):
    b, k = z.shape[:2]
    m = b * k * (k - 1)
    g = torch.tensor(G_CHECK, device="cuda")
    plain_total, plain_gz, plain_gx = ndiv_cuda.ndiv_joint_plain(z, x, ALPHA)
    plain = {"joint": (plain_total, plain_gz, plain_gx),
             "fwd": (ndiv_cuda.ndiv_fwd_plain(z, x, ALPHA), None, None),
             "bwd": (None, *ndiv_cuda.ndiv_bwd_plain(z, x, ALPHA, g))}
    got, rel, errs = {}, {}, {}
    for kernel, variant in ROUTES:
        key = ndiv_cuda.launch_key(kernel, variant)
        out = run_route(ndiv_cuda, kernel, variant, z, x, g)
        again = run_route(ndiv_cuda, kernel, variant, z, x, g)
        torch.cuda.synchronize()
        if not all(a is None or torch.equal(a, c) for a, c in zip(out, again)):
            raise AssertionError(f"{label} {key}: repeated launches differ")
        rel[key], err = {}, 0.0
        for name, o, want, rtol, atol in zip(
                ("loss", "dz", "dx"), out, plain[kernel],
                (VAL_RTOL, GRAD_RTOL, GRAD_RTOL),
                (0.0, GRAD_ATOL_OF_MAX, GRAD_ATOL_OF_MAX)):
            if o is None:
                continue
            rel[key][name] = assert_close(torch, o, want, f"{label} {key} "
                                          f"{name}", rtol, atol)
            err = max(err, max_err(o / m, want / m) if name == "loss"
                      else max_err(o, want))
        errs[key] = err
        got[key] = out
    # The layouts compute every per-condition value in one order: equal
    # grads, bitwise; the loss may sum in another tree.
    layouts_bitwise = all(
        torch.equal(got[a][i], got[c][i])
        for a, c in (("joint", "joint_group"), ("bwd", "bwd_group"),
                     ("bwd", "bwd_packed")) for i in (1, 2))
    if not layouts_bitwise:
        raise AssertionError(f"{label}: the layouts' grads differ")
    dz, dx = z.shape[2], x.shape[2]
    kernels = {ndiv_cuda.launch_key(kernel, variant):
               ndiv_cuda.serving_kernel(kernel, k, dz, dx)
               for kernel, variant in ROUTES}
    for kernel, variant in ROUTES:
        want = "warp" if k <= WARP_K[kernel] else "tile"
        served = kernels[ndiv_cuda.launch_key(kernel, variant)]
        if served != want:
            raise AssertionError(f"{label} {kernel} {variant}: served by "
                                 f"the {served} kernel, want {want}")
    # Where the warp kernel serves, the layouts are one launch of one
    # kernel: totals and grads bitwise equal.
    warp_modes = [kernel for kernel in ("fwd", "bwd", "joint")
                  if k <= WARP_K[kernel]]
    for kernel in warp_modes:
        keys = [ndiv_cuda.launch_key(kernel, v) for v in VARIANTS
                if (kernel, v) != ("joint", "packed")]
        if not all(a is None or torch.equal(a, c) for key in keys[1:]
                   for a, c in zip(got[keys[0]], got[key])):
            raise AssertionError(f"{label} {kernel}: the layouts differ "
                                 f"under the warp kernel")
    tile_rel = {}
    for kernel in warp_modes:
        for g_val in ((1.0, G_CHECK) if kernel == "bwd" else (None,)):
            tile_rel[f"{kernel}_g{g_val}" if g_val else kernel] = (
                warp_against_tile(torch, ndiv_cuda, kernel, z, x, g_val,
                                  label))
    out = {
        "shape": label, "loss": float(got["joint"][0] / m),
        "kernels": kernels,
        "max_abs_err": errs, "err_over_max": rel,
        "max_abs_dz": float(plain_gz.abs().max()),
        "max_abs_dx": float(plain_gx.abs().max()),
        "bitwise_repeat": True, "layouts_grads_bitwise_equal": True,
        "warp_modes_layouts_bitwise_equal": warp_modes,
        "warp_vs_tile_total_rel_err": tile_rel,
    }
    emit({"phase": "kernel_check", **out})
    return out


def warp_against_tile(torch, ndiv_cuda, kernel, z, x, g_val, label):
    """The warp kernel's call against the tile kernel's (``impl="tile"``)
    on the same inputs: grads bitwise equal, totals within
    TILE_TOTAL_RTOL; returns the totals' relative difference (0 for bwd)."""
    g = None if g_val is None else torch.tensor(g_val, device="cuda")
    warp = run_route(ndiv_cuda, kernel, "block", z, x, g)
    tile = ndiv_cuda._launch(kernel, "block", z, x, ALPHA, g, impl="tile")
    tile = ((tile, None, None) if kernel == "fwd" else
            (None, *tile) if kernel == "bwd" else tile)
    if not all(a is None or torch.equal(a, c)
               for a, c in zip(warp[1:], tile[1:])):
        raise AssertionError(f"{label} {kernel} at g={g_val}: the warp "
                             f"kernel's grads differ from the tile kernel's")
    if warp[0] is None or torch.equal(warp[0], tile[0]):
        return 0.0
    total_rel = float((warp[0] - tile[0]).abs() / tile[0].abs())
    if total_rel > TILE_TOTAL_RTOL:
        raise AssertionError(f"{label} {kernel}: totals {total_rel} apart "
                             f"on the warp and the tile kernel")
    return total_rel


@contextlib.contextmanager
def tile_reference(ndiv_cuda):
    """Every NDiv launch inside runs the tile kernel (``impl="tile"``),
    whatever the shape: the reference a step on the warp kernel is held
    against."""
    launch = ndiv_cuda._launch
    ndiv_cuda._launch = functools.partial(launch, impl="tile")
    try:
        yield
    finally:
        ndiv_cuda._launch = launch


def check_step_inputs(torch, ndiv_cuda, z, x, label):
    """The kernel on the inputs the first main-path step gives it.

    At init the generator's k samples of a condition sit ~1e-3..1e-1 apart
    at |x|^2 ~ 16, where a float32 Gram form keeps ~2 digits of a distance:
    the plain version in float32 is ~1e-3 of the largest dx off here.  The
    kernel accumulates the Gram form in float64, so it is held against the
    plain version in float64 at the tolerances of the other shapes; the
    float32 plain version's own error is printed beside it.  Returns the
    kernel's loss.
    """
    got = ndiv_cuda.ndiv_joint(z, x, ALPHA)
    exact = ndiv_cuda.ndiv_joint_plain(z.double(), x.double(), ALPHA)
    plain = ndiv_cuda.ndiv_joint_plain(z, x, ALPHA)
    out = {}
    for name, g, e, p, rtol, atol in zip(
            ("loss", "dz", "dx"), got, exact, plain,
            (VAL_RTOL, GRAD_RTOL, GRAD_RTOL), (0.0, GRAD_ATOL_OF_MAX,
                                               GRAD_ATOL_OF_MAX)):
        scale = float(e.abs().max())
        out[name] = {
            "err_over_max": assert_close(torch, g.double(), e,
                                         f"{label} step inputs {name}", rtol,
                                         atol),
            "plain_f32_err_over_max": max_err(p.double(), e) / scale}
    emit({"phase": "kernel_check_step_inputs", "preset": label,
          "shape": list(z.shape[:2]) + [z.shape[2], x.shape[2]], **out})
    return float(got[0]) / (z.shape[0] * z.shape[1] * (z.shape[1] - 1))


def device_ms(torch, fn, n, sleep_cycles, repeats=5):
    """Device time per call, the median of ``repeats`` windows: in each, a
    sleep kernel holds the card while the host queues n calls, so they run
    back to back and the events see device time, not launch overhead."""
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


def profile(torch, fn, n):
    """torch.profiler over n synchronised calls: wall time, summed kernel
    time, their ratio (the device's busy share), kernel launches, and the
    kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    ndiv = [e for e in kernels if any(name in e.key for name in NDIV_KERNELS)]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "wall_ms_per_call": wall_ms, "kernel_ms_per_call": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_call": sum(e.count for e in kernels) / n,
        "ndiv_kernels_ms_per_call": sum(
            e.self_device_time_total for e in ndiv) / 1e3 / n,
        "ndiv_launches_per_call": sum(e.count for e in ndiv) / n,
        "top_kernels": [{"name": e.key[:60],
                         "ms_per_call": e.self_device_time_total / 1e3 / n,
                         "launches_per_call": e.count / n} for e in top],
    }


def bound(b, k, dz, dx, kernel):
    """Least time (ms) on the card: the function's inputs read once and its
    outputs written once over HBM, or its float32 operations (the
    reference's precision) over the float32 peak.  The same for every
    layout: the layouts compute one function."""
    grads = kernel != "fwd"
    d = dz + dx
    io_bytes = 4 * b * k * d  # z and x; the grads are as large
    in_bytes = io_bytes + (4 if kernel == "bwd" else 0)  # bwd reads g
    out_bytes = (io_bytes if grads else 0) + (0 if kernel == "bwd" else 4)
    # Per condition: the distances of the k(k-1)/2 distinct pairs (the
    # matrix is symmetric), a difference and a multiply-add per element;
    # with grads, sum_j W_ij (a_i - a_j) = rowsum(W)_i a_i - (W a)_i, a
    # k x k x d product (2 flops per term).  Per (i, j) entry, ~12 flops
    # of normalisation and hinge and, with grads, ~18 of slack, dL/dD and W.
    flops = b * (k * (k - 1) * d + (2 * k * k * d if grads else 0)
                 + k * k * (12 + (18 if grads else 0)))
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def profile_step(torch, fn, preset):
    """The profile of 5 train steps: one NDiv kernel launch per step (the
    joint call), and the launches per step beside those of two-launch
    joint calls."""
    out = profile(torch, fn, 5)
    if out["ndiv_launches_per_call"] != 1:
        raise AssertionError(f"{preset}: {out['ndiv_launches_per_call']} "
                             f"NDiv kernel launches per step, want 1")
    return {"phase": f"profile_{preset}_train_step", "preset": preset, **out,
            "kernel_launches_per_call_tile_joint":
                TILE_JOINT_LAUNCHES_PER_STEP[preset]}


def warp_vs_tile_step(torch, ndiv_cuda, step, state, preset, cfg,
                      variant="block", kernels=("joint",)):
    """One train step from clones of ``state`` under ``variant`` (its
    ``kernels`` on the warp kernel), then the same step with every NDiv
    launch on the tile kernel (``tile_reference``): the grads are bitwise
    equal, so are G's and D's params and every metric but the NDiv loss
    and the total G loss, whose sums may differ in their last bits (held at
    TILE_TOTAL_RTOL).  Returns the phase and the first step's launches."""
    shape = (cfg.k, cfg.latent_dim, cfg.traj_dim)
    for kernel in kernels:
        if ndiv_cuda.serving_kernel(kernel, *shape) != "warp":
            raise AssertionError(f"{preset}: the warp kernel does not serve "
                                 f"{kernel} at k, dz, dx = {shape}")
    out = {}
    ndiv_cuda.VARIANT = variant
    try:
        reset(ndiv_cuda)
        out["warp"] = step(clone_state(torch, state))
        torch.cuda.synchronize()
        launches = launched(ndiv_cuda)
        with tile_reference(ndiv_cuda):
            out["tile"] = step(clone_state(torch, state))
            torch.cuda.synchronize()
    finally:
        ndiv_cuda.VARIANT = "block"
    (warp, wm), (tile, tm) = out["warp"], out["tile"]
    params_equal = all(torch.equal(a, b) for a, b in zip(
        [*warp.g.parameters(), *warp.d.parameters()],
        [*tile.g.parameters(), *tile.d.parameters()]))
    if not params_equal:
        raise AssertionError(f"{preset}: G or D params after one step differ "
                             f"between the warp and the tile kernel")
    loss_rel = {}
    for key, v in tm.items():
        if key in ("g_ndiv", "g_total"):
            loss_rel[key] = float((wm[key] - v).abs().max()
                                  / v.abs().max().clamp_min(1e-30))
            if loss_rel[key] > TILE_TOTAL_RTOL:
                raise AssertionError(f"{preset} {key}: {loss_rel[key]} off")
        elif not torch.equal(wm[key], v):
            raise AssertionError(f"{preset} {key}: {wm[key]} vs {v}")
    return {"phase": "warp_vs_tile_step", "preset": preset,
            "k_dz_dx": list(shape), "variant": variant,
            "launches": launches, "params_bitwise_equal": True,
            "other_metrics_bitwise_equal": True,
            "loss_rel_err": loss_rel}, launches


def pod_dp_routes(torch, ndiv_cuda, mesh):
    """One pod_dp step at full width from one state through
    ``make_sharded_train_step`` on ``mesh``, under the default route
    (``ndiv_joint``) and the NDIV_JOINT=0 one (``ndiv_fwd`` + ``ndiv_bwd``,
    block): the launches of the second, and its g_ndiv and G's Adam first
    moments against the first at the imagecond routes' tolerances.

    In float32 compute: in bf16 each weight gradient rounds to 8 bits, so
    two routes whose NDiv grads differ in their last float32 bits land a
    bf16 ulp (2^-8) apart in ~1% of G's elements, and those tolerances
    would hold nothing."""
    from ndivplanning_tpu_torch.parallel import (
        make_sharded_train_step,
        shard_state,
    )
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.utils.config import get_config

    cfg = get_config("pod_dp", dp_shards=1, div_shards=1,
                     compute_dtype="f32")
    step, _ = make_sharded_train_step(cfg, mesh)
    start = shard_state(create_train_state(cfg, seed=0), mesh)
    ref_state, ref = step(clone_state(torch, start))
    want = {"fwd": 1, "bwd": 1}
    ndiv_cuda.VARIANT, ndiv_cuda.JOINT = "block", False
    reset(ndiv_cuda)
    try:
        st, m = step(clone_state(torch, start))
        torch.cuda.synchronize()
        got = launched(ndiv_cuda)
        # The profiler's NDiv kernels per step: the forward and the
        # backward, one launch each (the warp kernel sums the loss itself).
        prof = profile(torch, lambda: step(clone_state(torch, start)), 3)
    finally:
        ndiv_cuda.JOINT = True
    if got != want:
        raise AssertionError(f"pod_dp NDIV_JOINT=0 route: launches {got}, "
                             f"want {want}")
    if prof["ndiv_launches_per_call"] != 2:
        raise AssertionError(f"pod_dp NDIV_JOINT=0 route: "
                             f"{prof['ndiv_launches_per_call']} NDiv kernel "
                             f"launches per step, want 2")
    ndiv_rel = assert_close(torch, m["g_ndiv"], ref["g_ndiv"],
                            "pod_dp route g_ndiv", VAL_RTOL)
    grad_rel = max(
        assert_close(torch, st.g_opt.mu[name], mu,
                     f"pod_dp route G grad {name}", GRAD_RTOL,
                     GRAD_ATOL_OF_MAX)
        for name, mu in ref_state.g_opt.mu.items())
    return got, {
        "phase": "pod_dp_routes", "preset": "pod_dp", "mesh": mesh.shape,
        "compute_dtype": cfg.compute_dtype, "batch_size": cfg.batch_size,
        "k": cfg.k, "variant": "block", "joint": False, "launches": got,
        "kernels": {key: ndiv_cuda.serving_kernel(
            key, cfg.k, cfg.latent_dim, cfg.traj_dim) for key in want},
        "g_ndiv": float(m["g_ndiv"][0]), "ref_g_ndiv": float(ref["g_ndiv"][0]),
        "profiler_ndiv_launches_per_step": prof["ndiv_launches_per_call"],
        "profiler_ndiv_kernels_ms_per_step": prof["ndiv_kernels_ms_per_call"],
        "g_ndiv_err_over_ref": ndiv_rel, "g_grads_err_over_max": grad_rel,
        "g_grads_bitwise_equal": all(
            torch.equal(st.g_opt.mu[name], mu)
            for name, mu in ref_state.g_opt.mu.items())}


def reset(*counted) -> None:
    """Zero the ``LAUNCHES`` counts of the given modules."""
    for module in counted:
        for key in module.LAUNCHES:
            module.LAUNCHES[key] = 0


def launched(*counted) -> dict:
    """The nonzero ``LAUNCHES`` counts of the given modules."""
    return {key: n for module in counted
            for key, n in module.LAUNCHES.items() if n}


def clone_state(torch, state):
    """A deep copy of a TrainState on the card (its generator re-seeded
    from the same state)."""
    rng = torch.Generator(device=state.rng.device)
    rng.set_state(state.rng.get_state())
    return dataclasses.replace(
        state, rng=rng, g=copy.deepcopy(state.g), d=copy.deepcopy(state.d),
        g_opt=copy.deepcopy(state.g_opt), d_opt=copy.deepcopy(state.d_opt),
        g_ema=copy.deepcopy(state.g_ema),
        ada={key: v.clone() for key, v in state.ada.items()})


def first_step_inputs(torch, cfg, state, make_task):
    """The first step's batch, z and G(z): its batch and then its z are the
    first draws from state.rng, and G does not change before its NDiv."""
    rng = torch.Generator(device="cuda")
    rng.set_state(state.rng.get_state())
    batch = make_task(cfg).sample(rng, cfg.batch_size)
    z = torch.randn((cfg.batch_size, cfg.k, cfg.latent_dim), generator=rng,
                    device="cuda")
    with torch.no_grad():
        x = state.g(batch.conditions, z).reshape(cfg.batch_size, cfg.k,
                                                 -1).contiguous()
    return batch, z, x


def train(torch, ndiv_cuda, cfg, state, step_fn, steps=TRAIN_STEPS):
    """``steps`` steps from ``state``, with the launch counts of
    ``ndiv_cuda`` reset just before; returns (state, per-step metrics,
    step ms, launches).  The joint kernel must launch once a step."""
    want = {"joint": steps}
    before = [p.detach().clone() for p in state.g.parameters()]
    d_before = [p.detach().clone() for p in state.d.parameters()]
    reset(ndiv_cuda)
    step_ms, history = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step_fn(cfg, state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append({key: float(v) for key, v in metrics.items()})
    launches = launched(ndiv_cuda)
    for rec in history:
        for key, v in rec.items():
            if v != v or abs(v) == float("inf"):
                raise AssertionError(f"non-finite metric {key}={v}")
    if all(torch.equal(a, p) for a, p in zip(before, state.g.parameters())):
        raise AssertionError("G params did not change")
    if all(torch.equal(a, p) for a, p in zip(d_before, state.d.parameters())):
        raise AssertionError("D params did not change")
    if launches != want:
        raise AssertionError(f"{cfg.name}: launches {launches} in {steps} "
                             f"steps, want {want}")
    return state, history, step_ms, launches


def check_first_step(history, step_input_loss, name):
    if abs(history[0]["g_ndiv"] - step_input_loss) > 1e-5 * step_input_loss:
        raise AssertionError(
            f"{name}: first step's g_ndiv {history[0]['g_ndiv']} is not the "
            f"NDiv of the inputs checked above ({step_input_loss})")


def plan_times(torch, plan, cfg, state, scene, condition, n=6):
    plan_gen = torch.Generator(device="cuda")
    plan_ms = []
    for i in range(n):
        plan_gen.manual_seed(i)
        t0 = time.perf_counter()
        result = plan(cfg, state, scene, condition, plan_gen)
        torch.cuda.synchronize()
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    return result, plan_ms, plan_gen


def check_plan(torch, plan, create_train_state, cfg, state, result, scene,
               condition):
    """Shapes, finiteness, distinct diverse picks, and agreement with the
    CPU port (plain torch) on the same latents at n=64."""
    if tuple(result.taus.shape) != (1000, cfg.horizon, 2):
        raise AssertionError(f"taus shape {tuple(result.taus.shape)}")
    if not (torch.isfinite(result.taus).all()
            and torch.isfinite(result.scores).all()):
        raise AssertionError("non-finite plan output")
    idx = result.diverse_idx.tolist()
    if len(set(idx)) != 8:
        raise AssertionError(f"diverse indices not distinct: {idx}")
    cpu_state = create_train_state(cfg, seed=0, device="cpu")
    cpu_state.g_ema.load_state_dict(
        {k: v.cpu() for k, v in state.g_ema.state_dict().items()})
    z64 = torch.randn((1, 64, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(9))
    small_gpu = plan(cfg, state, scene, condition, n_candidates=64,
                     z=z64.cuda())
    cpu_scene = dataclasses.replace(
        scene, **{f.name: getattr(scene, f.name).cpu()
                  for f in dataclasses.fields(scene)})
    small_cpu = plan(cfg, cpu_state, cpu_scene, condition.cpu(),
                     n_candidates=64, z=z64)
    score_err = max_err(small_gpu.scores.cpu(), small_cpu.scores)
    if score_err > 1e-4:
        raise AssertionError(f"plan scores cuda vs cpu differ by {score_err}")
    return {"best_score": float(result.best_score),
            "best_reached": float(result.best_reached), "diverse_idx": idx,
            "vs_cpu_n64_max_score_err": score_err,
            "vs_cpu_n64_same_diverse_idx":
                small_gpu.diverse_idx.tolist()
                == small_cpu.diverse_idx.tolist()}


def check_virtual_ranks(torch, ndiv_cuda, sharded, z, x, dp, div):
    """The sharded call site's per-rank function, for dp x div virtual
    ranks in this process, against the unsharded ``ndiv_joint``: the
    partials summed on the host in rank order, and the grads, each
    condition's from exactly one rank's kernel."""
    b, k = z.shape[:2]
    m = b * k * (k - 1)
    total, want_gz, want_gx = ndiv_cuda.ndiv_joint(z, x, ALPHA)
    reset(ndiv_cuda)
    partials = []
    gz, gx = torch.zeros_like(z), torch.zeros_like(x)
    bl = b // dp
    for i in range(dp):
        rows = slice(i * bl, (i + 1) * bl)
        z_full = z[rows].clone().requires_grad_()
        x_full = x[rows].clone().requires_grad_()
        for j in range(div):
            part = sharded.ndiv_rank_partial(z_full, x_full, ALPHA, j, div)
            g_z, g_x = torch.autograd.grad(part / m, (z_full, x_full))
            partials.append(float(part.detach()))
            gz[rows] += g_z
            gx[rows] += g_x
    torch.cuda.synchronize()
    launches = launched(ndiv_cuda)
    if launches != {"joint": dp * div}:
        raise AssertionError(f"virtual ranks {dp}x{div}: launches {launches}")
    want = float(total) / m
    loss_rel = abs(sum(partials) / m - want) / abs(want)
    grad_rel = max(max_err(gz, want_gz) / float(want_gz.abs().max()),
                   max_err(gx, want_gx) / float(want_gx.abs().max()))
    if loss_rel > SHARDED_RTOL or grad_rel > SHARDED_RTOL:
        raise AssertionError(
            f"virtual ranks {dp}x{div} at {list(z.shape)}: loss {loss_rel:.2e}"
            f" and grads {grad_rel:.2e} of the largest off the unsharded "
            f"kernel (tolerance {SHARDED_RTOL})")
    return {"mesh": [dp, div], "shape": list(z.shape[:2])
            + [z.shape[2], x.shape[2]], "loss": want,
            "loss_rel_err": loss_rel, "grad_err_over_max": grad_rel,
            "launches": launches}


def pod_dp_run(dtype, dp, div, steps, mesh=None):
    """pod_dp at full width from seed 0, ``steps`` sharded steps on a
    (dp, div) mesh (``mesh``, or one made over the default process group):
    per-step metrics, G's params and G's Adam first moments, on the host."""
    from ndivplanning_tpu_torch.parallel import (
        make_sharded_train_step,
        shard_state,
    )
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.utils.config import get_config

    cfg = get_config("pod_dp", dp_shards=dp, div_shards=div,
                     compute_dtype=dtype)
    step_fn, mesh = make_sharded_train_step(cfg, mesh)
    state = shard_state(create_train_state(cfg, seed=0), mesh)
    history = []
    for _ in range(steps):
        state, metrics = step_fn(state)
        history.append({key: float(v) for key, v in metrics.items()})
    return (history,
            {n: p.detach().cpu().numpy()
             for n, p in state.g.named_parameters()},
            {n: v.cpu().numpy() for n, v in state.g_opt.mu.items()})


def two_rank_worker(runs):
    """One of two ranks sharing the card through gloo (NCCL refuses two
    ranks on one device): every (dtype, dp, div) of ``runs``, through
    ``pod_dp_run``."""
    return {run: pod_dp_run(*run, TWO_RANK_STEPS) for run in runs}


def compare_runs(ref, got, dtype, lr, steps, label):
    """A sharded run against the 1x1 run from the same state, at
    TWO_RANK_TOL[dtype]: metrics, and G's params (see TWO_RANK_TOL for the
    elements whose gradient is within rounding of zero)."""
    import numpy as np

    tol = TWO_RANK_TOL[dtype]
    ref_history, ref_params, ref_mu = ref
    history, params, _ = got
    metric_err = {}
    for step, (rec, want) in enumerate(zip(history, ref_history)):
        for key, w in want.items():
            atol = tol["sign_atol"] if key in SIGN_METRICS else METRIC_ATOL
            if abs(rec[key] - w) > atol + tol["metric_rtol"] * abs(w):
                raise AssertionError(
                    f"{label} step {step} {key}: {rec[key]} vs 1x1 {w} "
                    f"(rtol {tol['metric_rtol']}, atol {atol})")
            metric_err[key] = max(metric_err.get(key, 0.0),
                                  abs(rec[key] - w) / max(abs(w), 1e-30))
    param_err, resolved_err, flipped, total = 0.0, 0.0, 0, 0
    atol = tol["param_atol"] + tol["param_atol_of_lr"] * lr * steps
    for name, want in ref_params.items():
        diff = np.abs(params[name] - want)
        off = diff > atol + tol["param_rtol"] * np.abs(want)
        mu = np.abs(ref_mu[name])
        resolved = mu > 1e-2 * mu.max()
        if tol["off_share"] is None and np.any(off & resolved):
            raise AssertionError(
                f"{label} G param {name}: {float(diff[off & resolved].max())}"
                f" off the 1x1 run where its gradient is resolved")
        if float(diff.max()) > 2.0 * lr * steps + 1e-6:
            raise AssertionError(f"{label} G param {name}: "
                                 f"{float(diff.max())} > 2 lr per step")
        param_err = max(param_err, float(diff.max()))
        resolved_err = max(resolved_err, float(diff[resolved].max()))
        flipped += int(np.sum(off))
        total += diff.size
    if tol["off_share"] is not None and flipped > tol["off_share"] * total:
        raise AssertionError(f"{label}: {flipped} of {total} G params off "
                             f"the 1x1 run, over {tol['off_share']}")
    return {"metrics_max_rel_err": metric_err,
            "metrics_1x1_last": ref_history[-1],
            "g_params_max_abs_err": param_err,
            "g_params_resolved_grad_max_abs_err": resolved_err,
            "g_params_outside_tol": flipped,
            "g_params": total, "tolerance": tol}


def serve_requests(torch, n, seed):
    """``n`` request dicts from random scenes (3 live obstacles each)."""
    from ndivplanning_tpu_torch.data.scenes import random_scene_batch

    sc = random_scene_batch(torch.Generator().manual_seed(seed), n)
    return [{"start": sc.start[i].tolist(), "goal": sc.goal[i].tolist(),
             "obstacles": sc.obstacles[i][sc.obstacle_mask[i] > 0.5].tolist()}
            for i in range(n)]


def checkpoint_restore(torch, workdir, want_step, device="cuda"):
    """A committed torch checkpoint restored by the CLI's loader on the card
    (``device``) and on the CPU: its step and every tensor bitwise equal."""
    from ndivplanning_tpu_torch.cli import _load_state
    from ndivplanning_tpu_torch.utils import checkpoint
    from ndivplanning_tpu_torch.utils.config import load_config

    cfg = load_config(workdir).replace(workdir=workdir)
    t0 = time.perf_counter()
    state = _load_state(cfg, device)
    next(state.g_ema.parameters()).sum().item()  # the copies are done
    load_s = time.perf_counter() - t0
    cpu_state = _load_state(cfg, "cpu")
    if state.step != want_step or cpu_state.step != want_step:
        raise AssertionError(f"{workdir} restored at step {state.step} / "
                             f"{cpu_state.step}, want {want_step}")
    card, cpu = checkpoint.state_dict(state), checkpoint.state_dict(cpu_state)
    del card["rng"], cpu["rng"]
    tensors, values = [], 0

    def walk(a, b, path):
        nonlocal values
        if isinstance(a, dict):
            if a.keys() != b.keys():
                raise AssertionError(f"{path}: keys differ")
            for key in a:
                walk(a[key], b[key], f"{path}/{key}")
        elif isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                raise AssertionError(f"{path}: card and CPU restores differ")
            tensors.append(path)
            values += a.numel()
        elif a != b:
            raise AssertionError(f"{path}: {a} != {b}")

    walk(card, cpu, "")
    if not all(p.device.type == device for p in state.g_ema.parameters()):
        raise AssertionError(f"the restore is not on {device}")
    return cfg, state, cpu_state, {
        "phase": f"checkpoint_{os.path.basename(workdir)}",
        "workdir": workdir,
        "step": state.step, "tensors": len(tensors), "values": values,
        "bitwise_equal_cpu": True, "load_s_card": load_s,
        "g_lr_at_step": state.g_opt.lr(state.g_opt.count)}


def serve_vs_cpu(torch, ndiv_cuda, cfg, state, cpu_state):
    """handle_batch's dispatch program on 16 scenes at 1000 candidates on
    the card and on the CPU, from one state and one set of latents, then
    handle_batch itself: scores at SERVE_RTOL/ATOL, picks equal but for
    the near-ties of the tie rule."""
    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.planning import server as srv
    from ndivplanning_tpu_torch.planning.planner import _diverse_top_m

    requests = serve_requests(torch, SERVE_SCENES, 5)
    scenes = Scene.stack([Scene.create(r["start"], r["goal"], r["obstacles"],
                                       device="cpu") for r in requests])
    z = torch.randn((SERVE_SCENES, cfg.n_candidates, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(6))
    device = state.rng.device
    reset(ndiv_cuda)
    card = srv._serve_plan_program(cfg, state, srv._to_device(scenes, device),
                                   z.to(device), SERVE_DIVERSE)
    cpu = srv._serve_plan_program(cfg, cpu_state, scenes, z, SERVE_DIVERSE)
    card_scores = card.scores.cpu()
    err = (card_scores - cpu.scores).abs()
    if bool((err > SERVE_RTOL * cpu.scores.abs() + SERVE_ATOL).any()):
        raise AssertionError(f"serve scores card vs CPU: {float(err.max())}")
    rows = torch.arange(SERVE_SCENES)
    card_best = card.scores.argmin(dim=1).cpu()
    cpu_best = cpu.scores.argmin(dim=1)
    gap = (cpu.scores[rows, card_best] - cpu.scores[rows, cpu_best]).abs()
    near = 2 * (SERVE_RTOL * cpu.scores[rows, cpu_best].abs() + SERVE_ATOL)
    if bool(((card_best != cpu_best) & (gap > near)).any()):
        raise AssertionError("serve best picks differ beyond a near-tie")
    card_div, cpu_div = card.diverse_idx.cpu(), cpu.diverse_idx
    same_div = (card_div == cpu_div).all(dim=1)
    explained = _diverse_top_m(cpu.taus.flatten(2), card_scores,
                               SERVE_DIVERSE)
    if bool((~same_div & ~(explained == card_div).all(dim=1)).any()):
        raise AssertionError("serve diverse picks differ beyond near-ties")
    # handle_batch itself on both devices with those latents.
    gen = torch.Generator(device=device)
    resp_card = srv.handle_batch(cfg, state, requests, gen,
                                 n_diverse=SERVE_DIVERSE, latents=lambda b: z)
    resp_cpu = srv.handle_batch(cfg, cpu_state, requests, torch.Generator(),
                                n_diverse=SERVE_DIVERSE, latents=lambda b: z)
    launches = launched(ndiv_cuda)
    if launches:
        raise AssertionError(f"the serving path launched NDiv: {launches}")
    for i, (rc, rp) in enumerate(zip(resp_card, resp_cpu)):
        if rc["batch_size"] != SERVE_SCENES or rc["best_score"] != float(
                card.best_score[i]):
            raise AssertionError(f"handle_batch response {i} is not its "
                                 f"dispatch program's answer")
        if abs(rc["best_score"] - rp["best_score"]) > float(near[i]):
            raise AssertionError(f"handle_batch best_score {i}: card "
                                 f"{rc['best_score']} cpu {rp['best_score']}")
    return {"phase": "serve_vs_cpu", "scenes": SERVE_SCENES,
            "n_candidates": cfg.n_candidates, "n_diverse": SERVE_DIVERSE,
            "rtol": SERVE_RTOL, "atol": SERVE_ATOL,
            "max_abs_score_err": float(err.max()),
            "best_equal_share": float((card_best == cpu_best).float().mean()),
            "diverse_equal_share": float(same_div.float().mean()),
            "reached_share_card": float(card.best_reached.mean()),
            "reached_share_cpu": float(cpu.best_reached.mean()),
            "ndiv_launches": launches}


def _strip_latency(obj):
    if isinstance(obj, list):
        return [_strip_latency(o) for o in obj]
    return {k: v for k, v in obj.items() if k != "latency_ms"}


def serve_session(torch, spawn):
    """One CLI server over pipes: bucket round trips, a 16-request array
    and a burst of 16 lines, a malformed line, stats and quit.  Returns
    the answers (for the bitwise repeat), the served report and timings."""
    reqs = serve_requests(torch, SERVE_SCENES, 11)
    answers, latency, round_trip = [], {}, {}
    with spawn() as c:
        for bucket in (1, 2, 4, 8, 16):
            for _ in range(SERVE_REPEATS):
                t0 = time.perf_counter()
                out = (c.plan(**reqs[0]) if bucket == 1
                       else c.plan_batch(reqs[:bucket]))
                round_trip.setdefault(bucket, []).append(
                    time.perf_counter() - t0)
                out = out if isinstance(out, list) else [out]
                if [r["batch_size"] for r in out] != [bucket] * len(out):
                    raise AssertionError(f"bucket {bucket}: batch sizes "
                                         f"{[r['batch_size'] for r in out]}")
                latency.setdefault(bucket, []).extend(
                    r["latency_ms"] for r in out)
                answers.append(out)
        burst = c.send_lines([json.dumps(r) for r in reqs])
        bad = c.send_lines(["not json"])
        stats = c.stats()
        served = c.close()
    for out in answers + [burst]:
        for r in out:
            if (len(r["best_traj"]) != 32 or len(r["diverse_trajs"])
                    != SERVE_DIVERSE or len(r["diverse_trajs"][0]) != 32):
                raise AssertionError(f"response shapes: {list(r)}")
    if [r["batch_size"] for r in burst] != [SERVE_SCENES] * SERVE_SCENES:
        raise AssertionError("the burst of 16 lines did not share one "
                             "bucket-16 dispatch")
    if "error" not in bad[0] or any("error" in r for r in burst):
        raise AssertionError("the malformed line's error is out of place")
    n_lines = len(answers) + SERVE_SCENES + 2
    if served != [{"served": n_lines}]:
        raise AssertionError(f"served report {served}, want {n_lines}")
    want_requests = (sum((1, 2, 4, 8, 16)) * (SERVE_REPEATS + 1)
                     + SERVE_SCENES)  # warmup, the round trips, the burst
    if stats["requests"] != want_requests:
        raise AssertionError(f"stats requests {stats['requests']}, want "
                             f"{want_requests}")
    return answers + [burst], n_lines, stats, latency, round_trip


def serve_planning512(torch):
    """Two CLI servers of the same seed over pipes, through the port's
    client: shapes, error position, served count, bitwise repeat."""
    from ndivplanning_tpu_torch.planning.client import PlanningClient

    def spawn():
        return PlanningClient.spawn(["--workdir", PLANNING512, "--warmup"])

    t0 = time.perf_counter()
    first, n_lines, stats, latency, round_trip = serve_session(torch, spawn)
    session_s = time.perf_counter() - t0
    second = serve_session(torch, spawn)[0]
    if _strip_latency(first) != _strip_latency(second):
        raise AssertionError("two servers of one seed answered differently")
    return {"phase": "serve_planning512", "workdir": PLANNING512,
            "transport": "pipes, PlanningClient.spawn",
            "lines_served": n_lines, "stats": stats,
            "repeat_bitwise_but_latency": True,
            "latency_ms_median_by_bucket": {
                b: statistics.median(v) for b, v in latency.items()},
            "round_trip_ms_median_by_bucket": {
                b: statistics.median(v) * 1e3 for b, v in round_trip.items()},
            "requests_per_s_16_array": SERVE_SCENES / statistics.median(
                round_trip[16]),
            "session_s": session_s}


def profile_serve(torch, ndiv_cuda, cfg, state):
    """torch.profiler around handle_batch at buckets 1 and 16: launches per
    dispatch may grow at most SERVE_LAUNCH_RATIO-fold with the bucket."""
    from ndivplanning_tpu_torch.planning import server as srv

    requests = serve_requests(torch, SERVE_SCENES, 13)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    reset(ndiv_cuda)
    for bucket in (1, SERVE_SCENES):
        out[bucket] = profile(torch, functools.partial(
            srv.handle_batch, cfg, state, requests[:bucket], gen,
            n_diverse=SERVE_DIVERSE), 5)
    if launched(ndiv_cuda):
        raise AssertionError(f"serving launched NDiv: {launched(ndiv_cuda)}")
    ratio = (out[SERVE_SCENES]["kernel_launches_per_call"]
             / out[1]["kernel_launches_per_call"])
    if ratio > SERVE_LAUNCH_RATIO:
        raise AssertionError(f"bucket 16 launches {ratio:.3f}x bucket 1's")
    return {"phase": "profile_serve", "launch_ratio_16_over_1": ratio,
            **{f"bucket_{b}": o for b, o in out.items()}}


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl"), encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def state_tensors(state) -> dict:
    """Every tensor of a TrainState by name: G, D, EMA G, both Adam
    chains' moments and the ADA state."""
    out = {}
    for name, module in (("g", state.g), ("d", state.d),
                         ("g_ema", state.g_ema)):
        out.update({f"{name}.{k}": v for k, v in module.state_dict().items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        out.update({f"{name}.mu.{k}": v for k, v in opt.mu.items()})
        out.update({f"{name}.nu.{k}": v for k, v in opt.nu.items()})
    out.update({f"ada.{k}": v for k, v in state.ada.items()})
    return out


def check_states_bitwise(torch, a, b, label) -> int:
    """Raise unless two states agree bitwise: every tensor, the step, the
    Adam counts and the generator's state.  Returns the values compared."""
    if (a.step, a.g_opt.count, a.d_opt.count) != (b.step, b.g_opt.count,
                                                  b.d_opt.count):
        raise AssertionError(f"{label}: steps or Adam counts differ")
    ta, tb = state_tensors(a), state_tensors(b)
    if ta.keys() != tb.keys():
        raise AssertionError(f"{label}: tensor names differ")
    for name, t in ta.items():
        if not torch.equal(t, tb[name]):
            raise AssertionError(f"{label}: {name} differs")
    if not torch.equal(a.rng.get_state(), b.rng.get_state()):
        raise AssertionError(f"{label}: the generators' states differ")
    return sum(t.numel() for t in ta.values())


def warp_launches_by_mode(torch, fn) -> dict:
    """Run ``fn`` under torch.profiler (the card's activity only) and count
    the NDiv kernels it launched: the warp kernel by mode, and the tile
    kernel and its sum."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"ndiv_warp_kernel<\s*(\d+)\s*,", e.key)
        if m:
            key = WARP_MODES[m.group(1)]
        elif any(name in e.key for name in NDIV_KERNELS):
            key = "tile"
        else:
            continue
        counts[key] = counts.get(key, 0) + e.count
    return out, counts


def clean_window_ms(rows, cfg):
    """Per-step wall ms of the log windows with no checkpoint or eval inside
    (a window ends at a log row and starts at the previous one, whose
    boundary saves and evaluates after its row)."""
    out = []
    train_rows = [r for r in rows if "kind" not in r]
    for prev, row in zip(train_rows, train_rows[1:]):
        busy = any(every and prev["step"] % every == 0
                   for every in (cfg.checkpoint_every, cfg.eval_every))
        if not busy:
            out.append(1e3 / row["steps_per_sec"])
    return out


def train_loop_phase(torch, ndiv_cuda):
    """The port's train loop on the planning512 recipe at full width, runs
    A (0 -> 300) and B (0 -> 200, resumed to 300): final states bitwise
    equal, B's rows from step 200 on equal to A's but for their clocks, a
    best checkpoint with a finite value, one ndiv_joint launch a step and
    one ndiv_fwd launch an eval leg (counts and profiler).  Then one eval
    point (both legs) timed and profiled, and the CLI's train and eval in
    subprocesses.  Returns (phase, launches by run)."""
    from ndivplanning_tpu_torch.train import loop
    from ndivplanning_tpu_torch.train.evaluate import evaluate_fixed
    from ndivplanning_tpu_torch.utils import checkpoint as ckpt
    from ndivplanning_tpu_torch.utils.config import load_config
    from ndivplanning_tpu_torch.utils.metrics import host_floats

    cfg = load_config(PLANNING512).replace(**LOOP_EVERY)
    if (cfg.steps, cfg.lr_schedule, cfg.batch_size, cfg.k) != (
            150000, "cosine", 512, 8):
        raise AssertionError(f"planning512 recipe changed: {cfg}")
    legs = 2 if cfg.g_ema_decay > 0 else 1
    points = {n: n // cfg.eval_every + (n % cfg.eval_every > 0)
              for n in (LOOP_STEPS, LOOP_RESUME_AT)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    run_a, run_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    launches = {}

    def run(key, workdir, steps, want):
        reset(ndiv_cuda)
        t0 = time.perf_counter()
        state, history = loop.train(cfg, num_steps=steps, workdir=workdir,
                                    echo=False)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches[key] = launched(ndiv_cuda)
        if launches[key] != want:
            raise AssertionError(f"train loop {key}: launches "
                                 f"{launches[key]}, want {want}")
        return state, history, wall_s

    state_a, history_a, wall_a = run(
        "run_a", run_a, LOOP_STEPS,
        {"joint": LOOP_STEPS, "fwd": legs * points[LOOP_STEPS]})
    run("run_b_first", run_b, LOOP_RESUME_AT,
        {"joint": LOOP_RESUME_AT, "fwd": legs * points[LOOP_RESUME_AT]})
    resumed = LOOP_STEPS - LOOP_RESUME_AT
    resumed_points = points[LOOP_STEPS] - points[LOOP_RESUME_AT]
    (state_b, history_b, wall_b), prof_counts = warp_launches_by_mode(
        torch, lambda: run("run_b_resumed", run_b, LOOP_STEPS,
                           {"joint": resumed, "fwd": legs * resumed_points}))
    want_prof = {"joint": resumed, "fwd": legs * resumed_points}
    if prof_counts != want_prof:
        raise AssertionError(f"the profiler counted {prof_counts} NDiv "
                             f"kernels in the resumed run, want {want_prof}")
    values = check_states_bitwise(torch, state_a, state_b, "runs A and B")
    check_states_bitwise(torch, ckpt.restore_latest(
        run_a, loop.create_train_state(cfg)), state_b, "A's last checkpoint")
    clocks = ("wall_s", "steps_per_sec")
    rows_a, rows_b = _rows(run_a), _rows(run_b)

    def tail(rows):
        return [{k: v for k, v in r.items() if k not in clocks}
                for r in rows if r["step"] >= LOOP_RESUME_AT]

    if tail(rows_a) != tail(rows_b):
        raise AssertionError("run B's metric rows from the resume on differ "
                             "from run A's")
    for r in rows_a:
        bad = [k for k, v in r.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {bad} at step {r['step']}")
    best = {}
    for name, workdir in (("a", run_a), ("b", run_b)):
        with open(os.path.join(workdir, "best", "best_path.json"),
                  encoding="utf-8") as f:
            best[name] = json.load(f)
        if (best[name].get("eval_path") not in ("ema", "raw")
                or not math.isfinite(best[name]["value"])):
            raise AssertionError(f"run {name} best: {best[name]}")
    if best["a"] != best["b"]:
        raise AssertionError(f"best markers differ: {best}")

    # One eval point: both legs on run A's final state.
    def eval_point():
        return [host_floats(evaluate_fixed(cfg, state_a, cfg.eval_suite_scenes,
                                           use_ema=use_ema))
                for use_ema in (True, False)[:legs]]

    eval_point()  # the frozen suite is cached by the loop already
    reset(ndiv_cuda)
    eval_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        eval_point()
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    eval_launches = launched(ndiv_cuda)
    if eval_launches != {"fwd": 3 * legs}:
        raise AssertionError(f"3 eval points launched {eval_launches}")
    eval_prof = profile(torch, eval_point, 3)
    if eval_prof["ndiv_launches_per_call"] != legs:
        raise AssertionError(f"an eval point made "
                             f"{eval_prof['ndiv_launches_per_call']} NDiv "
                             f"launches, want {legs}")
    step_state = clone_state(torch, state_a)
    step_prof = profile(torch, lambda: loop.train_step_fused(cfg, step_state),
                        5)
    shutil.rmtree(tmp)
    return {
        "phase": "train_loop", "workdir_config": PLANNING512,
        "steps": LOOP_STEPS, "resumed_at": LOOP_RESUME_AT,
        "batch_size": cfg.batch_size, "k": cfg.k,
        "g_hidden": list(cfg.g_hidden), "d_hidden": list(cfg.d_hidden),
        "lr_schedule": cfg.lr_schedule, "recipe_steps": cfg.steps,
        **LOOP_EVERY, "eval_legs": legs,
        "launches": launches, "profiler_resumed_run": prof_counts,
        "bitwise_equal_values": values, "rows_equal_from_resume": True,
        "best": best["a"],
        "step_ms_median": statistics.median(clean_window_ms(rows_a, cfg)),
        "step_ms_windows": clean_window_ms(rows_a, cfg),
        "run_a_s": wall_a, "run_b_resumed_s_profiled": wall_b,
        "eval_point_ms_median": statistics.median(eval_ms),
        "eval_point_ms": eval_ms,
        "eval_point_profile": {k: v for k, v in eval_prof.items()
                               if k != "top_kernels"},
        "eval_point_top_kernels": eval_prof["top_kernels"],
        "step_profile": {k: v for k, v in step_prof.items()
                         if k != "top_kernels"},
        "eval_rows": [r for r in rows_a if r.get("kind") == "eval"],
        "last_train_row": [r for r in rows_a if "kind" not in r][-1]}, (
            launches)


def cli_train_eval(torch):
    """``cli train`` (goalcond, full width, 100 steps) and ``cli eval`` on
    its run, each in a subprocess on the card: final_step 100 and finite
    eval_* values."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    every = [f"--set={k}={CLI_EVERY}"
             for k in ("log_every", "eval_every", "checkpoint_every")]
    cmd = [sys.executable, "-m", "ndivplanning_tpu_torch.cli"]
    t0 = time.perf_counter()
    trained = subprocess.run(
        [*cmd, "train", "--preset", "goalcond", "--steps",
         str(CLI_TRAIN_STEPS), "--workdir", tmp, *every],
        capture_output=True, text=True, timeout=600, check=True)
    train_s = time.perf_counter() - t0
    final = json.loads(trained.stdout.strip().splitlines()[-1])
    if final["final_step"] != CLI_TRAIN_STEPS:
        raise AssertionError(f"cli train: {final}")
    t0 = time.perf_counter()
    evaluated = subprocess.run([*cmd, "eval", "--workdir", tmp],
                               capture_output=True, text=True, timeout=600,
                               check=True)
    eval_s = time.perf_counter() - t0
    ev = json.loads(evaluated.stdout.strip().splitlines()[-1])
    if not ev or not all(k.startswith("eval_") and math.isfinite(v)
                         for k, v in ev.items()):
        raise AssertionError(f"cli eval: {ev}")
    shutil.rmtree(tmp)
    return {"phase": "cli_train_eval", "preset": "goalcond",
            "steps": CLI_TRAIN_STEPS, "every": CLI_EVERY,
            "final": final, "eval": ev, "train_process_s": train_s,
            "eval_process_s": eval_s}


def eval_planning512_phase(torch, ndiv_cuda, cfg, state, cpu_state):
    """evaluate_fixed on the restored planning512 on the card and on the
    CPU over the same frozen suite and latents: rates within
    EVAL_RATE_SAMPLES samples, every other metric at EVAL_RTOL; the card's
    NDiv through ndiv_fwd once.  Then the one-shot planner ladder on the
    card.  Returns (phase, launches)."""
    from ndivplanning_tpu_torch.train.evaluate import (
        evaluate_fixed,
        evaluate_fixed_planner,
    )
    from ndivplanning_tpu_torch.utils.metrics import host_floats

    n = cfg.eval_suite_scenes * cfg.k
    evaluate_fixed(cfg, state)  # draws and caches the suite on the card
    reset(ndiv_cuda)
    t0 = time.perf_counter()
    card = host_floats(evaluate_fixed(cfg, state))
    card_ms = (time.perf_counter() - t0) * 1e3
    launches = launched(ndiv_cuda)
    if launches != {"fwd": 1}:
        raise AssertionError(f"the card's eval launched {launches}")
    t0 = time.perf_counter()
    cpu = host_floats(evaluate_fixed(cfg, cpu_state))
    cpu_ms = (time.perf_counter() - t0) * 1e3
    if card.keys() != cpu.keys():
        raise AssertionError(f"eval keys differ: {card.keys()} {cpu.keys()}")
    rel = {}
    for key, want in cpu.items():
        got = card[key]
        if key in EVAL_RATES:
            if abs(got - want) > EVAL_RATE_SAMPLES / n + 1e-9:
                raise AssertionError(f"{key}: card {got} vs cpu {want}")
        elif abs(got - want) > EVAL_RTOL * abs(want):
            raise AssertionError(f"{key}: card {got} vs cpu {want}")
        rel[key] = abs(got - want) / max(abs(want), 1e-30)
    t0 = time.perf_counter()
    planner = evaluate_fixed_planner(cfg, state, "oneshot")
    torch.cuda.synchronize()
    planner_s = time.perf_counter() - t0
    with open(os.path.join(PLANNING512, "best", "best_path.json"),
              encoding="utf-8") as f:
        recorded = json.load(f)
    return {"phase": "eval_planning512", "n_scenes": cfg.eval_suite_scenes,
            "samples": n, "card_metrics": card, "cpu_metrics": cpu,
            "rel_err": rel,
            "launches": launches, "card_eval_ms": card_ms,
            "cpu_eval_ms": cpu_ms, "planner_oneshot": planner,
            "planner_oneshot_s": planner_s,
            "card_success_rate": card["eval_success_rate"],
            "jax_recorded_success_rate": recorded["value"],
            "jax_recorded_note": "measured by the JAX package on its own "
                                 "frozen suite; for reference, not held"}, (
                launches)


def ulp_up(torch, t):
    """``t`` with every element one float32 ulp up."""
    return torch.nextafter(t, torch.full_like(t, math.inf))


def plan_tally(scores, best_reached, ref) -> dict:
    """How far candidate ``scores [B, N]``, and the reached flags of each
    scene's pick ``best_reached [B]``, lie from the CPU's plan ``ref``:
    candidates whose score is off SERVE_RTOL/ATOL, scenes whose best score
    is off, whose pick or its reached flag differs."""
    off = ((scores - ref.scores).abs()
           > SERVE_RTOL * ref.scores.abs() + SERVE_ATOL)
    best, pick = scores.min(dim=1)
    best_off = ((best - ref.best_score).abs()
                > SERVE_RTOL * ref.best_score.abs() + SERVE_ATOL)
    return {"candidates_off": int(off.sum()),
            "best_score_off": int(best_off.sum()),
            "picks_differ": int((pick != ref.scores.argmin(dim=1)).sum()),
            "reached_differ": int((best_reached != ref.best_reached).sum())}


def cpu_spread(cfg, scenes, taus, card_taus):
    """The CPU's rollouts of its own candidates ``taus`` moved as the card
    moves them: the card's G's candidates ``card_taus`` (another GEMM
    order), and every waypoint (or action) one ulp up (a rounding of the
    dynamics every step).  Returns (its rollout of ``taus``, the two
    moved ones)."""
    import torch

    from ndivplanning_tpu_torch.envs.registry import get_env
    from ndivplanning_tpu_torch.envs.rollout import score_candidates

    params = get_env(cfg.env).make_params()
    return [score_candidates(params, scenes, t, cfg.rollout_mode,
                             env=cfg.env)
            for t in (taus, card_taus, ulp_up(torch, taus))]


def family_plan_vs_cpu(torch, cfg, state, cpu_state, seed):
    """plan_batch on FAMILY_SCENES random scenes at the config's candidates
    on the card and on the CPU from one set of latents: G's candidates at
    rtol/atol 1e-5, and each count of disagreements within twice the sum
    of the CPU's own counts under the card's two kinds of move
    (``cpu_spread``), plus FAMILY_SLACK."""
    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.planning import server as srv
    from ndivplanning_tpu_torch.planning.planner import plan_batch

    requests = serve_requests(torch, FAMILY_SCENES, seed)
    scenes = Scene.stack([Scene.create(r["start"], r["goal"], r["obstacles"],
                                       device="cpu") for r in requests])
    conditions = srv._condition_for(cfg, scenes)
    z = torch.randn((FAMILY_SCENES, cfg.n_candidates, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(seed))
    card = plan_batch(cfg, state, srv._to_device(scenes, "cuda"),
                      conditions.cuda(), z=z.cuda())
    cpu = plan_batch(cfg, cpu_state, scenes, conditions, z=z)
    taus_err = assert_close(torch, card.taus.cpu(), cpu.taus,
                            f"{cfg.env} plan candidates", 1e-5, 1e-5)
    _, by_g, by_ulp = cpu_spread(cfg, scenes, cpu.taus, card.taus.cpu())
    got = plan_tally(card.scores.cpu(), card.best_reached.cpu(), cpu)
    own = {name: plan_tally(r.score, r.reached.gather(
        1, r.score.argmin(dim=1, keepdim=True))[:, 0], cpu)
           for name, r in (("card_g_candidates", by_g),
                           ("waypoints_ulp_up", by_ulp))}
    for key, n in got.items():
        allowed = 2 * sum(o[key] for o in own.values()) + FAMILY_SLACK[key]
        if n > allowed:
            raise AssertionError(f"{cfg.env} plan, card vs CPU: {key} {n}, "
                                 f"allowed {allowed} (the CPU's own {own})")
    if not (torch.isfinite(card.scores).all()
            and tuple(card.taus.shape[1:]) == (cfg.n_candidates, cfg.horizon,
                                               cfg.state_dim)):
        raise AssertionError(f"{cfg.env} plan: shapes or non-finite scores")
    return {"scenes": FAMILY_SCENES, "n_candidates": cfg.n_candidates,
            "candidates_err_over_max": taus_err, "card_vs_cpu": got,
            "cpu_vs_cpu_moved": own,
            "best_score_card_mean": float(card.best_score.mean()),
            "best_score_cpu_mean": float(cpu.best_score.mean()),
            "reached_share_card": float(card.best_reached.mean()),
            "reached_share_cpu": float(cpu.best_reached.mean())}


ROLLOUT_METRICS = {"eval_success_rate": "reached",
                   "eval_collision_rate": "collided",
                   "eval_mean_score": "score"}


def family_eval_vs_cpu(torch, ndiv_cuda, cfg, state, cpu_state,
                       ndiv_rtol=EVAL_RTOL):
    """evaluate_fixed on the recipe's frozen suite on the card (one
    ndiv_fwd) and on the CPU.  The rollout's metrics within twice the sum
    of the CPU's own moves under the card's two kinds of move
    (``cpu_spread``: a rate by its flipped samples, the mean score by its
    change), plus FAMILY_RATE_SAMPLES samples or EVAL_RTOL; the others at
    EVAL_RTOL (eval_ndiv at ``ndiv_rtol``).  Returns (the comparison,
    launches)."""
    from ndivplanning_tpu_torch.train.evaluate import (
        EVAL_SUITE_SEED,
        evaluate_fixed,
        make_eval_suite,
    )
    from ndivplanning_tpu_torch.train.state import gen_params
    from ndivplanning_tpu_torch.utils.metrics import host_floats

    n_scenes = cfg.eval_suite_scenes
    n = n_scenes * cfg.k
    evaluate_fixed(cfg, state, n_scenes)  # draws and caches the suite
    reset(ndiv_cuda)
    t0 = time.perf_counter()
    card = host_floats(evaluate_fixed(cfg, state, n_scenes))
    card_ms = (time.perf_counter() - t0) * 1e3
    launches = launched(ndiv_cuda)
    if launches != {"fwd": 1}:
        raise AssertionError(f"{cfg.env} eval launched {launches}")
    cpu = host_floats(evaluate_fixed(cfg, cpu_state, n_scenes))
    suite = make_eval_suite(cfg, n_scenes, device="cpu")
    z = torch.randn((n_scenes, cfg.k, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(
                        EVAL_SUITE_SEED + 1))
    with torch.no_grad():
        taus = gen_params(cfg, cpu_state)(suite.conditions, z)
        card_taus = gen_params(cfg, state)(suite.conditions.cuda(),
                                           z.cuda()).cpu()
    base, *moved = cpu_spread(cfg, suite.scenes, taus, card_taus)
    own = {}
    for key, field in ROLLOUT_METRICS.items():
        if field == "score":
            own[key] = sum(float((r.score.mean() - base.score.mean()).abs())
                           for r in moved)
        else:
            own[key] = sum(int((getattr(r, field) != getattr(base, field))
                               .sum()) for r in moved) / n
    for key, want in cpu.items():
        if key in EVAL_RATES:
            allowed = 2 * own[key] + FAMILY_RATE_SAMPLES / n
        elif key == "eval_ndiv":
            allowed = ndiv_rtol * abs(want)
        else:
            allowed = EVAL_RTOL * abs(want) + 2 * own.get(key, 0.0)
        if abs(card[key] - want) > allowed + 1e-9:
            raise AssertionError(f"{cfg.env} eval {key}: card {card[key]} vs "
                                 f"cpu {want}, allowed {allowed}")
    return {"n_scenes": n_scenes, "samples": n, "card_metrics": card,
            "cpu_metrics": cpu, "cpu_own_moves": own,
            "card_eval_ms": card_ms, "launches": launches}, launches


def replay_bitwise_on_card(torch):
    """Every family's distilled actions, replayed in "actions" mode on the
    card, give its waypoint rollout bitwise: 16 random scenes x 64 noisy
    straight paths."""
    from ndivplanning_tpu_torch.data.scenes import random_scene_batch
    from ndivplanning_tpu_torch.envs.registry import FAMILIES, get_env
    from ndivplanning_tpu_torch.envs.rollout import (
        distill_actions,
        score_candidates,
    )

    gen = torch.Generator(device="cuda").manual_seed(21)
    scenes = random_scene_batch(gen, FAMILY_SCENES)
    t = (torch.arange(32, device="cuda") + 1.0) / 32
    paths = (scenes.start[:, None, None, :] + t[None, None, :, None]
             * (scenes.goal - scenes.start)[:, None, None, :]
             + 0.03 * torch.randn((FAMILY_SCENES, 64, 32, 2), generator=gen,
                                  device="cuda"))
    out = {}
    for env in FAMILIES:
        params = get_env(env).make_params()
        actions = distill_actions(params, scenes, paths, env)
        a = score_candidates(params, scenes, paths, "waypoints", env=env)
        b = score_candidates(params, scenes, actions, "actions", env=env)
        for key in ("positions", "score", "collided", "reached"):
            if not torch.equal(getattr(a, key), getattr(b, key)):
                raise AssertionError(f"{env}: replayed actions' {key} differ "
                                     f"from the waypoint rollout's")
        out[env] = {"action_shape": list(actions.shape),
                    "reached_share": float(a.reached.mean())}
    return out


def family_plan_profile(torch, plan, cfg, state):
    """One scene at the config's candidates: the plan's wall ms (median of
    6, the first apart) and its profile (3 plans)."""
    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.planning.server import _condition_for

    scene = Scene.create([0.1, 0.1], [0.9, 0.9], [[0.5, 0.5, 0.1]],
                         device="cuda")
    condition = _condition_for(cfg, scene)
    _, plan_ms, gen = plan_times(torch, plan, cfg, state, scene, condition)
    prof = profile(torch, lambda: plan(cfg, state, scene, condition, gen), 3)
    if prof["ndiv_launches_per_call"]:
        raise AssertionError(f"{cfg.env} plan launched NDiv kernels")
    return {"plan_ms_median": statistics.median(plan_ms),
            "plan_ms_first": plan_ms[0],
            "profile_plan": {k: v for k, v in prof.items()
                             if k != "top_kernels"},
            "profile_plan_top_kernels": prof["top_kernels"][:3]}


def env_families_phase(torch, ndiv_cuda):
    """The vendored family models on the card: restore (bitwise the CPU's),
    plan_batch and the frozen suite against the CPU, one profiled plan;
    arm3 at random weights; every family's replay.  Returns (phase,
    launches by model)."""
    from ndivplanning_tpu_torch.planning.planner import plan
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.utils.config import get_config

    out, launches = {}, {}
    for i, (name, (env, step)) in enumerate(FAMILY_MODELS.items()):
        workdir = os.path.join("checkpoints_torch", name)
        cfg, state, cpu_state, restored = checkpoint_restore(torch, workdir,
                                                             step)
        if cfg.env != env:
            raise AssertionError(f"{name}: env {cfg.env}, want {env}")
        reset(ndiv_cuda)
        planned = family_plan_vs_cpu(torch, cfg, state, cpu_state, 30 + i)
        if launched(ndiv_cuda):
            raise AssertionError(f"{name} plan launched {launched(ndiv_cuda)}")
        evaluated, launches[name] = family_eval_vs_cpu(torch, ndiv_cuda, cfg,
                                                       state, cpu_state)
        with open(os.path.join(workdir, "best", "best_path.json"),
                  encoding="utf-8") as f:
            recorded = json.load(f)
        out[name] = {
            "env": env, "restore": {k: v for k, v in restored.items()
                                    if k != "phase"},
            "plan_vs_cpu": planned, "eval_vs_cpu": evaluated,
            "card_success_rate": evaluated["card_metrics"]["eval_success_rate"],
            "jax_recorded_success_rate": recorded["value"],
            "jax_recorded_note": "best-of-both on the JAX package's own "
                                 "suite; for reference, not held",
            **family_plan_profile(torch, plan, cfg, state)}
    acfg = get_config("goalcond", env="arm3")
    astate = create_train_state(acfg, seed=0)
    reset(ndiv_cuda)
    out["arm3_random_weights"] = {
        "plan_vs_cpu": family_plan_vs_cpu(
            torch, acfg, astate, create_train_state(acfg, seed=0,
                                                    device="cpu"), 40),
        **family_plan_profile(torch, plan, acfg, astate)}
    if launched(ndiv_cuda):
        raise AssertionError(f"arm3 plan launched {launched(ndiv_cuda)}")
    out["replay_bitwise"] = replay_bitwise_on_card(torch)
    return {"phase": "env_families", **out}, launches


def family_loop(torch, ndiv_cuda, cfg, steps, label):
    """``steps`` steps of the train loop from the config's seed in a fresh
    workdir, twice: unprofiled (the launch counts, ms a step from the log
    windows with no eval or checkpoint inside) and under the profiler (the
    NDiv kernels by mode); the two final states bitwise equal.  First the
    first step's NDiv inputs against the kernel's plain version."""
    from ndivplanning_tpu_torch.data.tasks import make_task
    from ndivplanning_tpu_torch.train import loop
    from ndivplanning_tpu_torch.train.evaluate import evaluate_fixed

    legs = 2 if cfg.g_ema_decay > 0 else 1
    points = steps // cfg.eval_every + (steps % cfg.eval_every > 0)
    want = {"joint": steps, "fwd": legs * points}
    start = loop.create_train_state(cfg)
    _, z0, x0 = first_step_inputs(torch, cfg, start, make_task)
    input_loss = check_step_inputs(torch, ndiv_cuda, z0, x0, label)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_family_")
    reset(ndiv_cuda)
    t0 = time.perf_counter()
    state, _ = loop.train(cfg, num_steps=steps,
                          workdir=os.path.join(tmp, "a"), echo=False)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = launched(ndiv_cuda)
    if launches != want:
        raise AssertionError(f"{label} loop: launches {launches}, want {want}")
    (again, _), prof_counts = warp_launches_by_mode(torch, lambda: loop.train(
        cfg, num_steps=steps, workdir=os.path.join(tmp, "b"), echo=False))
    if prof_counts != want:
        raise AssertionError(f"{label} loop: the profiler counted "
                             f"{prof_counts} NDiv kernels, want {want}")
    values = check_states_bitwise(torch, state, again, f"{label} loops")
    rows = _rows(os.path.join(tmp, "a"))
    for r in rows:
        bad = [k for k, v in r.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{label}: non-finite {bad} at {r['step']}")
    step_ms = clean_window_ms(rows, cfg)
    step_state = clone_state(torch, state)
    step_prof = profile(torch, lambda: loop.train_step_fused(cfg, step_state),
                        5)
    if step_prof["ndiv_launches_per_call"] != 1:
        raise AssertionError(f"{label}: {step_prof['ndiv_launches_per_call']}"
                             f" NDiv kernels a step")
    eval_prof = profile(torch, lambda: [
        evaluate_fixed(cfg, state, cfg.eval_suite_scenes, use_ema=use_ema)
        for use_ema in (True, False)[:legs]], 3)
    shutil.rmtree(tmp)
    return {
        "steps": steps, "env": cfg.env, "rollout_mode": cfg.rollout_mode,
        "state_dim": cfg.state_dim, "batch_size": cfg.batch_size, "k": cfg.k,
        "g_hidden": list(cfg.g_hidden), "d_hidden": list(cfg.d_hidden),
        "lr_schedule": cfg.lr_schedule, "recipe_steps": cfg.steps,
        "log_every": cfg.log_every, "eval_every": cfg.eval_every,
        "eval_suite_scenes": cfg.eval_suite_scenes, "eval_legs": legs,
        "launches": launches, "profiler_ndiv_by_mode": prof_counts,
        "first_g_ndiv_of_checked_inputs": input_loss,
        "profiled_run_bitwise_equal_values": values,
        "step_ms_median": statistics.median(step_ms),
        "step_ms_windows": step_ms, "run_s": wall_s,
        "step_profile": {k: v for k, v in step_prof.items()
                         if k != "top_kernels"},
        "eval_point_profile": {k: v for k, v in eval_prof.items()
                               if k != "top_kernels"},
        "eval_rows": [r for r in rows if r.get("kind") == "eval"],
        "last_train_row": [r for r in rows if "kind" not in r][-1]}, launches


def train_env_families_phase(torch, ndiv_cuda):
    """The unicycle150k recipe at full width (cosine LR over its 150000
    steps) 100 steps with one eval point, then arm3 in action mode at the
    same widths 20 steps with one.  Returns (phase, launches by run)."""
    from ndivplanning_tpu_torch.utils.config import load_config

    ucfg = load_config(os.path.join("checkpoints_torch", "unicycle150k"))
    if (ucfg.env, ucfg.batch_size, ucfg.k, ucfg.g_hidden, ucfg.lr_schedule,
            ucfg.steps) != ("unicycle", 256, 8, (256, 256), "cosine", 150000):
        raise AssertionError(f"unicycle150k recipe changed: {ucfg}")
    unicycle, ulaunch = family_loop(torch, ndiv_cuda, ucfg.replace(
        **FAMILY_LOOP_EVERY), FAMILY_LOOP_STEPS, "unicycle150k")
    acfg = ucfg.replace(**ARM3_ACTIONS, **ARM3_LOOP_EVERY)
    arm3_actions, alaunch = family_loop(torch, ndiv_cuda, acfg,
                                        ARM3_LOOP_STEPS, "arm3_actions")
    return {"phase": "train_env_families", "unicycle150k": unicycle,
            "arm3_actions": arm3_actions}, {"unicycle150k": ulaunch,
                                            "arm3_actions": alaunch}


def serve_families_phase(torch):
    """``cli serve --warmup`` on reacher150k over pipes answering a burst of
    4 requests, then ``cli eval --planner oneshot`` on quadrotor150k, each
    in a subprocess: exit codes 0 and every field of the answers."""
    cmd = [sys.executable, "-m", "ndivplanning_tpu_torch.cli"]
    reqs = serve_requests(torch, 4, 17)
    t0 = time.perf_counter()
    served = subprocess.run(
        [*cmd, "serve", "--workdir", SERVE_FAMILY, "--warmup"],
        input="".join(json.dumps(r) + "\n" for r in reqs) + "quit\n",
        capture_output=True, text=True, timeout=600)
    serve_s = time.perf_counter() - t0
    if served.returncode:
        raise AssertionError(f"cli serve exited {served.returncode}: "
                             f"{served.stderr[-2000:]}")
    lines = [json.loads(line) for line in served.stdout.splitlines()
             if line.strip()]
    answers, tail = lines[:len(reqs)], lines[len(reqs):]
    for r in answers:
        if (set(r) != {"best_traj", "best_score", "best_reached",
                       "diverse_trajs", "latency_ms", "batch_size"}
                or len(r["best_traj"]) != 32 or len(r["best_traj"][0]) != 2
                or not math.isfinite(r["best_score"])
                or r["best_reached"] not in (0.0, 1.0)
                or not r["diverse_trajs"]):
            raise AssertionError(f"cli serve answer: {str(r)[:300]}")
    if tail != [{"served": len(reqs)}]:
        raise AssertionError(f"cli serve: after the answers {tail}")
    t0 = time.perf_counter()
    evaluated = subprocess.run(
        [*cmd, "eval", "--workdir", CLI_EVAL_FAMILY, "--planner", "oneshot"],
        capture_output=True, text=True, timeout=600)
    eval_s = time.perf_counter() - t0
    if evaluated.returncode:
        raise AssertionError(f"cli eval exited {evaluated.returncode}: "
                             f"{evaluated.stderr[-2000:]}")
    ev = json.loads(evaluated.stdout.strip().splitlines()[-1])
    if (ev.get("eval_planner") != "oneshot"
            or ev.get("eval_plan_n_scenes") != 512.0
            or not 0.0 <= ev.get("eval_plan_reach_rate", -1.0) <= 1.0
            or not math.isfinite(ev.get("eval_plan_best_score", math.nan))):
        raise AssertionError(f"cli eval: {ev}")
    return {"phase": "serve_families", "serve_workdir": SERVE_FAMILY,
            "answers": [{k: r[k] for k in ("best_score", "best_reached",
                                           "latency_ms", "batch_size")}
                        for r in answers],
            "serve_process_s": serve_s, "eval_workdir": CLI_EVAL_FAMILY,
            "eval": ev, "eval_process_s": eval_s}


def outcome_differs(a, b) -> int:
    """Episodes whose (reached, collided) differ between two MPCResults."""
    return int(((a.reached != b.reached) | (a.collided != b.collided)).sum())


def mpc_dispatch_times(torch, cfg, state, suite, profiled):
    """mpc_rollout_batch at B = 1 and 128 of the suite's scenes: wall ms a
    dispatch (median of 3 after one warm call) and, at the B in
    ``profiled``, its profile (one dispatch: the profiler's bookkeeping of
    25k-50k launches takes seconds a call)."""
    from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch

    out = {}
    for b in MPC_DISPATCH_SCENES:
        gen = torch.Generator(device="cuda").manual_seed(b)
        part = suite.map(lambda t: t[:b])

        def dispatch():
            return mpc_rollout_batch(cfg, state, part.scenes, part.conditions,
                                     gen, **MPC_EPISODE).reached.cpu()

        dispatch()
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            dispatch()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[b] = {"ms_median": statistics.median(ms), "ms": ms}
        if b not in profiled:
            continue
        prof = profile(torch, dispatch, 1)
        if prof["ndiv_launches_per_call"]:
            raise AssertionError("an MPC dispatch launched NDiv kernels")
        out[b].update(profile={k: v for k, v in prof.items()
                               if k != "top_kernels"},
                      top_kernels=prof["top_kernels"][:3])
    return out


def mpc_phase(torch, ndiv_cuda):
    """Closed-loop MPC on the three family models: evaluate_fixed_mpc on the
    card over the 512-scene suite beside JAX's recorded success; the card
    against the CPU on the first MPC_CPU_SCENES scenes with the suite's
    own CPU-drawn latents, within twice the CPU's own outcome changes
    under a one-ulp move of its latents (at least 1); dispatch times,
    launches and busy share at B = 1 and 128."""
    from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch
    from ndivplanning_tpu_torch.train.evaluate import (
        EVAL_SUITE_SEED,
        EVAL_SUITE_SIZE,
        evaluate_fixed_mpc,
        make_eval_suite,
    )

    out = {}
    for name, (env, step) in FAMILY_MODELS.items():
        workdir = os.path.join("checkpoints_torch", name)
        cfg, state, cpu_state, _ = checkpoint_restore(torch, workdir, step)
        reset(ndiv_cuda)
        t0 = time.perf_counter()
        card_eval = evaluate_fixed_mpc(cfg, state, **MPC_EPISODE)
        eval_s = time.perf_counter() - t0
        if launched(ndiv_cuda):
            raise AssertionError(f"{name} MPC launched {launched(ndiv_cuda)}")
        # The suite's latents as evaluate_fixed_mpc draws them.
        z = torch.randn((EVAL_SUITE_SIZE, MPC_EPISODE["total_steps"]
                         // MPC_EPISODE["replan_every"],
                         MPC_EPISODE["n_candidates"], cfg.latent_dim),
                        generator=torch.Generator().manual_seed(
                            EVAL_SUITE_SEED + 2))[:MPC_CPU_SCENES]
        suite = make_eval_suite(cfg, device="cpu").map(
            lambda t: t[:MPC_CPU_SCENES])
        card_suite = suite.map(lambda t: t.cuda())
        card = mpc_rollout_batch(cfg, state, card_suite.scenes,
                                 card_suite.conditions, z=z.cuda(),
                                 **MPC_EPISODE)
        card = card._replace(reached=card.reached.cpu(),
                             collided=card.collided.cpu())
        t0 = time.perf_counter()
        cpu = mpc_rollout_batch(cfg, cpu_state, suite.scenes,
                                suite.conditions, z=z, **MPC_EPISODE)
        cpu_s = time.perf_counter() - t0
        moved = mpc_rollout_batch(cfg, cpu_state, suite.scenes,
                                  suite.conditions, z=ulp_up(torch, z),
                                  **MPC_EPISODE)
        own = outcome_differs(cpu, moved)
        got = outcome_differs(card, cpu)
        allowed = max(2 * own, 1)
        if got > allowed:
            raise AssertionError(f"{name} MPC, card vs CPU: {got} of "
                                 f"{MPC_CPU_SCENES} episodes differ, allowed "
                                 f"{allowed} (the CPU's own {own})")
        if not torch.isfinite(card.positions).all():
            raise AssertionError(f"{name} MPC: non-finite positions")
        times = mpc_dispatch_times(torch, cfg, state, card_suite,
                                   MPC_PROFILED.get(name, ()))
        out[name] = {
            "env": env, "card_eval": card_eval, "card_eval_s": eval_s,
            "jax_recorded_success_rate": MPC_JAX_RECORDED[name],
            "jax_recorded_note": "eval --mpc on the JAX package's own suite "
                                 "(checkpoints/README.md); not held",
            "cpu_scenes": MPC_CPU_SCENES,
            "episodes_differ_card_vs_cpu": got,
            "episodes_differ_cpu_ulp": own, "allowed": allowed,
            "success_card": float(card.reached.float().mean()),
            "success_cpu": float(cpu.reached.float().mean()),
            "collision_card": float(card.collided.float().mean()),
            "collision_cpu": float(cpu.collided.float().mean()),
            "cpu_run_s": cpu_s, "dispatch": times}
    return {"phase": "mpc", **MPC_EPISODE, **out}


def mpc_serve_phase(torch):
    """`cli serve --warmup-mpc` on quadrotor150k over pipes: single
    closed-loop round trips, a burst of 16 "mpc": true lines (one bucket-16
    dispatch), a mixed array of 4 closed-loop and 4 plain requests; the
    answers' fields, latency per bucket and the stats' mpc_requests.  An
    array is one protocol line, written when its last answer is ready, so
    its plain answers carry the episodes' latency."""
    from ndivplanning_tpu_torch.planning.client import PlanningClient

    reqs = serve_requests(torch, SERVE_SCENES, 19)
    mpc_keys = {"path", "reached", "collided", "n_replans", "latency_ms",
                "batch_size"}
    latency = {}
    t0 = time.perf_counter()
    with PlanningClient.spawn(["--workdir", MPC_SERVE_WORKDIR,
                               "--warmup-mpc"]) as c:
        before = c.stats()  # answered once the warm-up is done
        start_s = time.perf_counter() - t0
        singles = [c.mpc(**reqs[i]) for i in range(MPC_SERVE_REPEATS)]
        burst = c.send_lines([json.dumps(dict(r, mpc=True)) for r in reqs])
        mixed = c.plan_batch([dict(r, mpc=True) for r in reqs[:4]]
                             + reqs[4:8])
        after = c.stats()
        served = c.close()
    episodes = singles + burst + mixed[:4]
    for r in episodes:
        if (set(r) != mpc_keys or len(r["path"]) != 64
                or r["n_replans"] != 8 or r["reached"] not in (0.0, 1.0)
                or not all(math.isfinite(v) for p in r["path"] for v in p)):
            raise AssertionError(f"closed-loop answer: {str(r)[:300]}")
        latency.setdefault(f"mpc_{r['batch_size']}", []).append(
            r["latency_ms"])
    for r in mixed[4:]:
        if "best_traj" not in r or r["batch_size"] != 4:
            raise AssertionError(f"plain answer in a mixed array: "
                                 f"{str(r)[:300]}")
        latency.setdefault("plain_4_mixed", []).append(r["latency_ms"])
    if ([r["batch_size"] for r in burst] != [SERVE_SCENES] * SERVE_SCENES
            or [r["batch_size"] for r in singles] != [1] * MPC_SERVE_REPEATS):
        raise AssertionError("closed-loop buckets are off")
    n_mpc = MPC_SERVE_REPEATS + SERVE_SCENES + 4
    if after["mpc_requests"] - before["mpc_requests"] != n_mpc:
        raise AssertionError(f"stats mpc_requests {before} -> {after}, want "
                             f"+{n_mpc}")
    n_lines = MPC_SERVE_REPEATS + SERVE_SCENES + 3
    if served != [{"served": n_lines}]:
        raise AssertionError(f"served report {served}, want {n_lines}")
    return {"phase": "mpc_serve", "workdir": MPC_SERVE_WORKDIR,
            "transport": "pipes, PlanningClient.spawn, --warmup-mpc",
            "spawn_to_first_answer_s": start_s, "stats": after,
            "latency_ms_median_by_bucket": {
                k: statistics.median(v) for k, v in latency.items()},
            "latency_ms_by_bucket": latency,
            "reached_share": sum(r["reached"] for r in episodes)
            / len(episodes)}


def cem_phase(torch, ndiv_cuda):
    """plan_cem on unicycle150k at the default budget, the card against the
    CPU on the same CPU-drawn noise; its ms, launches and busy share; the
    planner ladder (cli eval --planner cem and oneshot) on 128 scenes."""
    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.planning.cem import cem_population, plan_cem
    from ndivplanning_tpu_torch.planning.server import _condition_for

    cfg, state, cpu_state, _ = checkpoint_restore(torch, CEM_WORKDIR,
                                                  FAMILY_MODELS[
                                                      "unicycle150k"][1])
    n, elite, iters = cem_population(cfg)
    scene = Scene.create([0.1, 0.1], [0.9, 0.9],
                         [[0.5, 0.5, 0.12], [0.3, 0.7, 0.08]], device="cpu")
    cond = _condition_for(cfg, scene)
    eps = torch.randn((iters + 1, n, cfg.latent_dim),
                      generator=torch.Generator().manual_seed(23))
    card_scene = scene.map(lambda t: t.cuda())
    reset(ndiv_cuda)
    card, card_curve = plan_cem(cfg, state, card_scene, cond.cuda(),
                                eps=eps.cuda())
    again, again_curve = plan_cem(cfg, state, card_scene, cond.cuda(),
                                  eps=eps.cuda())
    if launched(ndiv_cuda):
        raise AssertionError(f"CEM launched {launched(ndiv_cuda)}")
    if not (torch.equal(card.taus, again.taus)
            and torch.equal(card_curve, again_curve)):
        raise AssertionError("CEM on the card is not bitwise run to run")
    cpu, cpu_curve = plan_cem(cfg, cpu_state, scene, cond, eps=eps)
    moved, _ = plan_cem(cfg, cpu_state, scene, cond, eps=ulp_up(torch, eps))
    best, cpu_best = float(card.best_score), float(cpu.best_score)
    own = abs(float(moved.best_score) - cpu_best)
    allowed = 2 * own + SERVE_RTOL * abs(cpu_best) + SERVE_ATOL
    if abs(best - cpu_best) > allowed:
        raise AssertionError(f"CEM best score card {best} vs CPU {cpu_best}, "
                             f"allowed {allowed}")
    curve = card_curve.cpu()
    if not bool((curve[1:] <= curve[:-1]).all()) or best > float(curve[-1]):
        raise AssertionError(f"CEM best curve {curve.tolist()}, best {best}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    call = lambda: plan_cem(cfg, state, card_scene, cond.cuda(),
                            gen)[0].best_score.item()
    call()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile(torch, call, 3)
    ladder = {}
    for planner in ("cem", "oneshot"):
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "ndivplanning_tpu_torch.cli", "eval",
             "--workdir", CEM_WORKDIR, "--planner", planner, "--suite-size",
             str(CEM_LADDER_SCENES)], capture_output=True, text=True,
            timeout=600)
        if done.returncode:
            raise AssertionError(f"cli eval --planner {planner} exited "
                                 f"{done.returncode}: {done.stderr[-2000:]}")
        ladder[planner] = json.loads(done.stdout.strip().splitlines()[-1])
        ladder[planner]["process_s"] = time.perf_counter() - t0
        if (ladder[planner]["eval_planner"] != planner
                or ladder[planner]["eval_plan_n_scenes"] != CEM_LADDER_SCENES):
            raise AssertionError(f"cli eval --planner {planner}: "
                                 f"{ladder[planner]}")
    return {"phase": "cem", "workdir": CEM_WORKDIR, "population": n,
            "elite": elite, "iters": iters,
            "best_score_card": best, "best_score_cpu": cpu_best,
            "best_score_cpu_ulp_move": own, "allowed": allowed,
            "best_curve_card": curve.tolist(),
            "best_curve_cpu": cpu_curve.tolist(),
            "best_reached_card": float(card.best_reached),
            "repeat_bitwise": True, "plan_ms_median": statistics.median(ms),
            "plan_ms": ms,
            "profile": {k: v for k, v in prof.items() if k != "top_kernels"},
            "top_kernels": prof["top_kernels"][:3], "ladder": ladder}


def distilled_phase(torch, ndiv_cuda):
    """The three distilled models: the restore bitwise the CPU's, one-shot
    evaluate_fixed on the card over the 512-scene suite, and the recipe's
    128-scene suite on the card against the CPU (family_eval_vs_cpu).
    Returns (phase, launches by model)."""
    from ndivplanning_tpu_torch.train.evaluate import evaluate_fixed
    from ndivplanning_tpu_torch.utils.metrics import host_floats

    out, launches = {}, {}
    for name, (env, step) in DISTILLED_MODELS.items():
        workdir = os.path.join("checkpoints_torch", name)
        cfg, state, cpu_state, restored = checkpoint_restore(torch, workdir,
                                                             step)
        if cfg.env != env:
            raise AssertionError(f"{name}: env {cfg.env}, want {env}")
        evaluated, launches[name] = family_eval_vs_cpu(
            torch, ndiv_cuda, cfg, state, cpu_state, DISTILLED_NDIV_RTOL)
        reset(ndiv_cuda)
        suite512 = host_floats(evaluate_fixed(cfg, state))
        launches[name] = {k: v + launched(ndiv_cuda).get(k, 0)
                          for k, v in launches[name].items()}
        with open(os.path.join(workdir, "best", "best_path.json"),
                  encoding="utf-8") as f:
            recorded = json.load(f)
        out[name] = {"env": env, "step": step,
                     "restore_values": restored["values"],
                     "eval_vs_cpu_128": evaluated,
                     "card_success_rate_512": suite512["eval_success_rate"],
                     "card_metrics_512": suite512,
                     "jax_recorded_best_path": recorded}
    out["quadrotor_distilled_ilqr"]["jax_recorded_success"] = (
        DISTILLED_ILQR_JAX)
    return {"phase": "distilled", **out}, launches


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ndivplanning_tpu_torch.data.scenes import rasterize_scene
    from ndivplanning_tpu_torch.data.tasks import make_task
    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.ops import ndiv_cuda
    from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss
    from ndivplanning_tpu_torch.parallel import (
        make_mesh,
        make_sharded_train_step,
        shard_state,
    )
    from ndivplanning_tpu_torch.parallel import sharded_step as sharded
    from ndivplanning_tpu_torch.parallel.spawn import run_ranks
    from ndivplanning_tpu_torch.planning.planner import plan
    from ndivplanning_tpu_torch.train.state import (
        create_train_state,
        gen_params,
    )
    from ndivplanning_tpu_torch.train.step import (
        train_step_fused,
        train_step_impl,
    )
    from ndivplanning_tpu_torch.utils.config import get_config

    # 1. Device.
    smi = nvidia_smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. Build.
    t0 = time.perf_counter()
    _, log = ndiv_cuda.build()
    ndiv_cuda.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. Every kernel route against its plain version.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = {s: check_kernels(torch, ndiv_cuda, *s, gen)
              for s in CHECK_SHAPES}
    ones = torch.ones((4, 8, 2), device="cuda")
    same = check_inputs(torch, ndiv_cuda, ones, 0.5 * ones.new_ones(4, 8, 64),
                        "identical")
    if same["loss"] != 0.0:
        raise AssertionError("identical samples: loss is not 0")
    for key, n in ndiv_cuda.LAUNCHES.items():
        if not n:
            raise AssertionError(f"{key} kernel never launched")

    # 3b. One small train step per preset on the card against the CPU port
    # (plain NDiv).
    for preset, extra in (("goalcond", {}), ("imagecond", {"image_size": 16})):
        small = get_config(preset, batch_size=8, k=4, horizon=8,
                           g_hidden=(32, 32), d_hidden=(32, 32),
                           ndiv_impl="pallas", **extra)
        ref = {}
        for dev in ("cpu", "cuda"):
            st = create_train_state(small, seed=1, device=dev)
            batch = make_task(small).sample(torch.Generator().manual_seed(6),
                                            8)
            batch.conditions = batch.conditions.to(dev)
            batch.real_traj = batch.real_traj.to(dev)
            z = torch.randn((8, 4, 2),
                            generator=torch.Generator().manual_seed(7))
            _, m = train_step_impl(small, st, batch, z=z.to(dev))
            ref[dev] = {key: float(v) for key, v in m.items()}
        for key, want in ref["cpu"].items():
            # g_ndiv: Gram-form distances of the initial generator's near-
            # duplicate samples lose ~3 digits on any device (see the parity
            # tests), so it is held at 1e-2; every other metric at 1e-4.
            rtol = 1e-2 if key == "g_ndiv" else 1e-4
            if abs(ref["cuda"][key] - want) > rtol * abs(want) + 1e-6:
                raise AssertionError(f"{preset} train step {key}: cuda "
                                     f"{ref['cuda'][key]} vs cpu {want}")
        emit({"phase": "train_step_vs_cpu", "preset": preset,
              "cuda": ref["cuda"], "cpu": ref["cpu"]})

    # 4. Goalcond main path: train, plan, evaluate, each with the counts
    # set to 0 just before it and read just after.
    path_launches = {}
    cfg = get_config("goalcond")
    state = create_train_state(cfg, seed=0)
    _, z0, x0 = first_step_inputs(torch, cfg, state, make_task)
    goal_input_loss = check_step_inputs(torch, ndiv_cuda, z0, x0, "goalcond")
    state, history, step_ms, path_launches["goalcond_train"] = train(
        torch, ndiv_cuda, cfg, state, train_step_fused)
    check_first_step(history, goal_input_loss, "goalcond")
    first, last = history[0], history[-1]
    emit({"phase": "train", "preset": "goalcond", "steps": TRAIN_STEPS,
          "batch_size": cfg.batch_size, "k": cfg.k, "horizon": cfg.horizon,
          "g_hidden": list(cfg.g_hidden), "d_hidden": list(cfg.d_hidden),
          "launches": path_launches["goalcond_train"],
          "first_g_ndiv_of_checked_inputs": goal_input_loss,
          "first": {k: first[k] for k in ("d_loss", "g_adv", "g_ndiv")},
          "last": {k: last[k] for k in ("d_loss", "g_adv", "g_ndiv")},
          "step_ms_median": statistics.median(step_ms),
          "step_ms_first": step_ms[0]})

    scene = Scene.create([0.1, 0.1], [0.9, 0.9], [[0.5, 0.5, 0.1]])
    condition = torch.tensor([0.1, 0.1, 0.9, 0.9], device="cuda")
    reset(ndiv_cuda)
    result, plan_ms, plan_gen = plan_times(torch, plan, cfg, state, scene,
                                           condition)
    if launched(ndiv_cuda):
        raise AssertionError(f"the plan launched {launched(ndiv_cuda)}")
    emit({"phase": "plan", "preset": "goalcond", "n_candidates": 1000,
          **check_plan(torch, plan, create_train_state, cfg, state, result,
                       scene, condition),
          "plan_ms_median": statistics.median(plan_ms),
          "plan_ms_first": plan_ms[0]})

    reset(ndiv_cuda)
    with torch.no_grad():
        eval_gen = torch.Generator(device="cuda")
        eval_gen.manual_seed(123)
        batch = make_task(cfg).sample(eval_gen, cfg.batch_size)
        z = torch.randn((cfg.batch_size, cfg.k, cfg.latent_dim),
                        generator=eval_gen, device="cuda")
        tau = gen_params(cfg, state)(batch.conditions, z)
        eval_ndiv = float(ndiv_loss(z, tau.reshape(cfg.batch_size, cfg.k, -1),
                                    cfg.ndiv_alpha))
    path_launches["goalcond_eval"] = launched(ndiv_cuda)
    if path_launches["goalcond_eval"] != {"fwd": 1}:
        raise AssertionError(f"the no-grad NDiv evaluation launched "
                             f"{path_launches['goalcond_eval']}, want fwd")
    emit({"phase": "eval_ndiv_no_grad", "g_ndiv": eval_ndiv,
          "launches": path_launches["goalcond_eval"]})

    emit(warp_vs_tile_step(torch, ndiv_cuda,
                           lambda st: train_step_fused(cfg, st), state,
                           "goalcond", cfg)[0])

    # Where the time goes: device busy time of a few steps and plans.
    emit(profile_step(torch, lambda: train_step_fused(cfg, state),
                      "goalcond"))
    emit({"phase": "profile_plan", "preset": "goalcond",
          **profile(torch, lambda: plan(cfg, state, scene, condition,
                                        plan_gen), 3)})
    goal_times = {}
    for kernel in ("joint", "fwd"):
        fn = getattr(ndiv_cuda, f"ndiv_{kernel}")
        plain = getattr(ndiv_cuda, f"ndiv_{kernel}_plain")
        goal_times[f"ndiv_{kernel}"] = {
            "ms": device_ms(torch, functools.partial(fn, z0, x0, ALPHA), 200,
                            50_000_000),
            "plain_ms": device_ms(torch, functools.partial(plain, z0, x0,
                                                           ALPHA),
                                  8, 200_000_000),
            "bound_ms": bound(*GOALCOND_SHAPE, kernel)[0]}
    emit({"phase": "kernel_times_goalcond", "shape": list(GOALCOND_SHAPE),
          "kernels": goal_times, "card": smi})

    # 5. Imagecond main path: 20 steps through the default route.
    icfg = get_config("imagecond")
    istate = create_train_state(icfg, seed=0)
    _, iz0, ix0 = first_step_inputs(torch, icfg, istate, make_task)
    image_input_loss = check_step_inputs(torch, ndiv_cuda, iz0, ix0,
                                         "imagecond")
    istate, ihistory, istep_ms, path_launches["imagecond_train"] = train(
        torch, ndiv_cuda, icfg, istate, train_step_fused)
    check_first_step(ihistory, image_input_loss, "imagecond")
    first, last = ihistory[0], ihistory[-1]
    emit({"phase": "imagecond_train", "preset": "imagecond",
          "steps": TRAIN_STEPS, "batch_size": icfg.batch_size, "k": icfg.k,
          "horizon": icfg.horizon, "image_size": icfg.image_size,
          "encoder_features": list(icfg.encoder_features),
          "g_hidden": list(icfg.g_hidden), "d_hidden": list(icfg.d_hidden),
          "launches": path_launches["imagecond_train"],
          "first_g_ndiv_of_checked_inputs": image_input_loss,
          "first": {k: first[k] for k in ("d_loss", "g_adv", "g_ndiv")},
          "last": {k: last[k] for k in ("d_loss", "g_adv", "g_ndiv")},
          "step_ms_median": statistics.median(istep_ms),
          "step_ms_first": istep_ms[0]})

    # 6. One imagecond step from one state, batch and z under each other
    # NDiv route, against the default route's.
    route_gen = torch.Generator(device="cuda")
    route_gen.manual_seed(77)
    rbatch = make_task(icfg).sample(route_gen, icfg.batch_size)
    rz = torch.randn((icfg.batch_size, icfg.k, icfg.latent_dim),
                     generator=route_gen, device="cuda")
    ref_state, ref = train_step_impl(icfg, clone_state(torch, istate), rbatch,
                                     z=rz)
    # The default route twice: the step is bitwise repeatable.
    again_state, again = train_step_impl(icfg, clone_state(torch, istate),
                                         rbatch, z=rz)
    repeat_bitwise = all(torch.equal(again[key], v) for key, v in ref.items())
    repeat_bitwise &= all(
        torch.equal(p, q) for p, q in zip(ref_state.g.parameters(),
                                          again_state.g.parameters()))
    repeat_bitwise &= all(
        torch.equal(p, q) for p, q in zip(ref_state.d.parameters(),
                                          again_state.d.parameters()))
    if not repeat_bitwise:
        raise AssertionError("the imagecond step is not bitwise repeatable")
    routes_out, path_launches["imagecond_routes"] = [], {}
    for variant, joint, want, want_kernels in STEP_ROUTES:
        ndiv_cuda.VARIANT, ndiv_cuda.JOINT = variant, joint
        reset(ndiv_cuda)
        try:
            st, m = train_step_impl(icfg, clone_state(torch, istate), rbatch,
                                    z=rz)
            torch.cuda.synchronize()
            got = launched(ndiv_cuda)
            # The NDiv kernels of one such step under the profiler.
            prof = profile(torch, lambda: train_step_impl(
                icfg, clone_state(torch, istate), rbatch, z=rz), 1)
        finally:
            ndiv_cuda.VARIANT, ndiv_cuda.JOINT = "block", True
        if got != want:
            raise AssertionError(f"route {variant}/joint={joint}: launches "
                                 f"{got}, want {want}")
        if prof["ndiv_launches_per_call"] != want_kernels:
            raise AssertionError(f"route {variant}/joint={joint}: "
                                 f"{prof['ndiv_launches_per_call']} NDiv "
                                 f"kernels a step, want {want_kernels}")
        for key, n in got.items():
            path_launches["imagecond_routes"][key] = (
                path_launches["imagecond_routes"].get(key, 0) + n)
        ndiv_rel = assert_close(torch, m["g_ndiv"], ref["g_ndiv"],
                                f"route {variant} g_ndiv", VAL_RTOL)
        grad_rel = max(
            assert_close(torch, st.g_opt.mu[name], mu,
                         f"route {variant} G grad {name}", GRAD_RTOL,
                         GRAD_ATOL_OF_MAX)
            for name, mu in ref_state.g_opt.mu.items())
        routes_out.append({
            "variant": variant, "joint": joint, "launches": got,
            "profiler_ndiv_launches_per_step": prof["ndiv_launches_per_call"],
            "profiler_ndiv_kernels_ms_per_step":
                prof["ndiv_kernels_ms_per_call"],
            "g_ndiv": float(m["g_ndiv"]), "g_ndiv_err_over_ref": ndiv_rel,
            "g_grads_err_over_max": grad_rel,
            "g_grads_bitwise_equal": all(
                torch.equal(st.g_opt.mu[name], mu)
                for name, mu in ref_state.g_opt.mu.items())})
    emit({"phase": "imagecond_routes", "ref_g_ndiv": float(ref["g_ndiv"]),
          "default_route_repeats_bitwise": repeat_bitwise,
          "routes": routes_out})

    # 6b. The slice's own path: one full-width imagecond step at k=64 under
    # the packed route (ndiv_fwd + ndiv_bwd on the warp kernel at kp = 64),
    # against the same step on the tile kernel: params bitwise equal.
    k64cfg = get_config("imagecond", k=64)
    k64state = create_train_state(k64cfg, seed=0)
    phase, path_launches["imagecond_k64_packed"] = warp_vs_tile_step(
        torch, ndiv_cuda, lambda st: train_step_fused(k64cfg, st), k64state,
        "imagecond_k64", k64cfg, "packed", ("fwd", "bwd"))
    if path_launches["imagecond_k64_packed"] != {"fwd_packed": 1,
                                                  "bwd_packed": 1}:
        raise AssertionError(f"imagecond k=64 packed step: launches "
                             f"{path_launches['imagecond_k64_packed']}")
    ndiv_cuda.VARIANT = "packed"
    try:
        prof = profile(torch, lambda: train_step_fused(
            k64cfg, clone_state(torch, k64state)), 1)
    finally:
        ndiv_cuda.VARIANT = "block"
    if prof["ndiv_launches_per_call"] != 2:
        raise AssertionError(f"imagecond k=64 packed step: "
                             f"{prof['ndiv_launches_per_call']} NDiv kernels")
    emit({**phase, "batch_size": k64cfg.batch_size,
          "profiler_ndiv_launches_per_step": prof["ndiv_launches_per_call"],
          "profiler_ndiv_kernels_ms_per_step":
              prof["ndiv_kernels_ms_per_call"],
          "profiler_wall_ms_per_step": prof["wall_ms_per_call"]})

    # 7. Image-conditioned planning on a rasterised scene.
    iscene = Scene.create([0.1, 0.1], [0.9, 0.9],
                          [[0.5, 0.5, 0.12], [0.35, 0.65, 0.08],
                           [0.65, 0.35, 0.1]])
    image = rasterize_scene(iscene, icfg.image_size)
    reset(ndiv_cuda)
    iresult, iplan_ms, iplan_gen = plan_times(torch, plan, icfg, istate,
                                              iscene, image)
    if launched(ndiv_cuda):
        raise AssertionError(f"the plan launched {launched(ndiv_cuda)}")
    emit({"phase": "imagecond_plan", "preset": "imagecond",
          "n_candidates": 1000, "image_shape": list(image.shape),
          **check_plan(torch, plan, create_train_state, icfg, istate,
                       iresult, iscene, image),
          "plan_ms_median": statistics.median(iplan_ms),
          "plan_ms_first": iplan_ms[0]})
    emit(warp_vs_tile_step(torch, ndiv_cuda,
                           lambda st: train_step_fused(icfg, st), istate,
                           "imagecond", icfg)[0])
    emit(profile_step(torch, lambda: train_step_fused(icfg, istate),
                      "imagecond"))
    emit({"phase": "profile_imagecond_plan", "preset": "imagecond",
          **profile(torch, lambda: plan(icfg, istate, iscene, image,
                                        iplan_gen), 3)})

    # 8. The pod_dp path.  First the sharded call site's per-rank function
    # for virtual ranks, against the unsharded kernel.
    for (dp, div), (b, k, dz, dx) in VIRTUAL_RANKS:
        z, x = away_from_kinks(torch, lambda n: (
            spread_latents(torch, n, k, dz, gen),
            torch.randn((n, k, dx), generator=gen, device="cuda")), b)
        emit({"phase": "sharded_ndiv_ranks",
              **check_virtual_ranks(torch, ndiv_cuda, sharded, z, x, dp,
                                    div)})

    # 8b. pod_dp at full width through make_sharded_train_step on a 1x1
    # mesh of one NCCL rank (the one cut: 8 chips to 1).
    tmpdir = tempfile.mkdtemp(prefix="chip_smoke_")
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(tmpdir, "store"), 1),
        rank=0, world_size=1)
    pcfg = get_config("pod_dp", dp_shards=1, div_shards=1)
    mesh = make_mesh(cfg=pcfg)
    pstep, _ = make_sharded_train_step(pcfg, mesh)
    pstate = shard_state(create_train_state(pcfg, seed=0), mesh)
    start_state = clone_state(torch, pstate)
    pstate, phistory, pstep_ms, path_launches["pod_dp_train"] = train(
        torch, ndiv_cuda, pcfg, pstate, lambda c, s: pstep(s),
        steps=POD_DP_STEPS)
    # The same first step twice from clones of the start: bitwise equal.
    # Then once without a mesh: the only difference is the NDiv partial's
    # rescale by m_local / m.
    s1, m1 = pstep(clone_state(torch, start_state))
    s2, m2 = pstep(clone_state(torch, start_state))
    repeat_bitwise = all(torch.equal(m1[key], m2[key]) for key in m1)
    repeat_bitwise &= all(
        torch.equal(p, q) for p, q in zip(
            [*s1.g.parameters(), *s1.d.parameters()],
            [*s2.g.parameters(), *s2.d.parameters()]))
    if not repeat_bitwise:
        raise AssertionError("the sharded pod_dp step is not bitwise "
                             "repeatable")
    _, m3 = train_step_fused(pcfg, clone_state(torch, start_state))
    unsharded_rel = {key: abs(float(m3[key]) - float(m1[key][0]))
                     / abs(float(m1[key][0])) for key in m3}
    if max(unsharded_rel.values()) > 1e-5:
        raise AssertionError(f"pod_dp: the step without a mesh is "
                             f"{unsharded_rel} relative off the sharded one")
    first, last = phistory[0], phistory[-1]
    emit({"phase": "pod_dp_train", "preset": "pod_dp",
          "steps": POD_DP_STEPS, "mesh": mesh.shape,
          "backend": dist.get_backend(), "batch_size": pcfg.batch_size,
          "k": pcfg.k, "horizon": pcfg.horizon,
          "g_hidden": list(pcfg.g_hidden), "d_hidden": list(pcfg.d_hidden),
          "cond_embed_dim": pcfg.cond_embed_dim,
          "compute_dtype": pcfg.compute_dtype,
          "launches": path_launches["pod_dp_train"],
          "first": {k: first[k] for k in ("d_loss", "g_adv", "g_ndiv")},
          "last": {k: last[k] for k in ("d_loss", "g_adv", "g_ndiv")},
          "step_ms_median": statistics.median(pstep_ms),
          "step_ms_first": pstep_ms[0],
          "repeat_bitwise": repeat_bitwise,
          "unsharded_step_rel_err": unsharded_rel})
    path_launches["pod_dp_routes"], routes_phase = pod_dp_routes(
        torch, ndiv_cuda, mesh)
    emit(routes_phase)

    # 8c. Two ranks on the card (gloo) against the 1x1 run, f32 and bf16.
    runs = [(dtype, dp, div) for dtype in ("f32", "bf16")
            for dp, div in TWO_RANK_MESHES]
    refs = {dtype: pod_dp_run(dtype, 1, 1, TWO_RANK_STEPS, mesh)
            for dtype in ("f32", "bf16")}
    t0 = time.perf_counter()
    ranks = run_ranks(two_rank_worker, 2, tmpdir, runs, cuda_device=0,
                      timeout=600)
    two_rank_s = time.perf_counter() - t0
    compared = []
    for run in runs:
        for rank, out in enumerate(ranks):
            compared.append({
                "dtype": run[0], "mesh": list(run[1:]), "rank": rank,
                **compare_runs(refs[run[0]], out[run], run[0], pcfg.g_lr,
                               TWO_RANK_STEPS,
                               f"{run[0]} {run[1]}x{run[2]} rank {rank}")})
    emit({"phase": "pod_dp_two_ranks", "backend": "gloo",
          "steps": TWO_RANK_STEPS, "seconds": two_rank_s,
          "runs": compared})
    emit(warp_vs_tile_step(torch, ndiv_cuda, pstep, pstate, "pod_dp",
                           pcfg)[0])
    emit(profile_step(torch, lambda: pstep(pstate), "pod_dp"))

    # 8d. The sharded call site and ndiv_joint at pod_dp's per-rank shape,
    # on inputs away from the hinge's kinks: the call site (loss and both
    # grads) against its plain version, the "jnp" row-block strategy.
    b, k, dz, dx = POD_DP_SHAPE
    zp, xp = away_from_kinks(torch, lambda n: (
        spread_latents(torch, n, k, dz, gen),
        torch.randn((n, k, dx), generator=gen, device="cuda")), b)

    def call_site(impl):
        zr, xr = zp.clone().requires_grad_(), xp.clone().requires_grad_()

        def fn():
            loss = sharded.ndiv_loss_sharded(zr, xr, ALPHA, mesh, impl)
            return (loss, *torch.autograd.grad(loss, (zr, xr)))
        return fn

    # ndiv_joint, ndiv_fwd and ndiv_bwd there (the warp kernel) against the
    # tile kernel (grads bitwise equal, totals within TILE_TOTAL_RTOL; bwd
    # at g = 1 and G_CHECK), then against their plain versions.
    pod_tile_rel = {
        f"{kernel}_g{g_val}" if g_val else kernel: warp_against_tile(
            torch, ndiv_cuda, kernel, zp, xp, g_val, "pod_dp shape")
        for kernel, g_val in (("joint", None), ("fwd", None), ("bwd", 1.0),
                              ("bwd", G_CHECK))}
    m_pod = b * k * (k - 1)
    warp = ndiv_cuda.ndiv_joint(zp, xp, ALPHA)
    pod_plain = ndiv_cuda.ndiv_joint_plain(zp, xp, ALPHA)
    for name, g, w, rtol, atol in zip(
            ("loss", "dz", "dx"), warp, pod_plain,
            (VAL_RTOL, GRAD_RTOL, GRAD_RTOL),
            (0.0, GRAD_ATOL_OF_MAX, GRAD_ATOL_OF_MAX)):
        assert_close(torch, g, w, f"pod_dp shape ndiv_joint {name}", rtol,
                     atol)
    pod_joint_err = max(max_err(warp[0] / m_pod, pod_plain[0] / m_pod),
                        max_err(warp[1], pod_plain[1]),
                        max_err(warp[2], pod_plain[2]))
    fwd_block = ndiv_cuda.ndiv_fwd(zp, xp, ALPHA)
    fwd_plain = ndiv_cuda.ndiv_fwd_plain(zp, xp, ALPHA)
    # The warp kernel's totals do not depend on its grid: 7 blocks walking
    # the conditions give the resident grid's bits.
    for kernel, want_total in (("fwd", fwd_block), ("joint", warp[0])):
        out = ndiv_cuda._launch(kernel, "block", zp, xp, ALPHA, blocks=7)
        if not torch.equal(out[0] if kernel == "joint" else out, want_total):
            raise AssertionError(f"pod_dp shape: the {kernel} total on 7 "
                                 f"blocks differs from the resident grid's")
    assert_close(torch, fwd_block, fwd_plain, "pod_dp shape ndiv_fwd",
                 VAL_RTOL)
    pod_err = {"fwd": max_err(fwd_block / m_pod, fwd_plain / m_pod),
               "bwd": 0.0}
    for g_val in (1.0, G_CHECK):
        g_pod = torch.tensor(g_val, device="cuda")
        bwd_block = ndiv_cuda.ndiv_bwd(zp, xp, ALPHA, g_pod)
        for name, got_g, want_g in zip(
                ("dz", "dx"), bwd_block,
                ndiv_cuda.ndiv_bwd_plain(zp, xp, ALPHA, g_pod)):
            assert_close(torch, got_g, want_g,
                         f"pod_dp shape ndiv_bwd {name} at g={g_val}",
                         GRAD_RTOL, GRAD_ATOL_OF_MAX)
            pod_err["bwd"] = max(pod_err["bwd"], max_err(got_g, want_g))
    site, site_plain = call_site("pallas"), call_site("jnp")
    got, want = site(), site_plain()
    site_err = 0.0
    for name, g, w, rtol, atol in zip(
            ("loss", "dz", "dx"), got, want, (VAL_RTOL, GRAD_RTOL, GRAD_RTOL),
            (0.0, GRAD_ATOL_OF_MAX, GRAD_ATOL_OF_MAX)):
        assert_close(torch, g, w, f"sharded call site {name}", rtol, atol)
        site_err = max(site_err, max_err(g, w))
    # The call site's host work (autograd, the pad, a one-rank all-reduce)
    # outlasts its device work now: few calls behind a long sleep, so the
    # queue holds them all and the events see device time.
    pod_times = {
        "site_ms": device_ms(torch, site, 20, 400_000_000),
        "site_plain_ms": device_ms(torch, site_plain, 4, 200_000_000),
        "joint_ms": device_ms(torch, functools.partial(
            ndiv_cuda.ndiv_joint, zp, xp, ALPHA), 100, 50_000_000),
        "joint_plain_ms": device_ms(torch, functools.partial(
            ndiv_cuda.ndiv_joint_plain, zp, xp, ALPHA), 4, 200_000_000)}
    g_one = torch.ones((), device="cuda")
    for kernel in ("fwd", "bwd"):
        args = (zp, xp, ALPHA) + ((g_one,) if kernel == "bwd" else ())
        pod_times[f"{kernel}_ms"] = device_ms(torch, functools.partial(
            getattr(ndiv_cuda, f"ndiv_{kernel}"), *args), 100, 50_000_000)
        pod_times[f"{kernel}_plain_ms"] = device_ms(
            torch, functools.partial(
                getattr(ndiv_cuda, f"ndiv_{kernel}_plain"), *args), 4,
            200_000_000)
    emit({"phase": "kernel_times_pod_dp", "shape": list(POD_DP_SHAPE),
          "kernels": {kern: ndiv_cuda.serving_kernel(kern, k, dz, dx)
                      for kern in ("joint", "fwd", "bwd")},
          "grads_bitwise_equal_tile": True,
          "total_rel_err_tile": pod_tile_rel,
          "joint_max_abs_err": pod_joint_err,
          "fwd_max_abs_err": pod_err["fwd"], "bwd_max_abs_err": pod_err["bwd"],
          "site_max_abs_err": site_err, **pod_times, "card": smi})
    dist.destroy_process_group()
    shutil.rmtree(tmpdir)

    # 8e. fwd and bwd at k=64 (the warp kernel at kp = 64) and the joint
    # there (the tile kernel) at imagecond's widths, on inputs away from the
    # hinge's kinks: times of the kernel, of the tile kernel and of the
    # plain version beside the bound, and the 7-block check (kernel_check
    # above held both shapes against the plain version and the tile kernel).
    k64 = {}
    for shape in K64_SHAPES:
        b64, k_64, dz64, dx64 = shape
        z64, x64 = away_from_kinks(torch, lambda n: (
            spread_latents(torch, n, k_64, dz64, gen),
            torch.randn((n, k_64, dx64), generator=gen, device="cuda")), b64)
        calls = 100 if b64 <= 512 else 10  # calls per window
        for kernel in ("fwd", "bwd", "joint"):
            g64 = g_one if kernel == "bwd" else None
            args = (z64, x64, ALPHA) + ((g_one,) if kernel == "bwd" else ())
            call = functools.partial(getattr(ndiv_cuda, f"ndiv_{kernel}"),
                                     *args)
            row = {"kernel": ndiv_cuda.serving_kernel(kernel, *shape[1:]),
                   "ms": device_ms(torch, call, calls, 50_000_000),
                   "plain_ms": device_ms(torch, functools.partial(
                       getattr(ndiv_cuda, f"ndiv_{kernel}_plain"), *args), 2,
                       200_000_000)}
            row["bound_ms"], row["bound_by"] = bound(*shape, kernel)
            if row["kernel"] == "warp":
                row["tile_ms"] = device_ms(torch, functools.partial(
                    ndiv_cuda._launch, kernel, "block", z64, x64, ALPHA, g64,
                    impl="tile"), max(2, calls // 10), 50_000_000)
                # The results do not depend on the grid at kp = 64 either.
                seven = ndiv_cuda._launch(kernel, "block", z64, x64, ALPHA,
                                          g64, blocks=7)
                full = call()
                if not all(torch.equal(a, c) for a, c in zip(
                        seven if kernel == "bwd" else (seven,),
                        full if kernel == "bwd" else (full,))):
                    raise AssertionError(f"{shape} {kernel}: 7 blocks give "
                                         f"other bits than the resident grid")
                row["grid_7_blocks_bitwise_equal"] = True
            k64[shape, kernel] = row
        emit({"phase": "kernel_times_k64", "shape": list(shape),
              "kernels": {kern: k64[shape, kern]
                          for kern in ("fwd", "bwd", "joint")},
              "card": smi})

    # 8f. The train loop and its eval on the planning512 recipe at full
    # width, the CLI's train and eval, and the frozen suite on the restored
    # planning512 model on the card against the CPU.
    phase, loop_launches = train_loop_phase(torch, ndiv_cuda)
    emit({**phase, "card": smi})
    for run, launches in loop_launches.items():
        path_launches[f"train_loop_{run}"] = launches
    emit({**cli_train_eval(torch), "card": smi})
    p512_cfg, p512_state, p512_cpu_state, p512_phase = checkpoint_restore(
        torch, PLANNING512, PLANNING512_STEP)
    phase, path_launches["eval_planning512"] = eval_planning512_phase(
        torch, ndiv_cuda, p512_cfg, p512_state, p512_cpu_state)
    emit({**phase, "card": smi})

    # 8g. The env families: the vendored models planned and evaluated on
    # the card against the CPU, arm3, the replays, then the two loops.
    phase, launches = env_families_phase(torch, ndiv_cuda)
    emit({**phase, "card": smi})
    for name, n in launches.items():
        path_launches[f"eval_{name}"] = n
    phase, launches = train_env_families_phase(torch, ndiv_cuda)
    emit({**phase, "card": smi})
    for name, n in launches.items():
        path_launches[f"train_loop_{name}"] = n

    # 8h. Closed-loop MPC and CEM on the family models (no NDiv kernel on
    # either path), MPC serving, and the distilled models' frozen suites.
    emit({**mpc_phase(torch, ndiv_cuda), "card": smi})
    emit({**mpc_serve_phase(torch), "card": smi})
    emit({**cem_phase(torch, ndiv_cuda), "card": smi})
    phase, launches = distilled_phase(torch, ndiv_cuda)
    emit({**phase, "card": smi})
    for name, n in launches.items():
        path_launches[f"eval_{name}"] = n

    # 9. Kernel times on the first imagecond step's inputs, every route,
    # beside the tile kernel's (one tiling, the same in every layout).
    totals = {}
    for launches in path_launches.values():
        for key, n in launches.items():
            totals[key] = totals.get(key, 0) + n
    g = torch.ones((), device="cuda")
    kernels = []
    for kernel, variant in ROUTES:
        key = ndiv_cuda.launch_key(kernel, variant)
        plain_args = (iz0, ix0, ALPHA) + ((g,) if kernel == "bwd" else ())
        plain = functools.partial(getattr(ndiv_cuda, f"ndiv_{kernel}_plain"),
                                  *plain_args)
        ms = device_ms(torch, functools.partial(run_route, ndiv_cuda, kernel,
                                                variant, iz0, ix0, g),
                       200, 50_000_000)
        tile_ms = device_ms(torch, functools.partial(
            ndiv_cuda._launch, kernel, variant, iz0, ix0, ALPHA,
            g if kernel == "bwd" else None, impl="tile"), 100, 50_000_000)
        # Few calls: the plain version issues ~60 launches per call, and
        # the queue must not fill while the sleep kernel holds the card.
        plain_ms = device_ms(torch, plain, 8, 200_000_000)
        bound_ms, bound_by = bound(*IMAGECOND_SHAPE, kernel)
        kernels.append({
            "name": f"ndiv_{key}", "route": "cuda", "variant": variant,
            "kernel": ndiv_cuda.serving_kernel(kernel, *IMAGECOND_SHAPE[1:]),
            "source": "ndivplanning_tpu_torch/csrc/ndiv.cu",
            "replaces": "ndivplanning_tpu/ops/ndiv_pallas.py:"
                        f"{REPLACES[(kernel, variant)]}",
            "launches": totals.get(key, 0),
            "launches_by_path": {p: n[key] for p, n in path_launches.items()
                                 if key in n},
            "max_abs_err": checks[IMAGECOND_SHAPE]["max_abs_err"][key],
            "ms": ms, "tile_ms": tile_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": list(IMAGECOND_SHAPE), "card": smi})
        if variant == "block":
            # The block rows at pod_dp's per-rank shape too.
            kernels[-1].update(
                kernel_pod_dp=ndiv_cuda.serving_kernel(kernel,
                                                       *POD_DP_SHAPE[1:]),
                max_abs_err_pod_dp=(pod_joint_err if kernel == "joint"
                                    else pod_err[kernel]),
                ms_pod_dp=pod_times[f"{kernel}_ms"],
                plain_ms_pod_dp=pod_times[f"{kernel}_plain_ms"],
                bound_ms_pod_dp=bound(*POD_DP_SHAPE, kernel)[0],
                shape_pod_dp=list(POD_DP_SHAPE))
    # The packed fwd and bwd at k=64: the warp kernel at kp = 64, as the
    # slice's k=64 imagecond step launched it; 512 and 8192 conditions.
    for kernel in ("fwd", "bwd"):
        key = ndiv_cuda.launch_key(kernel, "packed")
        small, large = (k64[shape, kernel] for shape in K64_SHAPES)
        kernels.append({
            "name": f"ndiv_{key}_k64", "route": "cuda", "variant": "packed",
            "kernel": small["kernel"],
            "source": "ndivplanning_tpu_torch/csrc/ndiv.cu",
            "replaces": "ndivplanning_tpu/ops/ndiv_pallas.py:"
                        f"{REPLACES[(kernel, 'packed')]}",
            "launches": path_launches["imagecond_k64_packed"][key],
            "launches_by_path": {"imagecond_k64_packed":
                                 path_launches["imagecond_k64_packed"][key]},
            "max_abs_err": checks[K64_SHAPES[0]]["max_abs_err"][key],
            "ms": small["ms"], "tile_ms": small["tile_ms"],
            "plain_ms": small["plain_ms"], "bound_ms": small["bound_ms"],
            "bound_by": small["bound_by"], "library_ms": None,
            "shape": list(K64_SHAPES[0]), "card": smi,
            "max_abs_err_8192": checks[K64_SHAPES[1]]["max_abs_err"][key],
            "ms_8192": large["ms"], "tile_ms_8192": large["tile_ms"],
            "plain_ms_8192": large["plain_ms"],
            "bound_ms_8192": large["bound_ms"],
            "bound_by_8192": large["bound_by"],
            "shape_8192": list(K64_SHAPES[1])})
    # The sharded call site on the 1x1 mesh: a call site over ndiv_joint,
    # with no kernel of its own: the joint kernel, a sum over the world and
    # the division by the global pair count.  Its launches are the joint
    # kernel's on the pod_dp path.  At div > 1 its least time adds the
    # all-gather of z and x (k/div of them per rank, the rest received); at
    # div = 1 nothing is gathered.
    site_bound, site_by = bound(*POD_DP_SHAPE, "joint")
    kernels.append({
        "name": "ndiv_sharded_call_site", "route": "cuda",
        "call_site_over": "ndiv_joint",
        "source": "ndivplanning_tpu_torch/parallel/sharded_step.py "
                  "(kernel: ndivplanning_tpu_torch/csrc/ndiv.cu)",
        "replaces": "ndivplanning_tpu/parallel/sharded_step.py:187",
        "launches": path_launches["pod_dp_train"]["joint"],
        "launches_by_path": {
            "pod_dp_train": path_launches["pod_dp_train"]["joint"]},
        "max_abs_err": site_err, "ms": pod_times["site_ms"],
        "plain_ms": pod_times["site_plain_ms"], "bound_ms": site_bound,
        "bound_by": site_by, "allgather_bytes": 0, "library_ms": None,
        "mesh": mesh.shape, "shape": list(POD_DP_SHAPE), "card": smi})
    for row in kernels:
        if not row["launches"]:
            raise AssertionError(f"{row['name']} never ran on a main path")
    emit({"phase": "no_joint_packed", "note": "the JAX package has no "
          "joint kernel under 'packed' (_vjp_fwd sends packed to fwd + "
          "bwd), so neither has the port"})
    # 10. The serving path on planning512: no NDiv kernel runs on it.
    emit({**p512_phase, "card": smi})
    reset(ndiv_cuda)
    emit({**serve_vs_cpu(torch, ndiv_cuda, p512_cfg, p512_state,
                         p512_cpu_state), "card": smi})
    emit({**serve_planning512(torch), "card": smi})
    emit({**profile_serve(torch, ndiv_cuda, p512_cfg, p512_state),
          "card": smi})
    emit({**serve_families_phase(torch), "card": smi})
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
