"""Command line of the torch port; counterpart of ``ndivplanning_tpu/cli.py``.

    python -m ndivplanning_tpu_torch.cli train --preset goalcond --workdir runs/goalcond
    python -m ndivplanning_tpu_torch.cli eval  --workdir runs/goalcond
    python -m ndivplanning_tpu_torch.cli plan  --workdir checkpoints_torch/planning512
    python -m ndivplanning_tpu_torch.cli serve --workdir checkpoints_torch/planning512 --warmup
    python -m ndivplanning_tpu_torch.cli serve --workdir runs/goalcond --tcp 7421 --cross-batch --watch-best
    python -m ndivplanning_tpu_torch.cli eval  --workdir checkpoints_torch/quadrotor150k --mpc
    python -m ndivplanning_tpu_torch.cli plan  --workdir checkpoints_torch/unicycle150k --refine cem
    python -m ndivplanning_tpu_torch.cli plan  --workdir checkpoints_torch/quadrotor_distilled_ilqr --refine ilqr
    python -m ndivplanning_tpu_torch.cli plan  --workdir checkpoints_torch/planning512 --sharded
    torchrun --nproc-per-node 2 -m ndivplanning_tpu_torch.cli plan --workdir checkpoints_torch/unicycle150k --sharded --refine trajopt --dp-shards 2
    python -m ndivplanning_tpu_torch.cli record-data --preset planning --out runs/p512.npz
    python -m ndivplanning_tpu_torch.cli train --workdir runs/p512 --dataset runs/p512.npz --epochs 30
    torchrun --standalone --nproc-per-node 2 -m ndivplanning_tpu_torch.cli train --preset pod_dp --dp-shards 2 --workdir runs/pod2
    torchrun --standalone --nproc-per-node 2 -m ndivplanning_tpu_torch.cli train --preset planning --workdir runs/p512x2 --dataset runs/p512.npz --epochs 30 --dp-shards 2
    python -m ndivplanning_tpu_torch.cli distill --workdir checkpoints_torch/quadrotor150k --planner mpc
    python -m ndivplanning_tpu_torch.cli train --preset goalcond --profile-dir runs/prof --debug-nans
    python -m ndivplanning_tpu_torch.cli viz --workdir checkpoints_torch/planning512 --out plan.png
    python -m ndivplanning_tpu_torch.cli curves --workdir runs/goalcond --out curves.png
    python -m ndivplanning_tpu_torch.cli export --workdir checkpoints_torch/planning512 --out bundle/
    python -m ndivplanning_tpu_torch.cli doctor

Every command runs on the CUDA card unless ``--device cpu`` is given.  A
``--workdir`` holding a recorded ``config.json`` is the base config; eval,
plan, serve, viz and export prefer its ``best/`` checkpoint.
``--profile-dir`` traces any of them with ``torch.profiler``.  ``plan
--sharded`` splits one scene's candidates over a process group's ranks
(``parallel/sharded_plan.py``): the group that exists, one that
``torchrun`` describes, or one rank of its own.  ``train`` (and ``train
--dataset``) under ``torchrun``, or inside a group that exists, trains on
the ``--dp-shards`` x ``--div-shards`` mesh of its ranks, which must fill
the world (NCCL where each rank has a card, gloo where ranks share one or
run on the CPU); rank 0 alone writes the workdir and prints the JSON
line.  A plain ``train`` opens no group: one process over the global
batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import typing

import torch

from ndivplanning_tpu_torch.utils.device import resolve_device


def _add_common(p: argparse.ArgumentParser) -> None:
    # --preset defaults in _build_config: a --workdir's recorded
    # config.json is the base when no --preset is given, else pointmass2d.
    p.add_argument("--preset", default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--k", type=int, default=None)
    p.add_argument("--ndiv-impl", default=None, choices=["auto", "pallas", "jnp"])
    p.add_argument("--gan-loss", default=None, choices=["bce", "lsgan", "hinge"])
    p.add_argument("--dp-shards", type=int, default=None)
    p.add_argument("--div-shards", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (Chrome/Perfetto "
                        "JSON) of the command into this directory")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError on the first non-finite "
                        "value: anomaly mode in the backward, a check of "
                        "every step's, plan's and eval leg's tensors")
    p.add_argument("--set", action="append", default=[], dest="set_overrides",
                   metavar="FIELD=VALUE",
                   help="generic Config field override, typed from the "
                        "dataclass (e.g. --set g_hidden=512,512)")


def _parse_field_value(field: str, raw: str):
    """Convert a --set VALUE string per the Config dataclass field type."""
    from ndivplanning_tpu_torch.utils.config import Config

    types = typing.get_type_hints(Config)
    if field not in types:
        raise SystemExit(
            f"--set: unknown config field {field!r}; "
            f"choose from {sorted(f.name for f in dataclasses.fields(Config))}")
    t = types[field]
    try:
        if t is bool:
            if raw.lower() in ("1", "true", "yes"):
                return True
            if raw.lower() in ("0", "false", "no"):
                return False
            raise ValueError(raw)
        if t is int:
            return int(raw)
        if t is float:
            return float(raw)
        if typing.get_origin(t) is tuple:
            elem = typing.get_args(t)[0]
            return tuple(elem(v) for v in raw.split(",") if v != "")
        return raw  # str fields
    except ValueError:
        raise SystemExit(
            f"--set: cannot parse {raw!r} as {t} for field {field!r}"
        ) from None


def _build_config(args):
    from ndivplanning_tpu_torch.utils.config import get_config, load_config

    overrides = {}
    for field in ("seed", "steps", "batch_size", "k", "ndiv_impl", "gan_loss",
                  "workdir", "dp_shards", "div_shards"):
        v = getattr(args, field)
        if v is not None:
            overrides[field] = v
    for kv in args.set_overrides:
        field, sep, raw = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects FIELD=VALUE, got {kv!r}")
        overrides[field] = _parse_field_value(field, raw)
    # A workdir's recorded config is the base (the exact models that made
    # its checkpoints), flags on top; a --preset naming another preset
    # opts out.
    recorded = load_config(args.workdir) if args.workdir else None
    if recorded is not None and (args.preset is None
                                 or args.preset == recorded.name):
        return recorded.replace(**overrides)
    return get_config(args.preset or "pointmass2d", **overrides)


def _load_state(cfg, device, prefer_best: bool = True):
    """A fresh state, replaced by the workdir's checkpoint when it has one.

    Planning and serving prefer ``<workdir>/best`` (the best-by-eval
    checkpoint) over the newest one: GAN quality oscillates."""
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.utils import checkpoint as ckpt

    state = create_train_state(cfg, device=device)
    if prefer_best and cfg.workdir:
        best = ckpt.restore_latest(os.path.join(cfg.workdir, "best"), state)
        if best is not None:
            return best
    restored = ckpt.restore_latest(cfg.workdir, state)
    if restored is None:
        # stderr: stdout carries the JSON protocol.
        print(f"[warning] no checkpoint found in workdir {cfg.workdir!r}: "
              "using UNTRAINED weights. Train first, or use the shipped "
              "pretrained model: --workdir checkpoints_torch/planning512 "
              "(see checkpoints_torch/README.md).", file=sys.stderr)
        return state
    return restored


def _maybe_profiled(args, fn):
    """Run ``fn`` under a ``torch.profiler`` trace when ``--profile-dir``
    is set (every command but doctor and curves).  A profiler that fails
    raises: the command exits non-zero instead of running untraced."""
    if not args.profile_dir:
        return fn()
    from ndivplanning_tpu_torch.utils.profiling import trace

    with trace(args.profile_dir):
        return fn()


def _plan_mpc(cfg, state, device, args) -> dict:
    """``plan --mpc``: ``--mpc-episodes`` random scenes (from ``seed + 3``)
    as closed-loop episodes in one batch, latents from ``seed + 5``;
    twice, the second call timed for ``episodes_per_sec``."""
    import time

    from ndivplanning_tpu_torch.data.scenes import random_scene_batch
    from ndivplanning_tpu_torch.planning.mpc import mpc_rollout_batch
    from ndivplanning_tpu_torch.planning.server import _condition_for

    n_ep = args.mpc_episodes
    scenes = random_scene_batch(
        torch.Generator(device=device).manual_seed(cfg.seed + 3), n_ep)
    conditions = _condition_for(cfg, scenes)

    def episodes():
        return mpc_rollout_batch(
            cfg, state, scenes, conditions,
            torch.Generator(device=device).manual_seed(cfg.seed + 5),
            total_steps=args.mpc_steps, replan_every=args.mpc_replan,
            n_candidates=args.mpc_candidates)

    t0 = time.perf_counter()
    result = episodes()
    reached, collided = result.reached.cpu(), result.collided.cpu()
    first_call_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    episodes().reached.cpu()
    episodes_per_sec = n_ep / max(time.perf_counter() - t0, 1e-9)
    out = {
        "episodes": n_ep,
        "success_rate": float(reached.mean()),
        "collision_rate": float(collided.mean()),
        "n_replans": result.n_replans,
        "total_steps": args.mpc_steps,
        "replan_every": args.mpc_replan,
        "episodes_per_sec": round(episodes_per_sec, 2),
        "first_call_s": round(first_call_s, 2),
    }
    if n_ep == 1:
        out["final_pos"] = result.positions[0, -1].tolist()
    return out


def _process_group(device: torch.device):
    """The default process group of ``plan --sharded`` and of ``train``
    under ``torchrun``: the caller's if it exists; one through ``env://``
    under ``torchrun`` (``WORLD_SIZE`` set), NCCL where each rank has a
    card of its own, gloo where ranks share one or the tensors are on the
    CPU; else (``plan --sharded`` alone) one rank through a ``FileStore``
    in a temp dir.  Returns ``(device, end)``: under ``torchrun`` a CUDA
    ``device`` becomes the rank's card (``LOCAL_RANK`` modulo the cards),
    made current, so that the state, the scene and the generator are built
    there; ``end`` ends a group made here."""
    import shutil
    import tempfile

    import torch.distributed as dist

    if dist.is_initialized():
        return device, lambda: None
    cuda = device.type == "cuda"
    if "WORLD_SIZE" in os.environ:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                      os.environ["WORLD_SIZE"]))
        own_card = cuda and per_host <= torch.cuda.device_count()
        if cuda:
            device = torch.device("cuda", local % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if own_card else "gloo",
                                init_method="env://")
        return device, dist.destroy_process_group
    tmp = tempfile.mkdtemp(prefix="ndiv_plan_")
    dist.init_process_group("nccl" if cuda else "gloo",
                            store=dist.FileStore(os.path.join(tmp, "store"),
                                                 1), rank=0, world_size=1)

    def end():
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return device, end


def _plan_sharded(cfg, state, scene, condition, generator, refine: str):
    """``plan --sharded`` inside the process group of ``_process_group``:
    the candidate-sharded planner of ``refine`` on the ``make_mesh(cfg=cfg)``
    mesh, from rank 0's ``state``; ``(result, curve or None, rank,
    "<dp>x<div>")``."""
    import torch.distributed as dist

    from ndivplanning_tpu_torch.parallel import (
        make_mesh,
        shard_state,
        sharded_plan as sp,
    )

    mesh = make_mesh(cfg=cfg)
    fn, _ = sp.BY_REFINE[refine](cfg, mesh)
    out = fn(shard_state(state, mesh), scene, condition, generator)
    result, curve = (out, None) if refine == "none" else out
    return result, curve, dist.get_rank(), f"{mesh.dp}x{mesh.div}"


def _parser() -> argparse.ArgumentParser:
    from ndivplanning_tpu_torch.train.distill import TEACHERS
    from ndivplanning_tpu_torch.train.evaluate import PLANNERS

    parser = argparse.ArgumentParser(prog="ndivplanning_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    doc = sub.add_parser(
        "doctor",
        help="environment diagnosis: versions, nvcc, the NDiv kernels' "
             "library, the native host plane, and a timeout-bounded probe "
             "of the card in a subprocess (never hangs)")
    doc.add_argument("--no-probe", action="store_true",
                     help="skip the subprocess probe (host introspection "
                          "only)")
    doc.add_argument("--probe-timeout", type=float, default=120.0,
                     help="seconds before the probe is declared hung")
    doc.add_argument("--probe-cpu", action="store_true",
                     help="probe the CPU instead of the CUDA card")
    cur = sub.add_parser(
        "curves",
        help="render a two-panel PNG training report (losses + "
             "frozen-suite eval curves) from a run's metrics.jsonl")
    cur.add_argument("--workdir", required=True,
                     help="run directory containing metrics.jsonl")
    cur.add_argument("--out", default="curves.png", help="output PNG path")
    names = ("train", "eval", "plan", "serve", "record-data", "distill",
             "viz", "export")
    for name in names:
        _add_common(sub.add_parser(name))
    (train_p, eval_p, plan_p, serve_p, record_p, distill_p, viz_p,
     export_p) = (sub.choices[name] for name in names)
    viz_p.add_argument("--out", default="plan.png", help="output PNG path")
    viz_p.add_argument("--mpc", action="store_true",
                       help="render one closed-loop MPC episode (executed "
                            "path colored by time, replan points marked) "
                            "instead of open-loop candidates")
    viz_p.add_argument("--mpc-steps", type=int, default=64)
    viz_p.add_argument("--mpc-replan", type=int, default=8)
    viz_p.add_argument("--mpc-candidates", type=int, default=256)
    export_p.add_argument("--out", required=True,
                          help="output directory of the torch.export "
                               "deployment bundle (.pt2 programs and "
                               "manifest.json)")
    export_p.add_argument("--n-candidates", type=int, default=None)
    export_p.add_argument("--n-diverse", type=int, default=8)
    train_p.add_argument("--dataset", default=None,
                         help="train from a recorded .npz dataset "
                              "(record-data) instead of the on-device task "
                              "sampler")
    train_p.add_argument("--epochs", type=int, default=1,
                         help="epochs over --dataset")
    train_p.add_argument("--eval-fraction", type=float, default=0.1,
                         help="held-out fraction of --dataset evaluated "
                              "against its true scenes (0 disables)")
    record_p.add_argument("--out", required=True, help="output .npz path")
    record_p.add_argument("--n-examples", type=int, default=4096)
    record_p.add_argument("--from-planner", default=None, choices=TEACHERS,
                          help="record planner-made expert trajectories "
                               "(re-verified open-loop against their true "
                               "scenes) instead of the task sampler's "
                               "experts: expert iteration's data")
    record_p.add_argument("--per-scene", type=int, default=1,
                          help="independent planner draws per scene "
                               "(--from-planner)")
    distill_p.add_argument("--rounds", type=int, default=1,
                           help="expert-iteration rounds (record -> "
                                "fine-tune -> frozen-suite eval; a round is "
                                "kept only if the tracked metric improves)")
    distill_p.add_argument("--scenes-per-round", type=int, default=2048)
    distill_p.add_argument("--per-scene", type=int, default=1,
                           help="independent planner draws per scene")
    distill_p.add_argument("--planner", default="mpc", choices=TEACHERS)
    distill_p.add_argument("--track", default=None,
                           help="the metric a round is accepted on (default: "
                                "the config's track_best_metric or "
                                "eval_success_rate); 'eval_plan_best_score' "
                                "adjudicates on the one-shot planner ladder "
                                "(lower is better)")
    distill_p.add_argument("--epochs", type=int, default=None,
                           help="fine-tune epochs per round (default: ~5000 "
                                "optimizer steps)")
    distill_p.add_argument("--suite-size", type=int, default=512,
                           help="frozen-suite scenes of the before/after "
                                "measurement")
    distill_p.add_argument("--mpc-replan", type=int, default=8)
    distill_p.add_argument("--mpc-candidates", type=int, default=256)
    distill_p.add_argument("--distill-workdir", default=None,
                           help="where the rounds' datasets and checkpoints "
                                "go (default <workdir>/distill)")
    distill_p.add_argument("--min-diversity-frac", type=float, default=0.5,
                           help="reject a round whose frozen-suite mean "
                                "pairwise distance falls below this fraction "
                                "of the pre-iteration value (0 disables)")
    eval_p.add_argument("--sampled", action="store_true",
                        help="sample a fresh eval batch instead of the "
                             "frozen suite")
    eval_p.add_argument("--suite-size", type=int, default=512)
    eval_p.add_argument("--planner", default=None, choices=PLANNERS,
                        help="open-loop planner quality on the frozen "
                             "suite: mean best score (lower is better) and "
                             "reach rate")
    eval_p.add_argument("--scene-chunk", type=int, default=None,
                        help="scenes per dispatch for --planner "
                             "(default 128 oneshot, 16 the refiners)")
    eval_p.add_argument("--dataset", default=None,
                        help="evaluate on a recorded .npz dataset's first "
                             "--suite-size rows against their true scenes")
    eval_p.add_argument("--mpc", action="store_true",
                        help="closed-loop quality: every frozen-suite scene "
                             "as a receding-horizon MPC episode (fixed "
                             "latents, comparable run to run)")
    for p in (eval_p, plan_p):
        p.add_argument("--mpc-steps", type=int, default=64,
                       help="closed-loop episode length")
        p.add_argument("--mpc-replan", type=int, default=8,
                       help="control steps executed per replanning cycle "
                            "(must divide --mpc-steps)")
        p.add_argument("--mpc-candidates", type=int, default=256,
                       help="candidate trajectories per replan")
    for p in (plan_p, serve_p):
        p.add_argument("--refine", default="none",
                       choices=("none", "cem", "grad", "trajopt", "ilqr",
                                "cem+trajopt"),
                       help="refinement: 'cem' runs cross-entropy-method "
                            "iterations in G's latent space at the one-shot "
                            "planner's rollout budget; 'grad' runs Adam on "
                            "the latents through G and the env on a soft "
                            "cost; 'trajopt' runs Adam on the trajectories "
                            "from G's warm starts; 'ilqr' runs iLQR on "
                            "action sequences from G's warm starts; "
                            "'cem+trajopt' seeds trajopt from CEM's best")
    plan_p.add_argument("--mpc", action="store_true",
                        help="closed-loop receding-horizon planning: replan "
                             "every --mpc-replan steps from the live state")
    plan_p.add_argument("--mpc-episodes", type=int, default=1,
                        help="episodes to run, as one batch")
    plan_p.add_argument("--sharded", action="store_true",
                        help="split the scene's candidates over the ranks "
                             "of the process group (torchrun's, or one rank "
                             "of its own) on a --dp-shards x --div-shards "
                             "mesh; the unsharded plan's result "
                             "(parallel/sharded_plan.py)")
    serve_p.add_argument("--warmup", action="store_true",
                         help="run one dispatch of every request bucket "
                              "before reading stdin")
    serve_p.add_argument("--no-overlap", action="store_true",
                         help="write responses synchronously instead of "
                              "on a writer thread")
    serve_p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                         help="serve the JSON-lines protocol over TCP on "
                              "this port (0 = ephemeral) instead of "
                              "stdin/stdout; every connection shares the "
                              "loaded model")
    serve_p.add_argument("--host", default="127.0.0.1",
                         help="bind address for --tcp")
    serve_p.add_argument("--max-pending", type=int, default=0, metavar="N",
                         help="with --cross-batch: admission control, "
                              "refuse new requests with {'error': "
                              "'overloaded', 'retry_ms': ...} once N "
                              "requests are queued or in flight "
                              "(0 = unbounded, the default)")
    serve_p.add_argument("--deadline-ms", type=float, default=0.0,
                         help="with --cross-batch: drop admitted requests "
                              "that queued longer than this before dispatch "
                              "({'error': 'deadline_exceeded'}); bounds "
                              "served tail latency under overload "
                              "(0 = no deadline)")
    serve_p.add_argument("--cross-batch", action="store_true",
                         help="with --tcp: coalesce requests ACROSS "
                              "connections into shared dispatches (N "
                              "concurrent single-request clients cost ~1 "
                              "dispatch instead of N); latent draws are "
                              "then the dispatcher's rather than "
                              "per-connection")
    serve_p.add_argument("--watch-best", action="store_true",
                         help="auto-reload: watch <workdir>/best and "
                              "hot-swap the served weights whenever a "
                              "training run writes a new best checkpoint "
                              "(swaps counted as 'auto_reloads' in the "
                              "stats line)")
    serve_p.add_argument("--watch-poll", type=float, default=2.0,
                         help="--watch-best poll interval in seconds")
    serve_p.add_argument("--warmup-mpc", action="store_true",
                         help="also dispatch a closed-loop batch of every "
                              "bucket before reading stdin (implies "
                              "--warmup)")
    return parser


def _curves(args) -> int:
    from ndivplanning_tpu_torch.utils.viz import plot_run_curves

    metrics_path = os.path.join(args.workdir, "metrics.jsonl")
    if not os.path.exists(metrics_path):
        print(f"error: no metrics.jsonl in {args.workdir!r} (pass a train "
              "run's --workdir)", file=sys.stderr)
        return 2
    with open(metrics_path, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    _, n_train, n_eval = plot_run_curves(
        rows, path=args.out,
        title=os.path.basename(os.path.normpath(args.workdir)))
    print(json.dumps({"out": args.out, "train_rows": n_train,
                      "eval_rows": n_eval}))
    return 0


def _viz(cfg, device, args) -> dict:
    """``viz``: the diverse top-8 of a plan of one random scene (scene from
    ``seed + 3``, latents from ``seed + 4``), or with ``--mpc`` one
    closed-loop episode of it."""
    from ndivplanning_tpu_torch.data.scenes import random_scene
    from ndivplanning_tpu_torch.planning.server import _condition_for
    from ndivplanning_tpu_torch.utils import viz

    state = _load_state(cfg, device)
    scene = random_scene(
        torch.Generator(device=device).manual_seed(cfg.seed + 3))
    condition = _condition_for(cfg, scene)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 4)
    if args.mpc:
        from ndivplanning_tpu_torch.planning.mpc import mpc_rollout

        r = mpc_rollout(cfg, state, scene, condition, generator,
                        total_steps=args.mpc_steps,
                        replan_every=args.mpc_replan,
                        n_candidates=args.mpc_candidates)
        viz.plot_mpc_episode(scene, r.positions, reached=r.reached,
                             collided=r.collided,
                             replan_every=args.mpc_replan, path=args.out,
                             title=f"{cfg.name}: MPC {args.mpc_steps} steps, "
                                   f"{r.n_replans} replans")
        return {"out": args.out, "reached": float(r.reached),
                "collided": float(r.collided), "n_replans": r.n_replans}
    from ndivplanning_tpu_torch.planning.planner import plan

    result = plan(cfg, state, scene, condition, generator, n_diverse=8)
    viz.plot_trajectories(
        scene, result.taus[result.diverse_idx],
        result.scores[result.diverse_idx], path=args.out,
        title=f"{cfg.name}: diverse top-8 of {result.scores.shape[0]} "
              "candidates", highlight=result.best_traj)
    return {"out": args.out, "best_score": float(result.best_score)}


def main(argv=None) -> int:
    parser = _parser()
    args, extra = parser.parse_known_args(argv)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "doctor":
        from ndivplanning_tpu_torch.utils.doctor import doctor_report

        report = doctor_report(
            probe=not args.no_probe, probe_timeout_s=args.probe_timeout,
            probe_platform="cpu" if args.probe_cpu else None)
        print(json.dumps(report, indent=1))
        # 0 when healthy (or the probe skipped); 3 = the card is unhealthy,
        # apart from 2 = bad usage.
        return 0 if report.get("healthy", True) else 3
    if args.cmd == "curves":
        return _curves(args)
    cfg = _build_config(args)
    device = resolve_device(args.device)
    if args.debug_nans:
        from ndivplanning_tpu_torch.utils.profiling import (
            enable_nan_debugging,
        )

        enable_nan_debugging(True)
    return _maybe_profiled(args, lambda: _run(args, cfg, device))


def _plan(args, cfg, device) -> int:
    """``plan``: one scene from ``cfg.seed``, planned on ``device``."""
    from ndivplanning_tpu_torch.data.scenes import random_scene
    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.planning.planner import PlanResult, plan
    from ndivplanning_tpu_torch.planning.refine import plan_refined_batch
    from ndivplanning_tpu_torch.planning.server import _condition_for

    state = _load_state(cfg, device)
    scene = random_scene(
        torch.Generator(device=device).manual_seed(cfg.seed + 3))
    condition = _condition_for(cfg, scene)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 4)
    out = {}
    curve = None
    if args.sharded:
        result, curve, rank, out["mesh"] = _plan_sharded(
            cfg, state, scene, condition, generator, args.refine)
        if rank:  # one answer, from rank 0
            return 0
    elif args.refine != "none":
        result, curve = plan_refined_batch(
            cfg, state, Scene.stack([scene]), condition[None],
            args.refine, generator=generator)
        result, curve = PlanResult(*(f[0] for f in result)), curve[0]
    else:
        result = plan(cfg, state, scene, condition, generator)
    if curve is not None:
        key = "best_curve" if args.refine == "cem" else "soft_loss_curve"
        out[key] = curve.tolist()
    print(json.dumps({
        "best_score": float(result.best_score),
        "best_reached": float(result.best_reached),
        "n_candidates": int(result.scores.shape[0]),
        **out,
    }))
    return 0


def _train(args, cfg, device) -> int:
    """``train``, on the sampler or a recorded ``--dataset``; under a
    process group on its mesh (``train/loop.py``), rank 0 printing the one
    JSON line, with the mesh and the backend."""
    import torch.distributed as dist

    from ndivplanning_tpu_torch.train.loop import train, train_from_dataset

    if args.dataset:
        from ndivplanning_tpu_torch.data.host_pipeline import (
            ArrayDataset,
            train_eval_split,
        )

        ds = ArrayDataset.from_npz(args.dataset)
        eval_ds = None
        if args.eval_fraction > 0:
            ds, eval_ds = train_eval_split(ds, args.eval_fraction,
                                           seed=cfg.seed)
        state, last = train_from_dataset(
            cfg, ds, num_epochs=args.epochs, workdir=cfg.workdir, echo=True,
            eval_dataset=eval_ds, device=device)
    else:
        state, history = train(cfg, device=device)
        last = history[-1] if history else None
    out = {"final_step": int(state.step), "last": last}
    if dist.is_initialized():
        if dist.get_rank():
            return 0
        out.update(mesh=f"{cfg.dp_shards}x{cfg.div_shards}",
                   backend=str(dist.get_backend()),
                   world=dist.get_world_size())
    print(json.dumps(out))
    return 0


def _run(args, cfg, device) -> int:
    """The commands that build a config and run on ``device``."""
    if args.cmd == "viz":
        print(json.dumps(_viz(cfg, device, args)))
        return 0

    if args.cmd == "export":
        from ndivplanning_tpu_torch.utils.export import export_bundle

        manifest = export_bundle(cfg, _load_state(cfg, device), args.out,
                                 n_candidates=args.n_candidates,
                                 n_diverse=args.n_diverse)
        print(json.dumps({
            "out": args.out, "step": manifest["step"],
            "device": manifest["device"],
            "generator_bytes": manifest["generator"]["bytes"],
            "planner_bytes": manifest["planner"]["bytes"],
            "export_s": {name: manifest[name]["export_s"]
                         for name in manifest["artifacts"]}}))
        return 0

    if args.cmd == "record-data":
        if args.from_planner:
            from ndivplanning_tpu_torch.train.distill import (
                record_planner_dataset,
            )

            stats = record_planner_dataset(
                cfg, _load_state(cfg, device), args.n_examples, args.out,
                planner=args.from_planner, per_scene=args.per_scene)
        else:
            from ndivplanning_tpu_torch.data.host_pipeline import (
                record_dataset,
            )

            stats = record_dataset(cfg, args.n_examples, args.out,
                                   seed=cfg.seed, device=device)
        print(json.dumps({"out": args.out, **stats}))
        return 0

    if args.cmd == "distill":
        from ndivplanning_tpu_torch.train.distill import (
            RECORD_SEED,
            expert_iteration,
        )

        # --seed moves the recording's scenes (and, through the config,
        # the fine-tune's draws); the offset keeps every derived seed far
        # from the frozen suite's.
        record_seed = (RECORD_SEED if args.seed is None
                       else RECORD_SEED + 7919 * args.seed)
        _, report = expert_iteration(
            cfg, _load_state(cfg, device), seed=record_seed,
            rounds=args.rounds, scenes_per_round=args.scenes_per_round,
            per_scene=args.per_scene, epochs=args.epochs,
            planner=args.planner, replan_every=args.mpc_replan,
            n_candidates=args.mpc_candidates, workdir=args.distill_workdir,
            suite_scenes=args.suite_size, echo=True,
            min_diversity_frac=args.min_diversity_frac, track=args.track)
        print(json.dumps({"rounds": report}))
        return 0

    if args.cmd == "train":
        import torch.distributed as dist

        if "WORLD_SIZE" in os.environ or dist.is_initialized():
            # The group first: under torchrun it names the rank's card,
            # where everything is built.
            device, end = _process_group(device)
            try:
                return _train(args, cfg, device)
            finally:
                end()
        return _train(args, cfg, device)

    if args.cmd == "eval":
        from ndivplanning_tpu_torch.train import evaluate as ev
        from ndivplanning_tpu_torch.utils.metrics import host_floats

        state = _load_state(cfg, device)
        if args.planner:
            out = ev.evaluate_fixed_planner(
                cfg, state, planner=args.planner, n_scenes=args.suite_size,
                scene_chunk=args.scene_chunk)
        elif args.mpc:
            out = ev.evaluate_fixed_mpc(
                cfg, state, n_scenes=args.suite_size,
                total_steps=args.mpc_steps, replan_every=args.mpc_replan,
                n_candidates=args.mpc_candidates)
        elif args.dataset:
            # Held-out eval against a recorded dataset's true scenes, the
            # leg train --dataset runs, latents fixed from seed + 1.
            from ndivplanning_tpu_torch.data.host_pipeline import (
                ArrayDataset,
                batch_from_arrays,
            )

            ds = ArrayDataset.from_npz(args.dataset)
            n = min(args.suite_size, ds.size)
            batch = batch_from_arrays({k: v[:n] for k, v in
                                       ds.arrays.items()}, cfg.conditioning)
            out = host_floats(ev.evaluate_on_batch(
                cfg, state, torch.Generator().manual_seed(cfg.seed + 1),
                batch))
        elif args.sampled:
            out = host_floats(ev.evaluate(
                cfg, state, torch.Generator().manual_seed(cfg.seed + 2)))
        else:
            # Frozen protocol: numbers are comparable run to run.
            out = host_floats(ev.evaluate_fixed(cfg, state,
                                                 n_scenes=args.suite_size))
        print(json.dumps(out))
        return 0

    if args.cmd == "plan" and args.mpc:
        print(json.dumps(_plan_mpc(cfg, _load_state(cfg, device), device,
                                   args)))
        return 0

    if args.cmd == "plan" and args.sharded:
        # The group first: under torchrun it names the rank's card, where
        # everything below is built.
        device, end = _process_group(device)
        try:
            return _plan(args, cfg, device)
        finally:
            end()
    if args.cmd == "plan":
        return _plan(args, cfg, device)

    from ndivplanning_tpu_torch.planning.server import (
        BestWatcher,
        serve,
        serve_tcp,
        warmup,
    )

    state = _load_state(cfg, device)
    # `reload` line: load the workdir's (possibly newer) best checkpoint.
    reload_fn = (lambda: _load_state(cfg, device)) if cfg.workdir else None
    watcher = None
    if args.watch_best:
        if reload_fn is None:
            print("--watch-best needs a --workdir to watch", file=sys.stderr)
            return 2
        watcher = BestWatcher(
            reload_fn, os.path.join(cfg.workdir, "best", "best_path.json"),
            poll_s=args.watch_poll)
    if args.warmup or args.warmup_mpc:  # --warmup-mpc implies --warmup
        secs = warmup(cfg, state, refine=args.refine, mpc=args.warmup_mpc)
        print(f"[serve] warmup: every request bucket dispatched in "
              f"{secs:.1f} s", file=sys.stderr, flush=True)
    if args.tcp is not None:
        server = serve_tcp(cfg, state, host=args.host, port=args.tcp,
                           refine=args.refine, overlap=not args.no_overlap,
                           cross_batch=args.cross_batch, reload_fn=reload_fn,
                           watcher=watcher,
                           max_pending=args.max_pending or None,
                           deadline_ms=args.deadline_ms or None)
        host, port = server.server_address[:2]
        # One readiness line on stdout: clients wait for it.
        print(json.dumps({"listening": f"{host}:{port}"}), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            server.server_close()
            if watcher is not None:
                watcher.stop()
        print(json.dumps({"served": server.lines_served}))
        return 0
    served = serve(cfg, state, refine=args.refine,
                   overlap=not args.no_overlap, reload_fn=reload_fn,
                   watcher=watcher)
    if watcher is not None:
        watcher.stop()
    print(json.dumps({"served": served}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
