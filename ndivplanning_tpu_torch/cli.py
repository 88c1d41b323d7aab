"""Command line of the torch port; counterpart of ``ndivplanning_tpu/cli.py``.

    python -m ndivplanning_tpu_torch.cli train --preset goalcond --workdir runs/goalcond
    python -m ndivplanning_tpu_torch.cli eval  --workdir runs/goalcond
    python -m ndivplanning_tpu_torch.cli plan  --workdir checkpoints_torch/planning512
    python -m ndivplanning_tpu_torch.cli serve --workdir checkpoints_torch/planning512 --warmup
    python -m ndivplanning_tpu_torch.cli eval  --workdir checkpoints_torch/quadrotor150k --mpc
    python -m ndivplanning_tpu_torch.cli plan  --workdir checkpoints_torch/unicycle150k --refine cem

Every command runs on the CUDA card unless ``--device cpu`` is given.  A
``--workdir`` holding a recorded ``config.json`` is the base config; eval,
plan and serve prefer its ``best/`` checkpoint.  The JAX CLI's other
subcommands and options exit with a message naming them: they are not
ported yet.
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

NOT_PORTED_COMMANDS = ("viz", "record-data", "distill", "export", "doctor",
                       "curves")


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to the torch CLI yet (ported: "
                      "train and eval on the on-device sampler, one-shot "
                      "and CEM planning, closed-loop MPC; plan and serve, "
                      "unsharded)")


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
    p.add_argument("--profile-dir", default=None, help="not ported yet")
    p.add_argument("--debug-nans", action="store_true",
                   help="not ported yet")
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


def _check_ported(args) -> None:
    from ndivplanning_tpu_torch.planning.server import REFINES
    from ndivplanning_tpu_torch.train.evaluate import PORTED_PLANNERS

    flags = {"--profile-dir": args.profile_dir is not None,
             "--debug-nans": args.debug_nans}
    if args.cmd in ("plan", "serve"):
        flags[f"--refine {args.refine}"] = args.refine not in REFINES
    if args.cmd == "plan":
        flags["--sharded"] = args.sharded
    elif args.cmd == "serve":
        flags.update({"--tcp": args.tcp is not None,
                      "--cross-batch": args.cross_batch,
                      "--max-pending": bool(args.max_pending),
                      "--deadline-ms": bool(args.deadline_ms),
                      "--watch-best": args.watch_best})
    elif args.cmd == "train":
        flags.update({"--dataset": args.dataset is not None,
                      "--epochs": args.epochs is not None,
                      "--eval-fraction": args.eval_fraction is not None})
    else:
        flags.update({"--dataset": args.dataset is not None,
                      f"--planner {args.planner}":
                          args.planner not in (None, *PORTED_PLANNERS)})
    for flag, on in flags.items():
        if on:
            raise _not_ported(f"{args.cmd} {flag}")


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


def _parser() -> argparse.ArgumentParser:
    from ndivplanning_tpu_torch.train.evaluate import PLANNERS

    parser = argparse.ArgumentParser(prog="ndivplanning_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in NOT_PORTED_COMMANDS:
        sub.add_parser(name, add_help=False, help="not ported yet")
    for name in ("train", "eval", "plan", "serve"):
        _add_common(sub.add_parser(name))
    train_p, eval_p, plan_p, serve_p = (
        sub.choices[name] for name in ("train", "eval", "plan", "serve"))
    train_p.add_argument("--dataset", default=None, help="not ported yet")
    train_p.add_argument("--epochs", type=int, default=None,
                         help="not ported yet")
    train_p.add_argument("--eval-fraction", type=float, default=None,
                         help="not ported yet")
    eval_p.add_argument("--sampled", action="store_true",
                        help="sample a fresh eval batch instead of the "
                             "frozen suite")
    eval_p.add_argument("--suite-size", type=int, default=512)
    eval_p.add_argument("--planner", default=None, choices=PLANNERS,
                        help="open-loop planner quality on the frozen "
                             "suite: mean best score (lower is better) and "
                             "reach rate; 'oneshot' and 'cem' are ported")
    eval_p.add_argument("--scene-chunk", type=int, default=None,
                        help="scenes per dispatch for --planner "
                             "(default 128 oneshot, 16 cem)")
    eval_p.add_argument("--dataset", default=None, help="not ported yet")
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
                            "planner's rollout budget; 'none' and 'cem' are "
                            "ported")
    plan_p.add_argument("--mpc", action="store_true",
                        help="closed-loop receding-horizon planning: replan "
                             "every --mpc-replan steps from the live state")
    plan_p.add_argument("--mpc-episodes", type=int, default=1,
                        help="episodes to run, as one batch")
    plan_p.add_argument("--sharded", action="store_true",
                        help="not ported yet")
    serve_p.add_argument("--warmup", action="store_true",
                         help="run one dispatch of every request bucket "
                              "before reading stdin")
    serve_p.add_argument("--no-overlap", action="store_true",
                         help="write responses synchronously instead of "
                              "on a writer thread")
    serve_p.add_argument("--tcp", type=int, default=None, metavar="PORT",
                         help="not ported yet")
    serve_p.add_argument("--cross-batch", action="store_true",
                         help="not ported yet")
    serve_p.add_argument("--max-pending", type=int, default=0,
                         help="not ported yet")
    serve_p.add_argument("--deadline-ms", type=float, default=0.0,
                         help="not ported yet")
    serve_p.add_argument("--watch-best", action="store_true",
                         help="not ported yet")
    serve_p.add_argument("--warmup-mpc", action="store_true",
                         help="also dispatch a closed-loop batch of every "
                              "bucket before reading stdin (implies "
                              "--warmup)")
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd in NOT_PORTED_COMMANDS:
        raise _not_ported(f"the {args.cmd!r} subcommand")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    _check_ported(args)
    cfg = _build_config(args)
    device = resolve_device(args.device)

    if args.cmd == "train":
        from ndivplanning_tpu_torch.train.loop import train

        state, history = train(cfg, device=device)
        print(json.dumps({"final_step": int(state.step),
                          "last": history[-1] if history else None}))
        return 0

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

    if args.cmd == "plan":
        from ndivplanning_tpu_torch.data.scenes import random_scene
        from ndivplanning_tpu_torch.planning.cem import plan_cem
        from ndivplanning_tpu_torch.planning.planner import plan
        from ndivplanning_tpu_torch.planning.server import _condition_for

        state = _load_state(cfg, device)
        scene = random_scene(
            torch.Generator(device=device).manual_seed(cfg.seed + 3))
        condition = _condition_for(cfg, scene)
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 4)
        out = {}
        if args.refine == "cem":
            result, best_curve = plan_cem(cfg, state, scene, condition,
                                          generator)
            out["best_curve"] = best_curve.tolist()
        else:
            result = plan(cfg, state, scene, condition, generator)
        print(json.dumps({
            "best_score": float(result.best_score),
            "best_reached": float(result.best_reached),
            "n_candidates": int(result.scores.shape[0]),
            **out,
        }))
        return 0

    from ndivplanning_tpu_torch.planning.server import serve, warmup

    state = _load_state(cfg, device)
    # `reload` line: load the workdir's (possibly newer) best checkpoint.
    reload_fn = (lambda: _load_state(cfg, device)) if cfg.workdir else None
    if args.warmup or args.warmup_mpc:  # --warmup-mpc implies --warmup
        secs = warmup(cfg, state, refine=args.refine, mpc=args.warmup_mpc)
        print(f"[serve] warmup: every request bucket dispatched in "
              f"{secs:.1f} s", file=sys.stderr, flush=True)
    served = serve(cfg, state, refine=args.refine,
                   overlap=not args.no_overlap, reload_fn=reload_fn)
    print(json.dumps({"served": served}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
