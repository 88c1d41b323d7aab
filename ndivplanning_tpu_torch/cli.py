"""Command line of the torch port; counterpart of ``ndivplanning_tpu/cli.py``.

    python -m ndivplanning_tpu_torch.cli plan  --workdir checkpoints_torch/planning512
    python -m ndivplanning_tpu_torch.cli serve --workdir checkpoints_torch/planning512 --warmup

Both run on the CUDA card unless ``--device cpu`` is given.  A ``--workdir``
holding a recorded ``config.json`` is the base config, and its ``best/``
checkpoint is preferred.  The JAX CLI's other subcommands and options
exit with a message naming them: they are not ported yet.
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

NOT_PORTED_COMMANDS = ("train", "eval", "viz", "record-data", "distill",
                       "export", "doctor", "curves")


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to the torch CLI yet "
                      "(ported: plan and serve, unsharded and unrefined)")


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
    flags = {"--profile-dir": args.profile_dir is not None,
             "--debug-nans": args.debug_nans,
             "--refine": args.refine != "none"}
    if args.cmd == "plan":
        flags.update({"--mpc": args.mpc, "--sharded": args.sharded})
    else:
        flags.update({"--tcp": args.tcp is not None,
                      "--cross-batch": args.cross_batch,
                      "--max-pending": bool(args.max_pending),
                      "--deadline-ms": bool(args.deadline_ms),
                      "--watch-best": args.watch_best,
                      "--warmup-mpc": args.warmup_mpc})
    for flag, on in flags.items():
        if on:
            raise _not_ported(f"{args.cmd} {flag}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ndivplanning_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in NOT_PORTED_COMMANDS:
        sub.add_parser(name, add_help=False, help="not ported yet")
    for name in ("plan", "serve"):
        p = sub.add_parser(name)
        _add_common(p)
        p.add_argument("--refine", default="none",
                       choices=("none", "cem", "grad", "trajopt", "ilqr",
                                "cem+trajopt"),
                       help="latent or trajectory refinement: only 'none' "
                            "is ported")
    plan_p, serve_p = sub.choices["plan"], sub.choices["serve"]
    plan_p.add_argument("--mpc", action="store_true", help="not ported yet")
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
                         help="not ported yet")
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

    if args.cmd == "plan":
        from ndivplanning_tpu_torch.data.scenes import random_scene
        from ndivplanning_tpu_torch.planning.planner import plan
        from ndivplanning_tpu_torch.planning.server import _condition_for

        state = _load_state(cfg, device)
        scene = random_scene(
            torch.Generator(device=device).manual_seed(cfg.seed + 3))
        result = plan(cfg, state, scene, _condition_for(cfg, scene),
                      torch.Generator(device=device).manual_seed(cfg.seed + 4))
        print(json.dumps({
            "best_score": float(result.best_score),
            "best_reached": float(result.best_reached),
            "n_candidates": int(result.scores.shape[0]),
        }))
        return 0

    from ndivplanning_tpu_torch.planning.server import serve, warmup

    state = _load_state(cfg, device)
    # `reload` line: load the workdir's (possibly newer) best checkpoint.
    reload_fn = (lambda: _load_state(cfg, device)) if cfg.workdir else None
    if args.warmup:
        secs = warmup(cfg, state)
        print(f"[serve] warmup: every request bucket dispatched in "
              f"{secs:.1f} s", file=sys.stderr, flush=True)
    served = serve(cfg, state, overlap=not args.no_overlap,
                   reload_fn=reload_fn)
    print(json.dumps({"served": served}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
