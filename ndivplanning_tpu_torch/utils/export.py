"""Deployment export through ``torch.export``; counterpart of ``ndivplanning_tpu/utils/export.py``.

Serializes the inference surfaces to ``.pt2`` programs (``torch.export``
``ExportedProgram`` files) with the trained weights baked in as
constants, so a deployment runs them with torch alone: no model code, no
checkpoint plumbing.  Every program has a symbolic batch axis, so one
export serves any request batch.

Bundle layout (:func:`export_bundle`):

    <out_dir>/generator.pt2        (conditions[b,...], z[b,n,zdim]) -> traj[b,n,H,S]
    <out_dir>/planner.pt2          one-shot planning: the scene's raw arrays
                                   and its noise -> (best_traj[b,H,S],
                                   best_score[b], best_reached[b],
                                   diverse_trajs[b,m,H,S])
    <out_dir>/cem_planner.pt2      the same plus best_curve[b, cem_iters]
    <out_dir>/trajopt_planner.pt2  the same plus loss_curve[b, steps]
    <out_dir>/mpc_controller.pt2   -> (positions[b,T,S], reached[b], collided[b])
    <out_dir>/manifest.json        config, device, budgets, signatures

The iLQR planner is not exported yet (:func:`export_ilqr_planner`
raises): its Jacobians are ``torch.func`` transforms (``vmap`` of
``jvp``), which neither ``torch.export`` nor ``make_fx`` traces with a
symbolic batch in this torch.  The manifest says so under
``ilqr_planner``.

Where the JAX package differs:

- An exported program takes no random generator: each planner program
  takes its noise as a last input, ``noise[b, *noise_shape]`` (the
  latents, CEM's population draws, MPC's per-cycle latents), which the
  port's eager planners take as ``z=`` / ``eps=``.  :func:`load_exported`
  returns a callable with the JAX package's raw-array signature
  ``(conditions, start, goal, obstacles, obstacle_mask, seeds)`` that draws
  scene j's noise from ``torch.Generator(device).manual_seed(seeds[j])``;
  JAX derives threefry keys from the seeds instead.
- An ``ExportedProgram`` keeps its constants on the device it was traced
  on: a bundle is written for one device (the manifest's ``device``), and
  :func:`load_exported` refuses another, naming both.  JAX lowers one
  artifact for the CPU and the TPU.
- The time loops of the rollouts trace as one ``scan`` each
  (``envs/rollout.py::time_loop``), so a program holds one step's graph
  instead of H copies; the other loops (CEM's iterations, MPC's cycles)
  unroll.  The trajectory optimiser's program is traced below autograd
  first (``make_fx``), backward included, because export's own tracing
  cannot take ``torch.autograd.grad`` of an op whose backward reads its
  output (sqrt, reciprocal); its loops all unroll, since scan's backward
  does not trace with a symbolic batch, so its program grows with the
  Adam steps (about 6000 nodes a step at H = 32) and takes minutes to
  export and to load.

A loaded program is bitwise the eager planner on the same noise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from ndivplanning_tpu_torch.envs.rollout import ScoreWeights
from ndivplanning_tpu_torch.envs.types import Scene
from ndivplanning_tpu_torch.utils.config import Config

GENERATOR_FILE = "generator.pt2"
PLANNER_FILE = "planner.pt2"
CEM_PLANNER_FILE = "cem_planner.pt2"
TRAJOPT_PLANNER_FILE = "trajopt_planner.pt2"
MPC_CONTROLLER_FILE = "mpc_controller.pt2"
MANIFEST_FILE = "manifest.json"

# Each artifact's own record, read back by load_exported.
_META = "ndiv_artifact.json"
_MAX_BATCH = 1 << 16
_SCENE_SIGNATURE = ("(conditions, start, goal, obstacles, obstacle_mask, "
                    "seeds) -> ")


class _Program(torch.nn.Module):
    """``fn(scenes, conditions, noise)`` over a scene's raw arrays."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, conditions, start, goal, obstacles, obstacle_mask,
                noise):
        scenes = Scene(start=start, goal=goal, obstacles=obstacles,
                       obstacle_mask=obstacle_mask)
        return tuple(self.fn(scenes, conditions, noise))


class _Refine(torch.nn.Module):
    """G's warm starts of the latents ``z``, then ``core(start, goal,
    obstacles, obstacle_mask, tau0)``, a graph traced below autograd."""

    def __init__(self, cfg: Config, state, core):
        super().__init__()
        self.cfg, self.state, self.core = cfg, state, core

    def forward(self, conditions, start, goal, obstacles, obstacle_mask, z):
        from ndivplanning_tpu_torch.train.state import gen_params

        with torch.no_grad():
            tau0 = gen_params(self.cfg, self.state)(conditions, z)
        return self.core(start, goal, obstacles, obstacle_mask, tau0)


class _Generate(torch.nn.Module):
    def __init__(self, gen):
        super().__init__()
        self.gen = gen

    def forward(self, conditions, z):
        return self.gen(conditions, z)


def _device(state) -> torch.device:
    return _indexed(state.rng.device)


def _indexed(device) -> torch.device:
    """``device`` with the current card's index where a CUDA device has
    none ("cuda" is "cuda:0" on a one-card host)."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and torch.cuda.is_available()):
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _scene_example(cfg: Config, device, noise_shape, batch: int = 7):
    """Example inputs of a scene program (their values do not matter; the
    batch equals no other axis, which symbolic tracing would tie to it)."""
    from ndivplanning_tpu_torch.data.scenes import random_scene_batch
    from ndivplanning_tpu_torch.planning.server import _condition_for

    gen = torch.Generator(device=device).manual_seed(0)
    scenes = random_scene_batch(gen, batch)
    noise = torch.randn((batch, *noise_shape), generator=gen, device=device)
    return (_condition_for(cfg, scenes), scenes.start, scenes.goal,
            scenes.obstacles, scenes.obstacle_mask, noise)


def _export(module, args, dynamic_shapes):
    """``torch.export`` of ``module`` at ``args`` (the rollouts' time loops
    trace as scans where no gradient flows through them)."""
    return torch.export.export(module, args, dynamic_shapes=dynamic_shapes,
                               strict=False)


def _scene_program(module, args):
    b = torch.export.Dim("b", min=1, max=_MAX_BATCH)
    return _export(module, args, tuple({0: b} for _ in args))


def _save(ep, path: str, meta: dict) -> int:
    torch.export.save(ep, path, extra_files={_META: json.dumps(meta)})
    return os.path.getsize(path)


# ------------------------------------------------ the programs, eagerly


def planner_program(cfg: Config, state, n_candidates: int | None = None,
                    n_diverse: int = 8):
    """``(fn(scenes, conditions, z), noise_shape)``: one-shot planning of
    stacked scenes on latents ``z [b, n, zdim]``."""
    from ndivplanning_tpu_torch.planning.planner import plan_batch

    n = cfg.n_candidates if n_candidates is None else n_candidates

    def fn(scenes, conditions, z):
        r = plan_batch(cfg, state, scenes, conditions, n_candidates=n,
                       n_diverse=n_diverse, weights=ScoreWeights(), z=z)
        return r.best_traj, r.best_score, r.best_reached, r.diverse_trajs

    return fn, (n, cfg.latent_dim)


def cem_program(cfg: Config, state, n_candidates: int | None = None,
                n_iters: int | None = None, n_diverse: int = 8):
    """CEM planning on its population draws ``eps [b, iters + 1, n,
    zdim]``; ``n_candidates`` is ``plan_cem``'s (the per-iteration
    population, by default the one-shot budget split over the
    iterations)."""
    from ndivplanning_tpu_torch.planning.cem import (
        cem_population,
        plan_cem_batch,
    )

    n, _, iters = cem_population(cfg, n_candidates, n_iters)

    def fn(scenes, conditions, eps):
        r, curve = plan_cem_batch(cfg, state, scenes, conditions,
                                  n_candidates=n_candidates, n_iters=iters,
                                  n_diverse=n_diverse,
                                  weights=ScoreWeights(), eps=eps)
        return (r.best_traj, r.best_score, r.best_reached, r.diverse_trajs,
                curve)

    return fn, (iters + 1, n, cfg.latent_dim)


def trajopt_program(cfg: Config, state, n_candidates: int | None = None,
                    n_steps: int | None = None, lr: float | None = None,
                    n_diverse: int = 8):
    """Trajectory optimisation from G's warm starts of ``z [b, n, zdim]``
    (``plan_trajopt``'s defaults)."""
    from ndivplanning_tpu_torch.planning.trajopt import (
        plan_trajopt_batch,
        resolve_budget,
    )

    n, steps, lr = resolve_budget(cfg, n_candidates, n_steps, lr)

    def fn(scenes, conditions, z):
        r, curve = plan_trajopt_batch(cfg, state, scenes, conditions,
                                      n_candidates=n, n_steps=steps, lr=lr,
                                      n_diverse=n_diverse,
                                      weights=ScoreWeights(), z=z)
        return (r.best_traj, r.best_score, r.best_reached, r.diverse_trajs,
                curve)

    return fn, (n, cfg.latent_dim)


def mpc_program(cfg: Config, state, total_steps: int = 64,
                replan_every: int = 8, n_candidates: int = 256):
    """Closed-loop episodes on per-cycle latents ``z [b, cycles, N,
    zdim]`` (``mpc_rollout_batch``)."""
    from ndivplanning_tpu_torch.planning.mpc import (
        _check_fused,
        mpc_rollout_batch,
    )

    _check_fused(total_steps, replan_every)

    def fn(scenes, conditions, z):
        r = mpc_rollout_batch(cfg, state, scenes, conditions,
                              total_steps=total_steps,
                              replan_every=replan_every,
                              n_candidates=n_candidates,
                              weights=ScoreWeights(), z=z)
        return r.positions, r.reached, r.collided

    return fn, (total_steps // replan_every, n_candidates, cfg.latent_dim)


# ------------------------------------------------------------- export


def _meta(kind: str, state, noise_shape=None) -> dict:
    return {"kind": kind, "device": str(_device(state)),
            "noise_shape": None if noise_shape is None else list(noise_shape)}


def export_generator(cfg: Config, state, path: str) -> int:
    """Write ``G(conditions, z) -> trajectories`` (EMA-aware) to ``path``;
    batch and sample-count axes symbolic.  Returns the file's bytes."""
    from ndivplanning_tpu_torch.train.state import gen_params

    device = _device(state)
    conditions = _scene_example(cfg, device, (1, cfg.latent_dim))[0]
    z = torch.randn((conditions.shape[0], 3, cfg.latent_dim), device=device)
    b = torch.export.Dim("b", min=1, max=_MAX_BATCH)
    n = torch.export.Dim("n", min=1, max=_MAX_BATCH)
    with torch.no_grad():
        ep = _export(_Generate(gen_params(cfg, state)), (conditions, z),
                     ({0: b}, {0: b, 1: n}))
    return _save(ep, path, _meta("generator", state))


def _export_scene_program(kind, cfg, state, path, program) -> int:
    fn, noise_shape = program
    args = _scene_example(cfg, _device(state), noise_shape)
    return _save(_scene_program(_Program(fn), args), path,
                 _meta(kind, state, noise_shape))


def export_planner(cfg: Config, state, path: str,
                   n_candidates: int | None = None,
                   n_diverse: int = 8) -> int:
    """Write the one-shot plan-a-scene-batch pipeline (generate -> rollout
    -> select) as one program."""
    return _export_scene_program(
        "planner", cfg, state, path,
        planner_program(cfg, state, n_candidates, n_diverse))


def export_cem_planner(cfg: Config, state, path: str,
                       n_candidates: int | None = None,
                       n_iters: int | None = None,
                       n_diverse: int = 8) -> int:
    """Write the CEM latent-refinement planner (``plan_cem``'s
    ``n_candidates`` semantics: an explicit value is the per-iteration
    population)."""
    return _export_scene_program(
        "cem_planner", cfg, state, path,
        cem_program(cfg, state, n_candidates, n_iters, n_diverse))


def export_trajopt_planner(cfg: Config, state, path: str,
                           n_candidates: int | None = None,
                           n_steps: int | None = None,
                           lr: float | None = None,
                           n_diverse: int = 8) -> int:
    """Write the trajectory-optimisation planner (``plan_trajopt``'s
    defaults: n = cfg.n_candidates / 4, cfg.trajopt_steps Adam steps).
    G's warm starts trace as the other programs do; the refinement is
    traced below autograd (``make_fx``) first, its backward included."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from ndivplanning_tpu_torch.planning.grad_refine import SoftWeights
    from ndivplanning_tpu_torch.planning.trajopt import (
        resolve_budget,
        trajopt_core,
    )
    from ndivplanning_tpu_torch.train.state import gen_params

    n, steps, lr = resolve_budget(cfg, n_candidates, n_steps, lr)
    noise_shape = (n, cfg.latent_dim)
    args = _scene_example(cfg, _device(state), noise_shape)
    with torch.no_grad():
        tau0 = gen_params(cfg, state)(args[0], args[5])

    def core(start, goal, obstacles, obstacle_mask, tau0):
        scenes = Scene(start=start, goal=goal, obstacles=obstacles,
                       obstacle_mask=obstacle_mask)
        r, curve = trajopt_core(cfg, scenes, tau0, steps, lr, SoftWeights(),
                                n_diverse, ScoreWeights())
        return (r.best_traj, r.best_score, r.best_reached, r.diverse_trajs,
                curve)

    core = make_fx(core, tracing_mode="symbolic",
                   _allow_non_fake_inputs=True)(*args[1:5], tau0)
    return _save(_scene_program(_Refine(cfg, state, core), args), path,
                 _meta("trajopt_planner", state, noise_shape))


ILQR_NOT_EXPORTED = (
    "the iLQR planner is not exported yet: its Jacobians are torch.func "
    "transforms (vmap of jvp), which torch.export and make_fx do not trace "
    "with a symbolic batch")


def export_ilqr_planner(cfg: Config, state, path: str,
                        n_candidates: int | None = None,
                        n_iters: int | None = None,
                        n_diverse: int = 8) -> int:
    """The iLQR planner's artifact: not ported yet, raises."""
    raise NotImplementedError(ILQR_NOT_EXPORTED)


def export_mpc_controller(cfg: Config, state, path: str,
                          total_steps: int = 64, replan_every: int = 8,
                          n_candidates: int = 256) -> int:
    """Write the closed-loop MPC controller (``mpc_rollout_batch``)."""
    return _export_scene_program(
        "mpc_controller", cfg, state, path,
        mpc_program(cfg, state, total_steps, replan_every, n_candidates))


def export_bundle(cfg: Config, state, out_dir: str,
                  n_candidates: int | None = None,
                  n_diverse: int = 8,
                  mpc_total_steps: int = 64,
                  mpc_replan_every: int = 8,
                  mpc_candidates: int = 256) -> dict:
    """Write the programs and a manifest to ``out_dir`` for the state's
    device; returns the manifest (with the budgets baked in)."""
    from ndivplanning_tpu_torch.planning.cem import cem_population
    from ndivplanning_tpu_torch.planning.ilqr import resolve_ilqr_budget
    from ndivplanning_tpu_torch.planning.trajopt import resolve_budget

    trj = resolve_budget(cfg, n_candidates)
    ilqr = resolve_ilqr_budget(cfg, n_candidates)
    os.makedirs(out_dir, exist_ok=True)
    jobs = {
        "generator": (GENERATOR_FILE, lambda p: export_generator(
            cfg, state, p)),
        "planner": (PLANNER_FILE, lambda p: export_planner(
            cfg, state, p, n_candidates=n_candidates, n_diverse=n_diverse)),
        "cem_planner": (CEM_PLANNER_FILE, lambda p: export_cem_planner(
            cfg, state, p, n_candidates=n_candidates, n_diverse=n_diverse)),
        "trajopt_planner": (TRAJOPT_PLANNER_FILE,
                            lambda p: export_trajopt_planner(
                                cfg, state, p, n_candidates=n_candidates,
                                n_diverse=n_diverse)),
        "mpc_controller": (MPC_CONTROLLER_FILE,
                           lambda p: export_mpc_controller(
                               cfg, state, p, total_steps=mpc_total_steps,
                               replan_every=mpc_replan_every,
                               n_candidates=mpc_candidates)),
    }
    written = {}
    for name, (file, write) in jobs.items():
        t0 = time.perf_counter()
        nbytes = write(os.path.join(out_dir, file))
        written[name] = {"file": file, "bytes": nbytes,
                         "export_s": round(time.perf_counter() - t0, 3)}
    device = _device(state)
    manifest = {
        "config": dataclasses.asdict(cfg),
        "step": int(state.step),
        "device": str(device),
        "platforms": [device.type],
        "artifacts": list(jobs),
        "generator": {
            **written["generator"],
            "signature": "(conditions[b,...], z[b,n,zdim]) -> traj[b,n,H,S]",
        },
        "planner": {
            **written["planner"],
            "n_candidates": (cfg.n_candidates if n_candidates is None
                             else n_candidates),
            "n_diverse": n_diverse,
            "signature": _SCENE_SIGNATURE + "(best_traj, best_score, "
                         "best_reached, diverse_trajs)",
        },
        "cem_planner": {
            **written["cem_planner"],
            # The population baked in (per iteration, plan_cem semantics).
            "population": cem_population(cfg, n_candidates)[0],
            "cem_iters": cfg.cem_iters,
            "n_diverse": n_diverse,
            "signature": _SCENE_SIGNATURE + "(best_traj, best_score, "
                         "best_reached, diverse_trajs, best_curve)",
        },
        "trajopt_planner": {
            **written["trajopt_planner"],
            "n_warm_starts": trj[0],
            "adam_steps": trj[1],
            "lr": trj[2],
            "n_diverse": n_diverse,
            "signature": _SCENE_SIGNATURE + "(best_traj, best_score, "
                         "best_reached, diverse_trajs, loss_curve)",
        },
        "ilqr_planner": {
            "file": None,
            "exported": False,
            "reason": ILQR_NOT_EXPORTED,
            "n_warm_starts": ilqr[0],
            "ilqr_iters": ilqr[1],
            "n_diverse": n_diverse,
            "signature": _SCENE_SIGNATURE + "(best_traj, best_score, "
                         "best_reached, diverse_trajs, cost_curve)",
        },
        "mpc_controller": {
            **written["mpc_controller"],
            "total_steps": mpc_total_steps,
            "replan_every": mpc_replan_every,
            "n_candidates": mpc_candidates,
            "signature": _SCENE_SIGNATURE + "(positions[b,T,S], reached[b], "
                         "collided[b])",
        },
    }
    with open(os.path.join(out_dir, MANIFEST_FILE), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


# --------------------------------------------------------------- load


def draw_noise(seeds, noise_shape, device) -> torch.Tensor:
    """``[b, *noise_shape]``: scene j's noise from
    ``torch.Generator(device).manual_seed(seeds[j])``."""
    return torch.stack([
        torch.randn(tuple(noise_shape), device=device,
                    generator=torch.Generator(device=device).manual_seed(
                        int(seed)))
        for seed in torch.as_tensor(seeds).tolist()])


def load_exported(path: str, device=None):
    """Load one artifact; returns a callable.  The generator's is
    ``(conditions, z)``; a planner's or the controller's is ``(conditions,
    start, goal, obstacles, obstacle_mask, seeds)``, drawing each scene's
    noise with :func:`draw_noise`, and its ``.program(..., noise)`` takes
    the noise itself.  ``device`` (default: the artifact's) must be the
    device the artifact was exported for, and so must the inputs' device:
    a program is never moved to another device."""
    extra = {_META: ""}
    ep = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    home = torch.device(meta["device"])

    def check(where, dev):
        dev = _indexed(dev)
        if dev != home:
            raise ValueError(
                f"{path} was exported for device {home}, not {where} "
                f"{dev}: an exported program keeps its constants on its "
                "device; export the bundle again on that device")

    if device is not None:
        check("the requested", device)
    program = ep.module()
    if meta["kind"] == "generator":
        def generate(conditions, z):
            check("the inputs'", conditions.device)
            return program(conditions, z)

        generate.program = program
        return generate
    noise_shape = tuple(meta["noise_shape"])

    def call(conditions, start, goal, obstacles, obstacle_mask, seeds):
        check("the inputs'", conditions.device)
        return program(conditions, start, goal, obstacles, obstacle_mask,
                       draw_noise(seeds, noise_shape, home))

    call.program = program
    call.noise_shape = noise_shape
    call.kind = meta["kind"]
    return call


