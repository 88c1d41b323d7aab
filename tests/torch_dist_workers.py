"""Workers for the torch port's parallel tests (torch and numpy only).

Each runs in every gloo rank that
``ndivplanning_tpu_torch.parallel.spawn.run_ranks`` spawns.  The workers
import no JAX: a spawned process imports this module, not the test file.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def ndiv_mesh_state_worker(cases, cfg):
    """The sharded NDiv cases, make_mesh's error and shard_state, in one
    process group."""
    return {"ndiv": sharded_ndiv_worker(cases),
            "mesh_error": mesh_errors_worker(),
            "shard_state": shard_state_worker(cfg)}


def sharded_ndiv_worker(cases):
    """Each case ``(name, dp, div, impl, z, x)`` of global numpy inputs:
    this rank's loss and its grads of its own blocks."""
    from ndivplanning_tpu_torch.parallel import make_mesh, ndiv_loss_sharded

    out = {}
    for name, dp, div, impl, z, x in cases:
        mesh = make_mesh(dp=dp, div=div)
        bl, kl = z.shape[0] // dp, z.shape[1] // div
        rows = slice(mesh.dp_index * bl, (mesh.dp_index + 1) * bl)
        cols = slice(mesh.div_index * kl, (mesh.div_index + 1) * kl)
        zl = torch.tensor(z[rows, cols], requires_grad=True)
        xl = torch.tensor(x[rows, cols], requires_grad=True)
        loss = ndiv_loss_sharded(zl, xl, 0.8, mesh, impl=impl)
        gz, gx = torch.autograd.grad(loss, (zl, xl))
        out[name] = (float(loss.detach()), (rows, cols), gz.numpy(),
                     gx.numpy())
    return out


def mesh_errors_worker():
    """make_mesh's error on a shape the world does not fill."""
    from ndivplanning_tpu_torch.parallel import make_mesh

    try:
        make_mesh(dp=3, div=1)
    except ValueError as e:
        return str(e)
    return None


def shard_state_worker(cfg):
    """A state built from this rank's own seed, then shard_state: every
    tensor and counter of it, and the generator's next draw."""
    from ndivplanning_tpu_torch.parallel import make_mesh, shard_state
    from ndivplanning_tpu_torch.parallel.sharded_step import _state_tensors
    from ndivplanning_tpu_torch.train.state import create_train_state

    state = create_train_state(cfg, seed=10 + dist.get_rank(), device="cpu")
    state.step, state.g_opt.count = dist.get_rank(), dist.get_rank()
    state = shard_state(state, make_mesh(dp=dist.get_world_size()))
    return ([t.detach().numpy().copy() for t in _state_tensors(state)],
            (state.step, state.g_opt.count, state.d_opt.count),
            torch.rand(4, generator=state.rng).numpy())


def sharded_step_worker(cfg, meshes, state_dict, inputs, repeats):
    """For each (dp, div): ``repeats`` runs of len(inputs) steps of the
    sharded train_step_impl from one state (numpy G, D and EMA weights),
    on injected global batches and z.  Per run: the metrics of every step,
    the final G, D and EMA params, and G's Adam first moments."""
    from ndivplanning_tpu_torch.data.tasks import Batch
    from ndivplanning_tpu_torch.envs.types import Scene
    from ndivplanning_tpu_torch.parallel import make_mesh, shard_state
    from ndivplanning_tpu_torch.train.state import create_train_state
    from ndivplanning_tpu_torch.train.step import train_step_impl

    out = {}
    for dp, div in meshes:
        mesh = make_mesh(dp=dp, div=div)
        runs = []
        for _ in range(repeats):
            state = create_train_state(cfg, seed=dist.get_rank(),
                                       device="cpu")
            for name, module in (("g", state.g), ("d", state.d),
                                 ("g_ema", state.g_ema)):
                module.load_state_dict({k: torch.tensor(v) for k, v
                                        in state_dict[name].items()})
            state = shard_state(state, mesh)
            history = []
            for cond, real, z in inputs:
                batch = Batch(torch.tensor(cond), torch.tensor(real),
                              Scene.create_batch(torch.tensor(cond[:, :2]),
                                                 torch.tensor(cond[:, 2:])))
                state, m = train_step_impl(cfg, state, batch,
                                           z=torch.tensor(z), mesh=mesh)
                history.append({k: float(v) for k, v in m.items()})
            runs.append((history, {
                name: {k: v.numpy().copy()
                       for k, v in module.state_dict().items()}
                for name, module in (("g", state.g), ("d", state.d),
                                     ("g_ema", state.g_ema))},
                {k: v.numpy().copy() for k, v in state.g_opt.mu.items()}))
        out[(dp, div)] = runs
    return out


# ------------------------------------------------- multi-rank training


def state_snapshot(state):
    """Every tensor and counter of a TrainState, as numpy on the host."""
    def host(tensors):
        return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}

    snap = {"step": state.step,
            "rng": state.rng.get_state().numpy().copy(),
            "ada": host(state.ada), "lecam_ema": host(state.lecam_ema)}
    for name in ("g", "d", "g_ema"):
        snap[name] = host(getattr(state, name).state_dict())
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        snap[name] = {"count": opt.count, "mu": host(opt.mu),
                      "nu": host(opt.nu)}
    return snap


def state_from_snapshot(cfg, snap):
    """A CPU TrainState holding ``snap`` (from :func:`state_snapshot`)."""
    from ndivplanning_tpu_torch.train.state import create_train_state

    def dev(arrays):
        return {k: torch.tensor(v) for k, v in arrays.items()}

    state = create_train_state(cfg, device="cpu")
    state.step = snap["step"]
    state.rng.set_state(torch.tensor(snap["rng"]))
    state.ada, state.lecam_ema = dev(snap["ada"]), dev(snap["lecam_ema"])
    for name in ("g", "d", "g_ema"):
        getattr(state, name).load_state_dict(dev(snap[name]))
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        opt.count = snap[name]["count"]
        opt.mu, opt.nu = dev(snap[name]["mu"]), dev(snap[name]["nu"])
    return state


def draws_numpy(draws):
    """A StepDraws as plain numpy: (noise, aug fields, fresh D)."""
    def host(t):
        return None if t is None else t.detach().cpu().numpy()

    return ([host(n) for n in draws.noise],
            [(host(a.mask), host(a.shift), host(a.cutout))
             for a in draws.aug],
            None if draws.fresh_d is None
            else {k: host(v) for k, v in draws.fresh_d.items()})


def draws_torch(arrays):
    """The StepDraws of :func:`draws_numpy`'s arrays."""
    from ndivplanning_tpu_torch.train.step import AugDraws, StepDraws

    def dev(a):
        return None if a is None else torch.tensor(a)

    noise, aug, fresh = arrays
    return StepDraws(
        noise=tuple(dev(n) for n in noise),
        aug=tuple(AugDraws(*(dev(t) for t in fields)) for fields in aug),
        fresh_d=None if fresh is None else {k: dev(v)
                                            for k, v in fresh.items()})


def mesh_knob_worker(runs):
    """Each run ``(name, cfg, (dp, div), snapshot, steps)``, ``steps`` a
    list of global ``(conditions, real_traj, z, draws_numpy)``: those steps
    of the sharded step on a (dp, div) mesh from the snapshot's state.
    Per run: each step's metrics and the state snapshot after each step."""
    from ndivplanning_tpu_torch.data.tasks import Batch
    from ndivplanning_tpu_torch.parallel import make_mesh, shard_state
    from ndivplanning_tpu_torch.train.step import train_step_impl

    out = {}
    for name, cfg, (dp, div), snap, steps in runs:
        mesh = make_mesh(dp=dp, div=div)
        state = shard_state(state_from_snapshot(cfg, snap), mesh)
        metrics, snaps = [], []
        for cond, real, z, draws in steps:
            batch = Batch(torch.tensor(cond), torch.tensor(real), None)
            state, m = train_step_impl(cfg, state, batch, z=torch.tensor(z),
                                       mesh=mesh, draws=draws_torch(draws))
            metrics.append({k: float(v) for k, v in m.items()})
            snaps.append(state_snapshot(state))
        out[name, dp, div] = (metrics, snaps)
    return out


# The loop's writers, counted per rank by train_jobs_worker.
LOOP_WRITERS = ("save_checkpoint", "save_config", "_write_dataset_marker",
                "_write_best_marker")


def train_jobs_worker(jobs):
    """Each job ``(name, fn, cfg, kwargs)``, in order, under the group on
    the CPU: ``fn`` "train" (``train(cfg, echo=False, **kwargs)``) or
    "dataset" (``train_from_dataset(cfg, **kwargs)``).  Per job: the
    history rows (or the last row) without ``steps_per_sec``, the state
    snapshot, and the calls this rank made to each of LOOP_WRITERS; or
    ``("error", message)`` for a ValueError."""
    from ndivplanning_tpu_torch.train import loop

    calls = {}

    def counted(fn, name):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    saved = {"save_checkpoint": loop.ckpt.save_checkpoint}
    loop.ckpt.save_checkpoint = counted(saved["save_checkpoint"],
                                        "save_checkpoint")
    for name in LOOP_WRITERS[1:]:
        saved[name] = getattr(loop, name)
        setattr(loop, name, counted(saved[name], name))
    out = {}
    try:
        for name, fn, cfg, kwargs in jobs:
            calls.clear()
            try:
                if fn == "train":
                    state, rows = loop.train(cfg, echo=False, device="cpu",
                                             **kwargs)
                else:
                    state, last = loop.train_from_dataset(cfg, device="cpu",
                                                          **kwargs)
                    rows = [last]
            except ValueError as e:
                out[name] = ("error", str(e))
                continue
            rows = [{k: v for k, v in r.items() if k != "steps_per_sec"}
                    for r in rows]
            out[name] = (rows, state_snapshot(state), dict(calls))
    finally:
        loop.ckpt.save_checkpoint = saved.pop("save_checkpoint")
        for name, fn in saved.items():
            setattr(loop, name, fn)
    return out


def failing_worker():
    """Raises in every rank."""
    raise ValueError(f"rank {dist.get_rank()} fails on purpose")


def multi_rank_train_worker(jobs, runs):
    """train_jobs_worker's ``jobs``, then mesh_knob_worker's ``runs``, in
    one process group."""
    return {"train": train_jobs_worker(jobs),
            "knobs": mesh_knob_worker(runs)}
