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



def failing_worker():
    """Raises in every rank."""
    raise ValueError(f"rank {dist.get_rank()} fails on purpose")
