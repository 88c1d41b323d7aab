"""Data-parallel and diversity-sample-sharded training; counterpart of ``ndivplanning_tpu/parallel/sharded_step.py``.

The JAX package jits its one train step over the mesh and lets GSPMD
insert the collectives.  The port has no implicit sharding, so the same
program is written out: :func:`make_sharded_train_step` runs
``train/step.py::train_step_impl`` with a mesh, where every rank draws the
global batch and z from its replicated generator, keeps its dp slice of
the conditions and its (dp, div) slice of the samples, builds a local
objective whose sum over the ranks is the global one, and sums the grads
over the world before the identical Adam update on every rank.

:func:`ndiv_loss_sharded` is the explicit-collective NDiv for k sharded
over ``div`` and conditions over ``dp``, with the JAX package's two
strategies:

- ``impl="jnp"``: each rank computes only its own rows of the pairwise
  and hinge matrices, in plain torch.
- ``impl="pallas"``: the call site of the fused kernel
  (``_ndiv_sharded_pallas``).  Each rank gathers its dp slice's full k
  over the div group, takes its own chunk of the gathered conditions (the
  k x k math is block-diagonal per condition, so a batch split is exact),
  and runs ``ndiv_loss_fused`` on it: on CUDA tensors the hand-written
  ``ndiv_joint`` kernel, once per rank per differentiated step.

Both end in a sum over the world and a division by the global pair count.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ndivplanning_tpu_torch.data.tasks import make_task
from ndivplanning_tpu_torch.ops.ndiv_cuda import ndiv_loss_fused
from ndivplanning_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_reduce_sum_,
    broadcast_,
    flat_,
    make_mesh,
)
from ndivplanning_tpu_torch.train.state import TrainState
from ndivplanning_tpu_torch.utils.config import Config

IMPLS = ("jnp", "pallas")


class _GatherK(torch.autograd.Function):
    """All-gather along k over the div group.  Every rank of the group
    reads this rank's samples, so the grad of this rank's slice is the sum
    of the group's grads of it: a reduce-scatter, done as an all-reduce
    and a slice (gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh, ctx.k_local = mesh, t.shape[1]
        return all_gather_cat(t, mesh.div_group, dim=1)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_sum_(g.contiguous().clone(), ctx.mesh.div_group)
        lo = ctx.mesh.div_index * ctx.k_local
        return g[:, lo:lo + ctx.k_local].contiguous(), None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the world.  The result is one value replicated on every
    rank, so its cotangent passes through unchanged (psum's transpose)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum_(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def world_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, the same bits on every rank,
    differentiable: for a value every rank then holds whole, each rank's
    cotangent is that of its own summand."""
    return _AllReduceSum.apply(t, group)


def gather_k(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[b, k/div, ...]`` -> ``[b, k, ...]`` over the div group,
    differentiable."""
    return t if mesh.div == 1 else _GatherK.apply(t, mesh)


def ndiv_rank_partial(z_full: torch.Tensor, x_full: torch.Tensor,
                      alpha: float, div_index: int,
                      div: int) -> torch.Tensor:
    """One div rank's hinge sum at the sharded call site.

    ``z_full [b, k, dz]`` and ``x_full [b, k, dx]`` are the dp slice's
    gathered samples.  The conditions are zero-padded to ``chunk * div``
    (a zero condition adds no hinge and no grad) and the rank takes chunk
    ``div_index``, ``chunk = ceil(b / div)``; the fused loss, a mean over
    the chunk's pairs, times that pair count is the chunk's hinge sum.
    """
    b, k = z_full.shape[:2]
    chunk = -(-b // div)
    pad = chunk * div - b
    if pad:
        z_full = F.pad(z_full, (0, 0, 0, 0, 0, pad))
        x_full = F.pad(x_full, (0, 0, 0, 0, 0, pad))
    lo = div_index * chunk
    z_my, x_my = z_full[lo:lo + chunk], x_full[lo:lo + chunk]
    return ndiv_loss_fused(z_my, x_my, alpha) * (chunk * k * (k - 1))


def _row_block(rows: torch.Tensor, full: torch.Tensor, row_offset: int):
    """Normalised distances ``[b, k_local, k]`` from this rank's rows to all
    k columns, and the self-pair mask ``[k_local, k]``."""
    k_local, k = rows.shape[1], full.shape[1]
    sq_r = torch.sum(rows * rows, dim=-1)
    sq_c = torch.sum(full * full, dim=-1)
    gram = torch.matmul(rows, full.transpose(-1, -2))
    d2 = torch.clamp(sq_r[..., :, None] + sq_c[..., None, :] - 2.0 * gram,
                     min=0.0)
    cols = torch.arange(k, device=rows.device)[None, :]
    own = torch.arange(k_local, device=rows.device)[:, None] + row_offset
    self_mask = cols == own
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    d2 = torch.where(self_mask, zero, d2)
    pos = d2 > 0.0
    d = torch.where(pos, torch.sqrt(torch.where(pos, d2, torch.ones_like(d2))),
                    zero)
    r = torch.sum(d, dim=-1, keepdim=True)
    r_pos = r > 0.0
    n = torch.where(r_pos, d / torch.where(r_pos, r, torch.ones_like(r)), zero)
    return n, self_mask


def _rows_partial(z: torch.Tensor, x: torch.Tensor, alpha: float,
                  mesh: Mesh) -> torch.Tensor:
    """The hinge sum over this rank's rows, all k columns ("jnp")."""
    offset = mesh.div_index * z.shape[1]
    nz, self_mask = _row_block(z, gather_k(z, mesh), offset)
    nx, _ = _row_block(x, gather_k(x, mesh), offset)
    # where(slack > 0), not clamp: the strict-> hinge subgradient of
    # ops/ndiv.py.
    slack = alpha * nz - nx
    zero = torch.zeros((), dtype=slack.dtype, device=slack.device)
    hinge = torch.where(slack > 0.0, slack, zero)
    return torch.sum(torch.where(self_mask, zero, hinge))


def ndiv_share_sharded(z: torch.Tensor, x: torch.Tensor, alpha: float,
                       mesh: Mesh, impl: str = "jnp") -> torch.Tensor:
    """This rank's share of the global NDiv loss: its partial hinge sum
    over the global pair count.  The shares of all ranks sum to the loss.

    ``z [B/dp, k/div, dz]`` and ``x [B/dp, k/div, dx]`` are this rank's
    blocks.  Differentiable: the grad of a gathered block is summed over
    the div group, so the grads of the ranks' shares sum to the loss's.
    """
    if z.shape[:2] != x.shape[:2]:
        raise ValueError(f"z and x must agree on leading/k dims, got "
                         f"{tuple(z.shape)} vs {tuple(x.shape)}")
    b, k = z.shape[0] * mesh.dp, z.shape[1] * mesh.div
    m = b * k * (k - 1)
    if impl == "pallas":
        partial = ndiv_rank_partial(gather_k(z, mesh), gather_k(x, mesh),
                                    alpha, mesh.div_index, mesh.div)
    elif impl == "jnp":
        partial = _rows_partial(z, x, alpha, mesh)
    else:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    return partial / m


def ndiv_loss_sharded(z: torch.Tensor, x: torch.Tensor, alpha: float,
                      mesh: Mesh, impl: str = "jnp") -> torch.Tensor:
    """NDiv loss with k sharded over ``div`` and conditions over ``dp``.

    Takes this rank's blocks, as :func:`ndiv_share_sharded`, and returns
    the global loss on every rank: the shares summed over the world.  Its
    value and its grads (each rank's for its own blocks) equal
    ``ndiv_loss_reference`` on the unsharded arrays.
    """
    return world_sum(ndiv_share_sharded(z, x, alpha, mesh, impl), mesh.world)


def _state_tensors(state: TrainState):
    """Every tensor of the train state that the replicas must agree on."""
    tensors = [*state.g.parameters(), *state.d.parameters(),
               *state.g_ema.parameters(), *state.ada.values(),
               *state.lecam_ema.values()]
    for opt in (state.g_opt, state.d_opt):
        tensors += [*opt.mu.values(), *opt.nu.values()]
    return tensors


@torch.no_grad()
def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Replicate the train state across the mesh, in place: rank 0's
    params, optimizer state, EMA, counters and generator state on every
    rank, so that replicas start bitwise equal whatever each one built."""
    flat_(_state_tensors(state), lambda t: broadcast_(t, mesh.world))
    device = state.rng.device
    counters = torch.tensor([state.step, state.g_opt.count,
                             state.d_opt.count], device=device)
    broadcast_(counters, mesh.world)
    state.step, state.g_opt.count, state.d_opt.count = counters.tolist()
    rng = state.rng.get_state().to(device)
    state.rng.set_state(broadcast_(rng, mesh.world).cpu())
    return state


def make_sharded_train_step(cfg: Config, mesh: Mesh | None = None,
                            chunk: int = 1):
    """The data-parallel train step for ``cfg``: returns (step_fn, mesh).

    ``step_fn(state) -> (state, metrics)`` samples the global batch from
    ``state.rng`` and takes ``chunk`` steps, each through
    ``train_step_impl`` on the mesh; metrics are stacked ``[chunk]``, as
    the JAX step's scan stacks them.  ``mesh`` defaults to
    ``make_mesh(cfg=cfg)``.
    """
    # Imported here: train/step.py reaches this package through its mesh.
    from ndivplanning_tpu_torch.train.step import train_step_impl

    if mesh is None:
        mesh = make_mesh(cfg=cfg)
    task = make_task(cfg)

    def step(state: TrainState):
        history = []
        for _ in range(chunk):
            batch = task.sample(state.rng, cfg.batch_size)
            state, metrics = train_step_impl(cfg, state, batch, mesh=mesh)
            history.append(metrics)
        return state, {key: torch.stack([m[key] for m in history])
                       for key in history[0]}

    return step, mesh
