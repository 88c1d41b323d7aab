"""The (dp, div) mesh over a torch.distributed process group, and its collectives; counterpart of ``ndivplanning_tpu/parallel/mesh.py``.

Axes as in the JAX package: ``dp`` shards the condition batch, ``div`` the
k diversity samples of each condition.  Ranks are laid out row-major, as
``np.asarray(devices).reshape(dp, div)`` lays out devices: rank =
dp_index * div + div_index, so the ranks of one dp index (a "div group")
are neighbours.

The caller initialises the default process group: gloo for CPU tensors,
NCCL for CUDA tensors, or gloo for CUDA tensors where several ranks share
one card (NCCL refuses that).  Gloo does not take every collective on CUDA
tensors, so under gloo a CUDA tensor goes through host memory, explicitly,
in the collectives below; compute stays on the card.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ndivplanning_tpu_torch.utils.config import Config

DP_AXIS = "dp"
DIV_AXIS = "div"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(dp, div)`` layout of the world's ranks, seen from one rank."""

    dp: int
    div: int
    dp_index: int
    div_index: int
    world: dist.ProcessGroup
    # The ranks that share this rank's dp index.
    div_group: dist.ProcessGroup

    @property
    def shape(self) -> dict[str, int]:
        return {DP_AXIS: self.dp, DIV_AXIS: self.div}


def make_mesh(dp: int | None = None, div: int = 1,
              cfg: Config | None = None) -> Mesh:
    """This rank's ``(dp, div)`` mesh over the default process group.

    ``cfg`` gives ``(cfg.dp_shards, cfg.div_shards)``; with neither, every
    rank goes on the ``dp`` axis.  Every rank must call this, with the same
    shape: each rank creates every div group, in the same order.
    """
    if cfg is not None:
        dp, div = cfg.dp_shards, cfg.div_shards
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the default process group: call "
            "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // div
    if dp < 1 or div < 1 or dp * div != world:
        raise ValueError(f"mesh ({dp}x{div}) needs {dp * div} ranks, the "
                         f"process group has {world}")
    div_group = None
    for i in range(dp):
        group = dist.new_group(list(range(i * div, (i + 1) * div)))
        if i == rank // div:
            div_group = group
    return Mesh(dp, div, rank // div, rank % div, dist.group.WORLD,
                div_group)


# ------------------------------------------------------------ collectives


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group``, in place; every rank gets the same bits."""
    if _via_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of ``group``, in place."""
    if _via_host(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    src = t.detach().cpu() if _via_host(t, group) else t.detach()
    src = src.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def flat_(tensors, collective) -> None:
    """Apply an in-place ``collective`` to a list of same-dtype tensors as
    one flat buffer (one call instead of one per tensor), in place."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
