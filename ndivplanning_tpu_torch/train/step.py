"""The NDiv-GAN train step; counterpart of ``ndivplanning_tpu/train/step.py``.

Alternating updates as in the JAX step: D updates on detached fakes, then
G updates against the already-updated D with the adversarial loss plus
``ndiv_weight`` x NDiv, whose fused kernel runs once per step on the card.
Covers the default path of the goalcond, pointmass2d, imagecond,
planning and pod_dp presets, unsharded or over a (dp, div) mesh of
torch.distributed ranks, in float32 or bf16 compute; every stabiliser
knob raises until it is ported.
"""

from __future__ import annotations

import torch

from ndivplanning_tpu_torch.data.tasks import Batch, make_task
from ndivplanning_tpu_torch.ops.gan_losses import get_gan_losses
from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss
from ndivplanning_tpu_torch.parallel.mesh import Mesh, all_reduce_sum_, flat_
from ndivplanning_tpu_torch.train.state import (
    TrainState,
    check_model_knobs,
    check_optimizer_knobs,
    f32_pow,
)
from ndivplanning_tpu_torch.utils.config import Config

_F32_TINY = torch.finfo(torch.float32).tiny


def check_step_knobs(cfg: Config) -> None:
    """Raise ``NotImplementedError`` naming the first unported knob set."""
    check_model_knobs(cfg)
    check_optimizer_knobs(cfg)
    knobs = {
        "instance_noise_sigma": cfg.instance_noise_sigma > 0,
        "diffaug": bool(cfg.diffaug),
        "ada_target": cfg.ada_target > 0,
        "r1_weight": cfg.r1_weight > 0,
        "lecam_weight": cfg.lecam_weight > 0,
        "topk_g_fraction": cfg.topk_g_fraction > 0,
        "feature_matching_weight": cfg.feature_matching_weight > 0,
        "div_floor": cfg.div_floor > 0,
        "d_reset_every": cfg.d_reset_every > 0,
        "remat": cfg.remat,
    }
    for name, on in knobs.items():
        if on:
            raise NotImplementedError(
                f"{name} is not ported to the torch train step yet")


def _ndiv(cfg: Config, z: torch.Tensor, traj: torch.Tensor,
          mesh: Mesh | None = None) -> torch.Tensor:
    """NDiv loss on ``[B, k, ...]`` latents and trajectories.

    With a mesh (authoritative, even a 1x1 one) the inputs are this rank's
    blocks and the result is this rank's share of the global loss, from
    ``parallel/sharded_step.py``: "pallas", and "auto" on CUDA tensors, go
    through the fused kernel's call site, and "jnp" (and "auto" on the CPU)
    through the row-block strategy, as the JAX package dispatches.
    Without a mesh the inputs are the global batch, whatever dp_shards and
    div_shards say, and ``ndiv_loss`` serves it: the fused kernel on the
    card, the reference on the CPU (the JAX step takes the reference for
    such a config on every backend).
    """
    b, k = z.shape[:2]
    x = traj.reshape(b, k, -1)
    if mesh is None:
        return ndiv_loss(z, x, cfg.ndiv_alpha, impl=cfg.ndiv_impl)
    from ndivplanning_tpu_torch.parallel.sharded_step import (
        ndiv_share_sharded,
    )

    if cfg.ndiv_impl not in ("auto", "pallas", "jnp"):
        raise ValueError(f"unknown ndiv_impl {cfg.ndiv_impl!r}; choose from "
                         "'auto', 'pallas', 'jnp'")
    fused = cfg.ndiv_impl == "pallas" or (cfg.ndiv_impl == "auto"
                                          and z.is_cuda)
    return ndiv_share_sharded(z, x, cfg.ndiv_alpha, mesh,
                              impl="pallas" if fused else "jnp")


def _local_block(batch: Batch, z: torch.Tensor, mesh: Mesh):
    """This rank's conditions and reals ``[dp slice]`` and latents
    ``[dp slice, div slice]`` of the global batch and z."""
    b, k = z.shape[:2]
    if b % mesh.dp or k % mesh.div:
        raise ValueError(f"batch {b} and k={k} must divide over the "
                         f"({mesh.dp}x{mesh.div}) mesh")
    bl, kl = b // mesh.dp, k // mesh.div
    rows = slice(mesh.dp_index * bl, (mesh.dp_index + 1) * bl)
    cols = slice(mesh.div_index * kl, (mesh.div_index + 1) * kl)
    return (batch.conditions[rows], batch.real_traj[rows],
            z[rows, cols].contiguous())


def train_step_impl(cfg: Config, state: TrainState, batch: Batch,
                    z: torch.Tensor | None = None, mesh: Mesh | None = None):
    """One G+D+NDiv update of ``state`` in place.

    ``z [B, k, zdim]`` replaces the latent draw from ``state.rng``.
    With a ``mesh`` (``parallel/mesh.py``) this is the explicit form of the
    JAX step under GSPMD: ``batch`` and ``z`` are global and every rank
    keeps its block of them; its losses are its shares of the global ones,
    which sum over the ranks to the unsharded objective.  The blocks divide
    the batch and k evenly, so a GAN term's share is its local mean over
    the world size (a real logit, replicated over the div group, counts
    1/div on each of its ranks), and NDiv's is the call site's partial
    over the global pair count.  D's and G's grads are summed over the
    world before every rank's identical Adam step, and the metrics are the
    summed shares.
    Returns (state, metrics), metrics a dict of 0-d float32 tensors.
    """
    check_step_knobs(cfg)
    d_loss_fn, g_loss_fn = get_gan_losses(cfg.gan_loss)
    b = batch.real_traj.shape[0]
    if z is None:
        z = torch.randn((b, cfg.k, cfg.latent_dim), generator=state.rng,
                        device=state.rng.device)
    if mesh is None:
        conditions, real = batch.conditions, batch.real_traj
    else:
        conditions, real, z = _local_block(batch, z, mesh)

    def share(loss):
        return loss if mesh is None else loss / (mesh.dp * mesh.div)

    def world_sum_(tensors):
        if mesh is not None:
            flat_(tensors, lambda t: all_reduce_sum_(t, mesh.world))
        return tensors

    # ---------------- D update on detached fakes ----------------
    with torch.no_grad():
        tau_fake = state.g(conditions, z)
    real_logits = state.d(conditions, real)
    fake_logits = state.d(conditions, tau_fake)
    d_loss = share(d_loss_fn(real_logits, fake_logits))
    d_grads = torch.autograd.grad(d_loss, list(state.d.parameters()))
    state.d_opt.step(state.d, world_sum_(list(d_grads)))

    # ---------------- G update against the updated D ----------------
    tau = state.g(conditions, z)
    g_adv = share(g_loss_fn(state.d(conditions, tau)))
    g_ndiv = _ndiv(cfg, z, tau, mesh)
    g_total = g_adv + cfg.ndiv_weight * g_ndiv
    g_grads = torch.autograd.grad(g_total, list(state.g.parameters()))
    state.g_opt.step(state.g, world_sum_(list(g_grads)))

    # EMA of G (decay 0 reduces to a copy).
    with torch.no_grad():
        ema = list(state.g_ema.parameters())
        torch._foreach_mul_(ema, cfg.g_ema_decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            list(state.g.parameters()), 1.0 - cfg.g_ema_decay))

    # ADA overfitting heuristic r_t, tracked by every run.  Its centre is
    # the loss variant's decision boundary (0.5 for lsgan's scores).
    rt_center = 0.5 if cfg.gan_loss == "lsgan" else 0.0
    rt = share(torch.mean(torch.sign(real_logits.detach() - rt_center)))
    metrics = {"d_loss": d_loss.detach(), "g_adv": g_adv.detach(),
               "g_ndiv": g_ndiv.detach(), "g_total": g_total.detach(),
               "d_rt": rt}
    if mesh is not None:
        summed = world_sum_([torch.stack(list(metrics.values()))])[0]
        metrics = dict(zip(metrics, summed.unbind()))
    a_d = cfg.ada_decay
    ada_r = a_d * state.ada["r"] + (1.0 - a_d) * metrics["d_rt"]
    a_corr = float(torch.tensor(1.0, dtype=torch.float32)
                   - f32_pow(a_d, state.step + 1))
    metrics["d_rt_ema"] = ada_r / max(a_corr, _F32_TINY)
    state.ada = {"r": ada_r, "p": state.ada["p"]}
    state.step += 1
    return state, metrics


def train_step_fused(cfg: Config, state: TrainState):
    """Sample a batch on the device from ``state.rng``, then one update."""
    batch = make_task(cfg).sample(state.rng, cfg.batch_size)
    return train_step_impl(cfg, state, batch)


def train_chunk(cfg: Config, state: TrainState, n_steps: int):
    """``n_steps`` steps of :func:`train_step_fused`; returns (state, the
    metrics stacked ``[n_steps]`` as device tensors).

    Nothing here reads a value on the host, so the host queues the chunk's
    steps without waiting for the card; the caller reads the metrics once,
    at a boundary.  The steps run one by one, so a chunk is bitwise the
    same steps taken singly."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    rows = []
    for _ in range(n_steps):
        state, metrics = train_step_fused(cfg, state)
        rows.append(metrics)
    return state, {key: torch.stack([m[key] for m in rows]) for key in rows[0]}
