"""The NDiv-GAN train step; counterpart of ``ndivplanning_tpu/train/step.py``.

Alternating updates as in the JAX step: D updates on detached fakes, then
G updates against the already-updated D with the adversarial loss plus
``ndiv_weight`` x NDiv, whose fused kernel runs once per step on the card.
Covers the default path of the goalcond, pointmass2d, imagecond and
planning presets; every stabiliser knob raises until it is ported.
"""

from __future__ import annotations

import torch

from ndivplanning_tpu_torch.data.tasks import Batch, make_task
from ndivplanning_tpu_torch.ops.gan_losses import get_gan_losses
from ndivplanning_tpu_torch.ops.ndiv import ndiv_loss
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
        "dp_shards/div_shards (mesh sharding)":
            cfg.dp_shards * cfg.div_shards > 1,
    }
    for name, on in knobs.items():
        if on:
            raise NotImplementedError(
                f"{name} is not ported to the torch train step yet")


def _ndiv(cfg: Config, z: torch.Tensor, traj: torch.Tensor) -> torch.Tensor:
    """NDiv loss on ``[B, k, ...]`` latents and trajectories."""
    b, k = z.shape[:2]
    return ndiv_loss(z, traj.reshape(b, k, -1), cfg.ndiv_alpha,
                     impl=cfg.ndiv_impl)


def train_step_impl(cfg: Config, state: TrainState, batch: Batch,
                    z: torch.Tensor | None = None):
    """One G+D+NDiv update of ``state`` in place.

    ``z [B, k, zdim]`` replaces the latent draw from ``state.rng``.
    Returns (state, metrics), metrics a dict of 0-d float32 tensors.
    """
    check_step_knobs(cfg)
    d_loss_fn, g_loss_fn = get_gan_losses(cfg.gan_loss)
    b = batch.real_traj.shape[0]
    if z is None:
        z = torch.randn((b, cfg.k, cfg.latent_dim), generator=state.rng,
                        device=state.rng.device)

    # ---------------- D update on detached fakes ----------------
    with torch.no_grad():
        tau_fake = state.g(batch.conditions, z)
    real_logits = state.d(batch.conditions, batch.real_traj)
    fake_logits = state.d(batch.conditions, tau_fake)
    d_loss = d_loss_fn(real_logits, fake_logits)
    state.d_opt.step(state.d, torch.autograd.grad(d_loss,
                                                  list(state.d.parameters())))

    # ADA overfitting heuristic r_t, tracked by every run.  Its centre is
    # the loss variant's decision boundary (0.5 for lsgan's scores).
    rt_center = 0.5 if cfg.gan_loss == "lsgan" else 0.0
    rt = torch.mean(torch.sign(real_logits.detach() - rt_center))
    a_d = cfg.ada_decay
    ada_r = a_d * state.ada["r"] + (1.0 - a_d) * rt
    a_corr = float(torch.tensor(1.0, dtype=torch.float32)
                   - f32_pow(a_d, state.step + 1))
    r_hat = ada_r / max(a_corr, _F32_TINY)
    state.ada = {"r": ada_r, "p": state.ada["p"]}

    # ---------------- G update against the updated D ----------------
    tau = state.g(batch.conditions, z)
    g_adv = g_loss_fn(state.d(batch.conditions, tau))
    g_ndiv = _ndiv(cfg, z, tau)
    g_total = g_adv + cfg.ndiv_weight * g_ndiv
    state.g_opt.step(state.g, torch.autograd.grad(g_total,
                                                  list(state.g.parameters())))

    # EMA of G (decay 0 reduces to a copy).
    with torch.no_grad():
        ema = list(state.g_ema.parameters())
        torch._foreach_mul_(ema, cfg.g_ema_decay)
        torch._foreach_add_(ema, torch._foreach_mul(
            list(state.g.parameters()), 1.0 - cfg.g_ema_decay))

    state.step += 1
    metrics = {
        "d_loss": d_loss.detach(),
        "g_adv": g_adv.detach(),
        "g_ndiv": g_ndiv.detach(),
        "g_total": g_total.detach(),
        "d_rt": rt,
        "d_rt_ema": r_hat,
    }
    return state, metrics


def train_step_fused(cfg: Config, state: TrainState):
    """Sample a batch on the device from ``state.rng``, then one update."""
    batch = make_task(cfg).sample(state.rng, cfg.batch_size)
    return train_step_impl(cfg, state, batch)
