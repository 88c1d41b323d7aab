"""Train state: modules, Adam chains, generator, step; counterpart of ``ndivplanning_tpu/train/state.py``.

The port updates the state in place (parameters, Adam moments, EMA and
step counter), the PyTorch idiom, where the JAX step returns a new pytree.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch
from torch import nn

from ndivplanning_tpu_torch.models.conditioning import ConditionEncoder
from ndivplanning_tpu_torch.models.mlp import Discriminator, Generator
from ndivplanning_tpu_torch.models.transformer import TrajectoryTransformer
from ndivplanning_tpu_torch.utils.config import Config
from ndivplanning_tpu_torch.utils.device import resolve_device


_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    """The models' compute dtype; parameters, optimizer state and EMA stay
    float32 whatever it is."""
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(
            f"unknown compute_dtype {cfg.compute_dtype!r}; "
            f"choose from {sorted(_DTYPES)}") from None


G_ARCHS = ("mlp", "transformer")


def check_model_knobs(cfg: Config) -> None:
    """Raise ``ValueError`` for a generator family the JAX package does not
    know."""
    if cfg.g_arch not in G_ARCHS:
        raise ValueError(f"unknown g_arch {cfg.g_arch!r}; "
                         f"choose from {list(G_ARCHS)}")


def check_optimizer_knobs(cfg: Config) -> None:
    """Raise ``ValueError`` for an LR schedule the JAX package does not know."""
    lr_schedule(cfg, cfg.g_lr)


_SCHEDULES = ("constant", "cosine", "linear")


def _linear_lr(init: float, end: float, steps: int, count: int) -> float:
    """``optax.linear_schedule(init, end, steps)(count)`` in float32."""
    frac = np.float32(1) - (np.float32(min(max(count, 0), steps))
                            / np.float32(steps))
    return float(np.float32(init - end) * frac + np.float32(end))


def _cosine_lr(init: float, steps: int, alpha: float, count: int) -> float:
    """``optax.cosine_decay_schedule(init, steps, alpha)(count)`` in float32."""
    frac = np.float32(math.pi) * np.float32(min(count, steps)) / np.float32(
        steps)
    decay = np.float32(0.5) * (np.float32(1) + np.cos(frac))
    return float(np.float32(init)
                 * (np.float32(1 - alpha) * decay + np.float32(alpha)))


def _scheduled_lr(cfg: Config, peak: float, count: int) -> float:
    """The LR of the update at ``count`` (updates taken before it): linear
    warmup from 0 over ``warmup_steps``, then the main schedule over the
    remaining ``steps``, as ``optax.join_schedules`` joins them."""
    warmup = cfg.warmup_steps
    if count < warmup:
        return _linear_lr(0.0, peak, warmup, count)
    count -= warmup
    decay_steps = max(cfg.steps - warmup, 1)
    if cfg.lr_schedule == "cosine":
        return _cosine_lr(peak, decay_steps, cfg.lr_final_ratio, count)
    if cfg.lr_schedule == "linear":
        return _linear_lr(peak, peak * cfg.lr_final_ratio, decay_steps, count)
    return float(np.float32(peak))


def lr_schedule(cfg: Config, peak: float) -> float | Callable[[int], float]:
    """The LR schedule of one Adam chain, as the JAX package's
    ``lr_schedule``: the float ``peak`` for a constant LR without warmup,
    else a function of the update count.  The decay runs over
    ``cfg.steps``; a resumed run finds its place from the restored count."""
    if cfg.lr_schedule not in _SCHEDULES:
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; "
            f"choose from {list(_SCHEDULES)}")
    if cfg.lr_schedule == "constant" and cfg.warmup_steps == 0:
        return peak
    return functools.partial(_scheduled_lr, cfg, peak)


class ConditionedGenerator(nn.Module):
    """G = its own condition encoder + the ``g_arch`` family's generator
    (the MLP, or the transformer of ``models/transformer.py``)."""

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        check_model_knobs(cfg)
        dtype = compute_dtype(cfg)
        self.encoder = ConditionEncoder(
            cfg.conditioning, cfg.cond_embed_dim,
            encoder_features=cfg.encoder_features,
            image_size=cfg.image_size, generator=generator, dtype=dtype)
        if cfg.g_arch == "transformer":
            self.generator = TrajectoryTransformer(
                self.encoder.embed_dim, cfg.latent_dim, cfg.horizon,
                cfg.state_dim, cfg.g_tf_dim, cfg.g_tf_layers, cfg.g_tf_heads,
                cfg.generator_output, generator, dtype)
        else:
            self.generator = Generator(
                self.encoder.embed_dim, cfg.latent_dim, cfg.horizon,
                cfg.state_dim, cfg.g_hidden, cfg.generator_output, generator,
                dtype)

    def forward(self, conditions: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
        return self.generator(self.encoder(conditions), z)


class ConditionedDiscriminator(nn.Module):
    """D = its own condition encoder + MLP scorer (not shared with G),
    spectrally normalised under ``d_spectral_norm``."""

    def __init__(self, cfg: Config, generator: torch.Generator | None = None):
        super().__init__()
        check_model_knobs(cfg)
        dtype = compute_dtype(cfg)
        self.encoder = ConditionEncoder(
            cfg.conditioning, cfg.cond_embed_dim,
            encoder_features=cfg.encoder_features,
            image_size=cfg.image_size, generator=generator, dtype=dtype)
        self.discriminator = Discriminator(
            self.encoder.embed_dim, cfg.traj_dim, cfg.d_hidden, generator,
            dtype, cfg.d_spectral_norm)

    def forward(self, conditions: torch.Tensor, traj: torch.Tensor,
                return_features: bool = False):
        return self.discriminator(self.encoder(conditions), traj,
                                  return_features=return_features)


def f32_pow(base: float, n: int) -> float:
    """``base ** n`` in float32, as the JAX package computes it."""
    return float(torch.tensor(base, dtype=torch.float32)
                 ** torch.tensor(float(n), dtype=torch.float32))


@functools.lru_cache(maxsize=4096)
def bias_correction(b: float, count: int) -> float:
    """``1 - b ** count`` in float32, computed on the host once a count."""
    return float(torch.tensor(1.0, dtype=torch.float32) - f32_pow(b, count))


@torch.no_grad()
def adam_update(params: list, grads: list, mu: list, nu: list, count: int,
                lr: float, b1: float, b2: float, eps: float = 1e-8) -> None:
    """One ``optax.adam`` update of the tensors ``params`` in place, with
    their moments ``mu``, ``nu`` (updated in place too) and ``count``, the
    number of updates including this one.  The arithmetic of
    :class:`Adam` and of the refiners' Adam on latents and trajectories
    (``planning/grad_refine.py``, ``planning/trajopt.py``)."""
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(
        nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    bc1, bc2 = bias_correction(b1, count), bias_correction(b2, count)
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, den)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(params, upd)


class Adam:
    """Adam as ``optax.adam``: ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)``,
    bias corrections in float32, moments keyed by parameter name.

    ``lr`` is a float or a schedule ``count -> float``.  optax keeps the
    schedule's count in a state of its own and reads it before its
    increment, so the update that makes ``count`` n takes ``lr(n - 1)``."""

    def __init__(self, module: nn.Module, lr: float | Callable[[int], float],
                 b1: float, b2: float, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in module.named_parameters()}
        self.nu = {n: torch.zeros_like(p) for n, p in module.named_parameters()}

    @torch.no_grad()
    def step(self, module: nn.Module, grads) -> None:
        names, params = zip(*module.named_parameters())
        self.count += 1
        lr = self.lr(self.count - 1) if callable(self.lr) else self.lr
        adam_update(list(params), list(grads), [self.mu[n] for n in names],
                    [self.nu[n] for n in names], self.count, lr, self.b1,
                    self.b2, self.eps)


@dataclasses.dataclass
class TrainState:
    """Everything a training run is.  ``rng`` is the device generator every
    draw of the step (batch, latents) comes from."""

    step: int
    rng: torch.Generator
    g: ConditionedGenerator
    d: ConditionedDiscriminator
    g_opt: Adam
    d_opt: Adam
    # EMA of G's parameters (cfg.g_ema_decay > 0); equals G otherwise.
    g_ema: ConditionedGenerator
    # ADA controller state: the r_t EMA (tracked by every run) and p.
    ada: dict
    # LeCam anchor trackers (cfg.lecam_weight): EMAs of D's mean real and
    # fake logits, bias-corrected by ``step`` where they are read; zeros
    # while the knob is off.
    lecam_ema: dict


def gen_params(cfg: Config, state: TrainState) -> ConditionedGenerator:
    """The generator eval and planning should use: the EMA one when the
    config tracks it, the live one otherwise."""
    return state.g_ema if cfg.g_ema_decay > 0 else state.g


def build_models(cfg: Config, generator: torch.Generator | None = None):
    """(generator, discriminator) modules for a config."""
    return (ConditionedGenerator(cfg, generator),
            ConditionedDiscriminator(cfg, generator))


def create_train_state(cfg: Config, seed: int | None = None,
                       device=None) -> TrainState:
    """Initialise modules and optimizers from the config's seed.

    ``device=None`` means the CUDA card.  Weights are drawn on the CPU from
    one seeded generator, so they are the same on every device."""
    check_optimizer_knobs(cfg)
    device = resolve_device(device)
    seed = cfg.seed if seed is None else seed
    g, d = build_models(cfg, torch.Generator().manual_seed(seed))
    g, d = g.to(device), d.to(device)
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    g_opt, d_opt = build_optimizers(cfg, g, d)
    return TrainState(
        step=0, rng=rng, g=g, d=d, g_opt=g_opt, d_opt=d_opt,
        g_ema=copy.deepcopy(g).requires_grad_(False),
        ada=fresh_ada(device), lecam_ema=fresh_lecam_ema(device),
    )


def build_optimizers(cfg: Config, g: nn.Module, d: nn.Module):
    """Fresh (G, D) Adam chains at count 0 with the config's LR schedules."""
    return (Adam(g, lr_schedule(cfg, cfg.g_lr), cfg.adam_b1, cfg.adam_b2),
            Adam(d, lr_schedule(cfg, cfg.d_lr), cfg.adam_b1, cfg.adam_b2))


def fresh_ada(device) -> dict:
    """The ADA controller's state at its start: r_t EMA and p at 0."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"r": zero.clone(), "p": zero.clone()}


def fresh_lecam_ema(device) -> dict:
    """The LeCam trackers at their start: both logit EMAs at 0."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"real": zero.clone(), "fake": zero.clone()}
