"""Trajectory generator and discriminator MLPs; counterpart of ``ndivplanning_tpu/models/mlp.py``.

Layouts follow the JAX modules: the condition embedding is concatenated
before the latent (``[cond_embed, z]``) or the flattened trajectory
(``[cond_embed, flat_traj]``), and the k samples fold into the batch axis
before the dense stack.

``dtype`` is the compute dtype, as flax's ``Dense(dtype=...)``: parameters
stay float32 and each layer casts its input, weight and bias to ``dtype``,
rounds the product to it and then adds the bias (:func:`linear`).  The
outputs (trajectories, logits, features) come back as float32.

``spectral_norm`` (D only) swaps each of D's dense layers, its head too,
for :class:`SNDense`, as the JAX ``Discriminator(spectral_norm=True)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def lecun_normal_(layer: nn.Linear | nn.Conv2d,
                  generator: torch.Generator | None) -> None:
    """flax's default Dense and Conv init: truncated-normal weights of
    variance 1/fan_in (cut at 2 sigma), zero bias.  fan_in is the inputs
    of one output unit (in_channels x kernel area for a conv)."""
    fan_in = layer.weight[0].numel()
    # Std of a unit normal truncated to [-2, 2]; dividing by it restores
    # unit variance after truncation, as jax.nn.initializers does.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std,
                              b=2.0 * std, generator=generator)
        layer.bias.zero_()


class SNDense(nn.Linear):
    """A dense layer with spectral normalisation, ``y = x @ (W / sigma) + b``,
    as the JAX ``SNDense``: sigma is estimated on every call by
    ``SN_ITERS`` power iterations from the fixed start vector
    ``u = 1 / sqrt(in_dim)``, in float32, with no state kept between calls
    (``torch.nn.utils.spectral_norm`` keeps a ``u`` buffer and runs one
    iteration a call: another function and another checkpoint schema).
    ``u`` and ``v`` carry no gradient; ``sigma = u W v`` does."""

    SN_ITERS = 15

    def normalized_weight(self) -> torch.Tensor:
        """``W / (sigma + 1e-12)`` in float32, ``[out, in]``."""
        w = self.weight.float()  # [out, in], the flax kernel transposed
        with torch.no_grad():
            u = torch.full((w.shape[1],), 1.0 / math.sqrt(w.shape[1]),
                           dtype=torch.float32, device=w.device)
            for _ in range(self.SN_ITERS):
                v = w @ u
                v = v / (torch.linalg.vector_norm(v) + 1e-12)
                u = w.t() @ v
                u = u / (torch.linalg.vector_norm(u) + 1e-12)
        sigma = (w @ u) @ v  # u^T W v in the flax kernel's layout
        return self.weight / (sigma + 1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.normalized_weight(), self.bias)


def dense(in_dim: int, out_dim: int, generator: torch.Generator | None,
          spectral_norm: bool = False) -> nn.Linear:
    layer = (SNDense if spectral_norm else nn.Linear)(in_dim, out_dim)
    lecun_normal_(layer, generator)
    return layer


def linear(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` in ``dtype`` as flax computes ``Dense(dtype=dtype)``:
    the product rounded to ``dtype``, then the bias added in it.  An
    :class:`SNDense` normalises its weight in float32 first."""
    if dtype == torch.float32:
        return layer(x)
    weight = (layer.normalized_weight() if isinstance(layer, SNDense)
              else layer.weight)
    return (torch.matmul(x.to(dtype), weight.to(dtype).t())
            + layer.bias.to(dtype))


class MLPTrunk(nn.Module):
    """Dense-ReLU trunk shared by G and D; casts its input to ``dtype``."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 spectral_norm: bool = False):
        super().__init__()
        dims = [in_dim, *hidden]
        self.compute_dtype = dtype
        self.layers = nn.ModuleList(
            dense(a, b, generator, spectral_norm)
            for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for layer in self.layers:
            x = F.relu(linear(layer, x, self.compute_dtype))
        return x


def _with_condition(cond_embed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``[cond_embed, x]`` with the embedding broadcast over x's k axis."""
    if cond_embed.shape[-1] == 0:
        return x
    b, k = x.shape[:2]
    c = cond_embed[:, None, :].expand(b, k, cond_embed.shape[-1])
    return torch.cat([c, x], dim=-1)


class Generator(nn.Module):
    """``G(cond_embed [B, C], z [B, k, zdim]) -> [B, k, horizon, state_dim]``."""

    def __init__(self, cond_dim: int, latent_dim: int, horizon: int,
                 state_dim: int = 2, hidden: Sequence[int] = (256, 256),
                 output: str = "linear",
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output not in ("linear", "sigmoid"):
            raise ValueError(f"unknown output activation {output!r}")
        self.horizon, self.state_dim, self.output = horizon, state_dim, output
        self.trunk = MLPTrunk(cond_dim + latent_dim, hidden, generator, dtype)
        self.head = dense(hidden[-1], horizon * state_dim, generator)

    def forward(self, cond_embed: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
        b, k, _ = z.shape
        x = _with_condition(cond_embed, z).reshape(b * k, -1)
        x = linear(self.head, self.trunk(x), self.trunk.compute_dtype).float()
        if self.output == "sigmoid":
            x = torch.sigmoid(x)
        return x.reshape(b, k, self.horizon, self.state_dim)


class Discriminator(nn.Module):
    """``D(cond_embed, traj) -> logit`` for ``traj [B, H, S]`` or ``[B, k, H, S]``."""

    def __init__(self, cond_dim: int, traj_dim: int,
                 hidden: Sequence[int] = (256, 256),
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32,
                 spectral_norm: bool = False):
        super().__init__()
        self.trunk = MLPTrunk(cond_dim + traj_dim, hidden, generator, dtype,
                              spectral_norm)
        self.head = dense(hidden[-1], 1, generator, spectral_norm)

    def forward(self, cond_embed: torch.Tensor, traj: torch.Tensor,
                return_features: bool = False):
        """With ``return_features=True`` also returns the trunk's last hidden
        layer, ``[*lead, hidden[-1]]``."""
        if traj.dim() == 4:  # [B, k, H, S]: per-sample conditioning
            b, k = traj.shape[:2]
            x = _with_condition(cond_embed, traj.reshape(b, k, -1))
            x = x.reshape(b * k, -1)
            lead = (b, k)
        else:  # [B, H, S]
            b = traj.shape[0]
            x = traj.reshape(b, -1)
            if cond_embed.shape[-1] > 0:
                x = torch.cat([cond_embed, x], dim=-1)
            lead = (b,)
        feats = self.trunk(x)
        logit = linear(self.head, feats,
                       self.trunk.compute_dtype).float().reshape(*lead)
        if return_features:
            return logit, feats.float().reshape(*lead, feats.shape[-1])
        return logit
