"""Attention-based trajectory generator; counterpart of ``ndivplanning_tpu/models/transformer.py``.

The trajectory is ``horizon`` waypoint tokens, a learned positional
embedding shifted per sample by a dense map of ``[cond_embed, z]``, refined
by pre-LN self-attention blocks.  The call signature is
:class:`models.mlp.Generator`'s, so ``ConditionedGenerator`` swaps families
with no other change.

flax's defaults, kept here: LayerNorm's epsilon is 1e-6 and its statistics
(``E[x^2] - E[x]^2``) and affine map run in float32 whatever the compute
dtype; ``gelu`` is the tanh approximation; attention divides the query by
``sqrt(head_dim)`` in the compute dtype and takes the softmax in it.
Attention is written out as matmul, softmax, matmul: the fused kernels of
``scaled_dot_product_attention`` sum in an order that can change between
runs, and the port keeps the JAX package's bitwise run-to-run promise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ndivplanning_tpu_torch.models.mlp import _with_condition, dense, linear

LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm(dtype=dtype)`` over the last axis."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + LN_EPS) * self.weight
        return ((x - mean) * mul + self.bias).to(self.compute_dtype)


class SelfAttention(nn.Module):
    """flax's ``nn.MultiHeadDotProductAttention(num_heads=heads,
    qkv_features=dim)`` on one sequence: ``query``, ``key``, ``value`` and
    ``out`` are its four dense maps, with the heads flattened into the
    feature axis (head-major)."""

    def __init__(self, dim: int, heads: int,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} must be divisible by heads {heads}")
        self.heads, self.compute_dtype = heads, dtype
        # sqrt(head_dim) in float32, then rounded to the compute dtype.
        self.scale = float(torch.tensor(math.sqrt(dim // heads),
                                        dtype=torch.float32).to(dtype))
        self.query, self.key, self.value, self.out = (
            dense(dim, dim, generator) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, dim = x.shape
        dtype, hd = self.compute_dtype, dim // self.heads

        def heads(layer):  # [n, t, dim] -> [n, heads, t, hd]
            return linear(layer, x, dtype).reshape(n, t, self.heads,
                                                   hd).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        q = q / self.scale
        weights = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        o = (weights @ v).transpose(1, 2).reshape(n, t, dim)
        return linear(self.out, o, dtype)


class _Block(nn.Module):
    """Pre-LN residual block: self-attention, then a 4x GELU MLP."""

    def __init__(self, dim: int, heads: int,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = SelfAttention(dim, heads, generator, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.fc1 = dense(dim, 4 * dim, generator)
        self.fc2 = dense(4 * dim, dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        x = x + self.attn(self.norm1(x))
        h = F.gelu(linear(self.fc1, self.norm2(x), dtype), approximate="tanh")
        return x + linear(self.fc2, h, dtype)


class TrajectoryTransformer(nn.Module):
    """``G(cond_embed [B, C], z [B, k, zdim]) -> [B, k, horizon, state_dim]``."""

    def __init__(self, cond_dim: int, latent_dim: int, horizon: int,
                 state_dim: int = 2, dim: int = 128, layers: int = 2,
                 heads: int = 4, output: str = "linear",
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output not in ("linear", "sigmoid"):
            raise ValueError(f"unknown output activation {output!r}")
        self.horizon, self.state_dim, self.output = horizon, state_dim, output
        self.compute_dtype = dtype
        self.pos_embed = nn.Parameter(torch.empty(horizon, dim))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)
        self.shift = dense(cond_dim + latent_dim, dim, generator)
        self.blocks = nn.ModuleList(_Block(dim, heads, generator, dtype)
                                    for _ in range(layers))
        self.norm = LayerNorm(dim, dtype)
        self.head = dense(dim, state_dim, generator)

    def forward(self, cond_embed: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
        b, k, _ = z.shape
        dtype = self.compute_dtype
        ctx = _with_condition(cond_embed, z).reshape(b * k, -1).to(dtype)
        # The learned waypoint tokens, shifted per sample by (cond, z).
        x = self.pos_embed.to(dtype)[None] + linear(self.shift, ctx,
                                                    dtype)[:, None, :]
        for block in self.blocks:
            x = block(x)
        x = linear(self.head, self.norm(x), dtype).float()
        if self.output == "sigmoid":
            x = torch.sigmoid(x)
        return x.reshape(b, k, self.horizon, self.state_dim)
