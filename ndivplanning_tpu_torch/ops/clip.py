"""``clip`` with the JAX package's derivative at its bounds.

``jnp.clip(x, lo, hi)`` is ``minimum(maximum(x, lo), hi)``, and
``jnp.maximum`` / ``jnp.minimum`` split a tie's derivative evenly, so
``jnp.clip`` has slope 0.5 at either bound; ``torch.clamp`` has slope 1
there.  The refiners differentiate the env dynamics (reverse mode for the
soft cost, forward mode for iLQR's Jacobians), and a saturated actuator or
a state resting on a wall sits exactly on its bound, so the two slopes
would give other gradients and other ``B_t``.

:func:`clip` is ``torch.clamp`` bitwise in value.  Where autograd records
(``torch.is_grad_enabled()``) it goes through an ``autograd.Function``
whose backward and ``jvp`` take JAX's slope: 1 inside, 0.5 on a bound, 0
outside (and 0 at NaN); it has a vmap rule, so ``torch.func`` transforms
compose over it.  Elsewhere it is the one ``torch.clamp`` launch.
"""

from __future__ import annotations

import torch


def _slope(x: torch.Tensor, lo: float | None,
           hi: float | None) -> torch.Tensor:
    """d clip / dx as JAX's ``minimum(maximum(x, lo), hi)`` has it."""
    if lo is None:
        inside, edge = x < hi, x == hi
    elif hi is None:
        inside, edge = x > lo, x == lo
    else:
        inside, edge = (x > lo) & (x < hi), (x == lo) | (x == hi)
    return torch.where(inside, 1.0, torch.where(edge, 0.5, 0.0)).to(x.dtype)


class _Clip(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, lo, hi = inputs
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.bounds = (lo, hi)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        return grad * _slope(x, *ctx.bounds), None, None

    @staticmethod
    def jvp(ctx, tangent, _lo, _hi):
        x, = ctx.saved_tensors
        return tangent * _slope(x, *ctx.bounds)


def clip(x: torch.Tensor, lo: float | None = None,
         hi: float | None = None) -> torch.Tensor:
    """``torch.clamp(x, lo, hi)`` (either bound may be None) whose
    derivative is ``jnp.clip``'s: 0.5 at a bound."""
    if torch.is_grad_enabled():
        return _Clip.apply(x, lo, hi)
    return torch.clamp(x, lo, hi)
