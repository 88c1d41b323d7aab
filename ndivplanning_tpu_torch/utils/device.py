"""Device selection for the port's entry points (no JAX counterpart: JAX picks its backend globally)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a missing card raises, never a CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        # The JAX reference computes distances and matmuls at
        # Precision.HIGHEST; TF32 keeps ~3 decimal digits and would break
        # f32 parity, so full-precision f32 is pinned wherever the port
        # starts on the card.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bf16 products accumulate in float32 as XLA's do: no split-K
        # partial sums rounded to bf16.
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
            False)
        # The JAX package's step is bitwise repeatable; cuDNN's default
        # conv backward algorithms (the image encoder's) sum with atomics.
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return dev
