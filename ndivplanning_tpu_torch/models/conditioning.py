"""Condition encoders; counterpart of ``ndivplanning_tpu/models/conditioning.py``.

Modes "none" (a ``[B, 0]`` embedding), "startgoal" (``[B, 4]`` start xy,
goal xy -> MLP embedding) and "image" (``[B, S, S, 3]`` scene images ->
conv embedding, ``models/encoder.py``).  ``dtype`` is the compute dtype:
the embedding comes out in it, as from the flax module.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ndivplanning_tpu_torch.data.scenes import IMAGE_CHANNELS
from ndivplanning_tpu_torch.models.encoder import SceneEncoderCNN
from ndivplanning_tpu_torch.models.mlp import dense, linear

MODES = ("none", "startgoal", "image")


class ConditionEncoder(nn.Module):
    """Maps raw conditions to a ``[B, C]`` embedding (C = 0 for "none")."""

    def __init__(self, mode: str, embed_dim: int = 64,
                 hidden: Sequence[int] = (64,),
                 encoder_features: Sequence[int] = (16, 32, 64),
                 image_size: int = 32,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown conditioning mode {mode!r}")
        self.mode, self.compute_dtype = mode, dtype
        self.embed_dim = 0 if mode == "none" else embed_dim
        self.layers = nn.ModuleList()
        if mode == "startgoal":
            dims = [4, *hidden, embed_dim]
            self.layers.extend(dense(a, b, generator)
                               for a, b in zip(dims[:-1], dims[1:]))
        elif mode == "image":
            self.cnn = SceneEncoderCNN(embed_dim, encoder_features,
                                       image_size, IMAGE_CHANNELS, generator,
                                       dtype)

    def forward(self, conditions: torch.Tensor) -> torch.Tensor:
        if self.mode == "none":
            return conditions.new_zeros((conditions.shape[0], 0))
        if self.mode == "image":
            return self.cnn(conditions)
        x, dtype = conditions.to(self.compute_dtype), self.compute_dtype
        for layer in self.layers[:-1]:
            x = F.relu(linear(layer, x, dtype))
        return linear(self.layers[-1], x, dtype)
