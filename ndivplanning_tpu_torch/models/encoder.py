"""Conv scene encoder for image-conditioned generation; counterpart of ``ndivplanning_tpu/models/encoder.py``.

Strided 3x3 convs with ReLU, a flatten and a dense layer.  The convs are
plain ``nn.Conv2d`` (cuDNN on the card, with TF32 off as
``utils/device.py`` pins it).  Two layout points keep it equal to the flax
module:

- flax ``nn.Conv`` pads "SAME": at stride 2 on an even size that is 0
  before and 1 after on each spatial axis, not the symmetric 1 of
  ``padding=1``.  The padding is computed per layer from the input size.
- The public interface is NHWC and the flatten runs over NHWC order, as
  the JAX module flattens, so the dense weights carry over unchanged.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ndivplanning_tpu_torch.models.mlp import dense, lecun_normal_, linear

_STRIDE = 2
_KERNEL = 3


def _same_pad(size: int) -> tuple[int, int]:
    """(before, after) padding of flax "SAME" for one spatial axis."""
    total = max((math.ceil(size / _STRIDE) - 1) * _STRIDE + _KERNEL - size, 0)
    return total // 2, total - total // 2


class SceneEncoderCNN(nn.Module):
    """Occupancy image ``[B, H, W, C]`` -> embedding ``[B, embed_dim]``."""

    def __init__(self, embed_dim: int = 64,
                 features: Sequence[int] = (16, 32, 64),
                 image_size: int = 32, in_channels: int = 3,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        convs, channels, size = [], in_channels, image_size
        for f in features:
            conv = nn.Conv2d(channels, f, _KERNEL, stride=_STRIDE)
            lecun_normal_(conv, generator)
            convs.append(conv)
            channels, size = f, math.ceil(size / _STRIDE)
        self.convs = nn.ModuleList(convs)
        self.dense = dense(channels * size * size, embed_dim, generator)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        x = image.to(dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW for the convs
        for conv in self.convs:
            top, bottom = _same_pad(x.shape[2])
            left, right = _same_pad(x.shape[3])
            x = F.pad(x, (left, right, top, bottom))
            if dtype == torch.float32:
                x = conv(x)
            else:
                x = (F.conv2d(x, conv.weight.to(dtype), stride=_STRIDE)
                     + conv.bias.to(dtype)[:, None, None])
            x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
        return linear(self.dense, x, dtype)
