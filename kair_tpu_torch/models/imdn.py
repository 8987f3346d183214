"""IMDN lightweight SR (counterpart of ``kair_tpu/models/imdn.py``;
reference models/network_imdn.py:33-66). Its distillation blocks use
leaky ReLU at slope 0.05 (``negative_slope``), not the 0.2 of the other
blocks. NHWC in (any float type), NHWC f32 out."""

from __future__ import annotations

import torch
import torch.nn as nn

from kair_tpu_torch.models.srresnet import UPSAMPLERS, weight_dtype
from kair_tpu_torch.ops.blocks import (ConvBlock, IMDBlock, ShortcutBlock,
                                       sequential)


class IMDN(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 64,
                 nb: int = 8, upscale: int = 4, act_mode: str = "L",
                 upsample_mode: str = "pixelshuffle",
                 negative_slope: float = 0.05):
        super().__init__()
        body = [IMDBlock(nc, negative_slope=negative_slope)
                for _ in range(nb)]
        self.model = sequential(
            ConvBlock(in_nc, nc, mode="C"),
            ShortcutBlock(sequential(*body, ConvBlock(nc, nc, mode="C"))),
            UPSAMPLERS[upsample_mode](nc, out_nc, upscale, ""))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(weight_dtype(self))).float()
