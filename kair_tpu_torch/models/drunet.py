"""DRUNet (UNetRes) denoiser prior (counterpart of
``kair_tpu/models/drunet.py``; reference models/network_unet.py:21-87).

Four-scale residual U-Net: head conv → (nb ResBlocks + ×2 down) ×3 → nb
body ResBlocks → (×2 up + nb ResBlocks) ×3 with additive skips → tail
conv. KAIR's keys ``m_head``, ``m_down1.{i}``, …, ``m_tail``. H and W
must be multiples of 8 (the caller pads, as in the JAX package). NHWC in
(any float type), NHWC f32 out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from kair_tpu_torch.ops.blocks import (ConvBlock, DownsampleAvgPool,
                                       DownsampleMaxPool,
                                       DownsampleStrideConv, ResBlock,
                                       UpsampleConvTranspose,
                                       UpsamplePixelShuffle, UpsampleUpConv,
                                       sequential)

DOWNSAMPLERS = {
    "strideconv": DownsampleStrideConv,
    "maxpool": DownsampleMaxPool,
    "avgpool": DownsampleAvgPool,
}
UPSAMPLERS = {
    "convtranspose": UpsampleConvTranspose,
    "pixelshuffle": UpsamplePixelShuffle,
    "upconv": UpsampleUpConv,
}


class UNetRes(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3,
                 nc: Sequence[int] = (64, 128, 256, 512), nb: int = 4,
                 act_mode: str = "R", downsample_mode: str = "strideconv",
                 upsample_mode: str = "convtranspose", bias: bool = True):
        super().__init__()
        down, up = DOWNSAMPLERS[downsample_mode], UPSAMPLERS[upsample_mode]

        def res(ch):
            return [ResBlock(ch, mode="C" + act_mode + "C", bias=bias)
                    for _ in range(nb)]

        self.m_head = ConvBlock(in_nc, nc[0], bias=bias, mode="C")
        self.m_down1 = sequential(*res(nc[0]), down(nc[0], nc[1], 2, "", bias))
        self.m_down2 = sequential(*res(nc[1]), down(nc[1], nc[2], 2, "", bias))
        self.m_down3 = sequential(*res(nc[2]), down(nc[2], nc[3], 2, "", bias))
        self.m_body = sequential(*res(nc[3]))
        self.m_up3 = sequential(up(nc[3], nc[2], 2, "", bias), *res(nc[2]))
        self.m_up2 = sequential(up(nc[2], nc[1], 2, "", bias), *res(nc[1]))
        self.m_up1 = sequential(up(nc[1], nc[0], 2, "", bias), *res(nc[0]))
        self.m_tail = ConvBlock(nc[0], out_nc, bias=bias, mode="C")

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x1 = self.m_head(x0.to(self.m_head.weight.dtype))
        x2 = self.m_down1(x1)
        x3 = self.m_down2(x2)
        x4 = self.m_down3(x3)
        x = self.m_body(x4)
        x = self.m_up3(x + x4)
        x = self.m_up2(x + x3)
        x = self.m_up1(x + x2)
        return self.m_tail(x + x1).float()
