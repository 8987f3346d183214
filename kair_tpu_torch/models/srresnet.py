"""SRResNet-family backbones: MSRResNet0/1, DPSR's MSRResNet_prior, SRMD
(counterpart of ``kair_tpu/models/srresnet.py``).

References:
  MSRResNet0  network_msrresnet.py:38-83 (head → nb ResBlocks + conv,
              shortcut → upsampler(s) → HR convs, last conv bias-free)
  MSRResNet1  network_msrresnet.py:89-135 (named modules, bilinear base)
  MSRResNet_prior (DPSR) network_dpsr.py:42-76 (MSRResNet0, in_nc 4: the
              image and a σ channel; nc 96)
  SRMD        network_srmd.py:26-77 (image ⊕ 15-dim PCA kernel ⊕ σ, plain
              conv stack, one ×scale upsampler)

NHWC in (any float type), NHWC f32 out; the body runs in the weights'
type.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.ops.blocks import (Conv, ConvBlock, ResBlock,
                                       ShortcutBlock, UpsampleConvTranspose,
                                       UpsamplePixelShuffle, UpsampleUpConv,
                                       pixel_shuffle, resize_bilinear,
                                       sequential)

UPSAMPLERS = {
    "upconv": UpsampleUpConv,
    "pixelshuffle": UpsamplePixelShuffle,
    "convtranspose": UpsampleConvTranspose,
}


def upsampler_stack(up, nc: int, upscale: int, act_mode: str) -> list:
    """One ×3 or log2(upscale) ×2 upsamplers, KAIR's ``m_uper``."""
    if upscale == 3:
        return [up(nc, nc, 3, act_mode)]
    return [up(nc, nc, 2, act_mode) for _ in range(int(math.log2(upscale)))]


def weight_dtype(model: nn.Module) -> torch.dtype:
    return next(model.parameters()).dtype


class MSRResNet0(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 64,
                 nb: int = 16, upscale: int = 4, act_mode: str = "R",
                 upsample_mode: str = "upconv"):
        super().__init__()
        body = [ResBlock(nc, mode="C" + act_mode + "C") for _ in range(nb)]
        self.model = sequential(
            ConvBlock(in_nc, nc, mode="C"),
            ShortcutBlock(sequential(*body, ConvBlock(nc, nc, mode="C"))),
            *upsampler_stack(UPSAMPLERS[upsample_mode], nc, upscale,
                             act_mode),
            ConvBlock(nc, nc, mode="C" + act_mode),
            ConvBlock(nc, out_nc, bias=False, mode="C"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(weight_dtype(self))).float()


class ResidualBlockNoBN(nn.Module):
    """x + conv2(relu(conv1(x))) (network_msrresnet.py's
    ResidualBlock_noBN)."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = Conv(nf, nf, 3, 1, 1)
        self.conv2 = Conv(nf, nf, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


class MSRResNet1(nn.Module):
    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 64,
                 nb: int = 16, upscale: int = 4):
        super().__init__()
        self.upscale = upscale
        self.conv_first = Conv(in_nc, nc, 3, 1, 1)
        self.recon_trunk = nn.Sequential(*[ResidualBlockNoBN(nc)
                                           for _ in range(nb)])
        if upscale == 4:
            self.upconv1 = Conv(nc, nc * 4, 3, 1, 1)
            self.upconv2 = Conv(nc, nc * 4, 3, 1, 1)
        else:
            self.upconv1 = Conv(nc, nc * upscale * upscale, 3, 1, 1)
        self.HRconv = Conv(nc, nc, 3, 1, 1)
        self.conv_last = Conv(nc, out_nc, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = lambda v: F.leaky_relu(v, 0.1)
        out = self.recon_trunk(act(self.conv_first(
            x.to(self.conv_first.weight.dtype))))
        if self.upscale == 4:
            out = act(pixel_shuffle(self.upconv1(out), 2))
            out = act(pixel_shuffle(self.upconv2(out), 2))
        else:
            out = act(pixel_shuffle(self.upconv1(out), self.upscale))
        out = self.conv_last(act(self.HRconv(out))).float()
        h, w = x.shape[1:3]
        return out + resize_bilinear(x.float(), (h * self.upscale,
                                                 w * self.upscale))


class SRMD(nn.Module):
    """The input is NHWC concat(image, PCA kernel map, σ map), in_nc
    channels."""

    def __init__(self, in_nc: int = 19, out_nc: int = 3, nc: int = 128,
                 nb: int = 12, upscale: int = 4, act_mode: str = "R",
                 upsample_mode: str = "pixelshuffle"):
        super().__init__()
        self.model = sequential(
            ConvBlock(in_nc, nc, mode="C" + act_mode[-1]),
            *[ConvBlock(nc, nc, mode="C" + act_mode) for _ in range(nb - 2)],
            UPSAMPLERS[upsample_mode](nc, out_nc, upscale, ""))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(weight_dtype(self))).float()
