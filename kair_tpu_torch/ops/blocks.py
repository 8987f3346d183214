"""Network blocks for the port, NHWC (counterpart of ``kair_tpu/ops/blocks.py``).

Only what SwinIR needs so far: ``pixel_shuffle`` (:40), ``upsample_nearest``
(:60) and ``Conv`` (:91-135) with its fused-tail mode. Feature maps are
(B, H, W, C) as in the JAX package; a ``Conv`` hands PyTorch's convolution a
channels-last view of the same memory, so no copy is made on the card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from kair_tpu_torch.ops.kernels.conv_block import conv3x3_residual, pack_conv3x3


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel shuffle with torch.nn.PixelShuffle's channel order:
    input channel co*r² + i*r + j → output (co, h*r+i, w*r+j)."""
    n, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(n, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, co)


def upsample_nearest(x: torch.Tensor, r: int) -> torch.Tensor:
    """nn.Upsample(mode='nearest') on NHWC: out[i] = in[i // r]."""
    return x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)


class Conv(nn.Conv2d):
    """nn.Conv2d on NHWC tensors, with KAIR's parameters (``weight`` OIHW,
    ``bias``) so a released state dict loads unchanged.

    ``residual``/``phase``: fused tail mode, computing
    conv(roll(x, (phase, phase))) + bias + residual through
    ``conv3x3_residual`` — the CUDA kernel on the card, its plain version on
    the CPU. It needs a 3x3, stride-1, padding-1 conv with C_in == C_out."""

    _pack_key: Optional[tuple] = None
    _pack: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                phase: int = 0) -> torch.Tensor:
        if residual is None:
            if phase:
                raise ValueError("phase needs the fused residual mode")
            y = super().forward(x.permute(0, 3, 1, 2))
            return y.permute(0, 2, 3, 1).contiguous()
        if not (self.kernel_size == (3, 3) and self.stride == (1, 1)
                and self.padding == (1, 1) and self.dilation == (1, 1)
                and self.groups == 1 and self.bias is not None
                and self.in_channels == self.out_channels):
            raise ValueError("fused residual mode needs k=3/s=1/p=1/d=1/"
                             "groups=1, a bias and C_in == C_out")
        packed = self._packed_weight() if x.is_cuda else None
        return conv3x3_residual(x, residual, self.weight, self.bias,
                                phase=phase, packed_weight=packed)

    @torch.no_grad()
    def _packed_weight(self) -> torch.Tensor:
        """The kernel's weight layout, rebuilt only when the weight changes."""
        key = (self.weight.data_ptr(), self.weight._version)
        if key != self._pack_key:
            self._pack = pack_conv3x3(self.weight)
            self._pack_key = key
        return self._pack
