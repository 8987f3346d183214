"""Network blocks for the port, NHWC (counterpart of ``kair_tpu/ops/blocks.py``).

What SwinIR and VRT need so far: ``pixel_shuffle`` (:40),
``upsample_nearest`` (:60), ``resize_bilinear`` (:65) and ``Conv``
(:91-135) with its fused-tail mode. Feature maps are
(B, H, W, C) as in the JAX package; a ``Conv`` hands PyTorch's convolution a
channels-last view of the same memory, so no copy is made on the card.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
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


@lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of ``jax.image.resize(method="bilinear")`` along
    one axis: the triangle kernel at half-pixel centres, widened by the
    factor when downsampling (antialiasing), each row normalised, rows whose
    sample falls outside the input zeroed."""
    scale = n_out / n_in
    kscale = max(1.0 / scale, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    dist = np.abs(sample[:, None] - np.arange(n_in)[None, :]) / kscale
    wts = np.maximum(0.0, 1.0 - dist)
    tot = wts.sum(1, keepdims=True)
    wts = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps,
                   wts / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return (wts * inside[:, None]).astype(np.float32)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NHWC x to ``size`` with the JAX package's
    semantics (``jax.image.resize``, half-pixel centres): equal to torch's
    ``F.interpolate(mode="bilinear", align_corners=False)`` when upsampling,
    antialiased when downsampling."""
    h, w = x.shape[1:3]
    if (h, w) == tuple(size):
        return x
    mh = _resize_on(h, size[0], str(x.device), x.dtype)
    mw = _resize_on(w, size[1], str(x.device), x.dtype)
    return torch.einsum("oh,nhwc,pw->nopc", mh, x, mw)


@lru_cache(maxsize=64)
def _resize_on(n_in: int, n_out: int, device: str, dtype) -> torch.Tensor:
    # made once per device: a copy from the host at every call would wait
    # for the card
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device, dtype)


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
