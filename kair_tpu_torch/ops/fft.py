"""FFT utilities for USRNet's data step (counterpart of
``kair_tpu/ops/fft.py``; reference network_usrnet_v1.py:32-98): PSF → OTF,
sf-fold zero-stuffing up/downsampling, the mean over distinct-block
aliases. NHWC, on ``torch.fft`` (cuFFT on the card) in complex64: cuFFT
has no bf16 transform, so callers hand these f32 tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch


def p2o(psf: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """PSF (N, h, w, C) → OTF (N, H, W, C) complex64: zero-pad to
    ``shape``, roll the kernel's centre to the origin, FFT over H and W
    (reference network_usrnet_v1.py:47-67)."""
    n, kh, kw, c = psf.shape
    otf = psf.new_zeros((n, shape[0], shape[1], c))
    otf[:, :kh, :kw] = psf
    otf = torch.roll(otf, (-(kh // 2), -(kw // 2)), dims=(1, 2))
    return torch.fft.fftn(otf, dim=(1, 2))


def upsample_zero(x: torch.Tensor, sf: int) -> torch.Tensor:
    """Sᵀy: zero-stuffed sf-fold upsampling, the sample at (0, 0) of each
    block (reference network_usrnet_v1.py:70-81)."""
    n, h, w, c = x.shape
    z = x.new_zeros((n, h * sf, w * sf, c))
    z[:, ::sf, ::sf] = x
    return z


def downsample_keep(x: torch.Tensor, sf: int) -> torch.Tensor:
    """S: the upper-left pixel of each sf × sf block (reference
    network_usrnet_v1.py:84-92)."""
    return x[:, ::sf, ::sf]


def splits_mean(a: torch.Tensor, sf: int) -> torch.Tensor:
    """Mean over the sf × sf distinct-block aliases of an (N, H, W, C)
    spectrum (reference network_usrnet_v1.py:32-44 and DataNet :187-188)."""
    n, h, w, c = a.shape
    return a.reshape(n, sf, h // sf, sf, w // sf, c).mean(dim=(1, 3))
