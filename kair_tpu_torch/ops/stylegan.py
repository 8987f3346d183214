"""StyleGAN2 resampling ops in plain PyTorch (counterpart of
``kair_tpu/ops/stylegan.py``; reference models/op/upfirdn2d.py and
fused_act.py, whose CUDA extensions are on no Pallas path).

The public functions take NHWC tensors, as the JAX package's; the
``*_nchw`` forms are what GPEN's modules call inside.

  upfirdn2d         zero-stuff by ``up``, pad (negative = crop), FIR filter
                    (correlation with the flipped kernel, one filter per
                    channel), keep every ``down``-th sample
  fused_leaky_relu  bias add, leaky ReLU 0.2, gain √2
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def make_kernel(k: Sequence[float]) -> torch.Tensor:
    """1-D taps → normalised 2-D FIR kernel (reference
    network_faceenhancer.py:31-39)."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()


def upfirdn2d_nchw(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
                   down: int = 1, pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    b, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros(b, c, h * up, w * up)
        z[:, :, ::up, ::up] = x
        x = z
    p0, p1 = pad
    x = F.pad(x, [max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)])
    x = x[:, :, max(-p0, 0):x.shape[2] - max(-p1, 0),
          max(-p0, 0):x.shape[3] - max(-p1, 0)]
    kh, kw = kernel.shape
    wk = torch.flip(kernel, (0, 1)).to(x.dtype).expand(c, 1, kh, kw)
    return F.conv2d(x, wk, stride=down, groups=c)


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1,
              down: int = 1, pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """NHWC upsample → pad → FIR → downsample."""
    return upfirdn2d_nchw(x.permute(0, 3, 1, 2), kernel, up, down,
                          pad).permute(0, 2, 3, 1)


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2, scale: float = 2 ** 0.5,
                     channel_dim: int = -1) -> torch.Tensor:
    """bias add + leaky ReLU + √2 gain; the bias on ``channel_dim``."""
    if bias is not None:
        shape = [1] * x.ndim
        shape[channel_dim] = -1
        x = x + bias.to(x.dtype).view(shape)
    return F.leaky_relu(x, negative_slope) * scale


def upsample_pad(kernel_len: int, factor: int = 2) -> Tuple[int, int]:
    p = kernel_len - factor
    return (p + 1) // 2 + factor - 1, p // 2


def downsample_pad(kernel_len: int, factor: int = 2) -> Tuple[int, int]:
    p = kernel_len - factor
    return (p + 1) // 2, p // 2


def upsample2(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """reference Upsample (network_faceenhancer.py:42-60), NHWC."""
    k = make_kernel(kernel) * factor ** 2
    return upfirdn2d(x, k.to(x.device), up=factor,
                     pad=upsample_pad(k.shape[0], factor))


def downsample2(x: torch.Tensor, kernel, factor: int = 2) -> torch.Tensor:
    """reference Downsample (:63-81), NHWC."""
    k = make_kernel(kernel)
    return upfirdn2d(x, k.to(x.device), down=factor,
                     pad=downsample_pad(k.shape[0], factor))


def blur(x: torch.Tensor, kernel, pad: Tuple[int, int],
         upsample_factor: int = 1) -> torch.Tensor:
    """reference Blur (:84-100), NHWC."""
    k = make_kernel(kernel)
    if upsample_factor > 1:
        k = k * upsample_factor ** 2
    return upfirdn2d(x, k.to(x.device), pad=pad)

