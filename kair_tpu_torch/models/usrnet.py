"""USRNet, the deep unfolding network for non-blind SR and deblurring
(counterpart of ``kair_tpu/models/usrnet.py``; reference
models/network_usrnet_v1.py, the complex form of network_usrnet.py).

n_iter × [closed-form FFT data step (no parameters) → learned bias-free
ResUNet prior], with each iteration's (α, β) from HyPaNet. The data step
runs in f32 / complex64 whatever the model's type (cuFFT has no bf16);
the prior and HyPaNet run in the weights' type, as in
``kair_tpu/models/usrnet.py:97-100``.

Inputs (NHWC): x (N, h, w, C) LR image, k (N, kh, kw, 1) blur PSF, sf an
int, sigma (N, 1, 1, 1) noise level. NHWC f32 out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from kair_tpu_torch.models.drunet import UNetRes
from kair_tpu_torch.ops.blocks import Conv, upsample_nearest
from kair_tpu_torch.ops.fft import p2o, splits_mean, upsample_zero


def data_step(x, FB, FBC, F2B, FBFy, alpha, sf: int) -> torch.Tensor:
    """The closed-form data-term solution in the Fourier domain (reference
    DataNet, network_usrnet_v1.py:179-194); f32 x and alpha, complex64
    spectra."""
    FR = FBFy + torch.fft.fftn(alpha * x, dim=(1, 2))
    FBR = splits_mean(FB * FR, sf)
    invW = splits_mean(F2B, sf)
    invWBR = FBR / (invW + alpha)
    FCBinvWBR = FBC * invWBR.repeat(1, sf, sf, 1)
    FX = (FR - FCBinvWBR) / alpha
    return torch.real(torch.fft.ifftn(FX, dim=(1, 2)))


class HyPaNet(nn.Module):
    """(σ, sf) → 2·n_iter positive hyper-parameters by a 1×1-conv MLP
    (reference network_usrnet_v1.py:204-218; keys ``mlp.0``, ``mlp.2``,
    ``mlp.4``)."""

    def __init__(self, in_nc: int = 2, out_nc: int = 16, channel: int = 64):
        super().__init__()
        self.mlp = nn.Sequential(
            Conv(in_nc, channel, 1, padding=0), nn.ReLU(),
            Conv(channel, channel, 1, padding=0), nn.ReLU(),
            Conv(channel, out_nc, 1, padding=0), nn.Softplus())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x) + 1e-6


class USRNet(nn.Module):
    """reference network_usrnet_v1.py:226-280; keys ``p.*`` (the prior)
    and ``h.mlp.*``."""

    def __init__(self, n_iter: int = 8, h_nc: int = 64, in_nc: int = 4,
                 out_nc: int = 3, nc: Sequence[int] = (64, 128, 256, 512),
                 nb: int = 2, act_mode: str = "R",
                 downsample_mode: str = "strideconv",
                 upsample_mode: str = "convtranspose"):
        super().__init__()
        self.n_iter = n_iter
        self.p = UNetRes(in_nc, out_nc, nc, nb, act_mode, downsample_mode,
                         upsample_mode, bias=False)
        self.h = HyPaNet(2, n_iter * 2, h_nc)

    def forward(self, x: torch.Tensor, k: torch.Tensor, sf: int,
                sigma: torch.Tensor) -> torch.Tensor:
        sf = int(sf)
        n, h, w, _ = x.shape
        dt = self.h.mlp[0].weight.dtype
        x, sigma = x.float(), sigma.float()
        FB = p2o(k.float(), (h * sf, w * sf))
        FBC = torch.conj(FB)
        F2B = FB.abs() ** 2
        FBFy = FBC * torch.fft.fftn(upsample_zero(x, sf), dim=(1, 2))
        x = upsample_nearest(x, sf)
        ab = self.h(torch.cat([sigma, torch.full_like(sigma, float(sf))],
                              -1).to(dt)).float()
        for i in range(self.n_iter):
            alpha = ab[..., i:i + 1]
            beta = ab[..., self.n_iter + i:self.n_iter + i + 1]
            x = data_step(x, FB, FBC, F2B, FBFy, alpha, sf)
            beta_map = beta.expand(n, x.shape[1], x.shape[2], 1)
            x = self.p(torch.cat([x, beta_map], -1).to(dt))
        return x
