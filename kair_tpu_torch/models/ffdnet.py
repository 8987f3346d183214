"""FFDNet noise-map denoiser (counterpart of ``kair_tpu/models/ffdnet.py``;
reference models/network_ffdnet.py:27-69).

Pixel-unshuffle ×2 → conv stack on [features ⊕ σ map] → pixel shuffle.
An odd height or width is replicate-padded and cropped back, as the
reference does at run time (network_ffdnet.py:54-59); the JAX package
leaves that to its caller.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.models.dncnn import plain_stack
from kair_tpu_torch.ops.blocks import pixel_shuffle, pixel_unshuffle


class FFDNet(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64,
                 nb: int = 15, act_mode: str = "R", sf: int = 2):
        super().__init__()
        self.sf = sf
        self.model = plain_stack(in_nc * sf * sf + 1, out_nc * sf * sf, nc,
                                 nb, act_mode)

    def forward(self, x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
        """x: NHWC; sigma: (N, 1, 1, 1) noise level. NHWC f32 out."""
        h, w = x.shape[1:3]
        dt = self.model[0].weight.dtype
        ph, pw = (-h) % self.sf, (-w) % self.sf
        x = x.to(dt)
        if ph or pw:
            x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph),
                      mode="replicate").permute(0, 2, 3, 1)
        x = pixel_unshuffle(x, self.sf)
        m = sigma.to(dt).expand(x.shape[0], x.shape[1], x.shape[2], 1)
        y = pixel_shuffle(self.model(torch.cat([x, m], -1)), self.sf)
        return y[:, :h, :w].float()
