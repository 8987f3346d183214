"""RRDB / ESRGAN generators (counterpart of ``kair_tpu/models/rrdbnet.py``).

References:
  RRDB (old KAIR layout) network_rrdb.py:14-54 — head → nb RRDB + conv,
      shortcut → upsampler(s) → HR convs; ``model.{i}`` keys, the blocks'
      convs ``conv{j}.0`` (basicblock's RRDB)
  RRDBNet (ESRGAN/BSRGAN) network_rrdbnet.py:74-104 — named modules, its
      own plain-conv dense blocks, nearest ×2(,×2) + convs
  RRDBNet_noUp (fork, SPECT) network_rrdbnet.py:106-125 — no upsampling

KAIR's old RRDB hard-codes gc=32 in its blocks (network_rrdb.py:30); the
port passes ``gc`` through as the JAX package does, default 32. NHWC in
(any float type), NHWC f32 out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.models.srresnet import (UPSAMPLERS, upsampler_stack,
                                            weight_dtype)
from kair_tpu_torch.ops.blocks import (RRDB as RRDBBlock, Conv, ConvBlock,
                                       ShortcutBlock, sequential,
                                       upsample_nearest)


class RRDB(nn.Module):
    """Old-style ESRGAN generator (network_rrdb.py:14-54)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nc: int = 64,
                 nb: int = 23, gc: int = 32, upscale: int = 4,
                 act_mode: str = "L", upsample_mode: str = "upconv"):
        super().__init__()
        body = [RRDBBlock(nc, gc) for _ in range(nb)]
        self.model = sequential(
            ConvBlock(in_nc, nc, mode="C"),
            ShortcutBlock(sequential(*body, ConvBlock(nc, nc, mode="C"))),
            *upsampler_stack(UPSAMPLERS[upsample_mode], nc, upscale,
                             act_mode),
            ConvBlock(nc, nc, mode="C" + act_mode),
            ConvBlock(nc, out_nc, mode="C"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(weight_dtype(self))).float()


class DenseBlock5C(nn.Module):
    """network_rrdbnet.py's ResidualDenseBlock_5C: plain convs ``conv1`` …
    ``conv5``, leaky 0.2, residual scaled by 0.2."""

    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        for j in range(1, 5):
            setattr(self, f"conv{j}", Conv(nf + (j - 1) * gc, gc, 3, 1, 1))
        self.conv5 = Conv(nf + 4 * gc, nf, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for j in range(1, 5):
            feats.append(F.leaky_relu(
                getattr(self, f"conv{j}")(torch.cat(feats, -1)), 0.2))
        return self.conv5(torch.cat(feats, -1)) * 0.2 + x


class DenseRRDB(nn.Module):
    """network_rrdbnet.py's RRDB: ``RDB1`` … ``RDB3``."""

    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.RDB1 = DenseBlock5C(nf, gc)
        self.RDB2 = DenseBlock5C(nf, gc)
        self.RDB3 = DenseBlock5C(nf, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """ESRGAN/BSRGAN-style generator (network_rrdbnet.py:74-104)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32, sf: int = 4):
        super().__init__()
        self.sf = sf
        self.conv_first = Conv(in_nc, nf, 3, 1, 1)
        self.RRDB_trunk = nn.Sequential(*[DenseRRDB(nf, gc)
                                          for _ in range(nb)])
        self.trunk_conv = Conv(nf, nf, 3, 1, 1)
        self.upconv1 = Conv(nf, nf, 3, 1, 1)
        if sf == 4:
            self.upconv2 = Conv(nf, nf, 3, 1, 1)
        self.HRconv = Conv(nf, nf, 3, 1, 1)
        self.conv_last = Conv(nf, out_nc, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = lambda v: F.leaky_relu(v, 0.2)
        fea = self.conv_first(x.to(self.conv_first.weight.dtype))
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        fea = act(self.upconv1(upsample_nearest(fea, 2)))
        if self.sf == 4:
            fea = act(self.upconv2(upsample_nearest(fea, 2)))
        return self.conv_last(act(self.HRconv(fea))).float()


class RRDBNetNoUp(nn.Module):
    """The fork's SPECT variant without upsampling (network_rrdbnet.py:
    106-125)."""

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 23, gc: int = 32):
        super().__init__()
        self.conv_first = Conv(in_nc, nf, 3, 1, 1)
        self.RRDB_trunk = nn.Sequential(*[DenseRRDB(nf, gc)
                                          for _ in range(nb)])
        self.trunk_conv = Conv(nf, nf, 3, 1, 1)
        self.HRconv = Conv(nf, nf, 3, 1, 1)
        self.conv_last = Conv(nf, out_nc, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = self.conv_first(x.to(self.conv_first.weight.dtype))
        fea = fea + self.trunk_conv(self.RRDB_trunk(fea))
        return self.conv_last(F.leaky_relu(self.HRconv(fea), 0.2)).float()
