"""DnCNN / IRCNN / FDnCNN denoisers (counterpart of
``kair_tpu/models/dncnn.py``; reference models/network_dncnn.py).

Plain conv stacks on cuDNN through ``ops/blocks``; KAIR's ``model.{i}``
keys. NHWC in (any float type), NHWC f32 out; the body runs in the
weights' type and the residual ``x - n`` (network_dncnn.py:69-71) in f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from kair_tpu_torch.ops.blocks import Conv, ConvBlock, sequential


def plain_stack(in_nc: int, out_nc: int, nc: int, nb: int,
                act_mode: str) -> nn.Module:
    """head conv + act, nb - 2 body conv(+BN)+act, tail conv: KAIR's
    DnCNN/FDnCNN/FFDNet/SRMD body, ``model.0`` … ``model.{last}``."""
    return sequential(
        ConvBlock(in_nc, nc, mode="C" + act_mode[-1]),
        *[ConvBlock(nc, nc, mode="C" + act_mode) for _ in range(nb - 2)],
        ConvBlock(nc, out_nc, mode="C"))


class DnCNN(nn.Module):
    """DnCNN (network_dncnn.py:40-71): act_mode 'R' is the released form
    (BN merged, ``utils/bnorm``), 'BR' the training form."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64,
                 nb: int = 17, act_mode: str = "BR"):
        super().__init__()
        assert "R" in act_mode or "L" in act_mode
        self.model = plain_stack(in_nc, out_nc, nc, nb, act_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.model(x.to(self.model[0].weight.dtype))
        return x.float() - n.float()


class IRCNN(nn.Module):
    """IRCNN: seven 3x3 convs dilated 1,2,3,4,3,2,1 (network_dncnn.py:
    77-116), residual."""

    def __init__(self, in_nc: int = 1, out_nc: int = 1, nc: int = 64):
        super().__init__()
        dils = (1, 2, 3, 4, 3, 2, 1)
        layers = []
        for i, d in enumerate(dils):
            last = i == len(dils) - 1
            layers.append(Conv(nc if i else in_nc, out_nc if last else nc, 3,
                               1, padding=d, dilation=d))
            if not last:
                layers.append(nn.ReLU())
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.model(x.to(self.model[0].weight.dtype))
        return x.float() - n.float()


class FDnCNN(nn.Module):
    """FDnCNN: DnCNN with a noise-level-map input channel, no residual
    (network_dncnn.py:128-149); the input is concat(L, σ map)."""

    def __init__(self, in_nc: int = 2, out_nc: int = 1, nc: int = 64,
                 nb: int = 20, act_mode: str = "R"):
        super().__init__()
        self.model = plain_stack(in_nc, out_nc, nc, nb, act_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x.to(self.model[0].weight.dtype)).float()
