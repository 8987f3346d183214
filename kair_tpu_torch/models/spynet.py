"""SpyNet optical flow, NHWC (counterpart of ``kair_tpu/models/spynet.py``;
KAIR ``network_vrt.py:342-457``).

A 6-level coarse-to-fine pyramid: a 2x average-pool pyramid of the
normalised frames; at each level [ref ⊕ warp(supp, 2·up(flow)) ⊕ up(flow)]
→ a 5-conv basic module → residual flow. Inputs are resized to multiples
of 32; the returned flows are rescaled to the requested levels' sizes. The
modules carry KAIR's keys (``basic_module.N.basic_module.{0,2,4,6,8}``, the
``mean``/``std`` buffers), so a released state dict loads as it is. The
convs are cuDNN's, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.ops.blocks import resize_bilinear
from kair_tpu_torch.ops.warp import flow_warp


class BasicModule(nn.Module):
    """5 7x7 convs 8 → 32 → 64 → 32 → 16 → 2 with ReLUs (KAIR :342-357)."""

    def __init__(self):
        super().__init__()
        chans = [8, 32, 64, 32, 16, 2]
        layers: List[nn.Module] = []
        for i in range(5):
            layers.append(nn.Conv2d(chans[i], chans[i + 1], 7, 1, 3))
            if i < 4:
                layers.append(nn.ReLU())
        self.basic_module = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.basic_module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SpyNet(nn.Module):
    """KAIR :359-457 on NHWC RGB pairs in [0, 1]; computes in its
    parameters' type."""

    def __init__(self, return_levels: Sequence[int] = (5,)):
        super().__init__()
        self.return_levels = tuple(return_levels)
        self.basic_module = nn.ModuleList([BasicModule() for _ in range(6)])
        self.register_buffer("mean", torch.tensor(
            [0.485, 0.456, 0.406]).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor(
            [0.229, 0.224, 0.225]).view(1, 3, 1, 1))

    def forward(self, ref: torch.Tensor, supp: torch.Tensor):
        dt = self.mean.dtype
        ref, supp = ref.to(dt), supp.to(dt)
        n, h, w, _ = ref.shape
        w_floor = math.floor(math.ceil(w / 32.0) * 32.0)
        h_floor = math.floor(math.ceil(h / 32.0) * 32.0)
        ref = resize_bilinear(ref, (h_floor, w_floor))
        supp = resize_bilinear(supp, (h_floor, w_floor))
        mean, std = self.mean.view(1, 1, 1, 3), self.std.view(1, 1, 1, 3)
        refs, supps = [(ref - mean) / std], [(supp - mean) / std]
        pool = lambda a: F.avg_pool2d(a.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        for _ in range(5):
            refs.insert(0, pool(refs[0]))
            supps.insert(0, pool(supps[0]))

        flow = ref.new_zeros(n, refs[0].shape[1] // 2, refs[0].shape[2] // 2, 2)
        flows = []
        for level in range(6):
            up = F.interpolate(flow.permute(0, 3, 1, 2), scale_factor=2,
                               mode="bilinear", align_corners=True)
            up = up.permute(0, 2, 3, 1) * 2.0
            # an odd pyramid size: repeat the last row / column (KAIR :410-413)
            if up.shape[1] != refs[level].shape[1]:
                up = torch.cat([up, up[:, -1:]], 1)
            if up.shape[2] != refs[level].shape[2]:
                up = torch.cat([up, up[:, :, -1:]], 2)
            warped = flow_warp(supps[level], up, "bilinear", "border")
            flow = self.basic_module[level](
                torch.cat([refs[level], warped, up], -1)) + up
            if level in self.return_levels:
                scale = 2 ** (5 - level)
                out = resize_bilinear(flow, (h // scale, w // scale))
                out = out * out.new_tensor(
                    [float(w // scale) / float(w_floor // scale),
                     float(h // scale) / float(h_floor // scale)])
                flows.insert(0, out)
        return flows[0] if len(flows) == 1 else flows
