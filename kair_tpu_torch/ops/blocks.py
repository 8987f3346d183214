"""Network blocks for the port, NHWC (counterpart of ``kair_tpu/ops/blocks.py``).

SwinIR and VRT use ``pixel_shuffle`` (:40), ``upsample_nearest`` (:60),
``resize_bilinear`` (:65) and ``Conv`` (:91-135) with its fused-tail mode.
The CNN zoo adds ``pixel_unshuffle`` (:50), ``ConvT`` (:137), ``BatchNorm``
(:169), the mode-string factory ``ConvBlock`` (:192-253), ``ResBlock``
(:255), ``ResidualDenseBlock5C`` and ``RRDB`` (:323-356), ``IMDBlock``
(:358) and the up/down samplers (:450-542). The blocks no model of either
package builds, ``CALayer``, ``RCABlock``, ``RCAGroup`` (:273-321), ``ESA``,
``CFRB`` and ``NonLocalBlock2D`` (:381-448), are here too, for option
trees and user models that name them. Feature maps are (B, H, W, C)
as in the JAX package; a ``Conv`` hands PyTorch's convolution a
channels-last view of the same memory, so no copy is made on the card.

The factories build KAIR's own module trees (``models/basicblock.py``:
``conv`` and ``sequential``, which flattens nested ``nn.Sequential`` and
returns a lone module as it is), so a released state dict's keys
(``model.0.weight``, ``model.1.sub.3.res.2.bias``, …) load unchanged.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.ops.kernels.conv_block import (conv3x3_residual,
                                                   pack_conv3x3,
                                                   pack_conv3x3_f32)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC pixel shuffle with torch.nn.PixelShuffle's channel order:
    input channel co*r² + i*r + j → output (co, h*r+i, w*r+j)."""
    n, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(n, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, co)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`pixel_shuffle`, KAIR's FFDNet order
    (basicblock.py:104-127): output channel c*r² + i*r + j."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(n, h // r, w // r, c * r * r)


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
        packed = self._packed_weight(x.dtype) if x.is_cuda else None
        return conv3x3_residual(x, residual, self.weight, self.bias,
                                phase=phase, packed_weight=packed)

    @torch.no_grad()
    def _packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight layout of the kernel that takes ``dtype`` (f32: the
        f32 kernel's, else the bf16 one's), rebuilt only when the weight or
        the dtype changes."""
        key = (self.weight.data_ptr(), self.weight._version,
               dtype == torch.float32)
        if key != self._pack_key:
            self._pack = pack_conv3x3_f32(self.weight) \
                if dtype == torch.float32 else pack_conv3x3(self.weight)
            self._pack_key = key
        return self._pack


class ConvT(nn.ConvTranspose2d):
    """nn.ConvTranspose2d on NHWC tensors (KAIR's ``weight`` (in, out, kh,
    kw)): out = (in - 1) * stride - 2 * padding + kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).contiguous()


class BatchNorm(nn.BatchNorm2d):
    """nn.BatchNorm2d on NHWC tensors, as KAIR's conv factory configures it
    (basicblock.py:69: momentum 0.9 in torch's sense, eps 1e-4); the
    running statistics are buffers."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-4):
        super().__init__(channels, eps=eps, momentum=momentum, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class InstanceNorm(nn.InstanceNorm2d):
    """nn.InstanceNorm2d(affine=True) on NHWC tensors (mode char I)."""

    def __init__(self, channels: int):
        super().__init__(channels, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PixelShuffle(nn.Module):
    """Mode chars 2/3/4: :func:`pixel_shuffle` as a module."""

    def __init__(self, r: int):
        super().__init__()
        self.upscale_factor = r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.upscale_factor)


class UpsampleNearest(nn.Module):
    """Mode chars U/u/v: :func:`upsample_nearest` as a module."""

    def __init__(self, r: int):
        super().__init__()
        self.scale_factor = r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, self.scale_factor)


class Pool(nn.Module):
    """Mode chars M/A: max or average pooling, VALID, on NHWC tensors."""

    def __init__(self, kind: str, kernel_size: int, stride: int):
        super().__init__()
        self.kind, self.kernel_size, self.stride = kind, kernel_size, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pool = F.max_pool2d if self.kind == "max" else F.avg_pool2d
        y = pool(x.permute(0, 3, 1, 2), self.kernel_size, self.stride)
        return y.permute(0, 2, 3, 1)


def sequential(*mods: nn.Module) -> nn.Module:
    """KAIR's ``sequential`` (basicblock.py:36-56): nested nn.Sequential
    arguments are flattened into one; a lone argument is returned as is."""
    if len(mods) == 1:
        return mods[0]
    flat: List[nn.Module] = []
    for m in mods:
        flat.extend(m.children() if isinstance(m, nn.Sequential) else [m])
    return nn.Sequential(*flat)


def ConvBlock(in_channels: int = 64, out_channels: int = 64,
              kernel_size: int = 3, stride: int = 1, padding: int = 1,
              bias: bool = True, mode: str = "CBR",
              negative_slope: float = 0.2) -> nn.Module:
    """KAIR's mode-string conv factory (basicblock.py:61-101): one module
    per mode char, C conv | T conv-transpose | B batchnorm | I instancenorm
    | R/r relu | L/l leaky-relu | 2/3/4 pixel-shuffle | U/u/v nearest x2/3/4
    | M maxpool | A avgpool, joined by :func:`sequential` (so KAIR's slot
    indices name the parameters; a one-char mode is the module itself)."""
    layers: List[nn.Module] = []
    for t in mode:
        if t == "C":
            layers.append(Conv(in_channels, out_channels, kernel_size, stride,
                               padding, bias=bias))
        elif t == "T":
            layers.append(ConvT(in_channels, out_channels, kernel_size,
                                stride, padding, bias=bias))
        elif t == "B":
            layers.append(BatchNorm(out_channels))
        elif t == "I":
            layers.append(InstanceNorm(out_channels))
        elif t in "Rr":
            layers.append(nn.ReLU())
        elif t in "Ll":
            layers.append(nn.LeakyReLU(negative_slope))
        elif t in "234":
            layers.append(PixelShuffle(int(t)))
        elif t in "Uuv":
            layers.append(UpsampleNearest({"U": 2, "u": 3, "v": 4}[t]))
        elif t in "MA":
            layers.append(Pool("max" if t == "M" else "avg", kernel_size,
                               stride))
        else:
            raise NotImplementedError(f"Undefined mode char: {t}")
    return sequential(*layers)


class ShortcutBlock(nn.Module):
    """x + sub(x) (basicblock.py:190-204); the body's keys under ``sub``."""

    def __init__(self, sub: nn.Module):
        super().__init__()
        self.sub = sub

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.sub(x)


class ResBlock(nn.Module):
    """x + conv(act(conv(x))) (basicblock.py:211-224); keys ``res.0``,
    ``res.2``."""

    def __init__(self, channels: int = 64, kernel_size: int = 3,
                 mode: str = "CRC", negative_slope: float = 0.2,
                 bias: bool = True):
        super().__init__()
        self.res = ConvBlock(channels, channels, kernel_size,
                             padding=kernel_size // 2, bias=bias, mode=mode,
                             negative_slope=negative_slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.res(x)


class ResidualDenseBlock5C(nn.Module):
    """Five dense convs, leaky 0.2, residual scaled by 0.2 (basicblock.py:
    393-412; keys ``conv1.0`` … ``conv4.0``, ``conv5``)."""

    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()
        for j in range(1, 5):
            setattr(self, f"conv{j}", ConvBlock(nc + (j - 1) * gc, gc,
                                                mode="CL"))
        self.conv5 = ConvBlock(nc + 4 * gc, nc, mode="C")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for j in range(1, 5):
            feats.append(getattr(self, f"conv{j}")(torch.cat(feats, -1)))
        return self.conv5(torch.cat(feats, -1)) * 0.2 + x


class RRDB(nn.Module):
    """Residual-in-residual dense block (basicblock.py:416-431; keys
    ``RDB1`` … ``RDB3``)."""

    def __init__(self, nc: int = 64, gc: int = 32):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nc, gc)
        self.RDB2 = ResidualDenseBlock5C(nc, gc)
        self.RDB3 = ResidualDenseBlock5C(nc, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class IMDBlock(nn.Module):
    """Information multi-distillation block (basicblock.py:230-265): three
    conv + leaky (``negative_slope``, 0.05 in IMDN) steps each splitting off
    a quarter of the channels, a fourth conv, a 1x1 fusion, residual."""

    def __init__(self, channels: int = 64, d_rate: float = 0.25,
                 negative_slope: float = 0.05):
        super().__init__()
        self.d_nc = int(channels * d_rate)
        r_nc = channels - self.d_nc
        self.conv1 = ConvBlock(channels, channels, mode="CL",
                               negative_slope=negative_slope)
        self.conv2 = ConvBlock(r_nc, channels, mode="CL",
                               negative_slope=negative_slope)
        self.conv3 = ConvBlock(r_nc, channels, mode="CL",
                               negative_slope=negative_slope)
        self.conv4 = ConvBlock(r_nc, self.d_nc, mode="C")
        self.conv1x1 = ConvBlock(self.d_nc * 4, channels, 1, padding=0,
                                 mode="C")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.d_nc
        c1 = self.conv1(x)
        c2 = self.conv2(c1[..., d:])
        c3 = self.conv3(c2[..., d:])
        d4 = self.conv4(c3[..., d:])
        return x + self.conv1x1(torch.cat(
            [c1[..., :d], c2[..., :d], c3[..., :d], d4], -1))


class CALayer(nn.Module):
    """Squeeze-excite channel attention (basicblock.py:333-350): the mean
    over the map, 1x1 conv, ReLU, 1x1 conv, sigmoid, times x; keys
    ``conv_fc.0``, ``conv_fc.2``."""

    def __init__(self, channels: int = 64, reduction: int = 16):
        super().__init__()
        self.conv_fc = nn.Sequential(
            Conv(channels, channels // reduction, 1, padding=0), nn.ReLU(),
            Conv(channels // reduction, channels, 1, padding=0), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_fc(x.mean((1, 2), keepdim=True))


class RCABlock(nn.Module):
    """Residual channel-attention block (basicblock.py:354-369):
    x + CA(conv(act(conv(x)))); keys ``res.0``, ``res.2``, ``ca.*``."""

    def __init__(self, channels: int = 64, reduction: int = 16,
                 mode: str = "CRC", negative_slope: float = 0.2):
        super().__init__()
        self.res = ConvBlock(channels, channels, mode=mode,
                             negative_slope=negative_slope)
        self.ca = CALayer(channels, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ca(self.res(x)) + x


class RCAGroup(nn.Module):
    """``nb`` RCABlocks and a 3x3 conv, residual (basicblock.py:373-390);
    keys ``rg.0`` … ``rg.{nb-1}`` (the blocks), ``rg.{nb}`` (the conv)."""

    def __init__(self, channels: int = 64, reduction: int = 16, nb: int = 12,
                 mode: str = "CRC", negative_slope: float = 0.2):
        super().__init__()
        self.rg = sequential(*[RCABlock(channels, reduction, mode,
                                        negative_slope) for _ in range(nb)],
                             Conv(channels, channels, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rg(x) + x


class ESA(nn.Module):
    """Enhanced spatial attention (basicblock.py:271-295): a 1x1 reduction,
    a stride-2 conv, 7/3 max pooling, three 3x3 convs, a bilinear resize
    back, the 1x1 ``conv21`` branch added, a 1x1 conv and a sigmoid gate on
    x; keys ``conv1`` … ``conv6``, ``conv21``."""

    def __init__(self, channels: int = 64, reduction: int = 4):
        super().__init__()
        r = channels // reduction
        self.conv1 = Conv(channels, r, 1, padding=0)
        self.conv21 = Conv(r, r, 1, padding=0)
        self.conv2 = Conv(r, r, 3, stride=2, padding=0)
        self.conv3 = Conv(r, r, 3, padding=1)
        self.conv4 = Conv(r, r, 3, padding=1)
        self.conv5 = Conv(r, r, 3, padding=1)
        self.conv6 = Conv(r, channels, 1, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = F.max_pool2d(self.conv2(x1).permute(0, 3, 1, 2), 7, 3)
        x2 = F.relu(self.conv3(x2.permute(0, 2, 3, 1)))
        x2 = self.conv5(F.relu(self.conv4(x2)))
        x2 = resize_bilinear(x2, (x.shape[1], x.shape[2]))
        return x * torch.sigmoid(self.conv6(x2 + self.conv21(x1)))


class CFRB(nn.Module):
    """Concat-feature residual block with ESA (basicblock.py:298-329): three
    1x1 "distilled" branches beside three residual 3x3 convs, a fourth 3x3
    conv, their concatenation through a leaky ReLU and a 1x1 fusion, then
    ESA; keys ``conv1_d`` … ``conv4_d``, ``conv1_r`` … ``conv3_r``,
    ``conv1x1``, ``esa.*``."""

    def __init__(self, channels: int = 50, d_rate: float = 0.5,
                 negative_slope: float = 0.05):
        super().__init__()
        d = int(channels * d_rate)
        self.negative_slope = negative_slope
        for i in (1, 2, 3):
            setattr(self, f"conv{i}_d", Conv(channels, d, 1, padding=0))
            setattr(self, f"conv{i}_r", Conv(channels, channels, 3, padding=1))
        self.conv4_d = Conv(channels, d, 3, padding=1)
        self.conv1x1 = Conv(4 * d, channels, 1, padding=0)
        self.esa = ESA(channels, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = lambda v: F.leaky_relu(v, self.negative_slope)
        ds = []
        for i in (1, 2, 3):
            ds.append(getattr(self, f"conv{i}_d")(x))
            x = act(getattr(self, f"conv{i}_r")(x) + x)
        x = act(torch.cat(ds + [self.conv4_d(x)], -1))
        return self.esa(self.conv1x1(x))


class NonLocalBlock2D(nn.Module):
    """Embedded-Gaussian non-local block (basicblock.py:543-591): 1x1 convs
    ``g``, ``theta``, ``phi`` to nc / reduction channels, softmax(θ φᵀ) over
    all pixels (in f32) times g, a 1x1 conv ``W``, residual. ``act_mode``
    follows ``W`` ("" as in the JAX package; KAIR's default "B" adds a
    BatchNorm, keys ``W.0`` / ``W.1``)."""

    def __init__(self, nc: int = 64, reduction: int = 2, act_mode: str = ""):
        super().__init__()
        inter = nc // reduction
        self.g = Conv(nc, inter, 1, padding=0)
        self.theta = Conv(nc, inter, 1, padding=0)
        self.phi = Conv(nc, inter, 1, padding=0)
        self.W = ConvBlock(inter, nc, 1, padding=0, mode="C" + act_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        g, theta, phi = (m(x).reshape(n, h * w, -1)
                         for m in (self.g, self.theta, self.phi))
        attn = torch.softmax((theta @ phi.transpose(1, 2)).float(), -1)
        y = (attn.to(g.dtype) @ g).reshape(n, h, w, -1)
        return x + self.W(y)


def UpsamplePixelShuffle(in_channels: int = 64, out_channels: int = 3,
                         scale: int = 2, mode: str = "", bias: bool = True
                         ) -> nn.Module:
    """conv → pixel shuffle (+ act) (basicblock.py:446-452)."""
    return ConvBlock(in_channels, out_channels * scale ** 2, bias=bias,
                     mode="C" + str(scale) + mode)


def UpsampleUpConv(in_channels: int = 64, out_channels: int = 3,
                   scale: int = 2, mode: str = "", bias: bool = True
                   ) -> nn.Module:
    """nearest upsample → conv (+ act) (basicblock.py:455-467)."""
    return ConvBlock(in_channels, out_channels, bias=bias,
                     mode={2: "U", 3: "u", 4: "v"}[scale] + "C" + mode)


def UpsampleConvTranspose(in_channels: int = 64, out_channels: int = 3,
                          scale: int = 2, mode: str = "", bias: bool = True
                          ) -> nn.Module:
    """scale x scale, stride-scale transposed conv (basicblock.py:471-481)."""
    return ConvBlock(in_channels, out_channels, scale, scale, 0, bias=bias,
                     mode="T" + mode)


def DownsampleStrideConv(in_channels: int = 64, out_channels: int = 64,
                         scale: int = 2, mode: str = "", bias: bool = True
                         ) -> nn.Module:
    """scale x scale, stride-scale conv (basicblock.py:495-505)."""
    return ConvBlock(in_channels, out_channels, scale, scale, 0, bias=bias,
                     mode="C" + mode)


def DownsampleMaxPool(in_channels: int = 64, out_channels: int = 64,
                      scale: int = 2, mode: str = "", bias: bool = True
                      ) -> nn.Module:
    """max pool → 3x3 conv (basicblock.py:507-517; the conv padded as in the
    JAX package)."""
    return sequential(Pool("max", scale, scale),
                      ConvBlock(in_channels, out_channels, bias=bias,
                                mode="C" + mode))


def DownsampleAvgPool(in_channels: int = 64, out_channels: int = 64,
                      scale: int = 2, mode: str = "", bias: bool = True
                      ) -> nn.Module:
    """average pool → 3x3 conv (basicblock.py:520-530)."""
    return sequential(Pool("avg", scale, scale),
                      ConvBlock(in_channels, out_channels, bias=bias,
                                mode="C" + mode))
