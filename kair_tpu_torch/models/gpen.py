"""GPEN blind face restoration: a StyleGAN2 generator with a GAN-prior
encoder (counterpart of ``kair_tpu/models/gpen.py``; reference
models/network_faceenhancer.py:23-687).

The modules carry KAIR's names and layouts (``ecd0.0.0.weight``,
``generator.style.1.weight``, ``generator.convs.0.conv.weight`` of shape
(1, O, I, k, k), the ``blur.kernel`` / ``upsample.kernel`` buffers, …), so
a released ``GPEN-BFR-512.pth`` loads with ``load_state_dict`` as it is.
Images are NHWC at the entry points, NCHW inside; the resampling ops are
``ops/stylegan``'s plain PyTorch (cuDNN convs; no hand-written kernel).

``isconcat``: noise injection concatenates ``noise_weight · noise``,
doubling the channels. In GPEN the noise is the encoder's features; a
bare ``StyleGANGenerator`` given no noise draws it from an explicit
``torch.Generator``. The modulated convolution runs as one grouped
convolution over the batch (groups = B), as the reference does.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.ops.stylegan import (fused_leaky_relu, make_kernel,
                                         upfirdn2d_nchw, upsample_pad)

SSS = 2   # isconcat channel multiplier


def channels_of(multiplier: int) -> dict:
    m = multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * m, 128: 128 * m,
            256: 64 * m, 512: 32 * m, 1024: 16 * m}


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x ** 2, dim=1, keepdim=True) + 1e-8)


class EqualLinear(nn.Module):
    """Equalised-lr linear (reference :141-173): ``weight`` (out, in) / lr_mul."""

    def __init__(self, in_dim: int, out_dim: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: Optional[str] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = (1 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul, self.activation = lr_mul, activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, self.weight * self.scale)
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + (self.bias * self.lr_mul).to(out.dtype)


class EqualConv2d(nn.Module):
    """Equalised-lr conv (reference :103-138): ``weight`` (out, in, k, k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.scale = 1 / math.sqrt(in_ch * kernel_size ** 2)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight * self.scale, self.bias,
                        self.stride, self.padding)


class Blur(nn.Module):
    """reference :84-100: FIR with the buffer ``kernel``."""

    def __init__(self, kernel: Sequence[int], pad, upsample_factor: int = 1):
        super().__init__()
        k = make_kernel(kernel)
        if upsample_factor > 1:
            k = k * upsample_factor ** 2
        self.register_buffer("kernel", k)
        self.pad = tuple(pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d_nchw(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    """reference :42-60."""

    def __init__(self, kernel: Sequence[int], factor: int = 2):
        super().__init__()
        self.factor = factor
        self.register_buffer("kernel", make_kernel(kernel) * factor ** 2)
        self.pad = upsample_pad(len(kernel), factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d_nchw(x, self.kernel, up=self.factor, pad=self.pad)


class ModulatedConv2d(nn.Module):
    """Style-modulated (de)convolution with demodulation (reference
    ModulatedConv2d :188-285); ``weight`` (1, O, I, k, k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        k = kernel_size
        self.in_ch, self.out_ch, self.k = in_ch, out_ch, k
        self.upsample, self.downsample = upsample, downsample
        self.demodulate = demodulate
        if upsample:
            factor = 2
            p = (len(blur_kernel) - factor) - (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2 + factor - 1,
                                           p // 2 + 1), upsample_factor=factor)
        if downsample:
            p = (len(blur_kernel) - 2) + (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2, p // 2))
        self.scale = 1 / math.sqrt(in_ch * k ** 2)
        self.padding = k // 2
        self.weight = nn.Parameter(torch.randn(1, out_ch, in_ch, k, k))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        # modulation and demodulation in f32 whatever the activations' type
        s = self.modulation(style).float().view(b, 1, c, 1, 1)
        weight = self.scale * self.weight.float() * s         # (B, O, I, k, k)
        if self.demodulate:
            demod = torch.rsqrt(weight.pow(2).sum((2, 3, 4)) + 1e-8)
            weight = weight * demod.view(b, self.out_ch, 1, 1, 1)
        k = self.k
        if self.upsample:
            weight = weight.transpose(1, 2).reshape(b * c, self.out_ch, k, k)
            out = F.conv_transpose2d(x.reshape(1, b * c, h, w),
                                     weight.to(x.dtype), stride=2, groups=b)
            out = self.blur(out.view(b, self.out_ch, *out.shape[2:]))
        elif self.downsample:
            x = self.blur(x)
            out = F.conv2d(x.reshape(1, b * c, *x.shape[2:]),
                           weight.reshape(b * self.out_ch, c, k, k).to(x.dtype),
                           stride=2, groups=b)
            out = out.view(b, self.out_ch, *out.shape[2:])
        else:
            out = F.conv2d(x.reshape(1, b * c, h, w),
                           weight.reshape(b * self.out_ch, c, k, k).to(x.dtype),
                           padding=self.padding, groups=b)
            out = out.view(b, self.out_ch, *out.shape[2:])
        return out


class NoiseInjection(nn.Module):
    """isconcat noise (reference :293-306): cat(image, weight · noise)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, image: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise is None:
            noise = torch.randn(image.shape, generator=generator).to(image)
        return torch.cat([image, self.weight.to(image.dtype) * noise], 1)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias, channel_dim=1)


class StyledConv(nn.Module):
    """ModulatedConv2d + concat noise + FusedLeakyReLU (reference :287-356)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 style_dim: int, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 demodulate: bool = True):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    demodulate, upsample,
                                    blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch * SSS)

    def forward(self, x, style, noise=None, generator=None):
        out = self.noise(self.conv(x, style), noise, generator)
        return self.activate(out)


class ToRGB(nn.Module):
    """reference :358-377."""

    def __init__(self, in_ch: int, style_dim: int, upsample: bool = True,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        if upsample:
            self.upsample = Upsample(blur_kernel)
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class ConstantInput(nn.Module):
    def __init__(self, channels: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channels, size, size))

    def forward(self, batch: int) -> torch.Tensor:
        return self.input.expand(batch, -1, -1, -1)


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


class StyleGANGenerator(nn.Module):
    """StyleGAN2 synthesis and style MLP (reference Generator :379-555)."""

    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01):
        super().__init__()
        self.size, self.style_dim = size, style_dim
        self.style = nn.Sequential(PixelNorm(), *[
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp,
                        activation="fused_lrelu") for _ in range(n_mlp)])
        ch = channels_of(channel_multiplier)
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim,
                                blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(ch[4] * SSS, style_dim, upsample=False)
        self.log_size = int(math.log2(size))
        self.n_latent = self.log_size * 2 - 2
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(StyledConv(in_ch * SSS, out_ch, 3, style_dim,
                                         upsample=True, blur_kernel=blur_kernel))
            self.convs.append(StyledConv(out_ch * SSS, out_ch, 3, style_dim,
                                         blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(out_ch * SSS, style_dim))
            in_ch = out_ch

    def forward(self, style: torch.Tensor,
                noise: Optional[List[torch.Tensor]] = None,
                input_is_latent: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """style (B, D) or latents; ``noise``: NHWC maps, the encoder's in
        GPEN (index as in the JAX package), or None to draw each layer's
        from ``generator``. Returns an NHWC image."""
        w = style if input_is_latent else self.style(style)
        latent = w[:, None, :].expand(-1, self.n_latent, -1) if w.ndim == 2 \
            else w
        nz = (lambda i: None) if noise is None else \
            (lambda i: noise[i].permute(0, 3, 1, 2))
        out = self.input(latent.shape[0]).to(latent.dtype)
        out = self.conv1(out, latent[:, 0], nz(0), generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i, noise_i = 1, 1
        for j, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * j](out, latent[:, i], nz((noise_i + 1) // 2),
                                    generator)
            out = self.convs[2 * j + 1](out, latent[:, i + 1],
                                        nz((noise_i + 2) // 2), generator)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
            noise_i += 2
        return skip.permute(0, 2, 3, 1)


class ConvLayer(nn.Sequential):
    """Equal conv (+ blur before a stride-2 conv) + fused act (reference
    :557-603): [Blur,] EqualConv2d, FusedLeakyReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        layers: list = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers += [EqualConv2d(in_ch, out_ch, kernel_size, stride, padding,
                               bias=False), FusedLeakyReLU(out_ch)]
        super().__init__(*layers)


class FullGenerator(nn.Module):
    """GPEN (reference :630-687): the encoder pyramid's last map → style
    latent (through the style MLP); its maps are the synthesis network's
    concat noise. NHWC RGB in [-1, 1] in and out."""

    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01):
        super().__init__()
        ch = channels_of(channel_multiplier)
        self.log_size = int(math.log2(size))
        self.generator = StyleGANGenerator(size, style_dim, n_mlp,
                                           channel_multiplier, blur_kernel,
                                           lr_mlp)
        self.ecd0 = nn.Sequential(ConvLayer(3, ch[size], 1))
        in_ch = ch[size]
        for i in range(self.log_size, 2, -1):
            out_ch = ch[2 ** (i - 1)]
            setattr(self, f"ecd{self.log_size - i + 1}", nn.Sequential(
                ConvLayer(in_ch, out_ch, 3, downsample=True,
                          blur_kernel=blur_kernel)))
            in_ch = out_ch
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, style_dim, activation="fused_lrelu"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = x.permute(0, 3, 1, 2).to(self.final_linear[0].weight.dtype)
        noise = []
        for i in range(self.log_size - 1):
            feat = getattr(self, f"ecd{i}")(feat)
            noise.append(feat.permute(0, 2, 3, 1))
        style = self.final_linear(feat.reshape(feat.shape[0], -1))
        return self.generator(style, noise[::-1]).float()
