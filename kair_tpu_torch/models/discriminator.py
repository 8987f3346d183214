"""Discriminators for GAN training, NHWC (counterpart of
``kair_tpu/models/discriminator.py``; reference
models/network_discriminator.py:22-300).

Spectral normalisation follows the JAX package's rule, not
``torch.nn.utils.spectral_norm``: the kernel as a (k·k·in, out) matrix W
(HWIO flattened; a dense layer's (in, out)), the iteration vector ``u`` of
length out a buffer, and one power iteration per call

    v = W u / (‖W u‖ + 1e-12),  u' = Wᵀ v / (‖Wᵀ v‖ + 1e-12),
    σ = v · (W u'),             weight / σ  with σ's gradient stopped,

computed in f32 outside autocast. ``u'`` is stored only in training mode;
in eval mode the iteration is still computed and not stored. Torch's
``spectral_norm`` lets the gradient flow through σ, iterates in the other
orientation and does not iterate in eval, so a D written with it would
differ from the first step on.

The modules are named as the JAX ones (``conv0``, ``bn1``, ``linear0``,
…; ``discriminator_from_jax`` carries a JAX tree across); the VGG-style
discriminator flattens its last map in (H, W, C) order, as the JAX package
does. BatchNorm is KAIR's (``ops.blocks.BatchNorm``, momentum 0.9 in
torch's sense, eps 1e-4; the PatchGAN's flax momentum 0.9, eps 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.ops.blocks import BatchNorm, resize_bilinear


def _initial_u(n: int) -> torch.Tensor:
    return torch.randn(n, generator=torch.Generator().manual_seed(0))


class _SpectralNorm(nn.Module):
    """The power iteration shared by SNConv and SNDense."""

    spectral: bool = False

    def matrix(self) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def sigma(self) -> torch.Tensor:
        """σ of the current weight after one iteration from ``u`` (f32,
        detached); stores the new u in training mode."""
        with torch.autocast(self.u.device.type, enabled=False):
            mat = self.matrix().detach().float()
            v = mat @ self.u
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u_new = mat.t() @ v
            u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
            sigma = v @ (mat @ u_new)
        if self.training:
            self.u.copy_(u_new)
        return sigma

    def normalised_weight(self) -> torch.Tensor:
        return self.weight / self.sigma() if self.spectral else self.weight


class SNConv(_SpectralNorm):
    """Conv2d on NHWC with optional spectral normalisation; ``weight``
    OIHW, ``bias``, buffer ``u`` (out,)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, bias: bool = True,
                 spectral: bool = True):
        super().__init__()
        k = kernel_size
        self.stride, self.padding, self.spectral = stride, padding, spectral
        self.weight = nn.Parameter(torch.randn(out_ch, in_ch, k, k) * 0.02)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        if spectral:
            self.register_buffer("u", _initial_u(out_ch))

    def matrix(self) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.normalised_weight(),
                     self.bias, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class SNDense(_SpectralNorm):
    """Linear layer with optional spectral normalisation; ``weight``
    (out, in), ``bias``, buffer ``u`` (out,)."""

    def __init__(self, in_features: int, out_features: int,
                 spectral: bool = True):
        super().__init__()
        self.spectral = spectral
        self.weight = nn.Parameter(torch.randn(out_features, in_features) * 0.02)
        self.bias = nn.Parameter(torch.zeros(out_features))
        if spectral:
            self.register_buffer("u", _initial_u(out_features))

    def matrix(self) -> torch.Tensor:
        return self.weight.t()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.normalised_weight(), self.bias)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _InstanceNorm(nn.Module):
    """Instance norm without affine parameters, biased variance, eps 1e-5."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean((1, 2), keepdim=True)
        var = x.var((1, 2), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


class PatchGAN(nn.Module):
    """70×70 PatchGAN (reference :22-87): k4 s2 p2 convs with spectral,
    batch or instance norm."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "spectral"):
        super().__init__()
        sn = "spectral" in norm_type
        self.n_layers = n_layers

        def norm(nf):
            if "batch" in norm_type:
                return BatchNorm(nf, momentum=0.1, eps=1e-5)
            if "instance" in norm_type:
                return _InstanceNorm()
            return nn.Identity()

        self.conv0 = SNConv(input_nc, ndf, 4, 2, 2, spectral=sn)
        nf = ndf
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(nf * 2, 512)
            setattr(self, f"conv{n}", SNConv(nf_prev, nf, 4, 2, 2, spectral=sn))
            setattr(self, f"norm{n}", norm(nf))
        nf_prev, nf = nf, min(nf * 2, 512)
        setattr(self, f"conv{n_layers}", SNConv(nf_prev, nf, 4, 1, 2,
                                                spectral=sn))
        setattr(self, f"norm{n_layers}", norm(nf))
        self.conv_out = SNConv(nf, 1, 4, 1, 2, spectral=sn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _lrelu(self.conv0(x))
        for n in range(1, self.n_layers + 1):
            x = _lrelu(getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(x)))
        return self.conv_out(x)


class UNetDiscriminator(nn.Module):
    """U-Net discriminator with spectral norm (reference :89-140); the ×2
    upsamplings are bilinear with half-pixel centres."""

    def __init__(self, input_nc: int = 3, ndf: int = 64):
        super().__init__()
        n = ndf
        self.conv0 = SNConv(input_nc, n, 3, 1, 1, spectral=False)
        self.conv1 = SNConv(n, n * 2, 4, 2, 1, bias=False)
        self.conv2 = SNConv(n * 2, n * 4, 4, 2, 1, bias=False)
        self.conv3 = SNConv(n * 4, n * 8, 4, 2, 1, bias=False)
        self.conv4 = SNConv(n * 8, n * 4, 3, 1, 1, bias=False)
        self.conv5 = SNConv(n * 4, n * 2, 3, 1, 1, bias=False)
        self.conv6 = SNConv(n * 2, n, 3, 1, 1, bias=False)
        self.conv7 = SNConv(n, n, 3, 1, 1, bias=False)
        self.conv8 = SNConv(n, n, 3, 1, 1, bias=False)
        self.conv9 = SNConv(n, 1, 3, 1, 1, spectral=False)

    @staticmethod
    def _up2(x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, (x.shape[1] * 2, x.shape[2] * 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = _lrelu(self.conv0(x))
        x1 = _lrelu(self.conv1(x0))
        x2 = _lrelu(self.conv2(x1))
        x3 = self._up2(_lrelu(self.conv3(x2)))
        x4 = self._up2(_lrelu(self.conv4(x3)) + x2)
        x5 = self._up2(_lrelu(self.conv5(x4)) + x1)
        x6 = _lrelu(self.conv6(x5)) + x0
        out = _lrelu(self.conv8(_lrelu(self.conv7(x6))))
        return self.conv9(out)


class VGGStyleDiscriminator(nn.Module):
    """VGG-style discriminator for 96/128/192 inputs (reference :144-258);
    the spectral variant when ``sn`` (Discriminator_VGG_128_SN, :263-300),
    which has no BatchNorm."""

    def __init__(self, input_size: int = 128, in_nc: int = 3,
                 base_nc: int = 64, ac_type: str = "BL", sn: bool = False):
        super().__init__()
        nc = base_nc
        widths = [nc, nc, nc * 2, nc * 2, nc * 4, nc * 4, nc * 8, nc * 8,
                  nc * 8, nc * 8]
        self.use_bn = "B" in ac_type and not sn
        self.n_convs = len(widths)
        prev = in_nc
        for i, w in enumerate(widths):
            k, s = (3, 1) if i % 2 == 0 else (4, 2)
            setattr(self, f"conv{i}", SNConv(prev, w, k, s, 1, spectral=sn))
            if i > 0 and self.use_bn:
                setattr(self, f"bn{i}", BatchNorm(w))
            prev = w
        side = input_size // 2 ** (len(widths) // 2)
        self.linear0 = SNDense(prev * side * side, 100, spectral=sn)
        self.linear1 = SNDense(100, 1, spectral=sn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = getattr(self, f"conv{i}")(x)
            if i > 0 and self.use_bn:
                x = getattr(self, f"bn{i}")(x)
            x = _lrelu(x)
        x = x.reshape(x.shape[0], -1)
        return self.linear1(_lrelu(self.linear0(x)))


class VGG128SN(VGGStyleDiscriminator):
    """Discriminator_VGG_128_SN preset (reference :263-300)."""

    def __init__(self, in_nc: int = 3, base_nc: int = 64):
        super().__init__(128, in_nc, base_nc, "L", sn=True)


def set_frozen_mode(model: nn.Module) -> None:
    """The modes of D where it scores without being trained (the G update,
    R1, GP): spectral layers in eval (one iteration, ``u`` kept, as the
    JAX trainer's ``train=False``), BatchNorm in training mode (batch
    statistics, running statistics updated), as KAIR's netD, which stays
    in training mode throughout."""
    for m in model.modules():
        m.training = isinstance(m, nn.modules.batchnorm._BatchNorm)


def spectral_vectors(model: nn.Module) -> dict:
    """{name: u} of every spectral layer, cloned."""
    return {n: m.u.detach().clone() for n, m in model.named_modules()
            if isinstance(m, _SpectralNorm) and m.spectral}


@torch.no_grad()
def load_spectral_vectors(model: nn.Module, vectors: dict) -> None:
    mods = dict(model.named_modules())
    for n, u in vectors.items():
        mods[n].u.copy_(u)

