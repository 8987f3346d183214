"""Pixel losses of the plain trainer (counterpart of
``kair_tpu/train/losses.py``; reference model_plain.py:181-205,
models/loss.py, models/loss_ssim.py). Images are NHWC.

The GAN losses, the StyleGAN2 regularisers (R1, path length, gradient
penalty) and the SPECT Poisson loss belong to later slices and raise.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean((pred - target) ** 2)


def l2sum_loss(pred, target):
    return torch.sum((pred - target) ** 2)


def charbonnier_loss(pred, target, eps: float = 1e-9):
    """reference loss.py:208-219 (eps is added unsquared, as there)."""
    diff = pred - target
    return torch.mean(torch.sqrt(diff * diff + eps))


def tv_loss(x, weight: float = 1.0):
    """Total variation (reference loss.py:179-204) of an NHWC batch."""
    n, h, w, c = x.shape
    count_h = c * (h - 1) * w
    count_w = c * h * (w - 1)
    h_tv = torch.sum((x[:, 1:] - x[:, :h - 1]) ** 2)
    w_tv = torch.sum((x[:, :, 1:] - x[:, :, :w - 1]) ** 2)
    return weight * 2 * (h_tv / count_h + w_tv / count_w) / n


def _ssim_window(window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    g = torch.exp(-((torch.arange(window_size) - window_size // 2) ** 2)
                  / (2.0 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(pred, target, window_size: int = 11):
    """Differentiable SSIM of NHWC [0, 1] images: per-channel Gaussian
    windows with zero 'same' padding (reference loss_ssim.py:27-47)."""
    c = pred.shape[-1]
    k = _ssim_window(window_size).to(pred)[None, None].expand(c, 1, -1, -1)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), k, padding=window_size // 2,
                        groups=c).permute(0, 2, 3, 1)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = filt(pred), filt(target)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = filt(pred * pred) - mu1_sq
    s2 = filt(target * target) - mu2_sq
    s12 = filt(pred * target) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)


def ssim_loss(pred, target):
    """1 − SSIM, the minimisable form (as the JAX package)."""
    return 1.0 - ssim(pred, target)


LATER_SLICES = {"poisson": "SPECT", "gan": "GAN", "ragan": "GAN",
                "lsgan": "GAN", "wgan": "GAN", "softplusgan": "GAN"}


def get_loss_fn(name: str, opt_train: Optional[dict] = None) -> Callable:
    """Loss selection mirroring model_plain.py:181-205."""
    opt_train = opt_train or {}
    if name == "l1":
        return l1_loss
    if name == "l2":
        return l2_loss
    if name == "l2sum":
        return l2sum_loss
    if name == "ssim":
        return ssim_loss
    if name == "tv":
        return lambda pred, target: tv_loss(pred)
    if name == "charbonnier":
        return partial(charbonnier_loss,
                       eps=opt_train.get("G_charbonnier_eps") or 1e-9)
    if name in LATER_SLICES:
        raise NotImplementedError(
            f"loss [{name}] belongs to the {LATER_SLICES[name]} slice of the "
            "port, not ported yet")
    raise NotImplementedError(f"Loss type [{name}] is not found.")


def _later(name: str, slice_name: str) -> Callable:
    def raise_(*args, **kwargs):
        raise NotImplementedError(
            f"{name} belongs to the {slice_name} slice of the port, not "
            "ported yet")
    raise_.__name__ = name
    return raise_


gan_loss = _later("gan_loss", "GAN")
r1_penalty = _later("r1_penalty", "GAN")
g_path_regularize = _later("g_path_regularize", "GAN")
gradient_penalty_loss = _later("gradient_penalty_loss", "GAN")
poisson_ll_loss = _later("poisson_ll_loss", "SPECT")
