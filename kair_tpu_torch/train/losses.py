"""Training losses: the pixel losses and the GAN objectives (counterpart of
``kair_tpu/train/losses.py``; reference model_plain.py:181-205,
models/loss.py, models/loss_ssim.py). Images are NHWC.

The GAN losses (reference loss.py:136-173) and the StyleGAN2 regularisers
(R1, path length, gradient penalty; loss.py:222-290) take torch callables
and differentiate them with ``torch.autograd.grad(..., create_graph=True)``,
so their penalties train the network they probe. ``poisson_ll_loss`` is
the SPECT fork's negative Poisson log-likelihood in the counts domain.
"""

from __future__ import annotations

import math
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


def gan_loss(logits, target_is_real: bool, gan_type: str = "gan",
             real_label: float = 1.0, fake_label: float = 0.0):
    """GANLoss (reference loss.py:136-173; JAX ``losses.gan_loss``). For
    'ragan' the caller passes relativised logits, as the reference does at
    its call site (model_gan.py:242-251)."""
    gan_type = gan_type.lower()
    if gan_type in ("gan", "ragan"):
        label = real_label if target_is_real else fake_label
        return F.binary_cross_entropy_with_logits(
            logits, torch.full_like(logits, label))
    if gan_type == "lsgan":
        label = real_label if target_is_real else fake_label
        return torch.mean((logits - label) ** 2)
    if gan_type == "wgan":
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    if gan_type == "softplusgan":
        return torch.mean(F.softplus(-logits)) if target_is_real \
            else torch.mean(F.softplus(logits))
    raise NotImplementedError(f"GAN type [{gan_type}] is not found")


def denormalize_spect(img, method: str = "linear", max_pixel: float = 150.0):
    """Normalised SPECT images back to counts, on tensors (reference
    loss.py:310-319; the JAX loss's default method is "linear", unlike
    ``utils/spect``'s "log")."""
    if method == "log":
        return torch.exp(img * math.log(max_pixel + 1.0)) - 1.0
    if method == "anscombe":
        return (math.sqrt(max_pixel + 3.0 / 8.0) * img) ** 2 - 3.0 / 8.0
    if method == "linear":
        return img * max_pixel
    raise ValueError(f"Unknown normalization method: {method}")


def poisson_ll_loss(pred, target, normalization_method: str = "linear",
                    max_pixel: float = 150.0, epsilon: float = 1e-9):
    """Negative mean Poisson log-likelihood −(k·log λ − λ) in the counts
    domain: λ the denormalised prediction clipped below at ``epsilon``, k
    the denormalised target clipped at 0 (fork, reference loss.py:294-345)."""
    lam = torch.clamp(denormalize_spect(pred, normalization_method,
                                        max_pixel), min=epsilon)
    k = torch.clamp(denormalize_spect(target, normalization_method,
                                      max_pixel), min=0.0)
    return -torch.mean(k * torch.log(lam) - lam)


def get_loss_fn(name: str, opt_train: Optional[dict] = None) -> Callable:
    """Loss selection mirroring model_plain.py:181-205 (the GAN objectives
    are ``gan_loss``'s, not pixel losses: "gan" is not found here, as in
    the JAX package)."""
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
    if name == "poisson":
        return partial(
            poisson_ll_loss,
            normalization_method=opt_train.get(
                "G_poisson_normalization_method") or "linear",
            max_pixel=opt_train.get("G_poisson_max_pixel") or 150.0,
            epsilon=opt_train.get("G_poisson_epsilon") or 1e-9)
    raise NotImplementedError(f"Loss type [{name}] is not found.")


# ----------------------------------------------------------------------------
# StyleGAN2 training regularisers (reference models/loss.py:222-290)
# ----------------------------------------------------------------------------

def r1_penalty(d_fn: Callable, real_img: torch.Tensor) -> torch.Tensor:
    """R1 penalty on real data (reference loss.py:222-237): the batch mean
    of the squared L2 norm of d sum(D(real)) / d real."""
    real_img = real_img.detach().requires_grad_(True)
    grad, = torch.autograd.grad(d_fn(real_img).sum(), real_img,
                                create_graph=True)
    return grad.pow(2).reshape(grad.shape[0], -1).sum(1).mean()


def g_path_regularize(g_fn: Callable, latents: torch.Tensor,
                      mean_path_length, noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      decay: float = 0.01):
    """StyleGAN2 path-length regularisation (reference loss.py:239-251).

    g_fn maps latents (B, n_latent, D) to an NHWC image; without ``noise``
    it is drawn from ``generator`` and scaled by 1/sqrt(H·W). Returns
    (path_penalty, mean path length, new mean path length), the last two
    detached: carry the last as training state."""
    if not latents.requires_grad:
        latents = latents.detach().requires_grad_(True)
    fake = g_fn(latents)
    if noise is None:
        hw = fake.shape[1] * fake.shape[2] if fake.ndim == 4 else fake.numel()
        noise = torch.randn(fake.shape, generator=generator,
                            device=fake.device, dtype=fake.dtype) / math.sqrt(hw)
    grad, = torch.autograd.grad(fake, latents, noise, create_graph=True)
    path_lengths = grad.pow(2).sum(2).mean(1).sqrt()
    path_mean = mean_path_length + decay * (path_lengths.mean()
                                            - mean_path_length)
    path_penalty = (path_lengths - path_mean).pow(2).mean()
    return (path_penalty, path_lengths.mean().detach(),
            torch.as_tensor(path_mean).detach())


def gradient_penalty_loss(d_fn: Callable, real_data: torch.Tensor,
                          fake_data: torch.Tensor,
                          alpha: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          weight: Optional[torch.Tensor] = None,
                          channel_axis: int = -1) -> torch.Tensor:
    """WGAN-GP (reference loss.py:254-290): D's gradient at an interpolate
    of real and fake must have unit L2 norm over the channel axis (-1 for
    NHWC). ``alpha`` (B, 1, 1, 1), or drawn uniform from ``generator``."""
    b = real_data.shape[0]
    if alpha is None:
        alpha = torch.rand((b,) + (1,) * (real_data.ndim - 1),
                           generator=generator, device=real_data.device,
                           dtype=real_data.dtype)
    interp = (alpha * real_data.detach() + (1.0 - alpha) * fake_data.detach()
              ).requires_grad_(True)
    out = d_fn(interp)
    grads, = torch.autograd.grad(out, interp, torch.ones_like(out),
                                 create_graph=True)
    if weight is not None:
        grads = grads * weight
    gp = (grads.pow(2).sum(channel_axis).sqrt() - 1.0).pow(2).mean()
    if weight is not None:
        gp = gp / weight.mean()
    return gp
