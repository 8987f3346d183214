"""The SPECT fork's evaluation harness (counterpart of
``kair_tpu/eval/harness.py``; reference ``ModelBase.evaluate_metrics``,
model_base.py:280-569): per image and channel, PSNR / SSIM (/ LPIPS) at a
GLOBAL count scale (the largest H count over the set) and a LOCAL one (the
image's own largest count); optionally the estimate re-Poissoned first,
with the local LPIPS averaged over repeated draws; the Poisson
log-likelihood, and the loss per image.

LPIPS is optional (no weights ship with the repository): pass an
``lpips_fn(img_a_uint8_rgb, img_b_uint8_rgb) -> float`` (the third item
of ``models/lpips.load_lpips_default()``) or None, which reports nan.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from kair_tpu_torch.utils import image as im
from kair_tpu_torch.utils.spect import denormalize_spect, poisson_log_likelihood


def _channel_metrics(e_ch, h_ch, max_val, lpips_fn):
    """One channel clipped to [0, max_val] and scaled to uint8: PSNR, SSIM
    and LPIPS (nan without ``lpips_fn``) (reference
    _compute_channel_metrics, model_base.py:357-380). The reference scores
    the channel repeated to three gray channels; their PSNR and SSIM are
    the one channel's, computed here once, and LPIPS takes the three."""
    e = np.clip(e_ch, 0, max_val)
    h = np.clip(h_ch, 0, max_val)
    if max_val > 0:
        e8 = (e / max_val * 255).astype(np.uint8)
        h8 = (h / max_val * 255).astype(np.uint8)
    else:
        e8 = np.zeros_like(e, np.uint8)
        h8 = np.zeros_like(h, np.uint8)
    psnr = im.calculate_psnr(e8, h8)
    ssim = im.calculate_ssim(e8, h8)
    lp = float(lpips_fn(np.stack([e8] * 3, axis=2),
                        np.stack([h8] * 3, axis=2))) if lpips_fn \
        else float("nan")
    return psnr, ssim, lp


def evaluate_images(
    imgs_e: Sequence[np.ndarray], imgs_h: Sequence[np.ndarray],
    lpips_fn: Optional[Callable] = None,
    add_poisson_noise: bool = False,
    lpips_local_repeat_n: int = 1,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, float]:
    """HWC images in the COUNTS domain (already denormalised): the means
    of the global and local PSNR / SSIM / LPIPS over images and channels,
    and of the Poisson log-likelihood over images. ``rng`` (default
    ``default_rng(0)``) draws the re-Poissoned estimates, image by image
    and channel by channel in the JAX package's order."""
    rng = rng or np.random.default_rng(0)
    max_val_global = max(float(np.max(h)) for h in imgs_h)

    sums: Dict[str, float] = {k: 0.0 for k in
                              ("psnr", "ssim", "lpips", "psnr_local",
                               "ssim_local", "lpips_local", "pll")}
    n_total = 0
    for e_img, h_img in zip(imgs_e, imgs_h):
        if add_poisson_noise:
            # compare like with like: the estimate re-Poissoned against the
            # Poisson-noisy H (fork semantics, model_base.py:404-470)
            e_used = rng.poisson(np.clip(e_img, 0, None)).astype(np.float64)
        else:
            e_used = e_img
        max_val_local = max(float(np.max(h_img)), 1e-12)
        for ch in range(e_img.shape[2]):
            pg, sg, lg = _channel_metrics(e_used[:, :, ch], h_img[:, :, ch],
                                          max_val_global, lpips_fn)
            pl, sl, _ = _channel_metrics(e_used[:, :, ch], h_img[:, :, ch],
                                         max_val_local, None)
            if add_poisson_noise and lpips_fn and lpips_local_repeat_n > 1:
                lls = []
                for _ in range(lpips_local_repeat_n):
                    e_rs = rng.poisson(np.clip(e_img[:, :, ch], 0, None))
                    lls.append(_channel_metrics(e_rs, h_img[:, :, ch],
                                                max_val_local, lpips_fn)[2])
                ll = float(np.mean(lls))
            elif lpips_fn:
                ll = _channel_metrics(e_used[:, :, ch], h_img[:, :, ch],
                                      max_val_local, lpips_fn)[2]
            else:
                ll = float("nan")
            sums["psnr"] += pg
            sums["ssim"] += sg
            sums["lpips"] += lg
            sums["psnr_local"] += pl
            sums["ssim_local"] += sl
            sums["lpips_local"] += ll
            n_total += 1
        sums["pll"] += poisson_log_likelihood(np.clip(e_used, 0, None), h_img)
    out = {k: v / max(n_total, 1) for k, v in sums.items()}
    out["pll"] = sums["pll"] / max(len(imgs_e), 1)
    return out


def _host_f32(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def evaluate_model(eval_step: Callable, loader, normalization: Optional[dict],
                   lpips_fn: Optional[Callable] = None,
                   add_poisson_noise: bool = False,
                   lpips_local_repeat_n: int = 1,
                   loss_fn: Optional[Callable] = None) -> Dict[str, float]:
    """``eval_step(batch) -> E`` (NHWC, a tensor on any device or an array)
    over a Loader's epoch 0, brought to the host in f32, denormalised to
    counts with ``normalization`` ("linear", max 150 where it says nothing,
    as the JAX harness; reference _collect_test_data, model_base.py:
    308-349), then ``evaluate_images``; "loss" the sum of ``loss_fn(E, H)``
    over batches divided by the images."""
    method = (normalization or {}).get("type", "linear")
    max_pixel = (normalization or {}).get("max_pixel", 150)
    imgs_e, imgs_h = [], []
    loss_sum, n = 0.0, 0
    for batch in loader.epoch(0):
        e = _host_f32(eval_step(batch))
        h = np.asarray(batch["H"])
        if loss_fn is not None:
            loss_sum += float(loss_fn(e, h))
        for i in range(e.shape[0]):
            imgs_e.append(denormalize_spect(e[i], method, max_pixel))
            imgs_h.append(denormalize_spect(h[i], method, max_pixel))
            n += 1
    metrics = evaluate_images(imgs_e, imgs_h, lpips_fn, add_poisson_noise,
                              lpips_local_repeat_n)
    metrics["loss"] = loss_sum / max(n, 1)
    return metrics
