"""SPECT (bone-scan) count normalisation and Poisson utilities, numpy
(counterpart of ``kair_tpu/utils/spect.py``; fork reference
utils/utils_spect.py:3-35).

Counts k of a (2, 1024, 256) anterior/posterior scan map to network inputs
by ``normalize_spect`` (log: log(k + 1) / log(max + 1); anscombe:
sqrt(k + 3/8) / sqrt(max + 3/8); linear: k / max) and back by
``denormalize_spect``. ``poisson_log_likelihood`` scores an estimate in the
counts domain; ``anscombe`` / ``inverse_anscombe`` are the variance-
stabilising pair; ``binomial_thin`` simulates a reduced-dose scan.
"""

from __future__ import annotations

import numpy as np

METHODS = ("log", "anscombe", "linear")


def normalize_spect(img: np.ndarray, method: str = "log",
                    max_pixel: float = 150) -> np.ndarray:
    if method == "log":
        return np.log(img + 1.0) / np.log(max_pixel + 1.0)
    if method == "anscombe":
        return np.sqrt(img + 3 / 8) / np.sqrt(max_pixel + 3 / 8)
    if method == "linear":
        return img / max_pixel
    raise ValueError(f"Unknown normalization method: {method}")


def denormalize_spect(img: np.ndarray, method: str = "log",
                      max_pixel: float = 150) -> np.ndarray:
    if method == "log":
        return np.exp(img * np.log(max_pixel + 1.0)) - 1.0
    if method == "anscombe":
        return (np.sqrt(max_pixel + 3 / 8) * img) ** 2 - 3 / 8
    if method == "linear":
        return img * max_pixel
    raise ValueError(f"Unknown normalization method: {method}")


def poisson_log_likelihood(pred_counts: np.ndarray, target_counts: np.ndarray,
                           epsilon: float = 1e-9) -> float:
    """Mean Poisson log-likelihood k·log λ − λ in the counts domain, λ
    clipped below at ``epsilon`` and k at 0 (reference utils_image.pll,
    utils_image.py:833-861)."""
    lam = np.clip(pred_counts, epsilon, None)
    k = np.clip(target_counts, 0, None)
    return float(np.mean(k * np.log(lam) - lam))


def anscombe(counts: np.ndarray) -> np.ndarray:
    """2·sqrt(k + 3/8): Poisson counts to about unit-variance Gaussian."""
    return 2.0 * np.sqrt(np.clip(counts, 0, None) + 3.0 / 8.0)


def inverse_anscombe(y: np.ndarray, unbiased: bool = True) -> np.ndarray:
    """The algebraic inverse (biased), or Makitalo & Foi's closed-form
    approximately unbiased one."""
    if not unbiased:
        return (y / 2.0) ** 2 - 3.0 / 8.0
    yc = np.clip(y, 1e-6, None)
    return ((y / 2.0) ** 2 - 1.0 / 8.0 + np.sqrt(1.5) / 4.0 / yc
            - 11.0 / 8.0 / yc ** 2 + 5.0 * np.sqrt(1.5) / 8.0 / yc ** 3)


def binomial_thin(counts: np.ndarray, dose_fraction: float,
                  rng: np.random.Generator) -> np.ndarray:
    """A reduced-dose acquisition from full-dose counts: each event kept
    with probability ``dose_fraction``. Poisson(λ) thinned this way is
    exactly Poisson(dose_fraction·λ)."""
    if not 0.0 <= dose_fraction <= 1.0:
        raise ValueError(f"dose_fraction must be in [0,1], got {dose_fraction}")
    k = np.clip(np.round(counts), 0, None).astype(np.int64)
    return rng.binomial(k, dose_fraction).astype(np.float32)
