"""Motion-blur kernel synthesis and PSF→OTF (a numpy/scipy copy of
``kair_tpu/degrade/deblur.py``; reference utils/utils_deblur.py).

Motion kernels bin a random 3-D camera-shake trajectory
(``blurkernel_synthesis``, utils_deblur.py:555-641); USRNet's training
dataset draws them (dataset_usrnet.py:77-84). Where the JAX function calls
``cv2.resize(..., INTER_LINEAR)`` on a quarter of its kernels
(``kair_tpu/degrade/deblur.py:93-96``), this one calls
:func:`resize_linear`, the same interpolation in numpy, so that the
dataset needs no cv2 (the card has none).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.signal import convolve2d


def fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    x, y = np.mgrid[-size // 2 + 1: size // 2 + 1, -size // 2 + 1: size // 2 + 1]
    g = np.exp(-((x ** 2 + y ** 2) / (2.0 * sigma ** 2)))
    return g / g.sum()


def _linear_taps(n_in: int, n_out: int):
    """(first, second, their weights) of each output sample along one axis
    of cv2's INTER_LINEAR: half-pixel centres, source position
    (d + 0.5) · n_in / n_out − 0.5, clamped to the first and last sample."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= n_in - 1] = 0.0
    s[s >= n_in - 1] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), 1.0 - f, f


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for a 2-D
    float64 array, ``size`` = (width, height) as cv2 takes it: the rows
    first, then the columns, in float64 as cv2 computes a float64 image."""
    w_out, h_out = size
    x0, x1, a0, a1 = _linear_taps(img.shape[1], w_out)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], h_out)
    rows = img[:, x0] * a0 + img[:, x1] * a1
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


def _rot3d(x, r):
    Rx = np.array([[1, 0, 0], [0, np.cos(r[0]), -np.sin(r[0])],
                   [0, np.sin(r[0]), np.cos(r[0])]])
    Ry = np.array([[np.cos(r[1]), 0, np.sin(r[1])], [0, 1, 0],
                   [-np.sin(r[1]), 0, np.cos(r[1])]])
    Rz = np.array([[np.cos(r[2]), -np.sin(r[2]), 0],
                   [np.sin(r[2]), np.cos(r[2]), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx @ x


def random_trajectory(T: int, rng: np.random.Generator) -> np.ndarray:
    """3-D shake trajectory (reference utils_deblur.py:618-632)."""
    x = np.zeros((3, T))
    v = rng.standard_normal((3, T))
    r = np.zeros((3, T))
    trv, trr = 1.0, 2 * np.pi / T
    for t in range(1, T):
        F_rot = rng.standard_normal(3) / (t + 1) + r[:, t - 1]
        F_trans = rng.standard_normal(3) / (t + 1)
        r[:, t] = r[:, t - 1] + trr * F_rot
        v[:, t] = v[:, t - 1] + trv * F_trans
        x[:, t] = x[:, t - 1] + _rot3d(v[:, t], r[:, t])
    return x


def kernel_from_trajectory(x: np.ndarray,
                           rng: np.random.Generator) -> Optional[np.ndarray]:
    """Bin the trajectory into a kernel (reference utils_deblur.py:586-615),
    with histogram-style binning in place of the double loop."""
    h = 5 - np.log(rng.random()) / 0.15
    h = int(round(min(h, 27)))
    h = h + 1 - h % 2
    w = h
    xmin, xmax = x[0].min(), x[0].max()
    ymin, ymax = x[1].min(), x[1].max()
    if xmax <= xmin or ymax <= ymin:
        return None
    xthr = np.arange(xmin, xmax, (xmax - xmin) / w)
    ythr = np.arange(ymin, ymax, (ymax - ymin) / h)
    k = np.zeros((h, w))
    # k[i-1, j-1] counts the points in [xthr[i-1], xthr[i]) x
    # [ythr[j-1], ythr[j]), as the reference's loops do
    xi = np.searchsorted(xthr, x[0], side="right") - 1
    yj = np.searchsorted(ythr, x[1], side="right") - 1
    valid = (xi >= 0) & (xi < xthr.size - 1) & (yj >= 0) & (yj < ythr.size - 1)
    np.add.at(k, (xi[valid], yj[valid]), 1)
    if k.sum() == 0:
        return None
    k = k / k.sum()
    k = convolve2d(k, fspecial_gauss(3, 1), "same")
    return k / k.sum()


def blurkernel_synthesis(h: int = 37, w: Optional[int] = None,
                         rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random motion-blur kernel (reference utils_deblur.py:555-583)."""
    rng = rng or np.random.default_rng()
    w = h if w is None else w
    x = random_trajectory(250, rng)
    k = None
    while k is None:
        k = kernel_from_trajectory(x, rng)

    pw = ((h - k.shape[0]) // 2, (w - k.shape[1]) // 2)
    if pw[0] < 0 or pw[1] < 0:
        k = k[:h, :h]
    else:
        k = np.pad(k, [(pw[0],), (pw[1],)], "constant")
    x1, x2 = k.shape
    if rng.integers(0, 4) == 1:
        k = resize_linear(k, (int(rng.integers(x1, 5 * x1)),
                              int(rng.integers(x2, 5 * x2))))
        y1, y2 = k.shape
        k = k[(y1 - x1) // 2: (y1 - x1) // 2 + x1,
              (y2 - x2) // 2: (y2 - x2) // 2 + x2]
    if k.sum() < 0.1:
        from kair_tpu_torch.degrade.blindsr import fspecial_gaussian
        k = fspecial_gaussian(h, 0.1 + 6 * rng.random())
    return k / k.sum()


def psf2otf(psf: np.ndarray, shape=None) -> np.ndarray:
    """MATLAB psf2otf (reference utils_deblur.py:153-200): zero-pad to
    shape, circularly shift the center to (0, 0), FFT."""
    if shape is None:
        shape = psf.shape
    shape = np.asarray(shape)
    if np.all(psf == 0):
        return np.zeros(tuple(shape), np.complex64)
    inshape = psf.shape
    pad = np.zeros(tuple(shape), psf.dtype)
    pad[: inshape[0], : inshape[1]] = psf
    for axis, axis_size in enumerate(inshape):
        pad = np.roll(pad, -int(axis_size / 2), axis=axis)
    return np.fft.fft2(pad)
