"""SISR degradation synthesis: Gaussian blur kernels, PCA projection, and
the classical / srmd / dpsr / bicubic degradation models (a numpy/scipy
copy of ``kair_tpu/degrade/sisr.py``; reference utils/utils_sisr.py:35-295).

Host-side numpy (runs in the data pipeline); kernels are small so the math
is vectorised rather than the reference's per-pixel loops
(gm_blur_kernel, utils_sisr.py:56-67).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
from scipy import ndimage


def gm_blur_kernel(mean, cov, size: int = 15) -> np.ndarray:
    """Gaussian pdf kernel with the reference's center convention
    (utils_sisr.py:56-67: coordinates cy,cx = idx - size/2 - 0.5 + 1)."""
    center = size / 2.0 + 0.5
    ys = np.arange(size) - center + 1
    xs = np.arange(size) - center + 1
    cx, cy = np.meshgrid(xs, ys)                      # k[y,x] at (cx, cy)
    pts = np.stack([cx, cy], axis=-1) - np.asarray(mean)
    icov = np.linalg.inv(cov)
    expo = -0.5 * np.einsum("...i,ij,...j->...", pts, icov, pts)
    k = np.exp(expo) / (2 * np.pi * math.sqrt(np.linalg.det(cov)))
    return k / k.sum()


def anisotropic_gaussian(ksize: int = 15, theta: float = np.pi,
                         l1: float = 6, l2: float = 6) -> np.ndarray:
    """Rotated anisotropic Gaussian (reference utils_sisr.py:35-54)."""
    v = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]]) @ np.array([1.0, 0.0])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.array([[l1, 0], [0, l2]])
    sigma = V @ D @ np.linalg.inv(V)
    return gm_blur_kernel([0, 0], sigma, ksize)


def shifted_anisotropic_gaussian(k_size=(15, 15), sf: int = 4,
                                 min_var: float = 0.6, max_var: float = 10.0,
                                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """USRNet-style random shifted kernel (reference utils_sisr.py:130-170)."""
    rng = rng or np.random.default_rng()
    k_size = np.asarray(k_size)
    lambda_1 = min_var + rng.random() * (max_var - min_var)
    lambda_2 = min_var + rng.random() * (max_var - min_var)
    theta = rng.random() * np.pi
    LAMBDA = np.diag([lambda_1, lambda_2])
    Q = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    SIGMA = Q @ LAMBDA @ Q.T
    INV_SIGMA = np.linalg.inv(SIGMA)
    MU = k_size // 2 - 0.5 * (np.array([sf, sf]) - 1)
    X, Y = np.meshgrid(range(k_size[0]), range(k_size[1]))
    Z = np.stack([X, Y], 2) - MU
    raw = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", Z, INV_SIGMA, Z))
    return raw / raw.sum()


def get_pca_matrix(x: np.ndarray, dim_pca: int = 15) -> np.ndarray:
    """(k², N) kernel samples → (dim_pca, k²) projection
    (reference utils_sisr.py:76-89)."""
    import scipy.linalg

    C = x @ x.T
    _, v = scipy.linalg.eigh(C)
    return v[:, -dim_pca:].T


def cal_pca_matrix(ksize: int = 15, l_max: float = 12.0, dim_pca: int = 15,
                   num_samples: int = 500,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sample anisotropic kernels and compute their PCA basis
    (reference utils_sisr.py:100-127; column-major flatten like MATLAB)."""
    rng = rng or np.random.default_rng(0)
    kernels = np.zeros([ksize * ksize, num_samples], np.float32)
    for i in range(num_samples):
        theta = np.pi * rng.random()
        l1 = 0.1 + l_max * rng.random()
        l2 = 0.1 + (l1 - 0.1) * rng.random()
        k = anisotropic_gaussian(ksize, theta, l1, l2)
        kernels[:, i] = k.flatten(order="F")
    return get_pca_matrix(kernels, dim_pca)


_ASSETS = os.path.join(os.path.dirname(__file__), "..", "data", "assets")


def load_srmd_pca(path: Optional[str] = None) -> np.ndarray:
    """The published (15, 225) SRMD PCA projection basis. Released SRMD
    checkpoints were trained against exactly this P, so it is a data asset
    of the degradation protocol — vendored at data/assets/srmd_pca.npz
    (reference ships it as kernels/srmd_pca_matlab.mat; cal_pca_matrix
    regenerates an equivalent basis from scratch)."""
    if path is None:
        path = os.path.join(_ASSETS, "srmd_pca.npz")
    if path.endswith(".mat"):
        from scipy.io import loadmat

        return np.asarray(loadmat(path)["P"], np.float32)
    return np.load(path)["P"].astype(np.float32)


def load_kernels_12(path: Optional[str] = None) -> np.ndarray:
    """The 12 (25, 25) validation blur kernels (8 Gaussian + 4 motion) of
    the USRNet/SRMD eval protocols — vendored at data/assets/kernels_12.npz
    (reference: kernels/kernels_12.mat, dataset_usrnet.py:32,105)."""
    if path is None:
        path = os.path.join(_ASSETS, "kernels_12.npz")
    if path.endswith(".mat"):
        from scipy.io import loadmat

        cells = loadmat(path)["kernels"]
        return np.stack([np.asarray(cells[0, i], np.float64)
                         for i in range(cells.shape[1])])
    return np.load(path)["kernels"]


def pca_project(k: np.ndarray, pca: np.ndarray) -> np.ndarray:
    """Kernel (k,k) → PCA coefficients (dim_pca,), column-major flatten."""
    return pca @ k.flatten(order="F").astype(pca.dtype)


# ----------------------------------------------------------------------------
# degradation models (reference utils_sisr.py:223-295)
# ----------------------------------------------------------------------------

def bicubic_degradation(x: np.ndarray, sf: int = 3) -> np.ndarray:
    from kair_tpu_torch.utils.image import imresize_np

    return imresize_np(x, 1.0 / sf)


def srmd_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """blur (wrap) then bicubic down (reference :235-254)."""
    x = ndimage.convolve(x, k[:, :, None], mode="wrap")
    return bicubic_degradation(x, sf)


def dpsr_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """bicubic down then blur (reference :257-277)."""
    x = bicubic_degradation(x, sf)
    return ndimage.convolve(x, k[:, :, None], mode="wrap")


def classical_degradation(x: np.ndarray, k: np.ndarray, sf: int = 3) -> np.ndarray:
    """blur then s-fold subsample keeping upper-left (reference :280-294)."""
    x = ndimage.convolve(x, k[:, :, None], mode="wrap")
    return x[::sf, ::sf, ...]
