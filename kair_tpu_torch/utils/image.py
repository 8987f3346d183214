"""Image utilities for the port: IO, conversions, MATLAB-faithful bicubic
resize and the PSNR / SSIM metrics (counterpart of ``kair_tpu/utils/image.py``,
which is pure numpy; the port keeps its own copy so it never imports the
JAX package).

Host images are HWC (or HW) numpy arrays as in the reference; batches for
the model are NHWC. ``augment_img`` is the training datasets' flip and
rotation. Metric parity targets: PSNR utils_image.py:629-644, SSIM
utils_image.py:650-697 (11x11 sigma 1.5 Gaussian, valid region), bicubic
imresize utils_image.py:871-1014 (MATLAB antialiased kernel, symmetric
boundary). ``cv2`` is imported only inside the file readers and writers.
"""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np

IMG_EXTENSIONS = [".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".tiff", ".JPG",
                  ".JPEG", ".PNG", ".PPM", ".BMP", ".TIF"]


def is_image_file(filename: str) -> bool:
    return any(filename.endswith(ext) for ext in IMG_EXTENSIONS)


def get_image_paths(dataroot: str) -> List[str]:
    """Sorted recursive listing of image files (reference: utils_image.py:70-97)."""
    paths = []
    for dirpath, _, fnames in sorted(os.walk(dataroot)):
        for fname in sorted(fnames):
            if is_image_file(fname):
                paths.append(os.path.join(dirpath, fname))
    assert paths, f"{dataroot} has no valid image file"
    return paths


def imread_uint(path: str, n_channels: int = 3) -> np.ndarray:
    """Read an image as uint8 HxWxC (RGB order for 3-channel)."""
    import cv2
    if n_channels == 1:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        img = np.expand_dims(img, axis=2)
    else:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2RGB)
        else:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def imsave(img: np.ndarray, img_path: str) -> None:
    import cv2
    img = np.squeeze(img)
    if img.ndim == 3:
        img = img[:, :, [2, 1, 0]]
    cv2.imwrite(img_path, img)


def uint2single(img: np.ndarray) -> np.ndarray:
    return np.float32(img / 255.0)


def single2uint(img: np.ndarray) -> np.ndarray:
    return np.uint8((np.clip(img, 0, 1) * 255.0).round())


def hwc_to_nhwc(img: np.ndarray) -> np.ndarray:
    """HWC (or HW) float image -> 1xHxWxC."""
    if img.ndim == 2:
        img = img[:, :, None]
    return np.ascontiguousarray(img, dtype=np.float32)[None]


def nhwc_to_uint(x) -> np.ndarray:
    """Device output -> uint8 HWC/HW with clamp+round
    (reference tensor2uint: utils_image.py:296-300)."""
    img = np.squeeze(np.asarray(x, dtype=np.float32))
    return np.uint8((np.clip(img, 0, 1) * 255.0).round())


def augment_img(img: np.ndarray, mode: int = 0) -> np.ndarray:
    """The eight flips and rotations of the reference table
    (utils_image.py:387-404), as numpy views."""
    if mode == 0:
        return img
    elif mode == 1:
        return np.flipud(np.rot90(img))
    elif mode == 2:
        return np.flipud(img)
    elif mode == 3:
        return np.rot90(img, k=3)
    elif mode == 4:
        return np.flipud(np.rot90(img, k=2))
    elif mode == 5:
        return np.rot90(img)
    elif mode == 6:
        return np.rot90(img, k=2)
    elif mode == 7:
        return np.flipud(np.rot90(img, k=3))
    raise ValueError(f"bad augment mode {mode}")


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    """Crop so H and W are multiples of scale (reference: utils_image.py:500-513)."""
    img = np.copy(img)
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    in_img_type = img.dtype
    img = img.astype(np.float64)
    if in_img_type != np.uint8:
        img = img * 255.0
    if only_y:
        rlt = np.dot(img, [65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        rlt = np.matmul(img, [[65.481, -37.797, 112.0], [128.553, -74.203, -93.786],
                              [24.966, 112.0, -18.214]]) / 255.0 + [16, 128, 128]
    if in_img_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.0
    return rlt.astype(in_img_type)


def calculate_psnr(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    """PSNR on [0,255] images (reference: utils_image.py:629-644)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border: h - border, border: w - border].astype(np.float64)
    img2 = img2[border: h - border, border: w - border].astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _matlab_gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """The 11x11 σ=1.5 window cv2.getGaussianKernel produces
    (reference ssim uses it: utils_image.py:682-683)."""
    g = np.exp(-((np.arange(size) - (size - 1) / 2.0) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g)


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    """Single-channel MATLAB SSIM (reference: utils_image.py:676-697).

    Uses a 'valid' windowed correlation — equivalent to the reference's
    cv2.filter2D followed by the [5:-5,5:-5] crop, since the crop removes
    every border-influenced pixel.
    """
    from scipy.signal import fftconvolve

    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _matlab_gaussian_window()

    mu1 = fftconvolve(img1, window, mode="valid")
    mu2 = fftconvolve(img2, window, mode="valid")
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = fftconvolve(img1 ** 2, window, mode="valid") - mu1_sq
    sigma2_sq = fftconvolve(img2 ** 2, window, mode="valid") - mu2_sq
    sigma12 = fftconvolve(img1 * img2, window, mode="valid") - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
    """MATLAB-equivalent SSIM on [0,255] images (reference: utils_image.py:650-673)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    h, w = img1.shape[:2]
    img1 = img1[border: h - border, border: w - border]
    img2 = img2[border: h - border, border: w - border]

    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] in (2, 3):
            return float(np.mean([_ssim_single(img1[:, :, i], img2[:, :, i])
                                  for i in range(img1.shape[2])]))
        if img1.shape[2] == 1:
            return _ssim_single(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB bicubic kernel (reference: utils_image.py:871-876)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) +
            (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def resize_weights(in_length: int, out_length: int, scale: float,
                   antialiasing: bool = True) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Weights/indices for one resize axis (reference: utils_image.py:879-931).

    Returns (weights [out,P], indices [out,P] into the symmetric-padded axis,
    sym_len_start, sym_len_end).
    """
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(P, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # drop an all-but-guaranteed-zero first/last column (reference :919-926)
    zero_cols = (weights == 0).sum(axis=0)
    if zero_cols[0] != 0:
        indices = indices[:, 1: 1 + P - 2]
        weights = weights[:, 1: 1 + P - 2]
    if zero_cols[-1] != 0:
        indices = indices[:, 0: P - 2]
        weights = weights[:, 0: P - 2]

    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_length)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return np.ascontiguousarray(weights), indices, sym_len_s, sym_len_e


def _sym_pad_axis0(img: np.ndarray, s: int, e: int) -> np.ndarray:
    """Symmetric (reflect-with-repeat-free) padding along axis 0, matching the
    reference's manual flip-copy (utils_image.py:1024-1038)."""
    parts = []
    if s > 0:
        parts.append(img[:s][::-1])
    parts.append(img)
    if e > 0:
        parts.append(img[-e:][::-1])
    return np.concatenate(parts, axis=0)


def imresize_np(img: np.ndarray, scale: float, antialiasing: bool = True) -> np.ndarray:
    """MATLAB bicubic resize for HWC/HW [0,1] numpy images
    (reference: utils_image.py:1011-1090), vectorised with gathers."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    img = img.astype(np.float64)
    in_h, in_w = img.shape[:2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)

    w_h, idx_h, s_h, e_h = resize_weights(in_h, out_h, scale, antialiasing)
    w_w, idx_w, s_w, e_w = resize_weights(in_w, out_w, scale, antialiasing)

    # H axis: pad, gather, contract
    img_aug = _sym_pad_axis0(img, s_h, e_h)              # (in_h+s+e, W, C)
    gathered = img_aug[idx_h]                             # (out_h, P, W, C)
    out1 = np.einsum("op,opwc->owc", w_h, gathered)

    # W axis
    out1_t = np.swapaxes(out1, 0, 1)                      # (W, out_h, C)
    out1_aug = _sym_pad_axis0(out1_t, s_w, e_w)           # (in_w+s+e, out_h, C)
    gathered = out1_aug[idx_w]                            # (out_w, P, out_h, C)
    out2 = np.einsum("wp,wphc->hwc", w_w, gathered)       # (out_h, out_w, C)

    if squeeze:
        out2 = out2[:, :, 0]
    return out2
