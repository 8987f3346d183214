"""BSRGAN's practical degradation pipeline for blind SR training (a
numpy/scipy/cv2 copy of ``kair_tpu/degrade/blindsr.py``; reference
utils/utils_blindsr.py:309-560: random blur, resize, Gaussian, speckle,
Poisson and JPEG noise and sharpening, composed in shuffled order).

Every draw comes from the explicit ``np.random.Generator`` passed in (the
reference uses the global ``random`` / ``np.random``), in the JAX
module's order, with the same op menu, probabilities and parameter
ranges; the downsample to scale stays last as in ``degradation_bsrgan``
(utils_blindsr.py:466-470). ``cv2`` (resizes, Gaussian blur, the JPEG
codec) is imported only inside the functions that call it, where the JAX
module does: this path needs cv2, so it runs off the card (which has
none).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from kair_tpu_torch.degrade.sisr import anisotropic_gaussian
from kair_tpu_torch.utils import image as im


def fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian') (reference utils_blindsr.py:188-199)."""
    hsize = [hsize, hsize]
    siz = [(hsize[0] - 1.0) / 2.0, (hsize[1] - 1.0) / 2.0]
    std = sigma
    x, y = np.meshgrid(np.arange(-siz[1], siz[1] + 1),
                       np.arange(-siz[0], siz[0] + 1))
    arg = -(x * x + y * y) / (2 * std * std)
    h = np.exp(arg)
    h[h < np.finfo(float).eps * h.max()] = 0
    return h / h.sum() if h.sum() != 0 else h


def fspecial_laplacian(alpha: float) -> np.ndarray:
    """reference utils_blindsr.py:202-208."""
    alpha = max(0, min(alpha, 1))
    h1 = alpha / (alpha + 1)
    h2 = (1 - alpha) / (alpha + 1)
    return np.asarray([[h1, h2, h1], [h2, -4 / (alpha + 1), h2],
                       [h1, h2, h1]], np.float32)


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """Half-pixel-grid shift via bilinear resample
    (reference utils_blindsr.py:99-125; interp2d replaced with
    RegularGridInterpolator — same linear interpolation)."""
    from scipy.interpolate import RegularGridInterpolator

    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xv, yv = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    x1 = np.clip(xv + (shift if upper_left else -shift), 0, w - 1)
    y1 = np.clip(yv + (shift if upper_left else -shift), 0, h - 1)
    gy, gx = np.meshgrid(y1, x1, indexing="ij")
    pts = np.stack([gy, gx], axis=-1)
    if x.ndim == 2:
        return RegularGridInterpolator((yv, xv), x, method="linear")(pts)
    out = x.copy()
    for i in range(x.shape[-1]):
        out[:, :, i] = RegularGridInterpolator((yv, xv), x[:, :, i],
                                               method="linear")(pts)
    return out


def add_sharpening(img, weight=0.5, radius=50, threshold=10):
    """USM sharpening (reference utils_blindsr.py:309-332)."""
    import cv2

    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype("float32")
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    K = np.clip(img + weight * residual, 0, 1)
    return soft_mask * K + (1 - soft_mask) * img


def add_blur(img, sf=4, rng: Optional[np.random.Generator] = None):
    """reference utils_blindsr.py:335-346."""
    rng = rng or np.random.default_rng()
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    if rng.random() < 0.5:
        k = anisotropic_gaussian(ksize=2 * int(rng.integers(2, 12)) + 3,
                                 theta=rng.random() * np.pi,
                                 l1=wd2 * rng.random(), l2=wd2 * rng.random())
    else:
        k = fspecial_gaussian(2 * int(rng.integers(2, 12)) + 3, wd * rng.random())
    return ndimage.convolve(img, k[:, :, None], mode="mirror")


def add_resize(img, sf=4, rng: Optional[np.random.Generator] = None):
    """reference utils_blindsr.py:349-360."""
    import cv2

    rng = rng or np.random.default_rng()
    rnum = rng.random()
    if rnum > 0.8:
        sf1 = rng.uniform(1, 2)
    elif rnum < 0.7:
        sf1 = rng.uniform(0.5 / sf, 1)
    else:
        sf1 = 1.0
    interp = int(rng.choice([1, 2, 3]))
    img = cv2.resize(img, (int(sf1 * img.shape[1]), int(sf1 * img.shape[0])),
                     interpolation=interp)
    return np.clip(img, 0.0, 1.0)


def add_gaussian_noise(img, noise_level1=2, noise_level2=25,
                       rng: Optional[np.random.Generator] = None):
    """reference utils_blindsr.py:363-377 (color / gray / correlated)."""
    from scipy.linalg import orth

    rng = rng or np.random.default_rng()
    noise_level = int(rng.integers(noise_level1, noise_level2 + 1))
    rnum = rng.random()
    if rnum > 0.6:
        img = img + rng.normal(0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + rng.normal(0, noise_level / 255.0,
                               (*img.shape[:2], 1)).astype(np.float32)
    else:
        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = orth(rng.random((3, 3)))
        conv = U.T @ D @ U
        img = img + rng.multivariate_normal(
            [0, 0, 0], np.abs(L ** 2 * conv), img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img, noise_level1=2, noise_level2=25,
                      rng: Optional[np.random.Generator] = None):
    """reference utils_blindsr.py:380-395 (multiplicative)."""
    from scipy.linalg import orth

    rng = rng or np.random.default_rng()
    noise_level = int(rng.integers(noise_level1, noise_level2 + 1))
    img = np.clip(img, 0.0, 1.0)
    rnum = rng.random()
    if rnum > 0.6:
        img += img * rng.normal(0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        img += img * rng.normal(0, noise_level / 255.0,
                                (*img.shape[:2], 1)).astype(np.float32)
    else:
        L = noise_level2 / 255.0
        D = np.diag(rng.random(3))
        U = orth(rng.random((3, 3)))
        conv = U.T @ D @ U
        img += img * rng.multivariate_normal(
            [0, 0, 0], np.abs(L ** 2 * conv), img.shape[:2]).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img, rng: Optional[np.random.Generator] = None):
    """reference utils_blindsr.py:398-409."""
    rng = rng or np.random.default_rng()
    img = np.clip((img * 255.0).round(), 0, 255) / 255.0
    vals = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = rng.poisson(img * vals).astype(np.float32) / vals
    else:
        img_gray = np.dot(img[..., :3], [0.299, 0.587, 0.114])
        img_gray = np.clip((img_gray * 255.0).round(), 0, 255) / 255.0
        noise_gray = rng.poisson(img_gray * vals).astype(np.float32) / vals - img_gray
        img = img + noise_gray[:, :, None]
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img, rng: Optional[np.random.Generator] = None,
                   quality: Optional[int] = None):
    """reference utils_blindsr.py:412-418."""
    import cv2

    rng = rng or np.random.default_rng()
    if quality is None:
        quality = int(rng.integers(30, 96))
    bgr = cv2.cvtColor(im.single2uint(img), cv2.COLOR_RGB2BGR)
    _, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    dec = cv2.imdecode(enc, 1)
    return im.uint2single(cv2.cvtColor(dec, cv2.COLOR_BGR2RGB))


def random_crop(lq, hq, sf=4, lq_patchsize=64,
                rng: Optional[np.random.Generator] = None):
    """reference utils_blindsr.py:421-429."""
    rng = rng or np.random.default_rng()
    h, w = lq.shape[:2]
    rh = int(rng.integers(0, h - lq_patchsize + 1))
    rw = int(rng.integers(0, w - lq_patchsize + 1))
    lq = lq[rh: rh + lq_patchsize, rw: rw + lq_patchsize, :]
    hq = hq[rh * sf: (rh + lq_patchsize) * sf, rw * sf: (rw + lq_patchsize) * sf, :]
    return lq, hq


def degradation_bsrgan(img, sf=4, lq_patchsize=72,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The BSRGAN degradation model (reference utils_blindsr.py:432-520):
    shuffled [blur, blur, downsample2, downsample3, G-noise, JPEG, (isp)]
    with downsample-to-scale kept after downsample2, final JPEG, and an
    aligned random crop. Returns (lq, hq)."""
    import cv2

    rng = rng or np.random.default_rng()
    jpeg_prob, scale2_prob = 0.9, 0.25
    sf_ori = sf

    h1, w1 = img.shape[:2]
    img = img.copy()[: h1 - h1 % sf, : w1 - w1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")

    hq = img.copy()

    if sf == 4 and rng.random() < scale2_prob:
        if rng.random() < 0.5:
            interp = int(rng.choice([1, 2, 3]))
            img = cv2.resize(img, (int(img.shape[1] / 2), int(img.shape[0] / 2)),
                             interpolation=interp)
        else:
            img = im.imresize_np(img, 1 / 2, True)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    order = list(rng.permutation(7))
    idx1, idx2 = order.index(2), order.index(3)
    if idx1 > idx2:
        order[idx1], order[idx2] = order[idx2], order[idx1]

    a, b = img.shape[1], img.shape[0]
    for i in order:
        if i in (0, 1):
            img = add_blur(img, sf=sf, rng=rng)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf)
                interp = int(rng.choice([1, 2, 3]))
                img = cv2.resize(img, (int(img.shape[1] / sf1),
                                       int(img.shape[0] / sf1)),
                                 interpolation=interp)
            else:
                k = fspecial_gaussian(25, rng.uniform(0.1, 0.6 * sf))
                k_shifted = shift_pixel(k, sf)
                k_shifted = k_shifted / k_shifted.sum()
                img = ndimage.convolve(img, k_shifted[:, :, None], mode="mirror")
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            interp = int(rng.choice([1, 2, 3]))
            img = cv2.resize(img, (int(a / sf), int(b / sf)),
                             interpolation=interp)
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = add_gaussian_noise(img, 2, 25, rng=rng)
        elif i == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng=rng)
        # i == 6: camera ISP model — not shipped in the reference either
        #         (isp_model defaults to None, utils_blindsr.py:507-510)

    img = add_jpeg_noise(img, rng=rng)
    return random_crop(img, hq, sf_ori, lq_patchsize, rng=rng)


def degradation_bsrgan_plus(img, sf=4, shuffle_prob=0.5, use_sharp=False,
                            lq_patchsize=64,
                            rng: Optional[np.random.Generator] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """BSRGAN+ variant (reference utils_blindsr.py:524-560): optionally
    sharpened HQ, ordered-or-shuffled op chain incl. speckle/Poisson."""
    rng = rng or np.random.default_rng()
    h1, w1 = img.shape[:2]
    img = img.copy()[: h1 - h1 % sf, : w1 - w1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f"img size ({h1}X{w1}) is too small!")
    if use_sharp:
        img = add_sharpening(img)
    hq = img.copy()

    if rng.random() < shuffle_prob:
        order = list(rng.permutation(13))
    else:
        order = list(range(13))

    for i in order:
        if i == 0:
            img = add_blur(img, sf=sf, rng=rng)
        elif i == 1:
            img = add_resize(img, sf=sf, rng=rng)
        elif i == 2:
            img = add_gaussian_noise(img, 2, 25, rng=rng)
        elif i == 3:
            if rng.random() < 0.1:
                img = add_jpeg_noise(img, rng=rng)
        elif i == 4:
            img = add_speckle_noise(img, rng=rng)
        elif i == 5:
            img = add_poisson_noise(img, rng=rng)
        elif i == 6:
            img = add_jpeg_noise(img, rng=rng)
        elif i == 7:
            img = add_blur(img, sf=sf, rng=rng)
        elif i == 8:
            img = add_resize(img, sf=sf, rng=rng)
        elif i == 9:
            img = add_gaussian_noise(img, 2, 25, rng=rng)
        elif i == 10:
            if rng.random() < 0.1:
                img = add_jpeg_noise(img, rng=rng)
        elif i == 11:
            img = add_speckle_noise(img, rng=rng)
        elif i == 12:
            img = add_poisson_noise(img, rng=rng)

    # resize to LQ scale + final JPEG
    import cv2

    interp = int(rng.choice([1, 2, 3]))
    img = cv2.resize(img, (int(w / sf), int(h / sf)), interpolation=interp)
    img = add_jpeg_noise(img, rng=rng)
    return random_crop(np.clip(img, 0, 1), hq, sf, lq_patchsize, rng=rng)
