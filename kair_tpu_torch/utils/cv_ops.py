"""The image operations of the face pipeline without cv2, on torch tensors
(the card has no cv2). Each follows OpenCV 5.0's conventions for the
arguments the pipeline passes (``kair_tpu/utils/alignfaces.py:95-128``,
``kair_tpu/eval/face_pipeline.py:29-106``); ``tests/test_torch_face.py``
holds each against cv2 itself.

* ``warp_affine``: ``cv2.warpAffine(src, M, (w, h), flags)`` with flags
  INTER_LINEAR or INTER_AREA (which warpAffine runs as INTER_LINEAR: the
  pipeline's ``flags=3``), BORDER_CONSTANT 0. OpenCV 5 inverts M in
  float64, maps every destination pixel in float32 (the row's offset
  y·M₁ + M₂ rounded to float32, then one fused multiply-add with x·M₀),
  and interpolates in float32 by two fused lerps along x and one along y;
  taps outside the source read 0; 8-bit results round half to even. Its
  vectorised loop covers the row in blocks of 16 and finishes a row's last
  width mod 16 pixels by another formula: there this function can differ
  by one ulp of the coordinate (the tests hold those columns to 1 level /
  1e-5).
* ``gaussian_kernel`` / ``gaussian_blur``: ``cv2.getGaussianKernel`` and
  ``cv2.GaussianBlur`` of a float32 image (separable, BORDER_REFLECT_101;
  ksize (0, 0) → round(8σ + 1) | 1 for float images).
* ``erode``: ``cv2.erode`` with a k×k box (the border reads +inf).
* ``filter2d_u8``: ``cv2.filter2D(src, -1, kernel)`` of an 8-bit image
  (BORDER_REFLECT_101, float sums rounded half to even and saturated).
* ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` (half-pixel
  centres, edge samples clamped; by dsize, or by cv2's fx, fy): float images in float32, 8-bit images in
  cv2's fixed point (weights ×2048, rounded; the vertical pass as cv2's
  vector code rounds it, which the tests hold to one level on a few
  percent of the pixels).
* ``convert_scale_abs``: ``cv2.convertScaleAbs`` (|x| rounded half to even,
  saturated to uint8).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Array = Union[np.ndarray, torch.Tensor]

INTER_LINEAR, INTER_AREA = 1, 3


def _as_tensor(img: Array) -> Tuple[torch.Tensor, bool]:
    if isinstance(img, torch.Tensor):
        return img, False
    return torch.from_numpy(np.ascontiguousarray(img)), True


def _back(t: torch.Tensor, was_numpy: bool):
    return t.cpu().numpy() if was_numpy else t


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c of float32 operands, rounded once (the product of two
    float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2's inversion of a 2x3 affine map, in float64."""
    m = np.asarray(m, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(src: Array, m: np.ndarray, dsize: Tuple[int, int],
                flags: int = INTER_LINEAR):
    """``cv2.warpAffine(src, m, dsize, flags=flags)``: src (H, W) or
    (H, W, C), uint8 or float32; dsize (width, height)."""
    if flags not in (INTER_LINEAR, INTER_AREA):
        raise NotImplementedError(f"warp_affine: flags {flags} (linear only)")
    x, was_np = _as_tensor(src)
    gray = x.ndim == 2
    img = (x[..., None] if gray else x).float()
    h_in, w_in, c = img.shape
    w, h = dsize
    mi = torch.tensor(invert_affine(m), dtype=torch.float64)
    m32 = mi.float()
    dev = img.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    row_x = (ys * m32[1] + m32[2])                      # float32, two roundings
    row_y = (ys * m32[4] + m32[5])
    sx = _fma32(m32[0].to(dev).expand(h, w), xs.expand(h, w), row_x.expand(h, w))
    sy = _fma32(m32[3].to(dev).expand(h, w), xs.expand(h, w), row_y.expand(h, w))
    ix, iy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.long(), iy.long()
    flat = img.reshape(-1, c)

    def tap(dy: int, dx: int) -> torch.Tensor:
        yy, xx = iy + dy, ix + dx
        ok = (yy >= 0) & (yy < h_in) & (xx >= 0) & (xx < w_in)
        idx = (yy.clamp(0, h_in - 1) * w_in + xx.clamp(0, w_in - 1)).reshape(-1)
        return torch.where(ok[..., None], flat[idx].reshape(h, w, c),
                           torch.zeros((), device=dev))
    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = _fma32(ax, p01 - p00, p00)
    v1 = _fma32(ax, p11 - p10, p10)
    out = _fma32(ay, v1 - v0, v0)
    if x.dtype == torch.uint8:
        out = torch.round(out).clamp(0, 255).to(torch.uint8)
    out = out[..., 0] if gray else out
    return _back(out, was_np)


def gaussian_kernel(ksize: int, sigma: float) -> torch.Tensor:
    """cv2.getGaussianKernel(ksize, sigma, CV_32F): computed in float64,
    normalised, stored as float32 (σ ≤ 0: from ksize, as cv2)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    return torch.from_numpy((k / k.sum()).astype(np.float32))


def _reflect101_pad(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(H, W, C) padded BORDER_REFLECT_101, repeatedly for pads past the
    image (cv2's borderInterpolate)."""
    h, w = x.shape[:2]

    def idx(n, p):
        i = np.arange(-p, n + p)
        if n == 1:
            return np.zeros_like(i)
        period = 2 * n - 2
        i = np.mod(i, period)
        return np.where(i >= n, period - i, i)
    iy = torch.from_numpy(idx(h, ph)).to(x.device)
    ix = torch.from_numpy(idx(w, pw)).to(x.device)
    return x[iy][:, ix]


def gaussian_blur(src: Array, ksize: Tuple[int, int], sigma: float):
    """cv2.GaussianBlur of a float32 (H, W) or (H, W, C) image, sigmaY =
    sigmaX, BORDER_REFLECT_101."""
    x, was_np = _as_tensor(src)
    if x.dtype != torch.float32:
        raise NotImplementedError("gaussian_blur: float32 images only")
    kw, kh = ksize
    if kw <= 0:
        kw = kh = int(round(sigma * 8 + 1)) | 1
    gray = x.ndim == 2
    img = x[..., None] if gray else x
    kx = gaussian_kernel(kw, sigma).double().to(img.device)
    ky = gaussian_kernel(kh, sigma).double().to(img.device)
    p = _reflect101_pad(img.double(), kh // 2, kw // 2)     # (H+, W+, C)
    p = p.permute(2, 0, 1)[:, None]                          # (C, 1, H+, W+)
    p = F.conv2d(p, kx.view(1, 1, 1, -1)).float().double()
    p = F.conv2d(p, ky.view(1, 1, -1, 1)).float()
    out = p[:, 0].permute(1, 2, 0)
    return _back(out[..., 0] if gray else out, was_np)


def erode(src: Array, k: int = 5):
    """cv2.erode(src, np.ones((k, k))): the k×k minimum, the border +inf."""
    x, was_np = _as_tensor(src)
    gray = x.ndim == 2
    img = (x[..., None] if gray else x).permute(2, 0, 1)[None].double()
    out = -F.max_pool2d(F.pad(-img, [k // 2] * 4, value=-math.inf), k, 1)
    out = out[0].permute(1, 2, 0).to(x.dtype)
    return _back(out[..., 0] if gray else out, was_np)


def filter2d_u8(src: Array, kernel: np.ndarray):
    """cv2.filter2D(src, -1, kernel) of a uint8 image, BORDER_REFLECT_101,
    anchor at the centre."""
    x, was_np = _as_tensor(src)
    gray = x.ndim == 2
    img = x[..., None] if gray else x
    kh, kw = kernel.shape
    p = _reflect101_pad(img.double(), kh // 2, kw // 2).permute(2, 0, 1)[:, None]
    kt = torch.from_numpy(np.asarray(kernel, np.float32).astype(np.float64)
                          ).to(p.device)
    out = F.conv2d(p, kt[None, None])[:, 0].permute(1, 2, 0)
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return _back(out[..., 0] if gray else out, was_np)


def _linear_taps(n_in: int, n_out: int, coord32: bool, inv_scale=None):
    """cv2 INTER_LINEAR along one axis: the two source indices and their
    float32 weights of each output sample (half-pixel centres, clamped);
    ``coord32`` the source position rounded to float32 first (cv2's 8-bit
    path); ``inv_scale`` cv2's fx or fy when given (the taps step by 1/fx),
    else n_out / n_in."""
    scale = 1.0 / (n_out / n_in if inv_scale is None else inv_scale)
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    if coord32:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(np.float32)
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= n_in - 1] = 0.0
    s[s >= n_in - 1] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), np.float32(1) - f, f


def resize_linear(src: Array, dsize: Tuple[int, int] = (0, 0),
                  fx: float = 0.0, fy: float = 0.0):
    """cv2.resize(src, dsize, fx=fx, fy=fy) with INTER_LINEAR: src (H, W)
    or (H, W, C), uint8 or float32; dsize (width, height). With dsize
    (0, 0), as cv2: the output is round(W·fx) x round(H·fy) and the taps
    sample the source every 1/fx, 1/fy (not every W/round(W·fx))."""
    x, was_np = _as_tensor(src)
    h_in, w_in = x.shape[:2]
    w_out, h_out = dsize
    if w_out <= 0 or h_out <= 0:
        if fx <= 0 or fy <= 0:
            raise ValueError("resize_linear: give dsize or both fx and fy")
        # cv2's saturate_cast<int>: round half to even
        w_out, h_out = int(np.rint(w_in * fx)), int(np.rint(h_in * fy))
        inv_x, inv_y = float(fx), float(fy)
    else:
        inv_x = inv_y = None
    if (h_in, w_in) == (h_out, w_out) and inv_x in (None, 1.0) \
            and inv_y in (None, 1.0):
        return _back(x.clone(), was_np)
    gray = x.ndim == 2
    img = x[..., None] if gray else x
    u8 = x.dtype == torch.uint8
    x0, x1, a0, a1 = _linear_taps(w_in, w_out, u8, inv_x)
    y0, y1, b0, b1 = _linear_taps(h_in, h_out, u8, inv_y)
    dev = img.device
    t = lambda a: torch.from_numpy(a).to(dev)
    if u8:
        q = lambda a: t(np.rint(a.astype(np.float64) * 2048).astype(np.int64))
        a0q, a1q, b0q, b1q = q(a0), q(a1), q(b0), q(b1)
        v = img.long()
        rows = v[:, t(x0)] * a0q[None, :, None] + v[:, t(x1)] * a1q[None, :, None]
        # cv2's vectorised vertical pass: each product on the rows' sums
        # shifted right by 4, then by 16, the two added with 2, then >> 2
        out = ((((b0q[:, None, None] * (rows[t(y0)] >> 4)) >> 16)
                + ((b1q[:, None, None] * (rows[t(y1)] >> 4)) >> 16) + 2) >> 2)
        out = out.clamp(0, 255).to(torch.uint8)
    else:
        v = img.float()
        rows = v[:, t(x0)] * t(a0)[None, :, None] + v[:, t(x1)] * t(a1)[None, :, None]
        out = rows[t(y0)] * t(b0)[:, None, None] + rows[t(y1)] * t(b1)[:, None, None]
    return _back(out[..., 0] if gray else out, was_np)


def convert_scale_abs(src: Array):
    """cv2.convertScaleAbs(src): |src| rounded half to even, saturated to
    uint8."""
    x, was_np = _as_tensor(src)
    out = torch.round(x.double().abs()).clamp(0, 255).to(torch.uint8)
    return _back(out, was_np)


def rgb_bgr(img: Array):
    """cv2.cvtColor RGB2BGR / BGR2RGB: the channels reversed."""
    return img[..., ::-1].copy() if isinstance(img, np.ndarray) \
        else img.flip(-1)

