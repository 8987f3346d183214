"""Face alignment for the GPEN pipeline (counterpart of
``kair_tpu/utils/alignfaces.py``; reference utils/utils_alignfaces.py and
main_test_face_enhancement.py): Umeyama similarity transform from the 5
detected landmarks to the canonical facial template, warp and crop, and
paste back with mask blending. The template and the transform fit are
numpy copies of the JAX package's; the warps, erosion and blur are
``utils/cv_ops``' cv2-free versions."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from kair_tpu_torch.utils import cv_ops

# canonical 5-point template for a 112x112 crop (reference
# utils_alignfaces.py get_reference_facial_points defaults); float64 like
# the reference — stored f32 the LSBs shift warpAffine rounding
REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051],
    [65.53179932, 51.50139999],
    [48.02519989, 71.73660278],
    [33.54930115, 92.3655014],
    [62.72990036, 92.20410156]], np.float64)
DEFAULT_CROP_SIZE = (96, 112)


def get_reference_facial_points(output_size=(256, 256),
                                inner_padding_factor: float = 0.0,
                                outer_padding=(0, 0),
                                default_square: bool = True) -> np.ndarray:
    """Scale the canonical template to output_size (reference
    utils_alignfaces.py:99-183). The GPEN pipeline uses
    inner_padding_factor=0.25, outer_padding=(0,0), default_square=True
    (main_test_face_enhancement.py:96-101)."""
    tmp = REFERENCE_FACIAL_POINTS.copy().astype(np.float64)
    tmp_size = np.array(DEFAULT_CROP_SIZE, np.float64)
    if default_square:
        # square-pad the 96x112 template
        diff = max(tmp_size) - tmp_size
        tmp += diff[None, :] / 2
        tmp_size += diff
    if inner_padding_factor > 0:
        size_diff = tmp_size * inner_padding_factor * 2
        tmp += size_diff[None, :] / 2
        tmp_size += np.round(size_diff)
    size_bf_outer = np.array(output_size) - np.array(outer_padding) * 2
    # the reference computes float32(out)/int — a float64 result whose
    # numerator cast is lossless for the usual power-of-two sizes (:163)
    scale = np.float64(np.float32(size_bf_outer[0])) / np.float64(tmp_size[0])
    tmp = tmp * scale + np.array(outer_padding, np.float64)
    return tmp          # float64, like the reference (cast at the warp)


def umeyama(src: np.ndarray, dst: np.ndarray,
            estimate_scale: bool = True, scale: float = 1.0):
    """Least-squares similarity transform (reference _umeyama :22-91,
    Umeyama IEEE PAMI 1991). Returns (3x3 homogeneous matrix, scale). With
    estimate_scale=False the given `scale` is applied (the reference's
    inverse-transform path passes 1/forward_scale)."""
    num, dim = src.shape
    src_mean = src.mean(axis=0)
    dst_mean = dst.mean(axis=0)
    src_d = src - src_mean
    dst_d = dst - dst_mean
    A = dst_d.T @ src_d / num
    d = np.ones((dim,), np.float64)
    if np.linalg.det(A) < 0:
        d[dim - 1] = -1
    T = np.eye(dim + 1, dtype=np.float64)
    U, S, V = np.linalg.svd(A)
    rank = np.linalg.matrix_rank(A)
    if rank == 0:
        return T * np.nan, scale
    if rank == dim - 1:
        if np.linalg.det(U) * np.linalg.det(V) > 0:
            T[:dim, :dim] = U @ V
        else:
            s = d[dim - 1]
            d[dim - 1] = -1
            T[:dim, :dim] = U @ np.diag(d) @ V
            d[dim - 1] = s
    else:
        T[:dim, :dim] = U @ np.diag(d) @ V
    if estimate_scale:
        scale = 1.0 / src_d.var(axis=0).sum() * (S @ d)
    T[:dim, dim] = dst_mean - scale * (T[:dim, :dim] @ src_mean.T)
    T[:dim, :dim] *= scale
    return T, scale


def warp_and_crop_face(src_img: np.ndarray, facial_pts: np.ndarray,
                       reference_pts: Optional[np.ndarray] = None,
                       crop_size: Tuple[int, int] = (256, 256)):
    """Align a face to the template (reference :207-263, similarity path).
    Returns (crop, tfm_inv), the inverse 2x3 affine for pasting back, as the
    reference computes it (umeyama(ref, src) with the reciprocal forward
    scale). The fit runs in float32, as the reference passes float32 points
    uncast (:226, 235, 256-259)."""
    if reference_pts is None:
        reference_pts = get_reference_facial_points(crop_size)
    pts = np.float32(facial_pts)
    if pts.shape[0] == 2:           # (2, K) [xs; ys] → (K, 2)
        pts = pts.T
    ref = np.float32(reference_pts)
    if ref.shape[0] == 2:
        ref = ref.T
    T, s = umeyama(pts, ref)
    tfm = T[:2]
    tfm_inv = umeyama(ref, pts, estimate_scale=False, scale=1.0 / s)[0][:2]
    face = cv_ops.warp_affine(src_img, tfm, crop_size, flags=3)
    return face, tfm_inv


def paste_face_back(img: np.ndarray, face: np.ndarray,
                    tfm_inv: np.ndarray) -> np.ndarray:
    """Inverse-warp the enhanced face and blend it in with a soft mask
    (main_test_face_enhancement.py's paste-back); ``tfm_inv`` the crop →
    image affine of ``warp_and_crop_face``."""
    h, w = img.shape[:2]
    warped = cv_ops.warp_affine(face, tfm_inv, (w, h))
    mask = np.ones(face.shape[:2], np.float32)
    mask = cv_ops.warp_affine(mask, tfm_inv, (w, h))
    mask = cv_ops.erode(mask, 5)
    mask = cv_ops.gaussian_blur(mask, (0, 0), 3)[..., None]
    return (warped * mask + img * (1 - mask)).astype(img.dtype)
