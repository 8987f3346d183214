"""Blind face enhancement: detect → align → GPEN → paste back (counterpart
of ``kair_tpu/eval/face_pipeline.py``; reference
main_test_face_enhancement.py:77-139).

The orchestration (the blend mask, alignment, inverse-affine paste-back
with progressive mask accumulation) follows the JAX package's line for
line on ``utils/cv_ops``' cv2-free operations; the compute stages are
callables, so the pipeline runs against injected stand-ins as well as the
networks:

  detector(img_bgr_uint8) -> (facebs (N, 5 with the score), landms (N, 10))
  enhancer(face_rgb_uint8 (size, size, 3)) -> enhanced uint8, same shape

``make_gpen_enhancer`` and ``make_retinaface_detector`` wrap the port's
GPEN and RetinaFace modules; each runs on its parameters' device and type.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from kair_tpu_torch.utils import cv_ops
from kair_tpu_torch.utils.alignfaces import (get_reference_facial_points,
                                             warp_and_crop_face)


def make_blend_mask(size: int = 512) -> np.ndarray:
    """Soft rectangular blend mask (reference :85-89): the filled
    rectangle (26, 26)-(486, 486) at 512 (cv2's anti-aliased fill of
    integer corners is the plain one), blurred twice with a (101, 101)
    σ 11 Gaussian, then resized to the face size."""
    mask = np.zeros((512, 512), np.float32)
    mask[26:487, 26:487] = 1.0
    mask = cv_ops.gaussian_blur(mask, (101, 101), 11)
    mask = cv_ops.gaussian_blur(mask, (101, 101), 11)
    if size != 512:
        mask = cv_ops.resize_linear(mask, (size, size))
    return mask


_SMOOTH3 = np.array([[0.0625, 0.125, 0.0625],
                     [0.125, 0.25, 0.125],
                     [0.0625, 0.125, 0.0625]], np.float32)


def enhance_faces(img_rgb: np.ndarray, detector: Callable, enhancer: Callable,
                  size: int = 512, threshold: float = 0.9):
    """Full-image face enhancement (reference process(), :102-139).
    img_rgb uint8 (H, W, 3); returns (enhanced image uint8, the aligned
    faces, the enhanced faces)."""
    facebs, landms = detector(cv_ops.rgb_bgr(img_rgb))
    reference_5pts = get_reference_facial_points(
        (size, size), inner_padding_factor=0.25, outer_padding=(0, 0),
        default_square=True)
    blend_mask = make_blend_mask(size)

    orig_faces: List[np.ndarray] = []
    enhanced_faces: List[np.ndarray] = []
    height, width = img_rgb.shape[:2]
    full_mask = np.zeros((height, width), np.float32)
    full_img = np.zeros(img_rgb.shape, np.uint8)

    for faceb, facial5points in zip(facebs, landms):
        if faceb[4] < threshold:
            continue
        fh, fw = (faceb[3] - faceb[1]), (faceb[2] - faceb[0])
        facial5points = np.reshape(facial5points, (2, 5))
        of, tfm_inv = warp_and_crop_face(img_rgb, facial5points,
                                         reference_pts=reference_5pts,
                                         crop_size=(size, size))
        ef = enhancer(of)
        orig_faces.append(of)
        enhanced_faces.append(ef)

        tmp_mask = cv_ops.resize_linear(blend_mask, ef.shape[:2])
        tmp_mask = cv_ops.warp_affine(tmp_mask, tfm_inv, (width, height), flags=3)
        if min(fh, fw) < 100:       # a Gaussian filter for small faces
            ef = cv_ops.filter2d_u8(ef, _SMOOTH3)
        tmp_img = cv_ops.warp_affine(ef, tfm_inv, (width, height), flags=3)

        mask = tmp_mask - full_mask
        full_mask[np.where(mask > 0)] = tmp_mask[np.where(mask > 0)]
        full_img[np.where(mask > 0)] = tmp_img[np.where(mask > 0)]

    full_mask = full_mask[:, :, np.newaxis]
    out = cv_ops.convert_scale_abs(img_rgb * (1 - full_mask)
                                   + full_img * full_mask)
    return out, orig_faces, enhanced_faces


def make_gpen_enhancer(model: torch.nn.Module, size: int = 512) -> Callable:
    """GPEN single-face enhancer (reference faceenhancer.process, :62-75):
    resize → [-1, 1] → FullGenerator → [0, 1] → uint8. ``model`` maps an
    NHWC batch in [-1, 1] to the enhanced batch; it runs in its own
    parameters' type on their device."""
    p = next(model.parameters())

    def enhance(face_rgb: np.ndarray) -> np.ndarray:
        f = cv_ops.resize_linear(face_rgb, (size, size))
        x = f.astype(np.float32) / 255.0
        x = (x - 0.5) / 0.5
        with torch.inference_mode():
            y = model(torch.from_numpy(x[None]).to(p.device, p.dtype))
        y = np.clip(y.float().cpu().numpy()[0] * 0.5 + 0.5, 0.0, 1.0)
        return (y * 255.0 + 0.5).astype(np.uint8)

    return enhance


def make_retinaface_detector(model: torch.nn.Module,
                             threshold: float = 0.9) -> Callable:
    """RetinaFace detector (reference RetinaFaceDetection.detect): img_bgr
    uint8 → (facebs (N, 5), landms (N, 10) as [x1..x5, y1..y5]). Boxes and
    landmarks stay paired by score (the reference re-sorts the landmarks
    alone, mispairing them on several faces; the JAX package keeps them
    aligned, and so does this one)."""
    from kair_tpu_torch.models.retinaface import detect_faces
    p = next(model.parameters())

    def apply(x: np.ndarray):
        with torch.inference_mode():
            return model(torch.from_numpy(x).to(p.device, p.dtype))

    def detect(img_bgr: np.ndarray):
        dets, lms = detect_faces(apply, img_bgr.astype(np.float32),
                                 confidence_threshold=threshold)
        lms = lms.reshape(-1, 5, 2).transpose(0, 2, 1).reshape(-1, 10)
        return dets, lms

    return detect
