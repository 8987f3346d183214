"""JPEG compression-artifact-reduction dataset (counterpart of
``kair_tpu/data/dataset_jpeg.py``; reference data/dataset_jpeg.py:20-118):
grayscale (Y channel or gray conversion) or color pairs, the L image an
in-memory JPEG round trip of the H image at a fixed quality factor. Pure
numpy around ``cv2``'s codec, which is imported only where it is used."""

from __future__ import annotations

import numpy as np

from kair_tpu_torch.data.base import Dataset
from kair_tpu_torch.utils import image as im


def _jpeg_roundtrip(img_u8: np.ndarray, quality: int, color: bool) -> np.ndarray:
    import cv2

    if color:
        bgr = cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR)
        _, enc = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        return cv2.cvtColor(cv2.imdecode(enc, 1), cv2.COLOR_BGR2RGB)
    _, enc = cv2.imencode(".jpg", img_u8, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    return cv2.imdecode(enc, 0)


class DatasetJPEG(Dataset):
    def __init__(self, opt: dict):
        import cv2  # noqa: F401  (fail early if unavailable)

        self.opt = opt
        self.patch_size = opt.get("H_size") or 128
        self.quality_factor = opt.get("quality_factor") or 40
        self.quality_factor_test = opt.get("quality_factor_test") or self.quality_factor
        self.is_color = bool(opt.get("is_color") or False)
        self.phase = opt.get("phase") or "train"
        self.paths_H = im.get_image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        import cv2

        h_path = self.paths_H[index]
        if self.phase == "train":
            img = im.imread_uint(h_path, 3)
            ps_plus = self.patch_size + 8
            hh, ww = img.shape[:2]
            rh = int(rng.integers(0, max(0, hh - ps_plus) + 1))
            rw = int(rng.integers(0, max(0, ww - ps_plus) + 1))
            patch = im.augment_img(img[rh: rh + ps_plus, rw: rw + ps_plus],
                                   int(rng.integers(0, 8)))
            if self.is_color:
                img_h = patch.copy()
                img_l = _jpeg_roundtrip(patch, self.quality_factor, True)
            else:
                if rng.random() > 0.5:
                    gray = im.rgb2ycbcr(patch)
                else:
                    gray = cv2.cvtColor(patch, cv2.COLOR_RGB2GRAY)
                img_h = gray.copy()
                img_l = _jpeg_roundtrip(gray, self.quality_factor, False)
            hh, ww = img_h.shape[:2]
            if rng.random() > 0.5:
                rh = int(rng.integers(0, max(0, hh - self.patch_size) + 1))
                rw = int(rng.integers(0, max(0, ww - self.patch_size) + 1))
            else:
                rh = rw = 0
            img_h = img_h[rh: rh + self.patch_size, rw: rw + self.patch_size]
            img_l = img_l[rh: rh + self.patch_size, rw: rw + self.patch_size]
        else:
            if self.is_color:
                img_h = im.imread_uint(h_path, 3)
                img_l = _jpeg_roundtrip(img_h, self.quality_factor_test, True)
            else:
                img = im.imread_uint(h_path, 3)
                img_h = im.rgb2ycbcr(img)
                img_l = _jpeg_roundtrip(img_h, self.quality_factor_test, False)

        if img_h.ndim == 2:
            img_h, img_l = img_h[:, :, None], img_l[:, :, None]
        return {"L": im.uint2single(img_l), "H": im.uint2single(img_h),
                "L_path": h_path, "H_path": h_path}
