"""Blind-SR training dataset over BSRGAN's degradation pipeline (a numpy
copy of ``kair_tpu/data/dataset_blindsr.py``; reference
data/dataset_blindsr.py:9-92). The pipeline (``degrade/blindsr.py``) needs
cv2, so this dataset runs off the card."""

from __future__ import annotations

import numpy as np

from kair_tpu_torch.data.datasets import ImageFiles
from kair_tpu_torch.degrade.blindsr import (degradation_bsrgan,
                                            degradation_bsrgan_plus)
from kair_tpu_torch.utils import image as im


class DatasetBlindSR(ImageFiles):
    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.sf = opt.get("scale") or 4
        self.shuffle_prob = opt.get("shuffle_prob") or 0.1
        self.use_sharp = bool(opt.get("use_sharp") or False)
        self.degradation_type = opt.get("degradation_type") or "bsrgan"
        self.lq_patchsize = opt.get("lq_patchsize") or 64
        self.patch_size = opt.get("H_size") or (self.lq_patchsize * self.sf)
        self.phase = opt.get("phase") or "train"
        self.paths_H = self.image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        h_path = self.paths_H[index]
        img_h = im.uint2single(self.read_uint(h_path))

        if self.phase == "train":
            # oversized random crop so the degradation can crop again
            hh, ww = img_h.shape[:2]
            size = self.lq_patchsize * self.sf
            if hh < size or ww < size:
                # reflect-pad small images up to the required size
                img_h = np.pad(img_h, ((0, max(0, size - hh)),
                                       (0, max(0, size - ww)), (0, 0)),
                               mode="reflect")
            if self.degradation_type == "bsrgan_plus":
                img_l, img_h = degradation_bsrgan_plus(
                    img_h, self.sf, self.shuffle_prob, self.use_sharp,
                    self.lq_patchsize, rng=rng)
            else:
                img_l, img_h = degradation_bsrgan(
                    img_h, self.sf, self.lq_patchsize, rng=rng)
        else:
            img_h = im.modcrop(img_h, self.sf)
            img_l = im.imresize_np(img_h, 1 / self.sf, True)

        return {"L": np.ascontiguousarray(img_l, np.float32),
                "H": np.ascontiguousarray(img_h, np.float32),
                "L_path": h_path, "H_path": h_path}
