"""USRNet's training dataset (counterpart of ``kair_tpu/data/dataset_usrnet.py``;
reference data/dataset_usrnet.py:16-126): a motion or shifted Gaussian
blur kernel per item, wrap convolution, s-fold subsampling and noise.

One scale factor a batch, as in KAIR, which draws it when its item counter
reaches a multiple of the batch size (dataset_usrnet.py:54-58):
``begin_batch``, which the port's ``Loader`` calls before the items of
each batch, draws it from the epoch's Generator, so every batch is
deterministic in (seed, epoch) and all its items share ``sf``. (The JAX
module draws ``sf`` per item from a seed it derives per item, so its
items' scale factors differ within a batch and ``collate`` fails on their
L patches' shapes; ROADMAP Queue 3.) The draws after it, per item, are the
JAX module's, in its order. The test phase takes ``kernels_12[0]`` and
``sf_validation`` and draws nothing.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from kair_tpu_torch.data.datasets import ImageFiles
from kair_tpu_torch.degrade import deblur, sisr
from kair_tpu_torch.utils import image as im


class DatasetUSRNet(ImageFiles):
    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.patch_size = opt.get("H_size") or 96
        self.sigma_max = opt.get("sigma_max") if opt.get("sigma_max") is not None else 25
        self.scales = opt.get("scales") or [1, 2, 3, 4]
        self.sf_validation = opt.get("sf_validation") or 3
        self.phase = opt.get("phase") or "train"
        self.sf = None                 # this batch's, drawn by begin_batch
        # the first kernels_12 kernel (data/assets/kernels_12.npz; the
        # reference loads kernels/kernels_12.mat, dataset_usrnet.py:32,105)
        self.val_kernel = sisr.load_kernels_12(
            opt.get("kernels_path"))[0].astype(np.float64)
        self.val_kernel /= self.val_kernel.sum()
        self.paths_H = self.image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def begin_batch(self, rng: np.random.Generator) -> None:
        """Draw the next batch's scale factor (training only)."""
        if self.phase == "train":
            self.sf = int(rng.choice(self.scales))

    def get_example(self, index, rng):
        h_path = self.paths_H[index]
        img_h = self.read_uint(h_path)

        if self.phase == "train":
            if self.sf is None:
                raise ValueError("DatasetUSRNet draws one scale factor a batch: "
                                 "call begin_batch(rng) first, as the Loader "
                                 "does")
            sf = self.sf
            hh, ww = img_h.shape[:2]
            rh = int(rng.integers(0, max(0, hh - self.patch_size) + 1))
            rw = int(rng.integers(0, max(0, ww - self.patch_size) + 1))
            patch_h = img_h[rh: rh + self.patch_size, rw: rw + self.patch_size, :]
            patch_h = im.augment_img(patch_h, int(rng.integers(0, 8)))

            # kernel: motion blur or shifted Gaussian (reference :77-84)
            if rng.integers(0, 8) > 3:
                k = deblur.blurkernel_synthesis(h=25, rng=rng)
            else:
                sf_k = int(rng.choice(self.scales))
                k = sisr.shifted_anisotropic_gaussian(
                    (25, 25), sf_k, min_var=0.6, max_var=12.0, rng=rng)
                k = im.augment_img(k, int(rng.integers(0, 8)))
            k = np.ascontiguousarray(k, np.float32)

            # noise level (reference :88-92)
            if rng.integers(0, 9) == 1:
                noise_level = 0.0
            else:
                noise_level = float(rng.integers(0, self.sigma_max)) / 255.0

            # on the uint8 patch, as the reference convolves it
            img_l = ndimage.convolve(patch_h, k[:, :, None].astype(np.float64),
                                     mode="wrap")
            img_l = img_l[0::sf, 0::sf, ...]
            img_l = im.uint2single(img_l) + rng.normal(0, noise_level, img_l.shape)
            img_h_out = im.uint2single(patch_h)
        else:
            sf = self.sf_validation
            k = np.ascontiguousarray(self.val_kernel, np.float32)
            noise_level = 0.0
            img_h_mc = im.modcrop(img_h, sf)
            img_l = ndimage.convolve(img_h_mc, k[:, :, None].astype(np.float64),
                                     mode="wrap")
            img_l = img_l[0::sf, 0::sf, ...]
            img_l = im.uint2single(img_l)
            img_h_out = im.uint2single(img_h_mc)

        return {"L": np.ascontiguousarray(img_l, np.float32),
                "H": np.ascontiguousarray(img_h_out, np.float32),
                "k": k[:, :, None],
                "sigma": np.full((1, 1, 1), noise_level, np.float32),
                "sf": sf, "L_path": h_path, "H_path": h_path}
