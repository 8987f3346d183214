"""RAM-cached patch datasets (counterpart of ``kair_tpu/data/dataset_patch.py``;
reference data/dataset_dnpatch.py and data/dataset_plainpatch.py): every
patch is cut out once into memory, from a Generator seeded by the option
``seed``, and each item is one patch of that bank, augmented (and, for
denoising, noised) with the epoch's Generator. Pure numpy; images come
through the ``image_paths`` / ``read_uint`` hooks of
:class:`~kair_tpu_torch.data.datasets.ImageFiles`."""

from __future__ import annotations

from typing import List

import numpy as np

from kair_tpu_torch.data.datasets import ImageFiles
from kair_tpu_torch.utils import image as im


def _corner(h: int, w: int, ps: int, rng: np.random.Generator):
    rh = int(rng.integers(0, max(0, h - ps) + 1))
    rw = int(rng.integers(0, max(0, w - ps) + 1))
    return rh, rw


class DatasetDnPatch(ImageFiles):
    """AWGN denoising over a RAM patch bank (reference dataset_dnpatch.py)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 1
        self.patch_size = opt.get("H_size") or 64
        self.sigma = opt.get("sigma") or 25
        self.sigma_test = opt.get("sigma_test") or self.sigma
        self.phase = opt.get("phase") or "train"
        self.num_patches_per_image = opt.get("num_patches_per_image") or 64
        self.paths_H = self.image_paths(opt["dataroot_H"])
        self._bank: List[np.ndarray] = []
        self.update_data(np.random.default_rng(opt.get("seed") or 0))

    def update_data(self, rng: np.random.Generator) -> None:
        """Cut the patch bank anew (the reference re-samples it per epoch)."""
        self._bank.clear()
        ps = self.patch_size
        for path in self.paths_H:
            img = self.read_uint(path)
            for _ in range(self.num_patches_per_image):
                rh, rw = _corner(img.shape[0], img.shape[1], ps, rng)
                self._bank.append(img[rh: rh + ps, rw: rw + ps].copy())

    def __len__(self):
        return len(self._bank)

    def get_example(self, index, rng):
        patch = im.augment_img(self._bank[index], int(rng.integers(0, 8)))
        h = im.uint2single(patch)
        l = h + rng.standard_normal(h.shape).astype(np.float32) * (self.sigma / 255.0)
        return {"L": l.astype(np.float32), "H": h.astype(np.float32)}


class DatasetPlainPatch(ImageFiles):
    """Paired L/H RAM patch bank (reference dataset_plainpatch.py)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.patch_size = opt.get("H_size") or 64
        self.num_patches_per_image = opt.get("num_patches_per_image") or 32
        self.paths_H = self.image_paths(opt["dataroot_H"])
        self.paths_L = self.image_paths(opt["dataroot_L"])
        assert len(self.paths_H) == len(self.paths_L)
        self._h: List[np.ndarray] = []
        self._l: List[np.ndarray] = []
        self.update_data(np.random.default_rng(opt.get("seed") or 0))

    def update_data(self, rng: np.random.Generator) -> None:
        self._h.clear()
        self._l.clear()
        ps = self.patch_size
        for ph, pl in zip(self.paths_H, self.paths_L):
            ih, il = self.read_uint(ph), self.read_uint(pl)
            for _ in range(self.num_patches_per_image):
                rh, rw = _corner(ih.shape[0], ih.shape[1], ps, rng)
                self._h.append(ih[rh: rh + ps, rw: rw + ps].copy())
                self._l.append(il[rh: rh + ps, rw: rw + ps].copy())

    def __len__(self):
        return len(self._h)

    def get_example(self, index, rng):
        mode = int(rng.integers(0, 8))
        h = im.augment_img(self._h[index], mode)
        l = im.augment_img(self._l[index], mode)
        return {"L": im.uint2single(l), "H": im.uint2single(h)}
