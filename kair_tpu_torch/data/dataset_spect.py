"""SPECT bone-scan datasets (counterpart of ``kair_tpu/data/dataset_spect.py``;
fork reference data/dataset_spect.py:11-135, data/dataset_spectpatch.py:
10-183). Pure numpy.

Raw ``.dat`` files of float32 counts, shape (2, 1024, 256): the anterior
and posterior views; the posterior is flipped left-right and stacked as a
second channel, (1024, 256, 2) HWC. The train phase crops H and L jointly
and applies one of the 8 ``augment_img`` modes to both; then both are
normalised (``utils/spect.normalize_spect``, "log" unless the option block
says otherwise). The random draws consume the Generator in the JAX order
(row, column, mode), so one seed gives the JAX package's example.

``DatasetSPECTPatch`` cuts a RAM patch bank of ``num_patches_per_image``
random patches an image once, at construction (``update_data`` draws a new
bank; nothing calls it after construction, in the JAX package or here).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from kair_tpu_torch.data.base import Dataset
from kair_tpu_torch.utils import image as im
from kair_tpu_torch.utils.spect import normalize_spect

DAT_SHAPE = (2, 1024, 256)


def list_dat(root: str) -> List[str]:
    out = []
    for dirpath, _, fnames in sorted(os.walk(root)):
        for f in sorted(fnames):
            if f.endswith(".dat"):
                out.append(os.path.join(dirpath, f))
    assert out, f"{root} has no .dat files"
    return out


def read_spect_dat(path: str) -> np.ndarray:
    """(2, 1024, 256) anterior/posterior → (1024, 256, 2) HWC, the
    posterior flipped left-right (reference dataset_spect.py:65-83)."""
    data = np.fromfile(path, dtype=np.float32).reshape(DAT_SHAPE)
    return np.stack([data[0], np.fliplr(data[1])], axis=2)


def write_spect_dat(path: str, hwc: np.ndarray) -> None:
    """The inverse of ``read_spect_dat``: (1024, 256, 2) HWC counts to a
    raw float32 (2, 1024, 256) file."""
    data = np.stack([hwc[..., 0], np.fliplr(hwc[..., 1])]).astype(np.float32)
    data.tofile(path)


def _normalization(opt: dict):
    """(method, max_pixel) of an option block: "log" and 150 unless its
    ``normalization`` says otherwise (the JAX dataset's defaults)."""
    norm = opt.get("normalization") or {}
    if not isinstance(norm, dict):
        return "log", 150
    return norm.get("type", "log"), norm.get("max_pixel", 150)


class _SpectPairs(Dataset):
    """The option block's patch size, normalisation, phase and the H / L
    ``.dat`` paths from ``start_index`` to ``end_index``."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.patch_size = opt.get("H_size") or 64
        self.norm_type, self.max_pixel = _normalization(opt)
        self.phase = opt.get("phase") or "train"
        paths_h = list_dat(opt["dataroot_H"])
        paths_l = list_dat(opt["dataroot_L"])
        assert len(paths_h) == len(paths_l)
        s = opt.get("start_index") or 0
        e = opt.get("end_index") or len(paths_h)
        self.paths_H = paths_h[s:e]
        self.paths_L = paths_l[s:e]

    @property
    def normalization(self) -> dict:
        """The normalisation this dataset applies, as an option block."""
        return {"type": self.norm_type, "max_pixel": self.max_pixel}

    def _normalize(self, img: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(
            normalize_spect(img, self.norm_type, self.max_pixel), np.float32)


class DatasetSPECT(_SpectPairs):

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        img_h = read_spect_dat(self.paths_H[index])
        img_l = read_spect_dat(self.paths_L[index])
        if self.phase == "train":
            ps = self.patch_size
            hh, ww = img_h.shape[:2]
            rh = int(rng.integers(0, max(0, hh - ps) + 1))
            rw = int(rng.integers(0, max(0, ww - ps) + 1))
            img_h = img_h[rh: rh + ps, rw: rw + ps]
            img_l = img_l[rh: rh + ps, rw: rw + ps]
            mode = int(rng.integers(0, 8))
            img_h = im.augment_img(img_h, mode)
            img_l = im.augment_img(img_l, mode)
        ex = {"L": self._normalize(img_l), "H": self._normalize(img_h)}
        if self.phase != "train":
            ex["L_path"] = self.paths_L[index]
            ex["H_path"] = self.paths_H[index]
        return ex


class DatasetSPECTPatch(_SpectPairs):
    """The RAM patch bank (fork reference dataset_spectpatch.py:10-183),
    drawn at construction from ``default_rng(opt['seed'] or 0)``."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.num_patches_per_image = opt.get("num_patches_per_image") or 32
        self._bank_h: List[np.ndarray] = []
        self._bank_l: List[np.ndarray] = []
        self.update_data(np.random.default_rng(opt.get("seed") or 0))

    def update_data(self, rng: np.random.Generator) -> None:
        """Draw a new bank (reference dataset_spectpatch.py:60)."""
        self._bank_h.clear()
        self._bank_l.clear()
        ps = self.patch_size
        for ph, plo in zip(self.paths_H, self.paths_L):
            img_h = read_spect_dat(ph)
            img_l = read_spect_dat(plo)
            hh, ww = img_h.shape[:2]
            for _ in range(self.num_patches_per_image):
                rh = int(rng.integers(0, max(0, hh - ps) + 1))
                rw = int(rng.integers(0, max(0, ww - ps) + 1))
                self._bank_h.append(img_h[rh: rh + ps, rw: rw + ps].copy())
                self._bank_l.append(img_l[rh: rh + ps, rw: rw + ps].copy())

    def __len__(self):
        return len(self._bank_h)

    def get_example(self, index, rng):
        mode = int(rng.integers(0, 8))
        return {"L": self._normalize(im.augment_img(self._bank_l[index], mode)),
                "H": self._normalize(im.augment_img(self._bank_h[index], mode))}
