"""SRMD and DPSR training datasets: degradations synthesised from a random
blur kernel (a numpy copy of ``kair_tpu/data/dataset_srmd.py``; reference
data/dataset_srmd.py, data/dataset_dpsr.py).

SRMD: L = (blur ∘ bicubic↓)(H) + n, the network input the image ⊕ the
kernel's 15 PCA coefficients ⊕ σ, the degradation map broadcast over the
patch (dataset_srmd.py:139-151). DPSR: L = (bicubic↓ ∘ blur)(H) + n, the
input the image ⊕ a σ map (MSRResNet_prior, in_nc 4). Images come through
the ``image_paths`` / ``read_uint`` hooks of
:class:`~kair_tpu_torch.data.datasets.ImageFiles`.
"""

from __future__ import annotations

import numpy as np

from kair_tpu_torch.data.datasets import ImageFiles
from kair_tpu_torch.degrade import sisr
from kair_tpu_torch.utils import image as im


class DatasetSRMD(ImageFiles):
    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.sf = opt.get("scale") or 4
        self.patch_size = opt.get("H_size") or 96
        self.L_size = self.patch_size // self.sf
        sigma = opt.get("sigma") or [0, 50]
        self.sigma_min, self.sigma_max = sigma[0], sigma[1]
        self.sigma_test = opt.get("sigma_test") or 0
        self.phase = opt.get("phase") or "train"
        # the published PCA basis (data/assets/srmd_pca.npz; the reference
        # loads kernels/srmd_pca_*.mat)
        self.p = sisr.load_srmd_pca(opt.get("pca_path"))
        self.ksize = int(np.sqrt(self.p.shape[-1]))
        self.paths_H = self.image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        h_path = self.paths_H[index]
        img_h = im.uint2single(self.read_uint(h_path))
        img_h = im.modcrop(img_h, self.sf)

        if self.phase == "train":
            l_max = 10
            theta = np.pi * rng.random()
            l1 = 0.1 + l_max * rng.random()
            l2 = 0.1 + (l1 - 0.1) * rng.random()
            kernel = sisr.anisotropic_gaussian(self.ksize, theta, l1, l2)
        else:
            kernel = sisr.anisotropic_gaussian(self.ksize, np.pi, 0.1, 0.1)
        k_reduced = sisr.pca_project(kernel, self.p)

        img_l = np.float32(sisr.srmd_degradation(img_h, kernel, self.sf))

        if self.phase == "train":
            hh, ww = img_l.shape[:2]
            rh = int(rng.integers(0, max(0, hh - self.L_size) + 1))
            rw = int(rng.integers(0, max(0, ww - self.L_size) + 1))
            img_l = img_l[rh: rh + self.L_size, rw: rw + self.L_size]
            img_h = img_h[rh * self.sf: rh * self.sf + self.patch_size,
                          rw * self.sf: rw * self.sf + self.patch_size]
            mode = int(rng.integers(0, 8))
            img_l = im.augment_img(img_l, mode)
            img_h = im.augment_img(img_h, mode)
            if rng.random() < 0.1:
                noise_level = 0.0
            else:
                noise_level = float(rng.uniform(self.sigma_min, self.sigma_max)) / 255.0
        else:
            noise_level = float(self.sigma_test)

        img_l = img_l + rng.standard_normal(img_l.shape).astype(np.float32) * noise_level
        m_vec = np.concatenate([k_reduced, [noise_level]]).astype(np.float32)
        m_map = np.broadcast_to(m_vec, img_l.shape[:2] + (m_vec.size,))
        l_full = np.concatenate([np.ascontiguousarray(img_l, np.float32),
                                 np.ascontiguousarray(m_map, np.float32)], axis=-1)
        return {"L": l_full, "H": np.ascontiguousarray(img_h, np.float32),
                "L_path": h_path, "H_path": h_path}


class DatasetDPSR(ImageFiles):
    """reference data/dataset_dpsr.py: L = blur(bicubic↓(H)) + n; network
    input img ⊕ σ-map."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.sf = opt.get("scale") or 4
        self.patch_size = opt.get("H_size") or 96
        self.L_size = self.patch_size // self.sf
        sigma = opt.get("sigma") or [0, 50]
        self.sigma_min, self.sigma_max = sigma[0], sigma[1]
        self.sigma_test = opt.get("sigma_test") or 0
        self.phase = opt.get("phase") or "train"
        self.ksize = opt.get("ksize") or 15
        self.paths_H = self.image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        h_path = self.paths_H[index]
        img_h = im.uint2single(self.read_uint(h_path))
        img_h = im.modcrop(img_h, self.sf)

        if self.phase == "train":
            theta = np.pi * rng.random()
            l1 = 0.1 + 10 * rng.random()
            l2 = 0.1 + (l1 - 0.1) * rng.random()
            kernel = sisr.anisotropic_gaussian(self.ksize, theta, l1, l2)
        else:
            kernel = sisr.anisotropic_gaussian(self.ksize, np.pi, 0.1, 0.1)

        img_l = np.float32(sisr.dpsr_degradation(img_h, kernel, self.sf))

        if self.phase == "train":
            hh, ww = img_l.shape[:2]
            rh = int(rng.integers(0, max(0, hh - self.L_size) + 1))
            rw = int(rng.integers(0, max(0, ww - self.L_size) + 1))
            img_l = img_l[rh: rh + self.L_size, rw: rw + self.L_size]
            img_h = img_h[rh * self.sf: rh * self.sf + self.patch_size,
                          rw * self.sf: rw * self.sf + self.patch_size]
            mode = int(rng.integers(0, 8))
            img_l = im.augment_img(img_l, mode)
            img_h = im.augment_img(img_h, mode)
            noise_level = float(rng.uniform(self.sigma_min, self.sigma_max)) / 255.0
        else:
            noise_level = float(self.sigma_test)

        img_l = img_l + rng.standard_normal(img_l.shape).astype(np.float32) * noise_level
        m_map = np.full(img_l.shape[:2] + (1,), noise_level, np.float32)
        l_full = np.concatenate([np.ascontiguousarray(img_l, np.float32), m_map], -1)
        return {"L": l_full, "H": np.ascontiguousarray(img_h, np.float32),
                "L_path": h_path, "H_path": h_path}
