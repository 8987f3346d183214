"""Video test datasets (counterpart of the test half of
``kair_tpu/data/dataset_video.py``; KAIR data/dataset_video_test.py:11-297).

Clips are (D, H, W, C) float32 in [0, 1]; the Loader or the caller stacks
them to (B, D, H, W, C). Each dataset reads frames through two hooks,
``image_paths(folder)`` (the folder's frame files in order) and
``read_uint(path)`` (uint8 H x W x 3), as ``DatasetSR`` does: they are its
only file-system calls for frames, so a subclass can serve frames from
elsewhere (a machine without ``cv2``, seeded frames). The training
datasets and the packed-frame backend come with the video-training slice.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from kair_tpu_torch.data.base import Dataset
from kair_tpu_torch.utils import image as im


class _FrameSource:
    """Frame reading for the test datasets: the disk backend (KAIR's
    'disk' io_backend); the JAX package's packed 'framepack' store (its
    replacement for lmdb) is not ported yet and raises."""

    def __init__(self, opt: dict):
        backend = (opt.get("io_backend") or {"type": "disk"}).get("type", "disk")
        if backend != "disk":
            raise NotImplementedError(
                f"io_backend '{backend}' needs data/framepack.py, which comes "
                "with the video-training slice of the port")

    def image_paths(self, folder) -> List[str]:
        return [str(Path(folder) / n) for n in sorted(os.listdir(folder))]

    def read_uint(self, path: str) -> np.ndarray:
        return im.imread_uint(str(path), 3)

    def read_frame(self, path) -> np.ndarray:
        return im.uint2single(self.read_uint(str(path)))

    def read_clip(self, folder) -> np.ndarray:
        return np.stack([self.read_frame(p) for p in self.image_paths(folder)]
                        ).astype(np.float32)


def _folders(opt: dict, root: Path) -> List[str]:
    meta = opt.get("meta_info_file")
    if meta and os.path.exists(meta):
        with open(meta) as f:
            return [line.split(" ")[0].strip() for line in f if line.strip()]
    return sorted(os.listdir(root))


class VideoRecurrentTestDataset(_FrameSource, Dataset):
    """Whole-clip test dataset (KAIR dataset_video_test.py:11-130). With
    ``sigma`` (non-blind denoising, :102-113), L = H + seeded Gaussian noise
    with a constant σ-map channel appended; ``cache_data`` keeps clips in
    memory (:53-93)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        self.gt_root = Path(opt["dataroot_gt"])
        self.lq_root = Path(opt["dataroot_lq"])
        self.sigma = (opt.get("sigma") or 0) / 255.0
        self.cache_data = bool(opt.get("cache_data") or False)
        self.folders = _folders(opt, self.lq_root)
        self._cache: Dict[str, Any] = {}

    def __len__(self):
        return len(self.folders)

    def get_example(self, index: int, rng):
        folder = self.folders[index]
        if self.cache_data and folder in self._cache:
            lqs, gts = self._cache[folder]
        else:
            lqs = self.read_clip(self.lq_root / folder)
            gts = self.read_clip(self.gt_root / folder)
            if self.cache_data:
                self._cache[folder] = (lqs, gts)
        if self.sigma:
            # seeded as the JAX package seeds it (numpy default_rng(0))
            noise_rng = np.random.default_rng(0)
            lqs = gts + noise_rng.normal(0.0, self.sigma, gts.shape).astype(
                np.float32)
            t, h, w, _ = lqs.shape
            sigma_map = np.full((t, h, w, 1), self.sigma, np.float32)
            lqs = np.concatenate([lqs, sigma_map], axis=-1).astype(np.float32)
        return {"L": lqs, "H": gts, "folder": folder}


class SingleVideoRecurrentTestDataset(_FrameSource, Dataset):
    """LQ-only whole-clip test dataset (KAIR dataset_video_test.py:133-226)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        self.lq_root = Path(opt["dataroot_lq"])
        self.folders = _folders(opt, self.lq_root)

    def __len__(self):
        return len(self.folders)

    def get_example(self, index: int, rng):
        folder = self.folders[index]
        return {"L": self.read_clip(self.lq_root / folder), "folder": folder}


class VideoTestVimeo90KDataset(_FrameSource, Dataset):
    """Vimeo90K-test: 7 LQ frames in, the centre GT frame im4 out (KAIR
    dataset_video_test.py:229-297)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        self.gt_root = Path(opt["dataroot_gt"])
        self.lq_root = Path(opt["dataroot_lq"])
        self.temporal_scale = opt.get("temporal_scale") or 1
        self.num_frame = opt.get("num_frame") or 7
        self.pad_sequence = bool(opt.get("pad_sequence") or False)
        self.mirror_sequence = bool(opt.get("mirror_sequence") or False)
        self.neighbor_list = [i + (9 - self.num_frame) // 2
                              for i in range(self.num_frame)][::self.temporal_scale]
        with open(opt["meta_info_file"]) as f:
            self.subfolders = [line.split(" ")[0].strip() for line in f
                               if line.strip()]

    def __len__(self):
        return len(self.subfolders)

    def get_example(self, index: int, rng):
        sub = self.subfolders[index]
        lqs = np.stack([self.read_frame(self.lq_root / sub / f"im{n}.png")
                        for n in self.neighbor_list]).astype(np.float32)
        gt = self.read_frame(self.gt_root / sub / "im4.png")[None].astype(
            np.float32)
        if self.pad_sequence:
            lqs = np.concatenate([lqs, lqs[-1:]], axis=0)
        if self.mirror_sequence:
            lqs = np.concatenate([lqs, lqs[::-1]], axis=0)
        return {"L": lqs, "H": gt, "folder": sub, "border": 0}
