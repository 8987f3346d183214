"""Video datasets (counterpart of ``kair_tpu/data/dataset_video.py``; KAIR
data/dataset_video_train.py:11-182 and dataset_video_test.py:11-297): the
test datasets and ``VideoRecurrentTrainDataset`` with its paired random
crop and joint flip/rotation.

Clips are (D, H, W, C) float32 in [0, 1]; the Loader or the caller stacks
them to (B, D, H, W, C). Each dataset reads frames through two hooks,
``image_paths(folder)`` (the folder's frame files in order) and
``read_uint(path)`` (uint8 H x W x 3), as ``DatasetSR`` does: they are its
only file-system calls for frames, so a subclass can serve frames from
elsewhere (a machine without ``cv2``, seeded frames). The other training
datasets (Vimeo, non-blind denoising, frame interpolation) and the packed
'framepack' backend are a later slice of the port (ROADMAP Queue 1).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from kair_tpu_torch.data.base import Dataset
from kair_tpu_torch.utils import image as im


class _FrameSource:
    """Frame reading for the video datasets: the disk backend (KAIR's
    'disk' io_backend); the JAX package's packed 'framepack' store (its
    replacement for lmdb) is not ported yet and raises."""

    def __init__(self, opt: dict):
        backend = (opt.get("io_backend") or {"type": "disk"}).get("type", "disk")
        if backend != "disk":
            raise NotImplementedError(
                f"io_backend '{backend}' needs data/framepack.py, a later "
                "slice of the port (ROADMAP Queue 1)")

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


def paired_random_crop(img_gts: List[np.ndarray], img_lqs: List[np.ndarray],
                       gt_patch_size: int, scale: int,
                       rng: np.random.Generator):
    """The same window of every LQ frame and the matching GT window (KAIR
    utils/utils_video.py:240-300)."""
    lq_patch_size = gt_patch_size // scale
    h_lq, w_lq = img_lqs[0].shape[:2]
    top = int(rng.integers(0, h_lq - lq_patch_size + 1))
    left = int(rng.integers(0, w_lq - lq_patch_size + 1))
    img_lqs = [v[top:top + lq_patch_size, left:left + lq_patch_size]
               for v in img_lqs]
    top_gt, left_gt = top * scale, left * scale
    img_gts = [v[top_gt:top_gt + gt_patch_size, left_gt:left_gt + gt_patch_size]
               for v in img_gts]
    return img_gts, img_lqs


def augment_frames(frames: List[np.ndarray], hflip: bool, rot: bool,
                   rng: np.random.Generator) -> List[np.ndarray]:
    """One draw of hflip, vflip and transpose for all frames (KAIR
    utils_video.py:173-237)."""
    do_h = hflip and rng.random() < 0.5
    do_v = rot and rng.random() < 0.5
    do_r = rot and rng.random() < 0.5

    def aug(img):
        if do_h:
            img = img[:, ::-1, :]
        if do_v:
            img = img[::-1, :, :]
        if do_r:
            img = img.transpose(1, 0, 2)
        return img

    return [aug(f) for f in frames]


class VideoRecurrentTrainDataset(_FrameSource, Dataset):
    """Clips of ``num_frame`` frames at a random start and interval, a
    paired random crop and joint augmentation (KAIR
    dataset_video_train.py:11-182, disk backend). Without a
    ``meta_info_file`` on disk the GT folder's clips are scanned, each
    clip's frames through ``image_paths``."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        self.scale = opt.get("scale") or 4
        self.gt_size = opt.get("gt_size") or 256
        self.gt_root = Path(opt["dataroot_gt"])
        self.lq_root = Path(opt["dataroot_lq"])
        self.filename_tmpl = opt.get("filename_tmpl") or "08d"
        self.filename_ext = opt.get("filename_ext") or "png"
        self.num_frame = opt.get("num_frame") or 6
        self.interval_list = opt.get("interval_list") or [1]
        self.random_reverse = bool(opt.get("random_reverse") or False)
        self.use_hflip = bool(opt.get("use_hflip", True))
        self.use_rot = bool(opt.get("use_rot", True))

        self.keys: List[str] = []
        self.total_frames: Dict[str, int] = {}
        self.start_frames: Dict[str, int] = {}
        meta = opt.get("meta_info_file")
        if meta and os.path.exists(meta):
            with open(meta) as f:
                for line in f:
                    parts = line.split()
                    folder, n = parts[0], int(parts[1])
                    start = int(parts[3]) if len(parts) > 3 else 0
                    self.total_frames[folder] = n
                    self.start_frames[folder] = start
                    self.keys.extend(f"{folder}/{i:{self.filename_tmpl}}"
                                     for i in range(start, start + n))
        else:
            for clip in sorted(os.listdir(self.gt_root)):
                frames = [os.path.basename(p)
                          for p in self.image_paths(self.gt_root / clip)]
                self.total_frames[clip] = len(frames)
                self.start_frames[clip] = 0
                self.keys.extend(f"{clip}/{os.path.splitext(f)[0]}"
                                 for f in frames)

        # the validation partition (KAIR :64-76)
        val_partition: List[str] = []
        if opt.get("name") == "REDS":
            if opt.get("val_partition") == "REDS4":
                val_partition = ["000", "011", "015", "020"]
            elif opt.get("val_partition") == "official":
                val_partition = [f"{v:03d}" for v in range(240, 270)]
        test_mode = bool(opt.get("test_mode"))
        self.keys = [k for k in self.keys
                     if (k.split("/")[0] in val_partition) == test_mode]

    def __len__(self):
        return len(self.keys)

    def get_example(self, index: int, rng: np.random.Generator):
        key = self.keys[index]
        clip_name, frame_name = key.split("/")
        start = self.start_frames[clip_name]
        total = self.total_frames[clip_name]
        interval = int(rng.choice(self.interval_list))
        endmost = start + total - self.num_frame * interval
        start_idx = min(int(frame_name), max(start, endmost))
        indices = list(range(start_idx, start_idx + self.num_frame * interval,
                             interval))
        if self.random_reverse and rng.random() < 0.5:
            indices.reverse()
        lqs, gts = [], []
        for i in indices:
            name = f"{clip_name}/{i:{self.filename_tmpl}}.{self.filename_ext}"
            lqs.append(self.read_frame(self.lq_root / name))
            gts.append(self.read_frame(self.gt_root / name))
        gts, lqs = paired_random_crop(gts, lqs, self.gt_size, self.scale, rng)
        frames = augment_frames(gts + lqs, self.use_hflip, self.use_rot, rng)
        gts, lqs = frames[:self.num_frame], frames[self.num_frame:]
        return {"L": np.ascontiguousarray(np.stack(lqs), np.float32),
                "H": np.ascontiguousarray(np.stack(gts), np.float32),
                "key": key}


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
