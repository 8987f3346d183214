"""Video datasets (counterpart of ``kair_tpu/data/dataset_video.py``; KAIR
data/dataset_video_train.py:11-453 and dataset_video_test.py:11-425): the
recurrent training sets (REDS-style clips, non-blind denoising, Vimeo90K
septuplets and their frame-interpolation variant) with the paired random
crop and joint flip/rotation, and the test sets (whole clips, Vimeo90K,
and the DAVIS / UCF101 / Vid4 frame-interpolation sets).

Clips are (D, H, W, C) float32 in [0, 1]; the Loader or the caller stacks
them to (B, D, H, W, C). Each dataset reads frames through two hooks,
``image_paths(folder)`` (the folder's frame files in order) and
``read_uint(path)`` (uint8 H x W x 3), as ``DatasetSR`` does: they are its
only file-system calls for frames, so a subclass can serve frames from
elsewhere (a machine without ``cv2``, seeded frames). The training sets
also read packed stores (``io_backend`` 'framepack', ``data/framepack``,
the JAX package's replacement for KAIR's lmdb, by the same keys).
Every random draw is the JAX module's, in its order, so one seed gives the
same batches in both packages.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from kair_tpu_torch.data.base import Dataset
from kair_tpu_torch.utils import image as im


class _FrameSource:
    """Frame reading for the video datasets: files on disk through the
    hooks, and for the training sets (``read_key``) the ``io_backend``
    option's packed stores (KAIR dataset_video_train.py:100-120: an lmdb
    backend gets ``db_paths`` [lq root, gt root] and ``client_keys`` ['lq',
    'gt']; 'framepack' replaces 'lmdb' here, and a packed store needs a
    ``meta_info_file``: it cannot be folder-scanned)."""

    def __init__(self, opt: dict):
        io = dict(opt.get("io_backend") or {"type": "disk"})
        self.backend = io.pop("type", "disk")
        if self.backend != "disk":
            io.setdefault("db_paths", [str(opt["dataroot_lq"]),
                                       str(opt["dataroot_gt"])])
            io.setdefault("client_keys", ["lq", "gt"])
            if not opt.get("meta_info_file"):
                raise ValueError(
                    f"io_backend '{self.backend}' requires meta_info_file "
                    "(packed stores cannot be folder-scanned)")
        self.io_kwargs = io
        self.client = None

    def read_key(self, root, rel_path: str, key: str, client_key: str
                 ) -> np.ndarray:
        """One frame as float32: ``root / rel_path`` on disk, or ``key``
        of the ``client_key`` store (opened on the first read)."""
        if self.backend == "disk":
            return self.read_frame(Path(root) / rel_path)
        from kair_tpu_torch.data.framepack import FileClient, imfrombytes
        if self.client is None:
            self.client = FileClient(self.backend, **self.io_kwargs)
        return imfrombytes(self.client.get(key, client_key), float32=True)

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

    def frame_indices(self, index: int, rng: np.random.Generator):
        """The clip's name and its num_frame frame indices: a random
        interval, the start clamped so the clip fits, optionally
        reversed (KAIR :124-146)."""
        clip_name, frame_name = self.keys[index].split("/")
        start = self.start_frames[clip_name]
        total = self.total_frames[clip_name]
        interval = int(rng.choice(self.interval_list))
        endmost = start + total - self.num_frame * interval
        start_idx = min(int(frame_name), max(start, endmost))
        indices = list(range(start_idx, start_idx + self.num_frame * interval,
                             interval))
        if self.random_reverse and rng.random() < 0.5:
            indices.reverse()
        return clip_name, indices

    def clip_frames(self, clip_name: str, indices, root, which: str
                    ) -> List[np.ndarray]:
        """The clip's frames at ``indices`` from ``root`` (or the ``which``
        store: "lq" or "gt")."""
        out = []
        for i in indices:
            key = f"{clip_name}/{i:{self.filename_tmpl}}"
            out.append(self.read_key(root, f"{key}.{self.filename_ext}", key,
                                     which))
        return out

    def get_example(self, index: int, rng: np.random.Generator):
        key = self.keys[index]
        clip_name, indices = self.frame_indices(index, rng)
        lqs = self.clip_frames(clip_name, indices, self.lq_root, "lq")
        gts = self.clip_frames(clip_name, indices, self.gt_root, "gt")
        gts, lqs = paired_random_crop(gts, lqs, self.gt_size, self.scale, rng)
        frames = augment_frames(gts + lqs, self.use_hflip, self.use_rot, rng)
        gts, lqs = frames[:self.num_frame], frames[self.num_frame:]
        return {"L": np.ascontiguousarray(np.stack(lqs), np.float32),
                "H": np.ascontiguousarray(np.stack(gts), np.float32),
                "key": key}


class VideoRecurrentTrainNonblindDenoisingDataset(VideoRecurrentTrainDataset):
    """GT-only clips plus Gaussian noise of a uniform σ, with the σ map
    appended to L as a fourth channel (KAIR dataset_video_train.py:184-259);
    the crop is at scale 1 (:237)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.sigma_min = (opt.get("sigma_min") or 0) / 255.0
        self.sigma_max = (opt.get("sigma_max") or 50) / 255.0

    def get_example(self, index: int, rng: np.random.Generator):
        key = self.keys[index]
        clip_name, indices = self.frame_indices(index, rng)
        gts = self.clip_frames(clip_name, indices, self.gt_root, "gt")
        gts, _ = paired_random_crop(gts, gts, self.gt_size, 1, rng)
        gts = augment_frames(gts, self.use_hflip, self.use_rot, rng)
        gt = np.ascontiguousarray(np.stack(gts), np.float32)
        # the noise is drawn here, in the data pipeline (KAIR :245-251)
        sigma = rng.uniform(self.sigma_min, self.sigma_max)
        lqs = gt + rng.normal(0.0, sigma, gt.shape).astype(np.float32)
        sigma_map = np.full(lqs.shape[:3] + (1,), sigma, np.float32)
        return {"L": np.concatenate([lqs, sigma_map], -1).astype(np.float32),
                "H": gt, "key": key}


class VideoRecurrentTrainVimeoDataset(_FrameSource, Dataset):
    """Vimeo90K septuplets (KAIR dataset_video_train.py:262-388): keys from
    the meta_info ("00001/0001 7 (256,448,3)") or the GT tree's clip/sequence
    folders; the centred window of num_frame frames im{n} (:321), strided
    by temporal_scale; mirror_sequence doubles 7 frames to 14, pad_sequence
    repeats the last (:375-380)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.opt = opt
        self.scale = opt.get("scale") or 4
        self.gt_size = opt.get("gt_size") or 256
        self.gt_root = Path(opt["dataroot_gt"])
        self.lq_root = Path(opt["dataroot_lq"])
        self.temporal_scale = opt.get("temporal_scale") or 1
        self.num_frame = opt.get("num_frame") or 7
        self.random_reverse = bool(opt.get("random_reverse") or False)
        self.use_hflip = bool(opt.get("use_hflip", True))
        self.use_rot = bool(opt.get("use_rot", True))
        self.mirror_sequence = bool(opt.get("mirror_sequence") or False)
        self.pad_sequence = bool(opt.get("pad_sequence") or False)
        meta = opt.get("meta_info_file")
        if meta and os.path.exists(meta):
            with open(meta) as f:
                self.keys = [line.split(" ")[0] for line in f if line.strip()]
        else:
            self.keys = [f"{clip}/{seq}"
                         for clip in sorted(os.listdir(self.gt_root))
                         for seq in sorted(os.listdir(self.gt_root / clip))]
        self.neighbor_list = [i + (9 - self.num_frame) // 2
                              for i in range(self.num_frame)
                              ][::self.temporal_scale]

    def __len__(self):
        return len(self.keys)

    def _frames(self, key: str, root, which: str, neighbors
                ) -> List[np.ndarray]:
        return [self.read_key(root, f"{key}/im{n}.png", f"{key}/im{n}", which)
                for n in neighbors]

    def _neighbors(self, rng: np.random.Generator) -> List[int]:
        neighbors = list(self.neighbor_list)
        if self.random_reverse and rng.random() < 0.5:
            neighbors.reverse()
        return neighbors

    def get_example(self, index: int, rng: np.random.Generator):
        neighbors = self._neighbors(rng)
        key = self.keys[index]
        lqs = self._frames(key, self.lq_root, "lq", neighbors)
        gts = self._frames(key, self.gt_root, "gt", neighbors)
        gts, lqs = paired_random_crop(gts, lqs, self.gt_size, self.scale, rng)
        n = len(lqs)
        frames = augment_frames(lqs + gts, self.use_hflip, self.use_rot, rng)
        lqs = np.ascontiguousarray(np.stack(frames[:n]), np.float32)
        gts = np.ascontiguousarray(np.stack(frames[n:]), np.float32)
        if self.mirror_sequence:
            lqs = np.concatenate([lqs, lqs[::-1]], 0)
            gts = np.concatenate([gts, gts[::-1]], 0)
        elif self.pad_sequence:
            lqs = np.concatenate([lqs, lqs[-1:]], 0)
            gts = np.concatenate([gts, gts[-1:]], 0)
        return {"L": lqs, "H": gts, "key": key}


_LUM = np.asarray([0.299, 0.587, 0.114], np.float32)
_YIQ = np.asarray([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                   [0.211, -0.523, 0.312]], np.float32)


def color_jitter_frames(frames: np.ndarray, strength: float,
                        rng: np.random.Generator) -> np.ndarray:
    """One brightness / contrast / saturation / hue jitter over a (T, H, W,
    3) stack, as torchvision's ColorJitter draws it (factors U[1 − s, 1 +
    s], hue shift U[−s, s], the four in a random order; the JAX package's
    draws, in its order). KAIR jitters the whole stacked clip at once
    (dataset_video_train.py:443-444)."""
    ops = list(rng.permutation(4))
    b = rng.uniform(max(0.0, 1 - strength), 1 + strength)
    c = rng.uniform(max(0.0, 1 - strength), 1 + strength)
    s = rng.uniform(max(0.0, 1 - strength), 1 + strength)
    h = rng.uniform(-strength, strength)
    x = frames
    for op in ops:
        if op == 0:
            x = x * b
        elif op == 1:
            mean = (x @ _LUM).mean(axis=(-2, -1), keepdims=True)[..., None]
            x = (x - mean) * c + mean
        elif op == 2:
            gray = (x @ _LUM)[..., None]
            x = (x - gray) * s + gray
        else:
            # a hue rotation in YIQ space (the HSV hue shift)
            theta = 2 * np.pi * h
            u, w = np.cos(theta), np.sin(theta)
            r = np.asarray([[1, 0, 0], [0, u, -w], [0, w, u]], np.float32)
            m = (np.linalg.inv(_YIQ) @ r @ _YIQ).astype(np.float32)
            x = x @ m.T
        x = np.clip(x, 0.0, 1.0)
    return x.astype(np.float32)


class VideoRecurrentTrainVimeoVFIDataset(VideoRecurrentTrainVimeoDataset):
    """Frame interpolation: L the neighbour frames, H the centre frame im4
    (KAIR dataset_video_train.py:390-453), with an optional joint colour
    jitter of strength 0.05 (:396-398)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.color_jitter = bool(opt.get("color_jitter") or False)

    def get_example(self, index: int, rng: np.random.Generator):
        neighbors = self._neighbors(rng)
        key = self.keys[index]
        lqs = self._frames(key, self.lq_root, "lq", neighbors)
        gts = self._frames(key, self.gt_root, "gt", [4])
        gts, lqs = paired_random_crop(gts, lqs, self.gt_size, self.scale, rng)
        frames = augment_frames(lqs + gts, self.use_hflip, self.use_rot, rng)
        stack = np.ascontiguousarray(np.stack(frames), np.float32)
        if self.color_jitter:
            stack = color_jitter_frames(stack, 0.05, rng)
        return {"L": stack[:-1], "H": stack[-1:], "key": key}


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


def _center_crop(img: np.ndarray, size) -> np.ndarray:
    th, tw = size
    h, w = img.shape[:2]
    top, left = (h - th) // 2, (w - tw) // 2
    return img[top:top + th, left:left + tw]


class _VfiSets(_FrameSource, Dataset):
    """Frame-interpolation test sets of septuplets: L the four frames at
    even steps, H the centre frame between them. ``data_root`` is the
    folder of clips (``define_dataset`` passes ``dataroot_lq``)."""

    takes_root = True
    crop = None

    def __init__(self, data_root: str, ext: str = "png"):
        super().__init__({})
        self.data_root = data_root
        self.images_sets: List[List[str]] = []

    def __len__(self):
        return len(self.images_sets)

    def _stack(self, paths) -> np.ndarray:
        imgs = [self.read_frame(p) for p in paths]
        if self.crop:
            imgs = [_center_crop(i, self.crop) for i in imgs]
        return np.stack(imgs).astype(np.float32)

    def _septuplets(self, imgs: List[str]):
        """Frames start, start + 2, start + 4, start + 6 with start + 3 in
        the middle, for every even start (KAIR :313-316)."""
        for start in range(0, len(imgs) - 6, 2):
            add = imgs[start:start + 7:2]
            yield start, add[:2] + [imgs[start + 3]] + add[2:]


class VFI_DAVIS(_VfiSets):
    """DAVIS, centre-cropped to 480x840 (KAIR dataset_video_test.py:
    300-343)."""

    crop = (480, 840)

    def __init__(self, data_root: str, ext: str = "png"):
        super().__init__(data_root, ext)
        for label_id in sorted(os.listdir(data_root)):
            imgs = self.image_paths(os.path.join(data_root, label_id))
            self.images_sets += [s for _, s in self._septuplets(imgs)]

    def get_example(self, index: int, rng):
        arr = self._stack(self.images_sets[index])
        return {"L": np.concatenate([arr[:2], arr[3:]], 0), "H": arr[2:3],
                "folder": str(index), "gt_path": ["vfi_result.png"]}


class VFI_UCF101(_VfiSets):
    """UCF101 triplet folders (frame0..3 and framet), centre-cropped to
    224x224 (KAIR dataset_video_test.py:346-377)."""

    crop = (224, 224)
    NAMES = ("frame0.png", "frame1.png", "frame2.png", "frame3.png",
             "framet.png")

    def __init__(self, data_root: str, ext: str = "png"):
        super().__init__(data_root, ext)
        self.file_list = sorted(os.listdir(data_root))

    def __len__(self):
        return len(self.file_list)

    def get_example(self, index: int, rng):
        d = os.path.join(self.data_root, self.file_list[index])
        arr = self._stack([os.path.join(d, n) for n in self.NAMES])
        return {"L": arr[:-1], "H": arr[-1:], "folder": self.file_list[index],
                "gt_path": ["vfi_result.png"]}


class VFI_Vid4(_VfiSets):
    """Vid4, each clip padded at both ends so that every odd frame is the
    target of its even neighbours (KAIR dataset_video_test.py:380-425)."""

    def __init__(self, data_root: str, ext: str = "png"):
        super().__init__(data_root, ext)
        self.data_info: Dict[str, List[Any]] = {"lq_path": [], "gt_path": [],
                                                "folder": []}
        for label_id in sorted(os.listdir(data_root)):
            imgs: List[Any] = self.image_paths(os.path.join(data_root,
                                                            label_id))
            if len(imgs) % 2 == 0:
                imgs.append(imgs[-1])
            # [img1, None, img0 .. imgN, None, imgN-1] (KAIR :397-401)
            imgs.insert(0, None)
            imgs.insert(0, imgs[1])
            imgs.append(None)
            imgs.append(imgs[-2])
            for start, sept in self._septuplets(imgs):
                self.data_info["lq_path"].append(
                    [os.path.basename(p) for p in imgs[start:start + 7:2]])
                self.data_info["gt_path"].append(
                    os.path.basename(imgs[start + 3]))
                self.data_info["folder"].append(label_id)
                self.images_sets.append(sept)

    def get_example(self, index: int, rng):
        arr = self._stack(self.images_sets[index])
        return {"L": np.concatenate([arr[:2], arr[3:]], 0), "H": arr[2:3],
                "folder": self.data_info["folder"][index],
                "lq_path": self.data_info["lq_path"][index],
                "gt_path": [self.data_info["gt_path"][index]]}
