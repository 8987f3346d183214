"""Image-restoration datasets (NHWC host pipeline; counterpart of
``kair_tpu/data/datasets.py``, pure numpy, copied so the port needs nothing
of the JAX package).

Each class reproduces the corresponding reference dataset's protocol
(patching, augmentation, degradation synthesis, seeded test noise) with an
explicit numpy Generator instead of global random state. Returned images
are HWC float32 in [0,1]; the Loader stacks them to NHWC.

  DatasetDnCNN   reference data/dataset_dncnn.py:9-101  (AWGN fixed σ;
                 test noise np.random.seed(0) for checkpoint-parity PSNR)
  DatasetFDnCNN  reference data/dataset_fdncnn.py        (σ∈[min,max], HxW
                 noise-level map concatenated as input channel)
  DatasetFFDNet  reference data/dataset_ffdnet.py:30-103 (scalar σ input 'C')
  DatasetSR      reference data/dataset_sr.py:7-105      (paired or MATLAB-
                 bicubic-synthesised L, aligned L/H crops)
  DatasetPlain   reference data/dataset_plain.py         (generic pairs)
  DatasetL       reference data/dataset_l.py             (L only, inference)

Every dataset of the port reads its images through two hooks of
:class:`ImageFiles`, ``image_paths`` and ``read_uint``: a subclass can
serve images from elsewhere (chip_smoke.py draws seeded ones, since the
card has no cv2 to decode files with).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from kair_tpu_torch.data.base import Dataset, Loader
from kair_tpu_torch.utils import image as im
from kair_tpu_torch.utils.logger import warn_once


class ImageFiles(Dataset):
    """The two file-system calls of a dataset: ``image_paths(root)`` lists
    a folder's images, ``read_uint(path)`` reads one as HWC uint8 with the
    dataset's ``n_channels``."""

    n_channels = 3

    def image_paths(self, root: str):
        return im.get_image_paths(root)

    def read_uint(self, path: str) -> np.ndarray:
        return im.imread_uint(path, self.n_channels)


def _rand_crop(img: np.ndarray, size: int, rng: np.random.Generator):
    h, w = img.shape[:2]
    rh = int(rng.integers(0, max(0, h - size) + 1))
    rw = int(rng.integers(0, max(0, w - size) + 1))
    return img[rh: rh + size, rw: rw + size, ...], rh, rw


class DatasetDnCNN(ImageFiles):
    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.patch_size = opt.get("H_size") or 64
        self.sigma = opt.get("sigma") or 25
        self.sigma_test = opt.get("sigma_test") or self.sigma
        self.phase = opt.get("phase") or "train"
        self.paths_H = self.image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index: int, rng: np.random.Generator) -> Dict[str, Any]:
        h_path = self.paths_H[index]
        img_h = self.read_uint(h_path)
        if self.phase == "train":
            patch, _, _ = _rand_crop(img_h, self.patch_size, rng)
            patch = im.augment_img(patch, int(rng.integers(0, 8)))
            h = im.uint2single(patch)
            l = h + rng.standard_normal(h.shape).astype(np.float32) * (self.sigma / 255.0)
        else:
            h = im.uint2single(img_h)
            np.random.seed(seed=0)  # test protocol parity (main_test_dncnn.py:151)
            l = h + np.random.normal(0, self.sigma_test / 255.0, h.shape)
        return {"L": l.astype(np.float32), "H": h.astype(np.float32),
                "L_path": h_path, "H_path": h_path}


class DatasetFDnCNN(ImageFiles):
    """Noise-level map concatenated into L (in_nc = n_channels+1)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.patch_size = opt.get("H_size") or 64
        self.sigma = opt.get("sigma") or [0, 75]
        self.sigma_min, self.sigma_max = self.sigma[0], self.sigma[1]
        self.sigma_test = opt.get("sigma_test") or 25
        self.phase = opt.get("phase") or "train"
        self.paths_H = self.image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        h_path = self.paths_H[index]
        img_h = self.read_uint(h_path)
        if self.phase == "train":
            patch, _, _ = _rand_crop(img_h, self.patch_size, rng)
            patch = im.augment_img(patch, int(rng.integers(0, 8)))
            h = im.uint2single(patch)
            level = float(rng.uniform(self.sigma_min, self.sigma_max)) / 255.0
            l = h + rng.standard_normal(h.shape).astype(np.float32) * level
        else:
            h = im.uint2single(img_h)
            np.random.seed(seed=0)
            level = self.sigma_test / 255.0
            l = h + np.random.normal(0, level, h.shape)
        m = np.full(l.shape[:2] + (1,), level, np.float32)
        l = np.concatenate([l.astype(np.float32), m], axis=-1)
        return {"L": l, "H": h.astype(np.float32), "L_path": h_path, "H_path": h_path}


class DatasetFFDNet(ImageFiles):
    """Scalar σ conditioning channel 'C' of shape (1,1,1)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.patch_size = opt.get("H_size") or 64
        self.sigma = opt.get("sigma") or [0, 75]
        self.sigma_min, self.sigma_max = self.sigma[0], self.sigma[1]
        self.sigma_test = opt.get("sigma_test") or 25
        self.phase = opt.get("phase") or "train"
        self.paths_H = self.image_paths(opt["dataroot_H"])

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        h_path = self.paths_H[index]
        img_h = self.read_uint(h_path)
        if self.phase == "train":
            patch, _, _ = _rand_crop(img_h, self.patch_size, rng)
            patch = im.augment_img(patch, int(rng.integers(0, 8)))
            h = im.uint2single(patch)
            level = float(rng.uniform(self.sigma_min, self.sigma_max)) / 255.0
            l = h + rng.standard_normal(h.shape).astype(np.float32) * level
        else:
            h = im.uint2single(img_h)
            np.random.seed(seed=0)
            level = self.sigma_test / 255.0
            l = h + np.random.normal(0, level, h.shape)
        return {"L": l.astype(np.float32), "H": h.astype(np.float32),
                "C": np.full((1, 1, 1), level, np.float32),
                "L_path": h_path, "H_path": h_path}


class DatasetSR(ImageFiles):

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.sf = opt.get("scale") or 4
        self.patch_size = opt.get("H_size") or 96
        self.L_size = self.patch_size // self.sf
        self.phase = opt.get("phase") or "train"
        self.paths_H = self.image_paths(opt["dataroot_H"])
        self.paths_L = self.image_paths(opt["dataroot_L"]) if opt.get("dataroot_L") else None
        if self.paths_L:
            assert len(self.paths_L) == len(self.paths_H)

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        h_path = self.paths_H[index]
        img_h = im.uint2single(self.read_uint(h_path))
        img_h = im.modcrop(img_h, self.sf)
        if self.paths_L:
            l_path = self.paths_L[index]
            img_l = im.uint2single(self.read_uint(l_path))
        else:
            l_path = h_path
            img_l = im.imresize_np(img_h, 1 / self.sf, True)
        if self.phase == "train":
            img_l, rh, rw = _rand_crop(img_l, self.L_size, rng)
            rh, rw = rh * self.sf, rw * self.sf
            img_h = img_h[rh: rh + self.patch_size, rw: rw + self.patch_size, :]
            mode = int(rng.integers(0, 8))
            img_l = im.augment_img(img_l, mode)
            img_h = im.augment_img(img_h, mode)
        return {"L": np.ascontiguousarray(img_l, np.float32),
                "H": np.ascontiguousarray(img_h, np.float32),
                "L_path": l_path, "H_path": h_path}


class DatasetPlain(ImageFiles):
    """Generic paired L/H (reference data/dataset_plain.py)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_channels = opt.get("n_channels") or 3
        self.patch_size = opt.get("H_size") or 64
        self.phase = opt.get("phase") or "train"
        self.paths_H = self.image_paths(opt["dataroot_H"])
        self.paths_L = self.image_paths(opt["dataroot_L"])
        assert len(self.paths_L) == len(self.paths_H)

    def __len__(self):
        return len(self.paths_H)

    def get_example(self, index, rng):
        h_path, l_path = self.paths_H[index], self.paths_L[index]
        img_h = im.uint2single(self.read_uint(h_path))
        img_l = im.uint2single(self.read_uint(l_path))
        if self.phase == "train":
            hh, ww = img_h.shape[:2]
            rh = int(rng.integers(0, max(0, hh - self.patch_size) + 1))
            rw = int(rng.integers(0, max(0, ww - self.patch_size) + 1))
            img_h = img_h[rh: rh + self.patch_size, rw: rw + self.patch_size, :]
            img_l = img_l[rh: rh + self.patch_size, rw: rw + self.patch_size, :]
            mode = int(rng.integers(0, 8))
            img_h = im.augment_img(img_h, mode)
            img_l = im.augment_img(img_l, mode)
        return {"L": np.ascontiguousarray(img_l, np.float32),
                "H": np.ascontiguousarray(img_h, np.float32),
                "L_path": l_path, "H_path": h_path}


class DatasetL(ImageFiles):
    """L-only inference set (reference data/dataset_l.py)."""

    def __init__(self, opt: dict):
        self.n_channels = opt.get("n_channels") or 3
        self.paths_L = self.image_paths(opt["dataroot_L"])

    def __len__(self):
        return len(self.paths_L)

    def get_example(self, index, rng):
        l_path = self.paths_L[index]
        img_l = im.uint2single(self.read_uint(l_path))
        return {"L": img_l.astype(np.float32), "L_path": l_path}


# dataset types of the JAX package's extra registry, by the slice of the
# port that brings them (ROADMAP.md, Queue 1)
LATER_SLICES = {"spect": "SPECT", "spectpatch": "SPECT"}
# types whose classes live in modules of their own: (module, class)
MODULES = {
    "usrnet": ("dataset_usrnet", "DatasetUSRNet"),
    "srmd": ("dataset_srmd", "DatasetSRMD"),
    "dpsr": ("dataset_srmd", "DatasetDPSR"),
    "dnpatch": ("dataset_patch", "DatasetDnPatch"),
    "plainpatch": ("dataset_patch", "DatasetPlainPatch"),
    "blindsr": ("dataset_blindsr", "DatasetBlindSR"),
    "jpeg": ("dataset_jpeg", "DatasetJPEG"),
    "videorecurrenttraindataset": ("dataset_video", "VideoRecurrentTrainDataset"),
    "video_train": ("dataset_video", "VideoRecurrentTrainDataset"),
    "videorecurrenttestdataset": ("dataset_video", "VideoRecurrentTestDataset"),
    "video_test": ("dataset_video", "VideoRecurrentTestDataset"),
    "singlevideorecurrenttestdataset": ("dataset_video",
                                        "SingleVideoRecurrentTestDataset"),
    "video_test_single": ("dataset_video", "SingleVideoRecurrentTestDataset"),
    "videotestvimeo90kdataset": ("dataset_video", "VideoTestVimeo90KDataset"),
    "video_test_vimeo": ("dataset_video", "VideoTestVimeo90KDataset"),
    "videorecurrenttrainnonblinddenoisingdataset": (
        "dataset_video", "VideoRecurrentTrainNonblindDenoisingDataset"),
    "video_train_dn": ("dataset_video",
                       "VideoRecurrentTrainNonblindDenoisingDataset"),
    "videorecurrenttrainvimeodataset": ("dataset_video",
                                        "VideoRecurrentTrainVimeoDataset"),
    "video_train_vimeo": ("dataset_video", "VideoRecurrentTrainVimeoDataset"),
    "videorecurrenttrainvimeovfidataset": (
        "dataset_video", "VideoRecurrentTrainVimeoVFIDataset"),
    "video_train_vimeo_vfi": ("dataset_video",
                              "VideoRecurrentTrainVimeoVFIDataset"),
    # the frame-interpolation test sets take their folder, dataroot_lq
    "vfi_davis": ("dataset_video", "VFI_DAVIS"),
    "vfi_ucf101": ("dataset_video", "VFI_UCF101"),
    "vfi_vid4": ("dataset_video", "VFI_Vid4"),
}


def dataset_class(opt_ds: dict) -> type:
    """The dataset class of an option block's ``dataset_type`` (reference
    data/select_dataset.py:12-100)."""
    t = (opt_ds.get("dataset_type") or "plain").lower()
    table = {
        "dncnn": DatasetDnCNN, "denoising": DatasetDnCNN,
        "fdncnn": DatasetFDnCNN,
        "ffdnet": DatasetFFDNet,
        "sr": DatasetSR, "super-resolution": DatasetSR,
        "plain": DatasetPlain,
        "l": DatasetL,
    }
    if t in table:
        return table[t]
    if t in MODULES:
        import importlib
        module, cls = MODULES[t]
        return getattr(importlib.import_module(
            f"kair_tpu_torch.data.{module}"), cls)
    slice_name = LATER_SLICES.get(t)
    if slice_name:
        raise NotImplementedError(
            f"dataset type [{t}] belongs to the {slice_name} slice of the "
            "port, not ported yet")
    raise NotImplementedError(f"dataset type [{t}] is not implemented yet")


def define_dataset(opt_ds: dict) -> Dataset:
    """The dataset of an option block (reference data/select_dataset.py)."""
    cls = dataset_class(opt_ds)
    if getattr(cls, "takes_root", False):
        return cls(opt_ds["dataroot_lq"])
    return cls(opt_ds)


def make_train_loader(ds_opt: dict, batch_size: int, seed: int = 0,
                      info=lambda s: None) -> Loader:
    """The training batch source for a dataset option block: the Python
    ``Loader``. ``use_native_loader`` (the JAX package's C++ epoch loader)
    is a later slice of the port (ROADMAP Queue 1 item 10); the option is
    logged and the Python loader used, as the JAX package does when its
    native loader is unavailable."""
    if ds_opt.get("use_native_loader"):
        warn_once("native-loader", "use_native_loader: the native C++ loader "
                  "is a later slice of the port; using the Python loader")
        info("native loader not ported yet; using the python loader")
    ds = define_dataset(ds_opt)
    ld = Loader(ds, batch_size,
                shuffle=bool(ds_opt.get("dataloader_shuffle", True)),
                seed=seed)
    info(f"train images: {len(ds)}, iters/epoch: {len(ld)}")
    return ld
