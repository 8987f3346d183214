"""The native C++ patch loader (counterpart of
``kair_tpu/data/native_loader.py``), on the port's own copy of the JAX
package's C++ source, ``kair_tpu_torch/cpp/patch_loader.cpp``: a RAM cache
of the training images, and the crop, 8-mode augmentation, uint8→float,
AWGN and MATLAB-bicubic synthesis off the GIL on a std::thread pool — the
counterpart of torch DataLoader worker processes.

The JAX binding's library decodes files with libpng and libjpeg; the card
machines have neither, so here the port decodes (PNG by ``utils/png``, as
libpng does: gray to RGB by repetition, RGB to gray by libpng's default
BT.709 weights in 15-bit fixed point, 16-bit samples by their high byte;
any other format by the datasets' reader) and the C++ side fills the same
cache from the decoded pixels. Crop, augmentation, noise and the random
streams are the JAX package's, so the two loaders give the same batches,
bit for bit, from one seed and one set of files.

The library is built at first use with ``g++ -O3 -fPIC -std=c++17
-pthread -shared`` into ``kair_tpu_torch/_build/`` (git-ignored), named by
the source's hash, written under a temporary name and moved into place
with ``os.replace``; a failed build raises with the compiler's output.
``build_seconds`` is the last build's wall time (None: already built).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "cpp" / "patch_loader.cpp"
BUILD_DIR = PKG_DIR / "_build"
BUILD_TIMEOUT_S = 300
build_seconds: Optional[float] = None
_lock = threading.Lock()
_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpatch_loader.{digest}.so"


def build() -> Path:
    """Compile the loader unless this source's library exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread",
           "-shared", "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native loader failed: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        vp, i, u64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, \
            ctypes.c_float
        imgs = ctypes.POINTER(_U8P)
        for name, res, args in (
                ("loader_create", vp, [imgs, _IP, i, i, i]),
                ("loader_num_images", i, [vp]),
                ("loader_image_shape", i, [vp, i, _IP, _IP, _IP]),
                ("loader_sample_awgn_batch", i,
                 [vp, i, i, f, u64, _F32P, _F32P]),
                ("loader_sample_awgn_range_batch", i,
                 [vp, i, i, f, f, u64, _F32P, _F32P, _F32P]),
                ("loader_destroy", None, [vp]),
                ("loader_augment", None, [_U8P, i, i, i, _U8P]),
                ("pair_loader_create", vp, [imgs, _IP, imgs, _IP, i, i, i]),
                ("pair_loader_create_bicubic", vp, [imgs, _IP, i, i, i, i]),
                ("bicubic_downscale_u8", None, [_U8P, i, i, i, i, _F32P]),
                ("pair_loader_num", i, [vp]),
                ("pair_loader_sample_sr_batch", i,
                 [vp, i, i, i, u64, _F32P, _F32P]),
                ("pair_loader_destroy", None, [vp])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


# 15-bit fixed-point luma weights of libpng's png_set_rgb_to_gray_fixed
# defaults (BT.709), truncated as png_do_rgb_to_gray does without gamma
_GRAY_WEIGHTS = (6968, 23434, 32768 - 6968 - 23434)


def read_image(path: str, n_channels: int) -> np.ndarray:
    """(H, W, n_channels) uint8, as the JAX loader's libpng decode gives it
    for a PNG; other formats through ``utils.image.imread_uint``."""
    from kair_tpu_torch.utils import image as im
    from kair_tpu_torch.utils.png import read_png
    if not path.lower().endswith(".png"):
        return im.imread_uint(path, n_channels)
    img = read_png(path)
    if n_channels == 3 and img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    if n_channels == 1 and img.shape[2] == 3:
        rgb = img.astype(np.uint32)
        r, g, b = _GRAY_WEIGHTS
        gray = (r * rgb[..., 0] + g * rgb[..., 1] + b * rgb[..., 2]) >> 15
        return gray.astype(np.uint8)[..., None]
    return img


def read_images(paths: Sequence[str], n_channels: int, n_threads: int
                ) -> List[np.ndarray]:
    """Every image decoded (zlib releases the GIL: a thread pool)."""
    with ThreadPoolExecutor(max(1, n_threads)) as pool:
        return list(pool.map(lambda p: read_image(p, n_channels), paths))


def _image_table(images: Sequence[np.ndarray]):
    """ctypes (pointers, shapes) for decoded images; the arrays must live
    until the C++ side has copied them."""
    ptrs = (_U8P * len(images))(*[a.ctypes.data_as(_U8P) for a in images])
    shapes = (ctypes.c_int * (3 * len(images)))(
        *[d for a in images for d in a.shape])
    return ptrs, shapes


def _contiguous(images):
    return [np.ascontiguousarray(a, np.uint8) for a in images]


def native_augment(patch: np.ndarray, mode: int) -> np.ndarray:
    """The native 8-mode augmentation table on an (ps, ps, C) uint8
    patch (for parity tests against utils_image.augment_img)."""
    lib = _load_lib()
    patch = np.ascontiguousarray(patch, np.uint8)
    ps, ps2, c = patch.shape
    if ps != ps2:
        raise ValueError(f"square patch expected, got {patch.shape}")
    out = np.empty_like(patch)
    lib.loader_augment(patch.ctypes.data_as(_U8P), ps, c, mode,
                       out.ctypes.data_as(_U8P))
    return out


def native_bicubic_downscale(img: np.ndarray, sf: int) -> np.ndarray:
    """MATLAB-bicubic downscale of an HWC uint8 image by 1/sf in C++ (for
    parity tests against utils.image.imresize_np)."""
    lib = _load_lib()
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    out = np.empty((-(-h // sf), -(-w // sf), c), np.float32)
    lib.bicubic_downscale_u8(img.ctypes.data_as(_U8P), h, w, c, sf,
                             out.ctypes.data_as(_F32P))
    return out


class NativePatchLoader:
    """RAM-cached native loader for AWGN denoising training batches."""

    def __init__(self, paths: Sequence[str], n_channels: int = 1,
                 n_threads: int = 8):
        lib = _load_lib()
        images = _contiguous(read_images(paths, n_channels, n_threads))
        ptrs, shapes = _image_table(images)
        self._handle = lib.loader_create(ptrs, shapes, len(images),
                                         n_channels, n_threads)
        if not self._handle:
            raise RuntimeError(f"native loader: {len(paths)} images, not all "
                               f"of them {n_channels}-channel")
        self._lib = lib
        self.n_channels = n_channels
        self.n_images = lib.loader_num_images(self._handle)

    def image_shape(self, idx: int) -> Tuple[int, int, int]:
        h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if self._lib.loader_image_shape(self._handle, idx, ctypes.byref(h),
                                        ctypes.byref(w), ctypes.byref(c)):
            raise IndexError(idx)
        return h.value, w.value, c.value

    def sample_awgn_batch(self, batch: int, patch_size: int, sigma: float,
                          seed: int):
        """→ dict(L, H) of float32 NHWC arrays (the dataset_dncnn train
        protocol, dataset_dncnn.py:44-75)."""
        shape = (batch, patch_size, patch_size, self.n_channels)
        out_l, out_h = np.empty(shape, np.float32), np.empty(shape, np.float32)
        if self._lib.loader_sample_awgn_batch(
                self._handle, batch, patch_size, float(sigma),
                ctypes.c_uint64(seed), out_l.ctypes.data_as(_F32P),
                out_h.ctypes.data_as(_F32P)):
            raise RuntimeError("patch size larger than an image in the cache")
        return {"L": out_l, "H": out_h}

    def sample_awgn_range_batch(self, batch: int, patch_size: int,
                                sigma_min: float, sigma_max: float,
                                seed: int):
        """→ (dict(L, H), levels (batch,) already /255) with a noise level
        a patch ~ U[sigma_min, sigma_max] (the fdncnn / ffdnet train
        degradation)."""
        shape = (batch, patch_size, patch_size, self.n_channels)
        out_l, out_h = np.empty(shape, np.float32), np.empty(shape, np.float32)
        levels = np.empty((batch,), np.float32)
        if self._lib.loader_sample_awgn_range_batch(
                self._handle, batch, patch_size, float(sigma_min),
                float(sigma_max), ctypes.c_uint64(seed),
                out_l.ctypes.data_as(_F32P), out_h.ctypes.data_as(_F32P),
                levels.ctypes.data_as(_F32P)):
            raise RuntimeError("patch size larger than an image in the cache")
        return {"L": out_l, "H": out_h}, levels

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.loader_destroy(self._handle)
            self._handle = None


class NativePairLoader:
    """RAM-cached native loader for paired-SR training batches: LR files,
    or the on-the-fly MATLAB-bicubic branch (dataset_sr.py:66: modcrop H,
    downscale once at cache build, then crop + shared-mode augment)."""

    def __init__(self, paths_l: Optional[Sequence[str]],
                 paths_h: Sequence[str], n_channels: int = 3,
                 n_threads: int = 8, bicubic_sf: Optional[int] = None):
        lib = _load_lib()
        images_h = _contiguous(read_images(paths_h, n_channels, n_threads))
        ptrs_h, shapes_h = _image_table(images_h)
        if bicubic_sf is not None:
            if paths_l is not None:
                raise ValueError("bicubic_sf synthesises L: give no L files")
            self._handle = lib.pair_loader_create_bicubic(
                ptrs_h, shapes_h, len(images_h), n_channels, int(bicubic_sf),
                n_threads)
        else:
            if paths_l is None or len(paths_l) != len(paths_h):
                raise ValueError("one L file for each H file")
            images_l = _contiguous(read_images(paths_l, n_channels,
                                               n_threads))
            ptrs_l, shapes_l = _image_table(images_l)
            self._handle = lib.pair_loader_create(
                ptrs_l, shapes_l, ptrs_h, shapes_h, len(images_h),
                n_channels, n_threads)
        if not self._handle:
            raise RuntimeError(f"native pair loader: {len(paths_h)} pairs, not "
                               f"all {n_channels}-channel (or H smaller than sf)")
        self._lib = lib
        self.n_channels = n_channels
        self.n_pairs = lib.pair_loader_num(self._handle)

    def sample_sr_batch(self, batch: int, l_patch: int, sf: int, seed: int):
        """→ dict(L, H) float32 NHWC; H is (l_patch·sf)² — aligned crops,
        one augment mode for both (datasets.py DatasetSR.get_example)."""
        c = self.n_channels
        out_l = np.empty((batch, l_patch, l_patch, c), np.float32)
        out_h = np.empty((batch, l_patch * sf, l_patch * sf, c), np.float32)
        if self._lib.pair_loader_sample_sr_batch(
                self._handle, batch, l_patch, sf, ctypes.c_uint64(seed),
                out_l.ctypes.data_as(_F32P), out_h.ctypes.data_as(_F32P)):
            raise RuntimeError("patch larger than an image, or an H file "
                               "smaller than sf x its L file")
        return {"L": out_l, "H": out_h}

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.pair_loader_destroy(self._handle)
            self._handle = None


NATIVE_TYPES = ("dncnn", "fdncnn", "ffdnet", "sr", "plain")


def native_refusal(ds_opt: dict) -> Optional[str]:
    """Why the native loader has no protocol for an option block (None:
    it has one)."""
    kind = (ds_opt.get("dataset_type") or "dncnn").lower()
    if kind not in NATIVE_TYPES:
        return f"no native protocol for dataset_type {kind!r}"
    if kind == "dncnn" and isinstance(ds_opt.get("sigma"), (list, tuple)):
        return "the native dncnn protocol takes a fixed sigma only"
    if kind == "plain" and not ds_opt.get("dataroot_L"):
        return "the native plain protocol needs dataroot_L"
    return None


class NativeEpochLoader:
    """The Python ``Loader``'s ``epoch()`` protocol with batches from the
    C++ thread pool (decode-once RAM cache, crop / augment / degrade off
    the GIL), seeds (seed + epoch) · 1,000,003 + batch, as the JAX class:

    * ``dncnn`` with a fixed sigma (dataset_dncnn.py:44-75);
    * ``fdncnn`` / ``ffdnet`` with sigma ~ U[min, max] and the noise-level
      map channel (FDnCNN) or scalar C (FFDNet) built batch-side;
    * ``sr`` / ``plain`` with LR files, or for ``sr`` without
      ``dataroot_L`` the on-the-fly MATLAB-bicubic branch.
    """

    def __init__(self, ds_opt: dict, batch_size: int, seed: int = 0):
        from kair_tpu_torch.utils import image as im

        why = native_refusal(ds_opt)
        if why:
            raise ValueError(why)

        def listing(root):
            return list(root) if isinstance(root, (list, tuple)) \
                else im.get_image_paths(root)

        kind = (ds_opt.get("dataset_type") or "dncnn").lower()
        threads = ds_opt.get("dataloader_num_workers") or 8
        self.batch_size = batch_size
        self.seed = seed
        if kind == "dncnn":
            self._native = NativePatchLoader(
                listing(ds_opt["dataroot_H"]),
                n_channels=ds_opt.get("n_channels") or 1, n_threads=threads)
            self.patch_size = ds_opt.get("H_size") or 64
            self.sigma = float(ds_opt.get("sigma") or 25)
            self.n_images = self._native.n_images
            self._sample = lambda s: self._native.sample_awgn_batch(
                self.batch_size, self.patch_size, self.sigma, seed=s)
        elif kind in ("fdncnn", "ffdnet"):
            sigma = ds_opt.get("sigma") or [0, 75]
            if not isinstance(sigma, (list, tuple)):
                sigma = [sigma, sigma]
            smin, smax = float(sigma[0]), float(sigma[1])
            self._native = NativePatchLoader(
                listing(ds_opt["dataroot_H"]),
                n_channels=ds_opt.get("n_channels") or 3, n_threads=threads)
            self.patch_size = ds_opt.get("H_size") or 64
            self.n_images = self._native.n_images

            def sample(s):
                b, levels = self._native.sample_awgn_range_batch(
                    self.batch_size, self.patch_size, smin, smax, seed=s)
                if kind == "ffdnet":     # scalar C (b,1,1,1): datasets.py:133
                    b["C"] = levels.reshape(-1, 1, 1, 1)
                else:                    # map channel in L: datasets.py:96-97
                    m = np.broadcast_to(levels[:, None, None, None],
                                        b["L"].shape[:3] + (1,))
                    b["L"] = np.concatenate([b["L"], m.astype(np.float32)],
                                            axis=-1)
                return b

            self._sample = sample
        else:
            paths_h = listing(ds_opt["dataroot_H"])
            self.sf = (ds_opt.get("scale") or 4) if kind == "sr" else 1
            self.patch_size = ds_opt.get("H_size") or (96 if kind == "sr"
                                                       else 64)
            if self.patch_size % self.sf:
                raise ValueError(f"H_size {self.patch_size} not divisible "
                                 f"by scale {self.sf}")
            l_patch = self.patch_size // self.sf
            n_channels = ds_opt.get("n_channels") or 3
            if ds_opt.get("dataroot_L"):
                self._native = NativePairLoader(
                    listing(ds_opt["dataroot_L"]), paths_h,
                    n_channels=n_channels, n_threads=threads)
            else:                        # on-the-fly MATLAB bicubic
                self._native = NativePairLoader(
                    None, paths_h, n_channels=n_channels, n_threads=threads,
                    bicubic_sf=self.sf)
            self.n_images = self._native.n_pairs
            self._sample = lambda s: self._native.sample_sr_batch(
                self.batch_size, l_patch, self.sf, seed=s)

    def __len__(self) -> int:
        return max(1, self.n_images // self.batch_size)

    def epoch(self, epoch: int = 0):
        for i in range(len(self)):
            yield self._sample((self.seed + epoch) * 1_000_003 + i)
