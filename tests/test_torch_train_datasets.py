"""The port's training datasets against the JAX package's, batch for batch.

* Every dataset type of the zoo's and SwinIR's training recipes (dncnn,
  fdncnn, ffdnet, plain, l, dnpatch, plainpatch, srmd, dpsr, usrnet,
  blindsr) through the port's ``Loader`` and the JAX ``Loader`` with one
  seed, over two epochs: gray and color, train and test phases, σ fixed
  and ranged. Arrays are equal exactly; USRNet's blur kernels within 1e-6
  of their max, since the port resizes a quarter of its motion kernels in
  numpy where the JAX function calls cv2.
* USRNet draws one scale factor a batch (the JAX dataset draws one per
  item, ROADMAP Queue 3): its batches are compared with the JAX dataset's
  items driven by hand with the batch's scale factor patched in.
* ``degrade/deblur.resize_linear`` against ``cv2.resize(INTER_LINEAR)``,
  up and down, within 1e-6 of the kernel's max; ``blurkernel_synthesis``,
  ``psf2otf`` and the BSRGAN degradations against the JAX functions.
* The Loader hands a worker's exception to the consumer within 2 s.
"""

import os
import threading
import time
import types

import cv2
import numpy as np
import pytest

from kair_tpu.data import base as jbase
from kair_tpu.data import dataset_usrnet as jdu
from kair_tpu.data import datasets as jdatasets
from kair_tpu.degrade import blindsr as jblindsr
from kair_tpu.degrade import deblur as jdeblur
from kair_tpu_torch.data import base, datasets
from kair_tpu_torch.data.dataset_usrnet import DatasetUSRNet
from kair_tpu_torch.degrade import blindsr, deblur

SEED = 3
EPOCHS = 2
BATCH = 2


def _write_images(root, n, size, channels, seed):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
        img = cv2.GaussianBlur(img, (0, 0), 1.5)
        if channels == 1:
            img = img[..., 0]
        cv2.imwrite(os.path.join(root, f"im{i}.png"), img)
    return root


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Six 48x48 images in color and in gray, and a second color set as
    the L images of the paired types."""
    base_dir = tmp_path_factory.mktemp("trainsets")
    return {"color": _write_images(str(base_dir / "color"), 6, 48, 3, 0),
            "gray": _write_images(str(base_dir / "gray"), 6, 48, 1, 1),
            "L": _write_images(str(base_dir / "L"), 6, 48, 3, 2)}


def _assert_batches_equal(got, want, atol_rel=None):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, k
            if atol_rel and k in atol_rel:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=atol_rel[k] * np.abs(w).max(),
                    err_msg=k)
            else:
                np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert list(g) == list(w), k


def _both(opt):
    return datasets.define_dataset(dict(opt)), jdatasets.define_dataset(dict(opt))


def _compare_loaders(opt, shuffle=True):
    mine, ref = _both(opt)
    assert type(mine).__name__ == type(ref).__name__
    n = 0
    for epoch in range(EPOCHS):
        got = list(base.Loader(mine, BATCH, shuffle=shuffle, seed=SEED)
                   .epoch(epoch))
        want = list(jbase.Loader(ref, BATCH, shuffle=shuffle, seed=SEED)
                    .epoch(epoch))
        assert len(got) == len(want) == len(mine) // BATCH
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)
            n += 1
    return n


# (type, option keys, image folder) for every type but usrnet
CASES = {
    "dncnn-gray-train": ("dncnn", {"H_size": 24, "sigma": 25,
                                   "n_channels": 1}, "gray"),
    "dncnn-color-test": ("dncnn", {"sigma": 15, "sigma_test": 15,
                                   "phase": "test"}, "color"),
    "fdncnn-gray-train-ranged": ("fdncnn", {"H_size": 24, "sigma": [0, 75],
                                            "n_channels": 1}, "gray"),
    "fdncnn-color-test": ("fdncnn", {"sigma_test": 25, "phase": "test"},
                          "color"),
    "ffdnet-color-train-ranged": ("ffdnet", {"H_size": 32,
                                             "sigma": [0, 75]}, "color"),
    "ffdnet-gray-train-fixed": ("ffdnet", {"H_size": 32, "sigma": [15, 15],
                                           "n_channels": 1}, "gray"),
    "ffdnet-gray-test": ("ffdnet", {"sigma_test": 50, "phase": "test",
                                    "n_channels": 1}, "gray"),
    "plain-color-train": ("plain", {"H_size": 24, "dataroot_L": "L"},
                          "color"),
    "plain-color-test": ("plain", {"phase": "test", "dataroot_L": "L"},
                         "color"),
    "l-gray": ("l", {"n_channels": 1, "dataroot_L": "gray"}, None),
    "dnpatch-gray": ("dnpatch", {"H_size": 16, "num_patches_per_image": 3,
                                 "seed": 5}, "gray"),
    "dnpatch-color": ("dnpatch", {"H_size": 16, "num_patches_per_image": 2,
                                  "n_channels": 3, "sigma": 50}, "color"),
    "plainpatch-color": ("plainpatch", {"H_size": 16, "dataroot_L": "L",
                                        "num_patches_per_image": 2,
                                        "seed": 7}, "color"),
    "srmd-color-train": ("srmd", {"scale": 2, "H_size": 24,
                                  "sigma": [0, 50]}, "color"),
    "srmd-gray-test": ("srmd", {"scale": 3, "n_channels": 1,
                                "sigma_test": 0.02, "phase": "test"}, "gray"),
    "dpsr-color-train": ("dpsr", {"scale": 4, "H_size": 32,
                                  "sigma": [0, 50]}, "color"),
    "dpsr-color-test": ("dpsr", {"scale": 2, "phase": "test"}, "color"),
    "blindsr-bsrgan-x4": ("blindsr", {"scale": 4, "lq_patchsize": 8},
                          "color"),
    "blindsr-bsrgan-plus-x2": ("blindsr", {"scale": 2, "lq_patchsize": 12,
                                           "degradation_type": "bsrgan_plus",
                                           "shuffle_prob": 0.5,
                                           "use_sharp": True}, "color"),
    "blindsr-test": ("blindsr", {"scale": 4, "phase": "test"}, "color"),
}


def _options(name, folders):
    t, opt, folder = CASES[name]
    opt = {**opt, "dataset_type": t}
    if folder:
        opt["dataroot_H"] = folders[folder]
    if "dataroot_L" in opt:
        opt["dataroot_L"] = folders[opt["dataroot_L"]]
    return opt


@pytest.mark.parametrize("name", list(CASES))
def test_batches_equal_the_jax_datasets(folders, name):
    opt = _options(name, folders)
    assert _compare_loaders(opt) >= 2 * EPOCHS


class _PatchedDraws:
    """The epoch Generator as the JAX USRNet dataset sees it: its per-item
    draw of a scale-factor seed (``rng.integers(0, 2**31)``) takes nothing
    from the stream, so the draws after it are the port's."""

    def __init__(self, rng):
        self._rng = rng

    def integers(self, low, high=None, *a, **k):
        if (low, high) == (0, 2 ** 31):
            return 0
        return self._rng.integers(low, high, *a, **k)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def _jax_usrnet_batches(jds, scales, epoch, monkeypatch):
    """The JAX dataset's items in the port Loader's order, each batch's
    scale factor drawn as the port's ``begin_batch`` draws it and patched
    into the JAX dataset's per-item choice."""
    rng = np.random.default_rng(SEED + epoch)
    order = np.arange(len(jds))
    rng.shuffle(order)
    for b in range(len(jds) // BATCH):
        sf = int(rng.choice(scales))
        shim = types.SimpleNamespace(default_rng=lambda _seed, sf=sf:
                                     types.SimpleNamespace(
                                         choice=lambda _s, sf=sf: sf))
        numpy_shim = types.SimpleNamespace(**{k: getattr(np, k)
                                              for k in dir(np)
                                              if not k.startswith("__")})
        numpy_shim.random = shim
        monkeypatch.setattr(jdu, "np", numpy_shim)
        items = [jds.get_example(int(i), _PatchedDraws(rng))
                 for i in order[b * BATCH:(b + 1) * BATCH]]
        monkeypatch.setattr(jdu, "np", np)
        yield sf, jbase.collate(items)


@pytest.mark.parametrize("channels", [3, 1], ids=["color", "gray"])
def test_usrnet_one_scale_a_batch_and_jax_items(folders, channels,
                                                monkeypatch):
    scales = [1, 2, 3, 4]
    opt = {"dataset_type": "usrnet", "H_size": 24, "scales": scales,
           "n_channels": channels,
           "dataroot_H": folders["color" if channels == 3 else "gray"]}
    mine, ref = _both(opt)
    seen = set()
    for epoch in range(3):
        got = list(base.Loader(mine, BATCH, seed=SEED).epoch(epoch))
        want = list(_jax_usrnet_batches(ref, scales, epoch, monkeypatch))
        assert len(got) == len(want) == 3
        for g, (sf, w) in zip(got, want):
            assert g["sf"] == [sf] * BATCH
            assert g["L"].shape[1] == -(-24 // sf)
            _assert_batches_equal(g, w, atol_rel={"k": 1e-6})
            seen.add(sf)
    assert len(seen) >= 2, seen


def test_usrnet_test_phase_equals_jax(folders):
    opt = {"dataset_type": "usrnet", "phase": "test", "sf_validation": 3,
           "dataroot_H": folders["color"]}
    assert _compare_loaders(opt, shuffle=False) == EPOCHS * 6 // BATCH


def test_usrnet_needs_a_batch_scale(folders):
    ds = DatasetUSRNet({"dataroot_H": folders["color"], "H_size": 24})
    with pytest.raises(ValueError, match="begin_batch"):
        ds.get_example(0, np.random.default_rng(0))
    ds.begin_batch(np.random.default_rng(0))
    assert ds.get_example(0, np.random.default_rng(0))["sf"] == ds.sf


def test_define_dataset_builds_the_new_types(folders):
    for t, cls in (("dnpatch", "DatasetDnPatch"),
                   ("plainpatch", "DatasetPlainPatch"),
                   ("srmd", "DatasetSRMD"), ("dpsr", "DatasetDPSR"),
                   ("usrnet", "DatasetUSRNet"), ("blindsr", "DatasetBlindSR")):
        ds = datasets.define_dataset({"dataset_type": t,
                                      "dataroot_H": folders["color"],
                                      "dataroot_L": folders["L"],
                                      "num_patches_per_image": 1})
        assert type(ds).__name__ == cls
    for t, cls in (("video_train_vimeo", "VideoRecurrentTrainVimeoDataset"),
                   ("vfi_davis", "VFI_DAVIS")):
        assert datasets.dataset_class({"dataset_type": t}).__name__ == cls
    for t in ("spect", "spectpatch"):
        with pytest.raises(NotImplementedError, match="slice"):
            datasets.define_dataset({"dataset_type": t})


def test_datasets_read_only_through_the_hooks():
    """A subclass that serves images from memory needs no file: every type
    reads through ``image_paths`` / ``read_uint``."""
    img = np.random.RandomState(0).randint(0, 256, (40, 40, 3), np.uint8)

    def served(cls):
        class Served(cls):
            def image_paths(self, root):
                return [f"{root}/a.png", f"{root}/b.png"]

            def read_uint(self, path):
                return img[..., :self.n_channels].copy()
        return Served

    from kair_tpu_torch.data import (dataset_patch, dataset_srmd,
                                     dataset_usrnet)
    for cls, opt in ((datasets.DatasetDnCNN, {"H_size": 16}),
                     (datasets.DatasetFDnCNN, {"H_size": 16}),
                     (datasets.DatasetFFDNet, {"H_size": 16}),
                     (datasets.DatasetSR, {"H_size": 16, "scale": 2}),
                     (datasets.DatasetPlain, {"H_size": 16, "dataroot_L": "m"}),
                     (datasets.DatasetL, {"dataroot_L": "m"}),
                     (dataset_patch.DatasetDnPatch, {"H_size": 16}),
                     (dataset_patch.DatasetPlainPatch,
                      {"H_size": 16, "dataroot_L": "m"}),
                     (dataset_srmd.DatasetSRMD, {"H_size": 16, "scale": 2}),
                     (dataset_srmd.DatasetDPSR, {"H_size": 16, "scale": 2}),
                     (dataset_usrnet.DatasetUSRNet, {"H_size": 16})):
        ds = served(cls)({"dataroot_H": "mem", **opt})
        batch = next(base.Loader(ds, 2, seed=0).epoch(0))
        assert batch["L"].shape[0] == 2 and np.isfinite(batch["L"]).all()


@pytest.mark.parametrize("shape,size", [
    ((25, 25), (61, 90)), ((17, 23), (17, 23)), ((25, 25), (13, 7)),
    ((9, 31), (18, 124)), ((30, 30), (15, 15))],
    ids=["up", "same", "down", "up-odd", "half"])
def test_resize_linear_equals_cv2(shape, size):
    k = np.random.default_rng(sum(shape)).random(shape)
    want = cv2.resize(k, size, interpolation=cv2.INTER_LINEAR)
    got = deblur.resize_linear(k, size)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(k).max())


def test_blur_kernels_equal_the_jax_functions(monkeypatch):
    """Over 40 seeds, of which the resized kernels (a quarter) go through
    ``resize_linear`` where the JAX function calls cv2: the motion kernels,
    the Gaussians and psf2otf."""
    calls = []
    resize = deblur.resize_linear
    monkeypatch.setattr(deblur, "resize_linear",
                        lambda *a: calls.append(1) or resize(*a))
    for seed in range(40):
        got = deblur.blurkernel_synthesis(25, rng=np.random.default_rng(seed))
        want = jdeblur.blurkernel_synthesis(25, rng=np.random.default_rng(seed))
        assert got.shape == want.shape == (25, 25)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert 4 <= len(calls) <= 20, len(calls)
    np.testing.assert_array_equal(deblur.fspecial_gauss(7, 1.3),
                                  jdeblur.fspecial_gauss(7, 1.3))
    psf = deblur.fspecial_gauss(5, 1.0)
    np.testing.assert_array_equal(deblur.psf2otf(psf, (16, 12)),
                                  jdeblur.psf2otf(psf, (16, 12)))


@pytest.mark.parametrize("fn", ["degradation_bsrgan",
                                "degradation_bsrgan_plus"])
def test_bsrgan_degradations_equal_jax(fn):
    img = np.random.RandomState(4).rand(48, 48, 3).astype(np.float32)
    img = cv2.GaussianBlur(img, (0, 0), 1.0)
    for seed in range(4):
        kw = {"sf": 4, "lq_patchsize": 8} if fn == "degradation_bsrgan" else \
            {"sf": 2, "lq_patchsize": 12, "shuffle_prob": 0.5, "use_sharp": True}
        got = getattr(blindsr, fn)(img, rng=np.random.default_rng(seed), **kw)
        want = getattr(jblindsr, fn)(img, rng=np.random.default_rng(seed), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


class _RaisesAtFive(base.Dataset):
    def __len__(self):
        return 12

    def get_example(self, index, rng):
        if self.calls == 5:
            raise KeyError("item five is broken")
        self.calls += 1
        return {"L": np.zeros((2, 2, 1), np.float32)}

    calls = 0


def test_loader_reraises_a_worker_error_within_2s():
    threads = threading.active_count()
    got, t0 = [], time.perf_counter()
    with pytest.raises(KeyError, match="item five is broken") as info:
        for batch in base.Loader(_RaisesAtFive(), 2, shuffle=False).epoch(0):
            got.append(batch)
    assert time.perf_counter() - t0 < 2.0
    assert len(got) == 2                      # items 0-3; 4 and 5 fail
    # the traceback reaches into the producer's call of get_example
    assert any(e.name == "get_example" for e in info.traceback)
    deadline = time.perf_counter() + 2.0      # and the producer has ended
    while threading.active_count() > threads and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == threads
