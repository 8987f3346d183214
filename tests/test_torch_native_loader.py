"""The port's native loader (``kair_tpu_torch/data/native_loader.py`` on its
own copy of the C++ source) against the JAX ``NativeEpochLoader``, built
from the JAX package's source into this test's folder: the same batches,
bit for bit, from the same seed and files — ``dncnn`` (RGB PNG and JPEG
files read as gray), ``fdncnn`` and ``ffdnet`` (sigma ranges, the map
channel and scalar C), ``sr`` with LR files and on the fly (against
``imresize_np`` too); the 8-mode augment table; the too-large patch; and
``make_train_loader``'s choice: the native loader where asked, the Python
loader with a log line for another dataset type, and a raise, with no
fallback, when the build fails. No wall-time comparison: the JAX
package's ``test_native_throughput_beats_python`` fails under the full
suite's load and passes alone."""

import subprocess

import cv2
import numpy as np
import pytest

import kair_tpu.data.native_loader as jnl
from kair_tpu_torch.data import native_loader as tnl
from kair_tpu_torch.utils import image as tim


@pytest.fixture(scope="module", autouse=True)
def jax_library(tmp_path_factory):
    """The JAX binding's library built from its source here, so that no
    file under kair_tpu/ is written (the JAX binding builds beside its
    source)."""
    so = tmp_path_factory.mktemp("jaxlib") / "libpatch_loader.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread",
                    "-shared", "-o", str(so),
                    str(jnl._CPP_DIR) + "/patch_loader.cpp", "-lpng",
                    "-ljpeg"], check=True, capture_output=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnl, "_SO_PATH", str(so))
    mp.setattr(jnl, "_lib", None)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def img_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    paths = []
    for i, ext in enumerate(["png", "png", "jpg"]):
        img = (rng.rand(96, 112, 3) * 255).astype(np.uint8)
        p = str(root / f"im{i}.{ext}")
        cv2.imwrite(p, img)
        paths.append(p)
    gray = str(root / "gray.png")
    cv2.imwrite(gray, (rng.rand(80, 90) * 255).astype(np.uint8))
    return paths + [gray]


@pytest.fixture(scope="module")
def sr_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("sr")
    rng = np.random.RandomState(1)
    ls, hs = [], []
    for i in range(2):
        h = (rng.rand(64, 80, 3) * 255).astype(np.uint8)
        ph, pl = str(root / f"h{i}.png"), str(root / f"l{i}.png")
        cv2.imwrite(ph, h)
        cv2.imwrite(pl, h[::2, ::2])
        ls.append(pl)
        hs.append(ph)
    return ls, hs


def _same_batches(ds_opt, batch, seed=7, epochs=(0, 1)):
    jl = jnl.NativeEpochLoader(dict(ds_opt), batch, seed=seed)
    tl = tnl.NativeEpochLoader(dict(ds_opt), batch, seed=seed)
    assert len(jl) == len(tl) and jl.n_images == tl.n_images
    for e in epochs:
        for a, b in zip(jl.epoch(e), tl.epoch(e)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return next(iter(tl.epoch(0)))


@pytest.mark.parametrize("kind,channels,sigma", [
    ("dncnn", 1, 25), ("dncnn", 3, 15), ("fdncnn", 1, [10, 50]),
    ("ffdnet", 3, [0, 75])])
def test_denoising_batches_equal_the_jax_loader(img_files, kind, channels,
                                                sigma):
    b = _same_batches({"dataset_type": kind, "dataroot_H": img_files,
                       "n_channels": channels, "H_size": 32, "sigma": sigma,
                       "dataloader_num_workers": 3}, 4)
    extra = 1 if kind == "fdncnn" else 0
    assert b["L"].shape == (4, 32, 32, channels + extra)
    if kind == "ffdnet":
        assert b["C"].shape == (4, 1, 1, 1)


def test_sr_batches_with_lr_files_equal_the_jax_loader(sr_files):
    ls, hs = sr_files
    b = _same_batches({"dataset_type": "sr", "dataroot_H": hs,
                       "dataroot_L": ls, "scale": 2, "H_size": 32,
                       "n_channels": 3, "dataloader_num_workers": 2}, 6)
    assert b["L"].shape == (6, 16, 16, 3) and b["H"].shape == (6, 32, 32, 3)


def test_sr_on_the_fly_equals_the_jax_loader_and_imresize_np(tmp_path):
    sf, lp = 4, 12
    rng = np.random.RandomState(3)
    src = (rng.rand(lp * sf + 2, lp * sf + 3, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "h.png")
    cv2.imwrite(p, src[:, :, ::-1])
    b = _same_batches({"dataset_type": "sr", "dataroot_H": [p],
                       "dataroot_L": None, "scale": sf, "H_size": lp * sf,
                       "n_channels": 3, "dataloader_num_workers": 2}, 4)
    h_mod = tim.modcrop(src, sf)
    l_full = tim.imresize_np(tim.uint2single(h_mod), 1 / sf, True)
    for i in range(4):
        assert any(np.allclose(b["L"][i], tim.augment_img(l_full, m),
                               atol=1e-5) for m in range(8)), i
    for sf, (h, w) in [(2, (40, 56)), (3, (39, 45)), (4, (37, 52))]:
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        got = tnl.native_bicubic_downscale(img, sf)
        np.testing.assert_array_equal(got, jnl.native_bicubic_downscale(img, sf))
        np.testing.assert_allclose(got, tim.imresize_np(
            tim.uint2single(img), 1 / sf, True), rtol=1e-5, atol=1e-5)


def test_the_augment_table_equals_the_jax_one_and_augment_img():
    patch = np.random.RandomState(3).randint(0, 256, (16, 16, 3), np.uint8)
    for mode in range(8):
        got = tnl.native_augment(patch, mode)
        np.testing.assert_array_equal(got, jnl.native_augment(patch, mode))
        np.testing.assert_array_equal(got, tim.augment_img(patch, mode))


def test_decoding_equals_libpngs(img_files):
    """The cache the port fills equals the one libpng and libjpeg fill:
    every image's shape, and a crop at sigma 0 is a crop of the decode."""
    for c in (1, 3):
        jl = jnl.NativePatchLoader(img_files, n_channels=c, n_threads=2)
        tl = tnl.NativePatchLoader(img_files, n_channels=c, n_threads=2)
        for i in range(len(img_files)):
            assert tl.image_shape(i) == jl.image_shape(i)
        np.testing.assert_array_equal(
            tl.sample_awgn_batch(8, 64, 0.0, seed=5)["H"],
            jl.sample_awgn_batch(8, 64, 0.0, seed=5)["H"])


def test_a_patch_larger_than_an_image_raises(img_files):
    loader = tnl.NativePatchLoader(img_files, n_channels=1)
    with pytest.raises(RuntimeError, match="larger"):
        loader.sample_awgn_batch(2, 512, sigma=25.0, seed=0)


def test_make_train_loader_takes_the_native_loader(img_files):
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.data.datasets import make_train_loader
    said = []
    ds = {"dataset_type": "dncnn", "dataroot_H": img_files[0].rsplit("/", 1)[0],
          "n_channels": 1, "H_size": 32, "sigma": 25,
          "use_native_loader": True, "dataloader_num_workers": 2}
    ld = make_train_loader(ds, 2, seed=1, info=said.append)
    assert isinstance(ld, tnl.NativeEpochLoader)
    assert "native C++ loader" in said[-1]
    ld = make_train_loader(dict(ds, sigma=[0, 50]), 2, info=said.append)
    assert isinstance(ld, Loader)
    assert said[-2] == ("native loader: the native dncnn protocol takes a "
                        "fixed sigma only; using the python loader")


def test_a_failed_build_raises_with_no_fallback(img_files, tmp_path,
                                                monkeypatch):
    from kair_tpu_torch.data.datasets import make_train_loader
    broken = tmp_path / "patch_loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnl, "SOURCE", broken)
    monkeypatch.setattr(tnl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnl, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native loader"):
        make_train_loader({"dataset_type": "dncnn", "dataroot_H": img_files,
                           "n_channels": 1, "H_size": 32, "sigma": 25,
                           "use_native_loader": True}, 2)
