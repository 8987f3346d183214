"""The port's evaluation modes, image utilities and JPEG dataset on the
CPU, against the JAX package's (pure numpy) functions and against the
reference goldens in tests/fixtures/image_golden.npz
(tests/make_fixtures_image.py); the tolerances are those of
tests/test_image.py, or exact where both sides run the same numpy."""

import numpy as np
import pytest
import torch

from kair_tpu.eval import test_modes as jtm
from kair_tpu.utils import image as jim
from kair_tpu_torch.eval import test_modes as tm
from kair_tpu_torch.utils import image as im
from tests.conftest import FIXTURES

G = np.load(FIXTURES / "image_golden.npz")


def _fn(sf):
    """A deterministic NHWC 'model' with a receptive field: a 3-tap blur
    along W, then a scale-``sf`` nearest upsample."""
    def fn(a):
        b = 0.5 * a + 0.25 * (np.roll(a, 1, 2) + np.roll(a, -1, 2)) + 0.1
        return np.repeat(np.repeat(b, sf, 1), sf, 2)
    return fn


@pytest.mark.parametrize("mode", range(5))
@pytest.mark.parametrize("sf", [1, 4])
def test_test_mode_matches_jax(mode, sf):
    L = np.random.RandomState(mode).rand(1, 70, 90, 3).astype(np.float32)
    kw = dict(mode=mode, refield=8, min_size=32, sf=sf, modulo=8)
    np.testing.assert_array_equal(tm.test_mode(_fn(sf), L, **kw),
                                  jtm.test_mode(_fn(sf), L, **kw))


@pytest.mark.parametrize("tile,overlap", [(32, 8), (48, 16), (200, 0)])
def test_tile_overlap_matches_jax(tile, overlap):
    L = np.random.RandomState(tile).rand(2, 56, 72, 3).astype(np.float32)
    np.testing.assert_allclose(tm.tile_overlap(_fn(2), L, tile, overlap, 2),
                               jtm.tile_overlap(_fn(2), L, tile, overlap, 2),
                               atol=1e-7)


@pytest.mark.parametrize("name,scale,aa", [
    ("resize_s025", 0.25, True), ("resize_s05", 0.5, True),
    ("resize_s033", 1.0 / 3.0, True), ("resize_s2", 2.0, True),
    ("resize_s17", 1.7, True), ("resize_s4", 4.0, True),
    ("resize_noaa", 0.5, False)])
def test_imresize_matches_golden(name, scale, aa):
    want = G[name]
    np.testing.assert_allclose(im.imresize_np(G["img_f"], scale, aa), want,
                               atol=1e-5)
    x = torch.from_numpy(G["img_f"].astype(np.float32))[None]
    got = im.imresize_nhwc(x, scale, aa)[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_metrics_match_golden():
    u3, u3b, u1, u1b = G["img_u3"], G["img_u3b"], G["img_u1"], G["img_u1b"]
    assert abs(im.calculate_psnr(u3, u3b) - float(G["psnr_u3"])) < 1e-10
    assert abs(im.calculate_psnr(u3, u3b, border=4) - float(G["psnr_u3_b4"])) < 1e-10
    assert abs(im.calculate_ssim(u3, u3b) - float(G["ssim_u3"])) < 1e-8
    assert abs(im.calculate_ssim(u1, u1b) - float(G["ssim_u1"])) < 1e-8
    assert abs(im.calculate_psnrb(u1, u1b) - float(G["psnrb_u1"])) < 1e-6
    assert abs(im.calculate_psnrb(u3, u3b) - float(G["psnrb_u3"])) < 1e-6
    for border in (0, 3):
        assert im.calculate_psnrb(u3, u3b, border) == jim.calculate_psnrb(u3, u3b, border)


@pytest.mark.parametrize("mode", range(8))
def test_augment_matches_golden(mode):
    np.testing.assert_array_equal(im.augment_img(G["img_f"], mode), G[f"aug_{mode}"])
    x = torch.from_numpy(G["img_f"])[None]
    np.testing.assert_array_equal(im.augment_nhwc(x, mode)[0].numpy(),
                                  G[f"aug_{mode}"])
    back = im.augment_img(G[f"aug_{mode}"], im.inverse_augment_mode(mode))
    np.testing.assert_array_equal(back, G["img_f"])
    assert im.inverse_augment_mode(mode) == jim.inverse_augment_mode(mode)


def test_color_conversions_match_golden_and_jax():
    u3, f = G["img_u3"], G["img_f"].astype(np.float32)
    np.testing.assert_array_equal(im.rgb2ycbcr(u3, only_y=True), G["ycbcr_y_u3"])
    np.testing.assert_allclose(im.rgb2ycbcr(f.copy(), only_y=False),
                               G["ycbcr_full_f"], atol=1e-6)
    np.testing.assert_array_equal(im.bgr2ycbcr(u3, only_y=True), G["bgr_y_u3"])
    for a in (u3, f):
        np.testing.assert_array_equal(im.bgr2ycbcr(a, only_y=False),
                                      jim.bgr2ycbcr(a, only_y=False))
        np.testing.assert_array_equal(im.ycbcr2rgb(im.rgb2ycbcr(a, False)),
                                      jim.ycbcr2rgb(jim.rgb2ycbcr(a, False)))


def test_crops_patches_and_uint16_match_jax():
    big = np.random.RandomState(0).rand(900, 1000, 3).astype(np.float32)
    got = im.patches_from_image(big, 512, 64, 800)
    want = jim.patches_from_image(big, 512, 64, 800)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert len(im.patches_from_image(big[:700])) == 1
    np.testing.assert_array_equal(im.shave(big, 5), jim.shave(big, 5))
    u16 = (np.random.RandomState(1).rand(9, 7, 3) * 65535).astype(np.uint16)
    np.testing.assert_array_equal(im.uint162single(u16), jim.uint162single(u16))
    np.testing.assert_array_equal(im.single2uint16(im.uint162single(u16)), u16)


@pytest.fixture
def jpeg_root(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(11)
    yy, xx = np.mgrid[0:150, 0:170] / 40.0
    for i in range(4):
        img = np.stack([np.sin(yy * (i + 1) + c) + np.cos(xx * (c + 1))
                        for c in range(3)], -1)
        img = (img - img.min()) / np.ptp(img) * 200 + rng.rand(150, 170, 3) * 50
        cv2.imwrite(str(tmp_path / f"im{i}.png"), img.astype(np.uint8))
    return str(tmp_path)


@pytest.mark.parametrize("phase,color", [("train", False), ("train", True),
                                         ("test", False), ("test", True)])
def test_dataset_jpeg_matches_jax_batch_for_batch(jpeg_root, phase, color):
    from kair_tpu.data.base import Loader as JLoader
    from kair_tpu.data.dataset_jpeg import DatasetJPEG as JDatasetJPEG
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.data.datasets import define_dataset

    opt = {"dataset_type": "jpeg", "dataroot_H": jpeg_root, "H_size": 64,
           "quality_factor": 20, "is_color": color, "phase": phase}
    ds, jds = define_dataset(dict(opt)), JDatasetJPEG(dict(opt))
    assert type(ds).__name__ == "DatasetJPEG" and len(ds) == len(jds) == 4
    bs = 2 if phase == "train" else 1
    for epoch in range(2):
        got = list(Loader(ds, bs, shuffle=phase == "train", seed=3).epoch(epoch))
        want = list(JLoader(jds, bs, shuffle=phase == "train", seed=3).epoch(epoch))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["L"].shape[-1] == (3 if color else 1)
            for k in ("L", "H"):
                np.testing.assert_array_equal(g[k], w[k])
            assert g["H_path"] == w["H_path"]
