"""The SPECT slice's numerics and data against the JAX package, on the CPU.

* ``utils/spect`` against ``kair_tpu.utils.spect``: the three
  normalisations both ways, the Poisson log-likelihood, both inverse
  Anscombes (rtol 1e-12: the same numpy expressions in float64, reordered),
  and ``binomial_thin`` equal under the same Generator.
* The ``poisson`` loss and its gradient against
  ``kair_tpu.train.losses.poisson_ll_loss`` and ``jax.grad`` (float32, rtol
  1e-5), for each normalisation and through ``get_loss_fn``'s option keys.
* ``spect`` and ``spectpatch`` examples equal exactly to the JAX datasets'
  for the same seeds, on written ``.dat`` files; the Loader's batches too.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.data import base as jbase
from kair_tpu.data import dataset_spect as jds
from kair_tpu.train import losses as jlosses
from kair_tpu.utils import spect as jspect
from kair_tpu_torch.data import base, dataset_spect, datasets
from kair_tpu_torch.train import losses
from kair_tpu_torch.utils import spect

METHODS = ("log", "anscombe", "linear")


def _counts(seed, shape=(2, 64, 32, 2), lam=40.0):
    return np.random.default_rng(seed).poisson(lam, shape).astype(np.float64)


@pytest.mark.parametrize("method", METHODS)
def test_normalize_both_ways_match_jax(method):
    k = _counts(0)
    for mp in (150, 255.0):
        a = spect.normalize_spect(k, method, mp)
        np.testing.assert_allclose(a, jspect.normalize_spect(k, method, mp),
                                   rtol=1e-12)
        np.testing.assert_allclose(spect.denormalize_spect(a, method, mp),
                                   jspect.denormalize_spect(a, method, mp),
                                   rtol=1e-12)
        np.testing.assert_allclose(spect.denormalize_spect(a, method, mp), k,
                                   rtol=1e-9, atol=1e-9)
    # the default is "log", as in the JAX package
    np.testing.assert_array_equal(spect.normalize_spect(k),
                                  jspect.normalize_spect(k, "log"))
    with pytest.raises(ValueError, match="Unknown"):
        spect.normalize_spect(k, "sqrt")


def test_likelihood_anscombe_and_thinning_match_jax():
    k, lam = _counts(1), _counts(2) + np.random.default_rng(3).random()
    lam[0, 0, 0, 0] = -1.0       # clipped to epsilon
    for eps in (1e-9, 1e-3):
        assert spect.poisson_log_likelihood(lam, k, eps) == pytest.approx(
            jspect.poisson_log_likelihood(lam, k, eps), rel=1e-12)
    y = spect.anscombe(k)
    np.testing.assert_allclose(y, jspect.anscombe(k), rtol=1e-12)
    for unbiased in (True, False):
        np.testing.assert_allclose(spect.inverse_anscombe(y, unbiased),
                                   jspect.inverse_anscombe(y, unbiased),
                                   rtol=1e-12)
    for frac in (0.125, 0.5, 1.0):
        got = spect.binomial_thin(k, frac, np.random.default_rng(7))
        want = jspect.binomial_thin(k, frac, np.random.default_rng(7))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="dose_fraction"):
        spect.binomial_thin(k, 1.5, np.random.default_rng(0))


@pytest.mark.parametrize("method", METHODS)
def test_poisson_loss_and_gradient_match_jax(method):
    rng = np.random.default_rng(5)
    target = spect.normalize_spect(_counts(6), method).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.05, target.shape), 0.01,
                   None).astype(np.float32)
    # counts below epsilon under log and linear (clipped: no gradient);
    # anscombe squares it back to positive counts
    pred[0, 0, 0, 0] = -0.5
    kw = dict(normalization_method=method, max_pixel=150.0, epsilon=1e-9)
    p = torch.from_numpy(pred).requires_grad_(True)
    got = losses.poisson_ll_loss(p, torch.from_numpy(target), **kw)
    got.backward()
    jfn = lambda x: jlosses.poisson_ll_loss(x, jnp.asarray(target), **kw)
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    g, jg = p.grad.numpy(), np.asarray(jgrad)
    np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    assert (g[0, 0, 0, 0] == 0.0) == (method != "anscombe")


@pytest.mark.parametrize("opt_train", [
    {}, {"G_poisson_normalization_method": "log", "G_poisson_max_pixel": 200,
         "G_poisson_epsilon": 1e-3},
    {"G_poisson_normalization_method": "anscombe"}],
    ids=["defaults", "log-200-eps", "anscombe"])
def test_get_loss_fn_poisson_reads_the_option_keys(opt_train):
    rng = np.random.default_rng(8)
    p = rng.random((2, 16, 16, 2)).astype(np.float32)
    t = rng.random((2, 16, 16, 2)).astype(np.float32)
    got = losses.get_loss_fn("poisson", opt_train)(torch.from_numpy(p),
                                                   torch.from_numpy(t))
    want = jlosses.get_loss_fn("poisson", opt_train)(jnp.asarray(p),
                                                     jnp.asarray(t))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# ----------------------------------------------------------------------------
# datasets
# ----------------------------------------------------------------------------

def _phantom(rng, peak=150.0):
    """Smooth seeded counts rates, (1024, 256, 2)."""
    yy, xx = np.mgrid[:1024, :256] / np.array([1024.0, 256.0])[:, None, None]
    rate = np.zeros((1024, 256, 2))
    for c in range(2):
        for _ in range(4):
            cy, cx, s = rng.random(), rng.random(), 0.05 + 0.2 * rng.random()
            rate[..., c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / s ** 2)
    return rate / rate.max() * peak


@pytest.fixture(scope="module")
def dat_folders(tmp_path_factory):
    """Five seeded H / L pairs of (2, 1024, 256) float32 counts (L thinned
    to 1/8 of H)."""
    root = tmp_path_factory.mktemp("spect")
    rng = np.random.default_rng(11)
    for sub in ("H", "L"):
        os.makedirs(root / sub)
    for i in range(5):
        h = rng.poisson(_phantom(rng)).astype(np.float32)
        l = spect.binomial_thin(h, 1 / 8, rng)
        dataset_spect.write_spect_dat(str(root / "H" / f"s{i:03d}.dat"), h)
        dataset_spect.write_spect_dat(str(root / "L" / f"s{i:03d}.dat"), l)
    return str(root / "H"), str(root / "L")


def test_read_spect_dat_matches_jax(dat_folders):
    path = dataset_spect.list_dat(dat_folders[0])[2]
    got, want = dataset_spect.read_spect_dat(path), jds.read_spect_dat(path)
    assert got.shape == (1024, 256, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    raw = np.fromfile(path, np.float32).reshape(2, 1024, 256)
    np.testing.assert_array_equal(got[..., 1], raw[1, :, ::-1])


def _opt(dat_folders, **kw):
    return {"dataroot_H": dat_folders[0], "dataroot_L": dat_folders[1],
            "H_size": 64, **kw}


@pytest.mark.parametrize("kw", [
    {"phase": "train"},
    {"phase": "train", "normalization": {"type": "anscombe", "max_pixel": 120},
     "start_index": 1, "end_index": 4},
    {"phase": "test", "normalization": {"type": "linear", "max_pixel": 150},
     "start_index": 3},
    {"phase": "val"}], ids=["train-log", "train-anscombe", "test-linear",
                            "val-default"])
def test_spect_examples_equal_jax(dat_folders, kw):
    opt = _opt(dat_folders, **kw)
    got_ds = datasets.define_dataset({"dataset_type": "spect", **opt})
    want_ds = jds.DatasetSPECT(opt)
    assert type(got_ds) is dataset_spect.DatasetSPECT
    assert len(got_ds) == len(want_ds) and got_ds.paths_H == want_ds.paths_H
    norm = kw.get("normalization") or {"type": "log", "max_pixel": 150}
    assert got_ds.normalization == norm
    for i in range(len(got_ds)):
        for seed in (0, 9):
            g = got_ds.get_example(i, np.random.default_rng(seed))
            w = want_ds.get_example(i, np.random.default_rng(seed))
            assert g.keys() == w.keys()
            for k in w:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k]
    shape = (64, 64, 2) if kw["phase"] == "train" else (1024, 256, 2)
    assert g["L"].shape == shape


@pytest.mark.parametrize("kw", [
    {"num_patches_per_image": 3, "seed": 4},
    {"num_patches_per_image": 2, "H_size": 48, "start_index": 2,
     "normalization": {"type": "linear", "max_pixel": 150}}],
    ids=["seed4", "linear-48"])
def test_spectpatch_bank_and_examples_equal_jax(dat_folders, kw):
    opt = _opt(dat_folders, phase="train", **kw)
    got_ds = datasets.define_dataset({"dataset_type": "spectpatch", **opt})
    want_ds = jds.DatasetSPECTPatch(opt)
    assert type(got_ds) is dataset_spect.DatasetSPECTPatch
    assert len(got_ds) == len(want_ds) == len(want_ds.paths_H) * kw[
        "num_patches_per_image"]
    for a, b in zip(got_ds._bank_h + got_ds._bank_l,
                    want_ds._bank_h + want_ds._bank_l):
        np.testing.assert_array_equal(a, b)
    # the Loader: the same batches, epoch for epoch
    for epoch in range(2):
        gb = list(base.Loader(got_ds, 2, seed=3).epoch(epoch))
        wb = list(jbase.Loader(want_ds, 2, seed=3).epoch(epoch))
        assert len(gb) == len(wb) > 0
        for g, w in zip(gb, wb):
            for k in ("L", "H"):
                np.testing.assert_array_equal(g[k], w[k])
    # update_data draws a new bank as the JAX one does
    got_ds.update_data(np.random.default_rng(21))
    want_ds.update_data(np.random.default_rng(21))
    np.testing.assert_array_equal(got_ds._bank_l[-1], want_ds._bank_l[-1])


def test_spect_train_loader_batches_equal_jax(dat_folders):
    opt = _opt(dat_folders, phase="train")
    gb = list(base.Loader(dataset_spect.DatasetSPECT(opt), 2, seed=5).epoch(1))
    wb = list(jbase.Loader(jds.DatasetSPECT(opt), 2, seed=5).epoch(1))
    assert len(gb) == len(wb) == 2
    for g, w in zip(gb, wb):
        for k in ("L", "H"):
            np.testing.assert_array_equal(g[k], w[k])
