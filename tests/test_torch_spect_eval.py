"""The SPECT slice's evaluation side against the JAX package, on the CPU.

* ``eval/harness.evaluate_images`` and ``evaluate_model`` against
  ``kair_tpu.eval.harness``: clean, re-Poissoned (the same Generator
  draws), and with an LPIPS of seeded weights carried across by
  ``lpips_from_jax`` at ``lpips_local_repeat_n`` 3. PSNR within 1e-6 dB,
  SSIM within 1e-9, the likelihood within 1e-9 relative (the same uint8
  images, the same numpy), LPIPS within 1e-5 relative (two float32
  AlexNets).
* ``models/lpips.load_lpips_default``: None when the files are absent,
  found through ``$KAIR_LPIPS_DIR`` and an explicit folder when seeded
  ``.pth`` files are written; its ``lpips_fn`` equal to the JAX one's
  within 1e-5 relative.
* The summary functions: ``cost_analysis`` FLOP equal to the analytic
  2·MAC count of a small conv stack exactly, the JAX ``cost_analysis``
  figure of the same stack within 10% beside it (XLA counts its own
  lowering: the bias adds and the ReLUs too); ``activation_count``, the
  bytes, ``count_params`` against the JAX functions.
* ``cli/config_generator`` output byte-equal to the JAX generator's for the
  three experiments of ``options/spect/``, each parsing through the port's
  ``config.parse`` to the JAX package's tree; ``cli/replot`` writes the
  plots of the pairs the JAX CLI picks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu import config as jconfig
from kair_tpu.cli import config_generator as jgen
from kair_tpu.data import base as jbase
from kair_tpu.data import dataset_spect as jds
from kair_tpu.eval import harness as jharness
from kair_tpu.models import lpips_jax
from kair_tpu.utils import summary as jsummary
from kair_tpu_torch import config
from kair_tpu_torch.cli import config_generator, replot
from kair_tpu_torch.data import base, dataset_spect
from kair_tpu_torch.eval import harness
from kair_tpu_torch.models import lpips
from kair_tpu_torch.utils import summary
from kair_tpu_torch.utils.metrics_log import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECT_OPTIONS = os.path.join(REPO, "options", "spect")


def _pairs(seed, n=2, hw=(96, 64), peak=60.0):
    """(E, H) count images: H Poisson of a smooth rate, E a blurred H."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    es, hs = [], []
    for i in range(n):
        rate = peak * (0.2 + np.stack([
            np.exp(-((yy - hw[0] * rng.random()) ** 2
                     + (xx - hw[1] * rng.random()) ** 2) / 400.0)
            for _ in range(2)], -1))
        h = rng.poisson(rate).astype(np.float64)
        es.append(0.7 * h + 0.3 * rate + rng.normal(0, 1, h.shape))
        hs.append(h)
    return es, hs


def _assert_metrics(got, want, lpips_rel=1e-5):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if np.isnan(w):
            assert np.isnan(g), k
        elif k.startswith(("psnr")):
            assert abs(g - w) <= 1e-6, k
        elif k.startswith("ssim"):
            assert abs(g - w) <= 1e-9, k
        elif k.startswith("lpips"):
            assert g == pytest.approx(w, rel=lpips_rel), k
        else:
            assert g == pytest.approx(w, rel=1e-9, abs=1e-12), k


@pytest.fixture(scope="module")
def lpips_pair():
    """Seeded LPIPS weights: the JAX model's variables, the port's
    ``lpips_fn`` on them, and the JAX ``lpips_fn``."""
    jm = lpips_jax.LPIPSAlex()
    x = jnp.zeros((1, 64, 64, 3))
    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax.jit(jm.init)(jax.random.PRNGKey(3), x, x)))
    rng = np.random.RandomState(4)
    params = dict(variables["params"])
    for i in range(5):
        params[f"lin{i}"] = rng.rand(*params[f"lin{i}"].shape).astype(np.float32)
    variables = {"params": params}
    tm = lpips.LPIPSAlex()
    tm.load_state_dict(lpips.lpips_from_jax(variables))
    return (variables, lpips.make_lpips_fn(tm, "cpu"),
            lpips_jax.make_lpips_fn(jm, variables))


@pytest.mark.parametrize("poisson", [False, True], ids=["clean", "repoisson"])
def test_evaluate_images_matches_jax(poisson):
    es, hs = _pairs(0)
    got = harness.evaluate_images(es, hs, add_poisson_noise=poisson,
                                  rng=np.random.default_rng(1))
    want = jharness.evaluate_images(es, hs, add_poisson_noise=poisson,
                                    rng=np.random.default_rng(1))
    _assert_metrics(got, want)
    assert np.isnan(got["lpips"]) and np.isnan(got["lpips_local"])
    # the default Generator is default_rng(0) on both sides
    _assert_metrics(harness.evaluate_images(es, hs, add_poisson_noise=True),
                    jharness.evaluate_images(es, hs, add_poisson_noise=True))


@pytest.mark.parametrize("poisson", [False, True], ids=["clean", "repoisson"])
def test_evaluate_images_with_lpips_matches_jax(lpips_pair, poisson):
    _, fn, jfn = lpips_pair
    es, hs = _pairs(2)
    got = harness.evaluate_images(es, hs, fn, poisson, 3,
                                  np.random.default_rng(5))
    want = jharness.evaluate_images(es, hs, jfn, poisson, 3,
                                    np.random.default_rng(5))
    _assert_metrics(got, want)
    assert np.isfinite(got["lpips"]) and got["lpips"] > 0


@pytest.fixture(scope="module")
def dat_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("spect_eval")
    rng = np.random.default_rng(12)
    for sub in ("H", "L"):
        os.makedirs(root / sub)
    for i in range(2):
        h = rng.poisson(rng.random((1024, 256, 2)) * 40 + 5).astype(np.float32)
        dataset_spect.write_spect_dat(str(root / "H" / f"{i}.dat"), h)
        dataset_spect.write_spect_dat(str(root / "L" / f"{i}.dat"),
                                      np.round(h / 8).astype(np.float32))
    return {"dataroot_H": str(root / "H"), "dataroot_L": str(root / "L"),
            "phase": "test",
            "normalization": {"type": "linear", "max_pixel": 150}}


@pytest.mark.parametrize("poisson", [False, True], ids=["clean", "repoisson"])
def test_evaluate_model_matches_jax(dat_folder, poisson):
    """A fixed "model" (8·L, a tensor on the port's side), the port's Loader
    against the JAX one, a loss function."""
    loader = base.Loader(dataset_spect.DatasetSPECT(dat_folder), 1,
                         shuffle=False, drop_last=False)
    jloader = jbase.Loader(jds.DatasetSPECT(dat_folder), 1, shuffle=False,
                           drop_last=False)
    loss = lambda e, h: float(np.mean(np.abs(e - h)))
    got = harness.evaluate_model(
        lambda b: torch.from_numpy(b["L"]) * 8, loader,
        dat_folder["normalization"], add_poisson_noise=poisson, loss_fn=loss)
    want = jharness.evaluate_model(
        lambda b: jnp.asarray(b["L"]) * 8, jloader,
        dat_folder["normalization"], add_poisson_noise=poisson, loss_fn=loss)
    _assert_metrics(got, want)
    assert got["loss"] > 0


def _write_lpips_files(folder, variables):
    """The JAX variables as the two released files' keys: torchvision's
    ``features.N`` and lpips' ``lin{i}.model.1.weight``."""
    os.makedirs(folder, exist_ok=True)
    sd = lpips.lpips_from_jax(variables)
    torch.save({k[len("net."):]: v for k, v in sd.items()
                if k.startswith("net.")}, os.path.join(folder, "alexnet.pth"))
    torch.save({k: v for k, v in sd.items() if k.startswith("lin")},
               os.path.join(folder, "alex.pth"))


def test_load_lpips_default_lookup(tmp_path, monkeypatch, lpips_pair):
    variables = lpips_pair[0]
    monkeypatch.delenv("KAIR_LPIPS_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    assert lpips.load_lpips_default(device="cpu") is None
    assert lpips.load_lpips_default(str(tmp_path / "none"), "cpu") is None
    folder = str(tmp_path / "weights")
    _write_lpips_files(folder, variables)
    os.remove(os.path.join(folder, "alex.pth"))
    assert lpips.load_lpips_default(folder, "cpu") is None      # one file
    _write_lpips_files(folder, variables)
    monkeypatch.setenv("KAIR_LPIPS_DIR", folder)
    found = lpips.load_lpips_default(device="cpu")
    jfound = lpips_jax.load_lpips_default()
    assert found is not None and jfound is not None
    model, sd, fn = found
    assert isinstance(model, lpips.LPIPSAlex) and "lin0.model.1.weight" in sd
    rng = np.random.RandomState(6)
    a = (rng.rand(64, 80, 3) * 255).astype(np.uint8)
    b = np.clip(a + rng.randn(*a.shape) * 30, 0, 255).astype(np.uint8)
    assert fn(a, b) == pytest.approx(jfound[2](a, b), rel=1e-5)
    assert fn(a, b) == pytest.approx(lpips_pair[2](a, b), rel=1e-5)
    # <cwd>/model_zoo/lpips, the last place looked
    monkeypatch.delenv("KAIR_LPIPS_DIR")
    _write_lpips_files(str(tmp_path / "model_zoo" / "lpips"), variables)
    assert lpips.load_lpips_default(device="cpu") is not None


def test_load_lpips_default_refuses_a_missing_card(tmp_path, monkeypatch,
                                                   lpips_pair):
    _write_lpips_files(str(tmp_path), lpips_pair[0])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lpips.load_lpips_default(str(tmp_path))


# ----------------------------------------------------------------------------
# the model summary
# ----------------------------------------------------------------------------

def _conv_stack():
    torch.manual_seed(0)
    return torch.nn.Sequential(
        torch.nn.Conv2d(2, 16, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(16, 16, 3, padding=1), torch.nn.ReLU(),
        torch.nn.Conv2d(16, 2, 3, padding=1))


def _jax_stack(model, x):
    convs = [m for m in model if isinstance(m, torch.nn.Conv2d)]
    ws = [(jnp.asarray(c.weight.detach().numpy().transpose(2, 3, 1, 0)),
           jnp.asarray(c.bias.detach().numpy())) for c in convs]

    def fn(a):
        for i, (w, b) in enumerate(ws):
            a = jax.lax.conv_general_dilated(
                a, w, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
            if i < len(ws) - 1:
                a = jax.nn.relu(a)
        return a
    return fn, jnp.asarray(x.permute(0, 2, 3, 1).numpy())


def test_summary_counts():
    model = _conv_stack()
    x = torch.randn(1, 2, 32, 24)
    hw = 32 * 24
    macs = hw * 9 * (2 * 16 + 16 * 16 + 16 * 2)
    ca = summary.cost_analysis(model, x)
    assert ca["flops"] == 2 * macs
    jfn, jx = _jax_stack(model, x)
    jca = jsummary.cost_analysis(jfn, jx)
    assert ca["flops"] == pytest.approx(jca["flops"], rel=0.1)
    # bytes: each op's inputs and outputs, at least every weight and the
    # activations once
    weights = sum(p.numel() * 4 for p in model.parameters())
    acts = 4 * hw * (2 + 16 * 4 + 2)
    assert weights + acts <= ca["bytes accessed"] <= 4 * (weights + acts)
    # the outputs of the five aten ops (three convs, two ReLUs)
    assert summary.activation_count(model, x) == hw * (16 + 16 + 16 + 16 + 2)
    assert jsummary.activation_count(jfn, jx) >= hw * (16 * 4 + 2)
    n = sum(p.numel() for p in model.parameters())
    assert summary.count_params(model) == summary.count_params(
        model.state_dict()) == n
    jparams = {f"c{i}": {"kernel": np.zeros(tuple(c.weight.shape)),
                         "bias": np.zeros(tuple(c.bias.shape))}
               for i, c in enumerate(m for m in model
                                     if isinstance(m, torch.nn.Conv2d))}
    assert jsummary.count_params(jparams) == n
    assert summary.describe_model(model) == \
        f"Sequential: {n:,} params ({n * 4 / 1e6:.2f} MB fp32)"
    report = summary.summary_report(model, x)
    assert report.splitlines()[:3] == [
        summary.describe_model(model), "input (1, 2, 32, 24)",
        f"FLOPs: {2 * macs / 1e9:.2f} G"]


# ----------------------------------------------------------------------------
# the config generator and replot
# ----------------------------------------------------------------------------

def test_config_generator_matches_jax(tmp_path):
    args = [os.path.join(SPECT_OPTIONS, f) for f in (
        "base_template.json", "network_configs.json",
        "experiment_configs.json")]
    got = config_generator.generate_all(*args, str(tmp_path / "port"))
    want = jgen.generate_all(*args, str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) == [
        "drunet_psnr_8x_linear", "rrdbnet_psnr_8x_linear",
        "swinir_psnr_8x_linear"]
    for name in got:
        with open(got[name], "rb") as f, open(want[name], "rb") as g:
            assert f.read() == g.read(), name
        tree, jtree = config.parse(got[name]), jconfig.parse(want[name])
        tree.pop("opt_path"), jtree.pop("opt_path")
        assert tree == jtree, name
        assert tree["netG"]["in_nc"] == 2
        assert tree["datasets"]["val_2"]["normalization"] == {
            "type": "linear", "max_pixel": 150}
    only = config_generator.generate_all(*args, str(tmp_path / "only"),
                                         only="drunet_psnr_8x_linear")
    assert list(only) == ["drunet_psnr_8x_linear"]
    config_generator.main(["--template", args[0], "--networks", args[1],
                           "--experiments", args[2], "--out",
                           str(tmp_path / "cli")])
    assert sorted(os.listdir(tmp_path / "cli")) == sorted(
        f"{n}.json" for n in got)


def test_replot_writes_the_jax_pairs(tmp_path):
    ml = MetricsLogger(str(tmp_path))
    rng = np.random.RandomState(1)
    for step in (100, 200, 300):
        ml.log(step, {"val_1_psnr": 30 + rng.rand(), "val_1_ssim": rng.rand(),
                      "val_1_pll": -rng.rand(), "val_1_loss": rng.rand(),
                      "val_2_psnr": 29 + rng.rand()})
    keys = ["val_1_psnr", "val_1_ssim", "val_1_pll", "val_1_loss",
            "val_2_psnr"]
    want = [f"corr_{a}_{b}.png" for i, a in enumerate(keys)
            for b in keys[i + 1:]][:8]
    paths = replot.main(["--log_dir", str(tmp_path)])
    assert [os.path.basename(p) for p in paths] == want
    assert all(os.path.getsize(p) > 0 for p in paths)
    paths = replot.main(["--log_dir", str(tmp_path), "--pairs",
                         "val_1_loss:val_1_psnr"])
    assert [os.path.basename(p) for p in paths] == [
        "corr_val_1_loss_val_1_psnr.png"]
