"""``cli/train_spect`` on the CPU against ``kair_tpu.cli.train_spect``.

A SwinIR of ``in_nc`` 2 (C=24, one RSTB of depth 2, window 8, no
upsampler) trained with the ``poisson`` loss for 2 steps at B=2 of 64²
crops from seeded ``.dat`` files, then one evaluation of a full 1024x256
validation pair, clean and re-Poissoned (``eval_repoisson``), on the EMA
copy. The JAX CLI runs ``fuse_block: false`` (the Pallas kernel has no CPU
route but interpret mode); the port runs its main route, ``fuse_block:
true``, whose kernels run their plain versions on the CPU. The port starts
from the JAX CLI's initial parameters (its ``init_state`` at the CLI's seed,
carried across by ``swinir_from_jax`` as ``path.pretrained_netG``), so the
two runs see the same batches and the same weights:

* the logged losses within 1e-5 relative;
* ``metrics.csv``: the same columns; PSNR within 1e-3 dB, SSIM within 1e-4,
  the clean likelihood within 1e-5 relative; the re-Poissoned likelihood
  within 1e-4 relative (the estimates differ by float32 rounding, and
  ``rng.poisson`` moves a draw by a count where λ crosses a threshold:
  1.3e-5 read here); the loss columns, which the JAX CLI leaves at 0 (it
  hands its harness no loss), equal to the JAX Poisson loss of the port's
  own EMA output on the validation pair within 1e-5 relative;
* the best-PSNR / best-SSIM files, the checkpoints, and a resume to step 3.

The dataset's normalisation reaches the harness (a block with none
normalises "log"; the JAX CLI would denormalise "linear"). One step each
of DRUNet and RRDBNet-noUp at ``in_nc`` 2 and small width against the JAX
models' ``jax.value_and_grad``: the loss within 1e-5 relative, every
gradient element within 1e-4 of the model's largest gradient. Each loss is
taken where float32 is well conditioned: the Poisson loss with
``G_poisson_epsilon`` 1 count (at 1e-9 a random network's near-zero λ
makes k/λ amplify rounding: JAX's and the port's f32 gradients read 8e-4
and 1.3e-3 from float64 there), Charbonnier at eps 1e-3 (at 1e-9, 3e-5).
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu import config as jconfig
from kair_tpu.data.base import Loader as JLoader
from kair_tpu.data.datasets import define_dataset as jdefine_dataset
from kair_tpu.train import losses as jlosses
from kair_tpu.train.select import define_trainer as jdefine_trainer
from kair_tpu_torch import config
from kair_tpu_torch.ckpt import torch_convert as tt
from kair_tpu_torch.cli import train_spect
from kair_tpu_torch.data import base, dataset_spect
from kair_tpu_torch.eval.harness import evaluate_model
from kair_tpu_torch.train.trainer import PlainTrainer
from kair_tpu_torch.utils.spect import binomial_thin

SEED = 7
SWINIR = {"net_type": "swinir", "upscale": 1, "in_nc": 2, "img_size": 64,
          "window_size": 8, "img_range": 1.0, "depths": [2], "embed_dim": 24,
          "num_heads": [4], "mlp_ratio": 2, "upsampler": None,
          "resi_connection": "1conv"}


def _phantom(rng, peak=150.0):
    yy, xx = np.mgrid[:1024, :256] / np.array([1024.0, 256.0])[:, None, None]
    rate = np.zeros((1024, 256, 2))
    for c in range(2):
        for _ in range(4):
            cy, cx, s = rng.random(), rng.random(), 0.05 + 0.2 * rng.random()
            rate[..., c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / s ** 2)
    return rate / rate.max() * peak


@pytest.fixture(scope="module")
def spect_data(tmp_path_factory):
    """Four training pairs and one validation pair of seeded counts (H
    Poisson of a smooth phantom up to 150, L H thinned to 1/8)."""
    root = tmp_path_factory.mktemp("spect_train")
    rng = np.random.default_rng(0)
    for sub in ("H", "L", "vH", "vL"):
        os.makedirs(root / sub)
    for i in range(5):
        h = rng.poisson(_phantom(rng)).astype(np.float32)
        l = binomial_thin(h, 1 / 8, rng)
        a, b = ("H", "L") if i < 4 else ("vH", "vL")
        dataset_spect.write_spect_dat(str(root / a / f"s{i}.dat"), h)
        dataset_spect.write_spect_dat(str(root / b / f"s{i}.dat"), l)
    return str(root)


def _options(root, tmp, name, net, **train):
    opt = {
        "task": "spect", "model": "plain", "gpu_ids": [0], "scale": 1,
        "n_channels": 2, "normalization": {"type": "linear", "max_pixel": 150},
        "path": {"root": os.path.join(tmp, f"runs_{name}"),
                 "pretrained_netG": None},
        "datasets": {
            "train": {"name": "train", "dataset_type": "spect",
                      "dataroot_H": f"{root}/H", "dataroot_L": f"{root}/L",
                      "H_size": 64, "dataloader_shuffle": True,
                      "dataloader_batch_size": 2},
            "val_1": {"name": "val", "dataset_type": "spect",
                      "dataroot_H": f"{root}/vH", "dataroot_L": f"{root}/vL",
                      "eval_repoisson": True}},
        "netG": net,
        "train": {"G_lossfn_type": "poisson", "E_decay": 0.999,
                  "G_optimizer_lr": 2e-4, "G_scheduler_type": "MultiStepLR",
                  "G_scheduler_milestones": [100], "G_scheduler_gamma": 0.5,
                  "G_optimizer_reuse": True, "manual_seed": SEED,
                  "checkpoint_print": 1, "checkpoint_save": 2,
                  "checkpoint_test": 2, "lpips_local_repeat_n": 3, **train}}
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def _read_csv(path):
    with open(path) as f:
        head, row = f.read().strip().splitlines()
    return dict(zip(head.split(","), map(float, row.split(","))))


def _losses(log_path):
    with open(log_path) as f:
        return [float(line.split("G_loss:")[1].split()[0])
                for line in f if "G_loss:" in line]


def _drop_handlers(name):
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


@pytest.fixture
def fresh_loggers():
    """Both CLIs log through a logger named "train_spect" that keeps its
    first handlers: each run gets its own train.log."""
    _drop_handlers("train_spect")
    yield
    _drop_handlers("train_spect")


def test_train_spect_matches_the_jax_cli(spect_data, tmp_path, fresh_loggers):
    from kair_tpu.cli import train_spect as jtrain_spect
    tmp = str(tmp_path)
    jpath = _options(spect_data, tmp, "jax", {**SWINIR, "fuse_block": False})
    jtrain_spect.main(argv=["--opt", jpath, "--max_steps", "2"])
    _drop_handlers("train_spect")

    # the JAX CLI's initial parameters, as its init_state draws them
    jopt = jconfig.parse(jpath, is_train=True)
    b0 = next(iter(JLoader(jdefine_dataset(jopt["datasets"]["train"]), 2,
                           seed=SEED).epoch(0)))
    state = jdefine_trainer(jopt).init_state(
        jax.random.PRNGKey(SEED),
        {k: v for k, v in b0.items() if isinstance(v, np.ndarray)})
    init = os.path.join(tmp, "init_G.pth")
    torch.save(tt.swinir_from_jax(jax.tree_util.tree_map(
        np.asarray, state.params), img_size=64, window_size=8), init)

    ppath = _options(spect_data, tmp, "port", {**SWINIR, "fuse_block": True})
    raw = json.load(open(ppath))
    raw["path"]["pretrained_netG"] = init
    json.dump(raw, open(ppath, "w"))
    trainer = train_spect.main(argv=["--opt", ppath, "--device", "cpu",
                                     "--dtype", "f32", "--max_steps", "2"])
    assert trainer.step == 2 and trainer.dtype == torch.float32

    jtask, ptask = (config.parse(p)["path"]["task"] for p in (jpath, ppath))
    jl, pl = _losses(f"{jtask}/train.log"), _losses(f"{ptask}/train.log")
    assert len(pl) == len(jl) == 2
    np.testing.assert_allclose(pl, jl, rtol=1e-5)

    got, want = _read_csv(f"{ptask}/metrics.csv"), _read_csv(
        f"{jtask}/metrics.csv")
    assert list(got) == list(want) == ["step"] + [
        f"val_1{p}_{m}" for p in ("", "_poisson") for m in
        ("psnr", "ssim", "psnr_local", "ssim_local", "pll", "loss")]
    for k, w in want.items():
        if "psnr" in k:
            assert abs(got[k] - w) <= 1e-3, k
        elif "ssim" in k:
            assert abs(got[k] - w) <= 1e-4, k
        elif k.endswith("_pll"):
            rel = 1e-4 if "poisson" in k else 1e-5
            assert got[k] == pytest.approx(w, rel=rel), k
        elif k.endswith("_loss"):
            assert w == 0 and got[k] > 0, k
        else:
            assert got[k] == w, k

    # the loss columns by hand: the JAX loss of the evaluated EMA output
    opt = config.parse(ppath, is_train=True)
    val = next(base.Loader(dataset_spect.DatasetSPECT(opt["datasets"]["val_1"]),
                           1, shuffle=False, drop_last=False).epoch(0))
    e = trainer.eval_step({"L": val["L"]}, use_ema=True).float().numpy()
    by_hand = float(jlosses.get_loss_fn("poisson", jconfig.parse(
        ppath, is_train=True)["train"])(jnp.asarray(e), jnp.asarray(val["H"])))
    for k in ("val_1_loss", "val_1_poisson_loss"):
        assert got[k] == pytest.approx(by_hand, rel=1e-5), k

    models = config.parse(ppath)["path"]["models"]
    assert sorted(os.listdir(f"{models}/bestmodel")) == [
        "best_psnr_E.pth", "best_psnr_G.pth", "best_ssim_E.pth",
        "best_ssim_G.pth"]
    best = torch.load(f"{models}/bestmodel/best_psnr_E.pth", weights_only=True)
    for k, v in trainer.ema.state_dict().items():
        assert torch.equal(best[k], v), k
    assert {"2_G.pth", "2_E.pth", "2_optimizerG.pth"} <= set(os.listdir(models))
    # no plot from one evaluation (two points needed), as in the JAX CLI
    assert not [f for f in os.listdir(ptask) if f.startswith("corr_")]

    # a resume: from 2_G.pth (not the pretrained file) to step 3
    _drop_handlers("train_spect")
    t3 = train_spect.main(argv=["--opt", ppath, "--device", "cpu", "--dtype",
                                "f32", "--max_steps", "3"])
    assert t3.step == 3 and "3_G.pth" in os.listdir(models)
    with open(f"{ptask}/train.log") as f:
        assert "2_G.pth @ 2" in f.read()


class _Echo:
    """A trainer whose model returns its input, with an L1 loss."""
    loss_weight = 2.0

    @staticmethod
    def loss_fn(e, h):
        return (e - h).abs().mean()

    def eval_step(self, batch, use_ema=False):
        return torch.from_numpy(batch["L"])


def test_the_datasets_normalisation_reaches_the_harness(spect_data, tmp_path):
    """No ``normalization`` anywhere: the dataset normalises "log" and the
    evaluation denormalises "log" (the JAX CLI would hand the harness the
    block's nothing, "linear")."""
    path = _options(spect_data, str(tmp_path), "nonorm",
                    {**SWINIR, "fuse_block": True})
    raw = json.load(open(path))
    raw.pop("normalization")
    json.dump(raw, open(path, "w"))
    ds_opt = config.parse(path)["datasets"]["val_1"]
    assert "normalization" not in ds_opt
    loader = base.Loader(dataset_spect.DatasetSPECT(ds_opt), 1,
                         shuffle=False, drop_last=False)
    assert loader.dataset.normalization == {"type": "log", "max_pixel": 150}
    got = train_spect.run_evals(_Echo(), {"val_1": ({}, loader)}, None, 1,
                                False, logging.getLogger("spect_test"))
    fn = lambda b: torch.from_numpy(b["L"])
    want = evaluate_model(fn, loader, {"type": "log", "max_pixel": 150})
    linear = evaluate_model(fn, loader, None)
    assert got["val_1_psnr"] == want["psnr"]
    assert got["val_1_pll"] == want["pll"]
    b = next(loader.epoch(0))
    assert got["val_1_loss"] == pytest.approx(
        2.0 * np.abs(b["L"] - b["H"]).mean(), rel=1e-6)
    assert abs(linear["pll"] - want["pll"]) > 1.0


ZOO = {
    "drunet": ({"net_type": "drunet", "in_nc": 2, "out_nc": 2,
                "nc": [8, 16, 32, 64], "nb": 1, "act_mode": "R",
                "upsample_mode": "convtranspose",
                "downsample_mode": "strideconv", "bias": False},
               {"G_lossfn_type": "poisson", "G_poisson_epsilon": 1.0},
               lambda v: tt.unetres_from_jax(v, "R", "strideconv",
                                             "convtranspose")),
    "rrdbnet_no_up": ({"net_type": "rrdbnet_no_up", "in_nc": 2, "out_nc": 2,
                       "nf": 16, "nb": 2, "gc": 8, "act_mode": "L",
                       "bias": True},
                      {"G_lossfn_type": "charbonnier",
                       "G_charbonnier_eps": 1e-3}, tt.rrdbnet_from_jax),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_one_step_of_the_spect_cnns_matches_jax(spect_data, tmp_path, name):
    net, train, from_jax = ZOO[name]
    path = _options(spect_data, str(tmp_path), name, net, **train)
    opt, jopt = config.parse(path), jconfig.parse(path)
    batch = next(base.Loader(dataset_spect.DatasetSPECT(
        opt["datasets"]["train"]), 2, seed=SEED).epoch(0))
    arrays = {k: batch[k] for k in ("L", "H")}
    jt = jdefine_trainer(jopt)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax.jit(jt.model.init)(
        jax.random.PRNGKey(1), jnp.asarray(arrays["L"]))))
    jloss_fn = jlosses.get_loss_fn(train["G_lossfn_type"], jopt["train"])

    def loss_of(p):
        e = jt.model.apply({**variables, "params": p}, jnp.asarray(arrays["L"]),
                           train=True)
        return jloss_fn(e.astype(jnp.float32), jnp.asarray(arrays["H"]))
    jloss, jgrads = jax.value_and_grad(loss_of)(variables["params"])

    t = PlainTrainer(opt, device="cpu", dtype=torch.float32)
    t.model.load_state_dict(from_jax(variables), strict=True)
    loss = float(t.compute_grads(arrays))
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    want = from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
    names = [n for n, _ in t.model.named_parameters()]
    assert set(names) <= set(want)
    top = max(np.abs(want[n].numpy()).max() for n in names)
    for n, p in t.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-4 * top, err_msg=n)
