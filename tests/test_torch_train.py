"""The port's training slice on the CPU, against the JAX package.

* One JAX ``PlainTrainer`` step (tiny SwinIR, fuse_block=True, the Pallas
  forward and backward block kernels in interpret mode) and one port step,
  on weights carried across by ``swinir_from_jax``: the loss and every
  gradient match (f32; rtol 1e-3 of each tensor's scale); Adam + EMA
  (decay 0.5, so the EMA's move is far above the limit) fed JAX's
  gradients give JAX's updated parameters and EMA to 1e-6; the lr of
  the port's schedules equals JAX's at every step.
* ``DatasetSR`` + ``Loader``: identical batches from one seed.
* ``config.parse`` of the shipped SwinIR option files: the same tree.
* The losses, the regularisers and global-norm clipping against JAX/optax.
* Checkpoint save, resume and prune; ``cli.train.main`` on the CPU with a
  resumed second run; the card-only errors without a card.
"""

import json
import logging
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu import config as jconfig
from kair_tpu.ckpt.torch_convert import convert_swinir
from kair_tpu.data import base as jbase
from kair_tpu.data import datasets as jdatasets
from kair_tpu.models.swinir import fused_block_params
from kair_tpu.train import losses as jlosses
from kair_tpu.train import regularizers as jreg
from kair_tpu.train import schedulers as jsched
from kair_tpu.train.trainer import PlainTrainer as JaxTrainer
from kair_tpu_torch import config
from kair_tpu_torch.ckpt import checkpoint as ck
from kair_tpu_torch.ckpt.torch_convert import swinir_from_jax
from kair_tpu_torch.cli import train as cli_train
from kair_tpu_torch.data import base, datasets
from kair_tpu_torch.models import swinir as tsw
from kair_tpu_torch.train import losses, regularizers, schedulers
from kair_tpu_torch.train.trainer import PlainTrainer, clip_by_global_norm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTION_FILES = ["options/swinir/train_swinir_sr_classical_x4.json",
                "options/swinir/train_swinir_denoising_gray.json"]


def _drop_train_handlers() -> None:
    logger = logging.getLogger("train")
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


@pytest.fixture
def fresh_train_logger():
    """The CLI's "train" logger without handlers before and after the test:
    ``setup_logger`` keeps a logger's first handlers, so a CLI run earlier
    in the same process would otherwise keep writing to its own train.log."""
    _drop_train_handlers()
    yield
    _drop_train_handlers()


@pytest.fixture(scope="module")
def hr_dir(tmp_path_factory):
    """Six smooth 48x48 RGB PNGs."""
    import cv2
    root = tmp_path_factory.mktemp("trainH")
    rng = np.random.RandomState(0)
    for i in range(6):
        img = (rng.rand(48, 48, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(root / f"im{i}.png"), cv2.GaussianBlur(img, (0, 0), 2.0))
    return str(root)


def tiny_options(tmp_path, hr_dir, **train):
    opt = {
        "task": "tiny_swinir", "model": "plain", "gpu_ids": [0],
        "scale": 2, "n_channels": 3,
        "path": {"root": str(tmp_path / "runs")},
        "datasets": {"train": {"name": "train", "dataset_type": "sr",
                               "dataroot_H": hr_dir, "H_size": 32,
                               "dataloader_shuffle": True,
                               "use_native_loader": True,
                               "dataloader_batch_size": 2}},
        "netG": {"net_type": "swinir", "upscale": 2, "in_nc": 3,
                 "img_size": 16, "window_size": 8, "img_range": 1.0,
                 "depths": [2, 2], "embed_dim": 24, "num_heads": [4, 4],
                 "mlp_ratio": 2, "upsampler": "pixelshuffle",
                 "resi_connection": "1conv", "fuse_block": True},
        "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 2e-4,
                  "E_decay": 0.999, "G_scheduler_type": "MultiStepLR",
                  "G_scheduler_milestones": [2, 4], "G_scheduler_gamma": 0.5,
                  "G_optimizer_reuse": True, "manual_seed": 0,
                  "checkpoint_print": 1, "checkpoint_save": 1000,
                  "checkpoint_test": 1000, **train},
    }
    p = tmp_path / "opt.json"
    p.write_text(json.dumps(opt))
    return str(p)


def _interpret(fn):
    return lambda *a, **kw: fn(*a, **{**kw, "interpret": True})


def _numpy_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _params(sd, model):
    names = {n for n, _ in model.named_parameters()}
    return {k: v for k, v in sd.items() if k in names}


def test_one_step_matches_jax_trainer(tmp_path, hr_dir):
    # E_decay 0.5 moves the EMA by half Adam's step (about 1e-4), far above
    # the 1e-6 limit; at 0.999 the move (about 2e-7) would hide under it
    path = tiny_options(tmp_path, hr_dir, E_decay=0.5)
    batch = next(base.Loader(datasets.define_dataset(
        config.parse(path)["datasets"]["train"]), 2, seed=0).epoch(0))
    arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}

    jopt = jconfig.parse(path)
    jt = JaxTrainer(jopt)
    with mock.patch.object(jsb, "swin_block_pallas_2d",
                           _interpret(jsb.swin_block_pallas_2d)):
        state = jt.init_state(jax.random.PRNGKey(0), arrays)

        def loss_of(p):
            e = jt.model.apply({"params": p}, jnp.asarray(arrays["L"]),
                               train=True)
            return jlosses.l1_loss(e, jnp.asarray(arrays["H"]))

        jloss, jgrads = jax.value_and_grad(loss_of)(state.params)
        new_state, _ = jt.make_train_step(donate=False)(state, arrays)

    t = PlainTrainer(config.parse(path), device="cpu", dtype=torch.float32)
    sd = swinir_from_jax(_numpy_tree(state.params), img_size=16, window_size=8)
    t.model.load_state_dict(sd)
    t.ema.load_state_dict(sd)
    loss = t.compute_grads(arrays)
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    gsd = _params(swinir_from_jax(_numpy_tree(jgrads), img_size=16,
                                  window_size=8), t.model)
    assert set(gsd) == {n for n, _ in t.model.named_parameters()}
    for n, prm in t.model.named_parameters():
        want = gsd[n].numpy()
        np.testing.assert_allclose(prm.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max(), err_msg=n)

    # Adam + EMA fed JAX's gradients land on JAX's parameters and EMA
    for n, prm in t.model.named_parameters():
        prm.grad = gsd[n].clone()
    t.apply_update()
    for tree, module in ((new_state.params, t.model),
                         (new_state.ema_params, t.ema)):
        want = _params(swinir_from_jax(_numpy_tree(tree), img_size=16,
                                       window_size=8), t.model)
        for n, prm in module.named_parameters():
            moved = np.abs(want[n].numpy() - sd[n].numpy()).max()
            assert moved > 1e-5, (n, moved)
            np.testing.assert_allclose(prm.detach().numpy(), want[n].numpy(),
                                       atol=1e-6, err_msg=n)
    assert t.step == 1 and int(new_state.step) == 1


@pytest.mark.parametrize("opt_train", [
    {"G_optimizer_lr": 2e-4, "G_scheduler_type": "MultiStepLR",
     "G_scheduler_milestones": [2, 4, 5], "G_scheduler_gamma": 0.5},
    {"G_optimizer_lr": 4e-4, "G_scheduler_type": "CosineAnnealingWarmRestarts",
     "G_scheduler_periods": [3, 5], "G_scheduler_restart_weights": [1, 0.5],
     "G_scheduler_eta_min": 1e-7},
], ids=["multistep", "cosine"])
def test_schedule_matches_jax(opt_train):
    mine, ref = schedulers.get_schedule(opt_train), jsched.get_schedule(opt_train)
    for step in range(12):
        assert mine(step) == pytest.approx(float(ref(step)), rel=1e-6), step


def test_trainer_lr_follows_milestones(tmp_path, hr_dir):
    t = PlainTrainer(config.parse(tiny_options(tmp_path, hr_dir)),
                     device="cpu", dtype=torch.float32)
    ref = jsched.get_schedule(t.opt_train)
    for step in range(6):
        for prm in t.model.parameters():
            prm.grad = torch.zeros_like(prm)
        t.apply_update()
        assert t.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(ref(step)), rel=1e-6)


@pytest.mark.parametrize("phase", ["train", "test"])
def test_dataset_sr_and_loader_give_jax_batches(hr_dir, phase):
    ds_opt = {"dataset_type": "sr", "dataroot_H": hr_dir, "H_size": 32,
              "scale": 2, "n_channels": 3, "phase": phase}
    bs = 2 if phase == "train" else 1
    mine = base.Loader(datasets.define_dataset(dict(ds_opt)), bs, seed=3,
                       shuffle=phase == "train")
    ref = jbase.Loader(jdatasets.define_dataset(dict(ds_opt)), bs, seed=3,
                       shuffle=phase == "train")
    for epoch in range(2):
        got, want = list(mine.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 6 // bs
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                else:
                    assert g[k] == w[k]


@pytest.mark.parametrize("rel", OPTION_FILES)
def test_config_parse_matches_jax(rel):
    path = os.path.join(REPO, rel)
    mine, ref = config.parse(path), jconfig.parse(path)
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert config.dict2str(mine) == jconfig.dict2str(ref)


def test_find_last_checkpoint_and_save(tmp_path):
    for step, tag in ((5, "G"), (20, "G"), (30, "E")):
        (tmp_path / f"{step}_{tag}.pth").write_bytes(b"")
    assert config.find_last_checkpoint(str(tmp_path), "G") == \
        (20, str(tmp_path / "20_G.pth"))
    assert config.find_last_checkpoint(str(tmp_path / "none"), "G", "pre.pth") \
        == (0, "pre.pth")
    opt = config.parse(os.path.join(REPO, OPTION_FILES[0]))
    opt["path"]["options"] = str(tmp_path / "options")
    dumped = config.save(opt)
    assert json.load(open(dumped))["netG"]["embed_dim"] == 180


def _arrays(rng, b=2, c=3, h=16, w=16):
    return (rng.rand(b, h, w, c).astype(np.float32),
            rng.rand(b, h, w, c).astype(np.float32))


@pytest.mark.parametrize("name", ["l1", "l2", "l2sum", "charbonnier", "ssim"])
def test_losses_match_jax(name):
    p, t = _arrays(np.random.RandomState(0))
    got = losses.get_loss_fn(name, {})(torch.from_numpy(p), torch.from_numpy(t))
    want = jlosses.get_loss_fn(name, {})(jnp.asarray(p), jnp.asarray(t))
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-7)


def test_tv_loss_matches_jax():
    p, _ = _arrays(np.random.RandomState(1))
    assert float(losses.tv_loss(torch.from_numpy(p), 0.5)) == pytest.approx(
        float(jlosses.tv_loss(jnp.asarray(p), 0.5)), rel=1e-5)


@pytest.mark.parametrize("name", ["gan", "poisson"])
def test_later_slice_losses_raise(name):
    """"gan" is no pixel loss: not found, as in the JAX package (its
    objectives are ``gan_loss``'s); "poisson", the SPECT slice's, matches
    the JAX loss (rel 1e-5)."""
    if name == "gan":
        with pytest.raises(NotImplementedError, match="not found"):
            jlosses.get_loss_fn(name)
        with pytest.raises(NotImplementedError, match="not found"):
            losses.get_loss_fn(name, {})
    else:
        p, t = _arrays(np.random.RandomState(2))
        ot = {"G_poisson_normalization_method": "log"}
        got = losses.get_loss_fn(name, ot)(torch.from_numpy(p),
                                           torch.from_numpy(t))
        want = jlosses.get_loss_fn(name, ot)(jnp.asarray(p), jnp.asarray(t))
        assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_regularizers_match_jax():
    rng = np.random.RandomState(2)
    hwio = (rng.randn(3, 3, 4, 8) * 1.2).astype(np.float32)
    bias = np.array([2.0, -2.0, 0.1, 0, 0, 0, 0, 0], np.float32)
    conv = torch.nn.Conv2d(4, 8, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(bias))
    tree = {"conv": {"kernel": jnp.asarray(hwio), "bias": jnp.asarray(bias)}}
    regularizers.regularizer_orth(conv)
    want = jreg.regularizer_orth(tree)
    np.testing.assert_allclose(conv.weight.detach().numpy().transpose(2, 3, 1, 0),
                               np.asarray(want["conv"]["kernel"]), atol=1e-5)
    regularizers.regularizer_clip(conv)
    want = jreg.regularizer_clip(want)
    np.testing.assert_allclose(conv.bias.detach().numpy(),
                               np.asarray(want["conv"]["bias"]), atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    rng = np.random.RandomState(3)
    gs = [rng.randn(5, 4).astype(np.float32), rng.randn(7).astype(np.float32)]
    tg = [torch.from_numpy(g.copy()) for g in gs]
    clip_by_global_norm(tg, max_norm)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in gs], optax.EmptyState())
    for a, b in zip(tg, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_swinir_from_jax_reads_the_fused_layout():
    torch.manual_seed(0)
    cfg = dict(upscale=2, in_chans=3, embed_dim=24, depths=(2, 2),
               num_heads=(4, 4), window_size=8, mlp_ratio=2.0,
               upsampler="pixelshuffle")
    sd = tsw.SwinIR(img_size=16, **cfg).state_dict()
    std = convert_swinir({k: v.numpy() for k, v in sd.items()},
                         depths=(2, 2), upsampler="pixelshuffle", upscale=2)
    back = swinir_from_jax({"params": fused_block_params(std["params"])},
                           img_size=16, window_size=8)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_checkpoint_save_resume_prune(tmp_path, hr_dir):
    opt = config.parse(tiny_options(tmp_path, hr_dir))
    t = PlainTrainer(opt, device="cpu", dtype=torch.float32)
    batch = next(base.Loader(datasets.define_dataset(opt["datasets"]["train"]),
                             2, seed=0).epoch(0))
    for _ in range(2):
        t.train_step(batch)
    models = str(tmp_path / "models")
    paths = t.save(models, 2)
    assert [os.path.basename(p) for p in paths] == \
        ["2_G.pth", "2_E.pth", "2_optimizerG.pth"]
    assert not [f for f in os.listdir(models) if ".tmp" in f]
    # a G file loads into a fresh SwinIR as KAIR's would
    fresh = tsw.SwinIR(img_size=16, upscale=2, in_chans=3, embed_dim=24,
                       depths=(2, 2), num_heads=(4, 4), window_size=8,
                       mlp_ratio=2.0, upsampler="pixelshuffle")
    fresh.load_state_dict(ck.load(paths[0]))

    t2 = PlainTrainer(opt, device="cpu", dtype=torch.float32)
    step, g_path = config.find_last_checkpoint(models, "G")
    t2.resume(g_path, step)
    assert t2.step == 2
    for a, b in ((t.model, t2.model), (t.ema, t2.ema)):
        for (k, v), (k2, v2) in zip(a.state_dict().items(),
                                    b.state_dict().items()):
            assert k == k2 and torch.equal(v, v2), k
    s1, s2 = t.optimizer.state_dict(), t2.optimizer.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(s2["state"][i][k]))
    # the resumed trainer takes the same next step as the original
    l1, l2 = t.train_step(batch)["G_loss"], t2.train_step(batch)["G_loss"]
    assert float(l1) == float(l2)

    t.save(models, 3)
    ck.prune_old(models, "G", 3)
    assert sorted(f for f in os.listdir(models) if f.endswith("_G.pth")) == ["3_G.pth"]
    best = ck.save_best(models, "psnr", "G", t.model.state_dict())
    assert best.endswith(os.path.join("bestmodel", "best_psnr_G.pth"))
    assert os.path.exists(best)


@pytest.mark.usefixtures("fresh_train_logger")
def test_cli_train_main_runs_and_resumes_on_cpu(tmp_path, hr_dir):
    path = tiny_options(tmp_path, hr_dir)
    t = cli_train.main(argv=["--opt", path, "--device", "cpu", "--dtype", "f32",
                             "--max_steps", "2"])
    models = config.parse(path)["path"]["models"]
    assert t.step == 2
    assert {"2_G.pth", "2_E.pth", "2_optimizerG.pth"} <= set(os.listdir(models))
    t2 = cli_train.main(argv=["--opt", path, "--device", "cpu", "--dtype",
                              "f32", "--max_steps", "3"])
    assert t2.step == 3 and "3_G.pth" in os.listdir(models)


def test_f32_on_the_card_raises(tmp_path, hr_dir, monkeypatch):
    """f32 on a card-looking device: SwinIR passes the route check (its
    blocks run the f32 kernels); a G with VRT's bf16-only blocks still
    raises before any work."""
    from kair_tpu_torch.models import registry, vrt
    opt = config.parse(tiny_options(tmp_path, hr_dir))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    t = cli_train.build_trainer(opt, dtype=torch.float32)
    assert t.dtype == torch.float32 and t.device.type == "cuda"
    monkeypatch.setattr(registry, "define_g",
                        lambda o: torch.nn.Sequential(vrt.TMSA(24, 2)))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        cli_train.build_trainer(opt, dtype=torch.float32)


def test_no_card_raises(tmp_path, hr_dir, monkeypatch):
    opt = config.parse(tiny_options(tmp_path, hr_dir))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.build_trainer(opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(argv=["--opt", tiny_options(tmp_path, hr_dir),
                             "--max_steps", "1"])


@pytest.mark.parametrize("what,name", [
    ("dataset", "spect"), ("net", "spynet"), ("dataset", "spectpatch"),
    ("netD", "discriminator_patchgan"), ("netD", "discriminator_unet"),
    ("trainer", "gan"), ("netD", "discriminator_vgg_128")])
def test_later_slices_raise_naming_their_slice(what, name, tmp_path):
    """The entries of the later slices build: the SPECT datasets on a
    written ``.dat`` pair, ``define_g`` SpyNet (the JAX registry's
    ``return_levels`` default [5]), ``define_d`` each discriminator,
    ``define_trainer`` the GAN trainer."""
    from kair_tpu_torch.models import discriminator as tdisc
    from kair_tpu_torch.models.registry import define_d, define_g
    from kair_tpu_torch.models.spynet import SpyNet
    from kair_tpu_torch.train.gan import GanTrainer
    from kair_tpu_torch.train.select import define_trainer
    if what == "dataset":
        from kair_tpu_torch.data import dataset_spect
        for sub in ("H", "L"):
            os.makedirs(tmp_path / sub)
            np.zeros((2, 1024, 256), np.float32).tofile(
                str(tmp_path / sub / "a.dat"))
        ds = datasets.define_dataset({
            "dataset_type": name, "dataroot_H": str(tmp_path / "H"),
            "dataroot_L": str(tmp_path / "L"), "num_patches_per_image": 2})
        want = {"spect": dataset_spect.DatasetSPECT,
                "spectpatch": dataset_spect.DatasetSPECTPatch}[name]
        assert type(ds) is want and len(ds) == (1 if name == "spect" else 2)
        assert ds.get_example(0, np.random.default_rng(0))["L"].shape == (
            64, 64, 2)
    elif what == "net":
        net = define_g({"netG": {"net_type": name}})
        assert isinstance(net, SpyNet) and net.return_levels == (5,)
    elif what == "netD":
        net = define_d({"netD": {"net_type": name, "base_nc": 8}})
        want = {"discriminator_patchgan": tdisc.PatchGAN,
                "discriminator_unet": tdisc.UNetDiscriminator,
                "discriminator_vgg_128": tdisc.VGGStyleDiscriminator}[name]
        assert type(net) is want
    else:
        opt = {"model": name,
               "netG": {"net_type": "dncnn", "in_nc": 1, "out_nc": 1,
                        "nc": 8, "nb": 3, "act_mode": "R"},
               "netD": {"net_type": "discriminator_patchgan", "in_nc": 1,
                        "base_nc": 8},
               "train": {"G_lossfn_weight": 1.0, "F_lossfn_weight": 0}}
        assert isinstance(define_trainer(opt, device="cpu"), GanTrainer)


def _tiny_swinir(**kw):
    torch.manual_seed(0)
    return tsw.SwinIR(img_size=16, upscale=2, in_chans=3, embed_dim=24,
                      depths=(2, 2), num_heads=(4, 4), window_size=8,
                      mlp_ratio=2.0, upsampler="pixelshuffle", **kw).train()


def test_training_blocks_take_the_kernel_function():
    """Every block of a window-8 model goes through swin_block_train in
    training (the shift folded into its read, the output rolled back); the
    RSTB tails do not use the fused conv kernel."""
    model = _tiny_swinir()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 16, 24, 3)
                         .astype(np.float32))
    calls = {"train": 0, "tail": 0}
    fn, conv = tsw.swin_block_train, tsw.Conv.forward

    def spy(*a, **k):
        calls["train"] += 1
        return fn(*a, **k)

    def conv_spy(self, x, residual=None, phase=0):
        calls["tail"] += residual is not None
        return conv(self, x, residual, phase)

    with mock.patch.object(tsw, "swin_block_train", spy), \
            mock.patch.object(tsw.Conv, "forward", conv_spy):
        model(x).mean().backward()
    assert calls == {"train": 4, "tail": 0}
    assert all(p.grad is not None for p in model.parameters())


def test_use_checkpoint_gives_the_same_gradients():
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 16, 16, 3)
                         .astype(np.float32))
    grads = []
    for ckpt in (False, True):
        model = _tiny_swinir(use_checkpoint=ckpt)
        model(x).square().mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
