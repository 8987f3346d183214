"""The port's GAN trainer on the CPU, f32, against the JAX ``GanTrainer``.

* Three steps of ``GanTrainer`` on a tiny SwinIR ×4 (embed 16, one RSTB of
  two blocks, window 8, ``3conv``, ``nearest+conv``; JAX side
  ``fuse_block`` off, the XLA route; the port's training route, the block
  kernels' plain versions), a U-Net discriminator with spectral norm
  (base 8) and VGG19 features at layers (2, 7) with input norm, on weights
  carried across by ``swinir_from_jax``, ``discriminator_from_jax`` and
  ``vgg19_from_jax`` and the same batches. Cases: "gan"; "ragan" with
  ``D_update_ratio`` 2 (steps 1 and 3 update D only, step 2 both); "wgan"
  with R1 and GP (GP's interpolation weights JAX's, fed through
  ``gp_alpha``). After every step each network's move, and the EMA's,
  agrees with JAX's within 5e-2 of its norm (readings: G ≤ 8.1e-3, D ≤
  2.9e-2, E ≤ 2.9e-2. f32 noise in a gradient whose entries nearly cancel
  moves Adam's normalised update by up to lr, and ragan's relativised
  logits give D's last bias an exactly zero gradient; the EMA's move, 1e-3
  of G's, is a few ulps of its entries), each spectral ``u`` within 2e-4
  (readings ≤ 9.8e-5), the losses within 1e-5 of their value (≤ 2.3e-6),
  D_real − D_fake within 1e-5, and D_real, D_fake within 2e-4 a D update
  made (that bias; readings 3.6e-4 at the third).
* ``cli.train_gan`` on a tiny option tree (MSRResNet0, VGG-style D with
  BatchNorm at 32, no perceptual loss) trains, saves and resumes on the
  CPU; with ``F_lossfn_weight`` > 0 and no ``--vgg`` it raises; ``--dtype
  f32`` with a SwinIR G is refused on a CUDA route by the route check.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.models.vgg import VGG19Features as JaxVGG
from kair_tpu.train.gan import GANTrainState, GanTrainer as JaxGan
from kair_tpu_torch.ckpt.torch_convert import (discriminator_from_jax,
                                               swinir_from_jax, vgg19_from_jax)
from kair_tpu_torch.train import gan as tgan

STEPS = 3
MOVE_TOL, U_TOL, LOSS_TOL = 5e-2, 2e-4, 1e-5
CASES = {
    "gan": dict(gan_type="gan"),
    "ragan_cadence": dict(gan_type="ragan", D_update_ratio=2),
    "wgan_r1_gp": dict(gan_type="wgan", D_r1_weight=0.5, D_gp_weight=0.5,
                       D_reg_seed=3),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def gan_options(**train):
    return {"model": "gan", "scale": 4,
            "netG": {"net_type": "swinir", "upscale": 4, "in_nc": 3,
                     "img_size": 16, "window_size": 8, "img_range": 1.0,
                     "depths": [2], "embed_dim": 16, "num_heads": [2],
                     "mlp_ratio": 2, "upsampler": "nearest+conv",
                     "resi_connection": "3conv", "fuse_block": False},
            "netD": {"net_type": "discriminator_unet", "in_nc": 3,
                     "base_nc": 8},
            "train": {"G_lossfn_type": "l1", "G_lossfn_weight": 1e-2,
                      "F_lossfn_type": "l1", "F_lossfn_weight": 1.0,
                      "F_feature_layer": [2, 7], "F_use_input_norm": True,
                      "D_lossfn_weight": 5e-3, "E_decay": 0.999,
                      "G_optimizer_lr": 1e-4, "D_optimizer_lr": 1e-4,
                      **train}}


def batches():
    rng = np.random.RandomState(0)
    return [{"L": rng.rand(2, 16, 16, 3).astype(np.float32),
             "H": rng.rand(2, 64, 64, 3).astype(np.float32)}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def initial():
    """JAX initial variables of G, D and VGG (jitted inits)."""
    jt = JaxGan(gan_options(), vgg_variables={})
    b = batches()[0]
    vg = jax.jit(jt.model_g.init)(jax.random.PRNGKey(0), b["L"])
    vd = jax.jit(jt.model_d.init)(jax.random.PRNGKey(1), b["H"])
    vv = jax.jit(JaxVGG(feature_layers=(2, 7)).init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 3)))
    return vg, vd, vv


def _torch_states(state):
    return (swinir_from_jax({"params": state.params_g}, img_size=16),
            discriminator_from_jax({"params": state.params_d,
                                    "spectral": state.spectral_d}),
            swinir_from_jax({"params": state.ema_params}, img_size=16))


@pytest.fixture(scope="module")
def jax_runs(initial):
    """{case: (initial G, D, E; after each step (G, D, E, metrics); the GP
    alphas used)}."""
    vg, vd, vv = initial
    out = {}
    for case, train in CASES.items():
        jt = JaxGan(gan_options(**train), vgg_variables=vv)
        pg, pd = vg["params"], vd["params"]
        state = GANTrainState(step=jnp.zeros((), jnp.int32), params_g=pg,
                              params_d=pd, opt_g=jt.tx_g.init(pg),
                              opt_d=jt.tx_d.init(pd),
                              spectral_d=vd["spectral"],
                              ema_params=jax.tree_util.tree_map(jnp.copy, pg))
        fns = {True: jt.make_train_step(True), False: jt.make_train_step(False)}
        first, steps, alphas = _torch_states(state), [], []
        for i, b in enumerate(batches()):
            alphas.append(np.asarray(jax.random.uniform(
                jax.random.fold_in(jax.random.PRNGKey(jt.reg_seed), i),
                (2, 1, 1, 1), jnp.float32)))
            state, m = fns[jt.should_update_g(i + 1)](state, b)
            steps.append((*_torch_states(state),
                          {k: float(v) for k, v in m.items()}))
        out[case] = (first, steps, alphas)
    return vv, out


def _move_rel(got, want, prev):
    keys = [k for k in want if want[k].is_floating_point()
            and not k.endswith(".u")]
    num = sum(((got[k].float() - want[k].float()) ** 2).sum() for k in keys)
    den = sum(((want[k].float() - prev[k].float()) ** 2).sum() for k in keys)
    return float(torch.sqrt(num / den))


@pytest.mark.parametrize("case", list(CASES))
def test_gan_trainer_follows_jax(case, jax_runs):
    vv, runs = jax_runs
    (g0, d0, e0), steps, alphas = runs[case]
    trainer = tgan.GanTrainer(gan_options(**CASES[case]), dtype=torch.float32,
                              device="cpu", vgg_state=vgg19_from_jax(vv))
    trainer.model.load_state_dict(g0)
    trainer.ema.load_state_dict(e0)
    trainer.model_d.load_state_dict(d0)
    trainer.gp_alpha = lambda step, shape, device: torch.tensor(alphas[step])
    prev = (g0, d0, e0)
    updates = []
    for i, (b, (g, d, e, m)) in enumerate(zip(batches(), steps)):
        update_g = trainer.should_update_g(i + 1)
        updates.append(update_g)
        mt = trainer.train_step(b)
        got = tuple({k: v.clone() for k, v in m_.state_dict().items()}
                    for m_ in (trainer.model, trainer.model_d, trainer.ema))
        for name, a, w, p in zip("GDE", got, (g, d, e), prev):
            if name != "D" and not update_g:
                assert all(torch.equal(a[k], p[k]) for k in a), (i, name)
                continue
            err = _move_rel(a, w, p)
            assert err <= MOVE_TOL, (case, i, name, err)
        for k in d:
            if k.endswith(".u"):
                assert float((got[1][k] - d[k]).abs().max()) <= U_TOL, (i, k)
        assert set(mt) == set(m)
        for k, v in m.items():
            if k in ("D_real", "D_fake"):
                # D's last bias takes ragan's exactly cancelling gradient:
                # Adam moves it by up to lr a D update on noise, on both sides
                assert abs(float(mt[k]) - v) <= 2e-4 * (i + 1), (k, v)
            else:
                assert abs(float(mt[k]) - v) <= LOSS_TOL * abs(v), (k, v)
        gap = float(mt["D_real"] - mt["D_fake"]) - (m["D_real"] - m["D_fake"])
        assert abs(gap) <= 1e-5, gap
        prev = got
    assert trainer.step == STEPS
    if case == "ragan_cadence":
        assert updates == [False, True, False] and trainer.g_updates == 1


# ----------------------------------------------------------------------------
# cli.train_gan
# ----------------------------------------------------------------------------

def cli_options(tmp_path, hr_dir, **train):
    opt = {"task": "gan_tiny", "model": "gan", "scale": 2, "n_channels": 3,
           "path": {"root": str(tmp_path / "runs")},
           "datasets": {"train": {"name": "t", "dataset_type": "sr",
                                  "dataroot_H": hr_dir, "dataroot_L": None,
                                  "H_size": 96, "dataloader_shuffle": True,
                                  "dataloader_num_workers": 0,
                                  "dataloader_batch_size": 2}},
           "netG": {"net_type": "msrresnet0", "in_nc": 3, "out_nc": 3,
                    "nc": 8, "nb": 1, "upscale": 2, "scale": 2,
                    "upsample_mode": "pixelshuffle"},
           "netD": {"net_type": "discriminator_vgg_96", "in_nc": 3,
                    "base_nc": 4, "act_mode": "BL"},
           "train": {"G_lossfn_type": "l1", "G_lossfn_weight": 1e-2,
                     "F_lossfn_weight": 0, "gan_type": "ragan",
                     "D_lossfn_weight": 5e-3, "E_decay": 0.999,
                     "G_optimizer_lr": 1e-4, "D_optimizer_lr": 1e-4,
                     "manual_seed": 7, "checkpoint_save": 2,
                     "checkpoint_print": 1, "checkpoint_test": 10 ** 6,
                     **train}}
    path = tmp_path / "gan.json"
    path.write_text(json.dumps(opt))
    return str(path)


@pytest.fixture(scope="module")
def hr_dir(tmp_path_factory):
    """Four 96x96 RGB PNGs (the VGG-style D of the 96 preset scores a
    96x96 crop)."""
    import cv2
    root = tmp_path_factory.mktemp("ganH")
    rng = np.random.RandomState(3)
    for i in range(4):
        img = (rng.rand(96, 96, 3) * 255).astype(np.uint8)
        cv2.imwrite(str(root / f"im{i}.png"), cv2.GaussianBlur(img, (0, 0), 2))
    return str(root)


@pytest.fixture
def fresh_gan_logger():
    import logging
    logger = logging.getLogger("train_gan")
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
    yield
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


def test_cli_train_gan_trains_saves_and_resumes(tmp_path, hr_dir,
                                                fresh_gan_logger):
    from kair_tpu_torch.cli import train_gan
    opt = cli_options(tmp_path, hr_dir)
    t = train_gan.main(argv=["--opt", opt, "--device", "cpu",
                             "--max_steps", "2"])
    models = os.path.join(str(tmp_path), "runs", "gan_tiny", "models")
    assert sorted(os.listdir(models)) == sorted(
        f"2_{tag}.pth" for tag in ("G", "D", "E", "optimizerG", "optimizerD"))
    assert t.step == 2 and t.g_updates == 2
    # BatchNorm in training mode at each of D's four passes a ragan step:
    # G's (fake, real), then D's (real, fake)
    assert int(t.model_d.bn1.num_batches_tracked) == 8
    t2 = train_gan.main(argv=["--opt", opt, "--device", "cpu",
                              "--max_steps", "3"])
    assert t2.step == 3 and t2.g_updates == 3
    sd = torch.load(os.path.join(models, "3_D.pth"), weights_only=True)
    assert int(sd["bn1.num_batches_tracked"]) == 12
    assert all(torch.isfinite(v).all() for v in sd.values()
               if v.is_floating_point())


def test_cli_train_gan_refuses_random_vgg(tmp_path, hr_dir, fresh_gan_logger):
    from kair_tpu_torch.cli import train_gan
    opt = cli_options(tmp_path, hr_dir, F_lossfn_weight=1.0)
    with pytest.raises(ValueError, match="refusing random features"):
        train_gan.main(argv=["--opt", opt, "--device", "cpu",
                             "--max_steps", "1"])


def test_f32_swinir_gan_refused_on_the_card_route(monkeypatch):
    """--dtype f32 with a SwinIR G on a CUDA device (no card needed: the
    device is only named, no tensor moves): the route check passes, as the
    G's blocks run the f32 kernels there; no module of the G is a
    bf16-only route."""
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.train import trainer
    from kair_tpu_torch.train.trainer import bf16_only_route
    monkeypatch.setattr(trainer, "default_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)
    opt = gan_options()
    opt["train"]["F_lossfn_weight"] = 0
    t = tgan.GanTrainer(opt, dtype=torch.float32)
    assert t.dtype == torch.float32 and t.device.type == "cuda"
    assert bf16_only_route(define_g(opt)) is None
