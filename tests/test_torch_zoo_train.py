"""Training the CNN zoo on the CPU, f32, against the JAX package.

* One ``PlainTrainer`` step of DnCNN (act "R" and "BR"), FFDNet (plain2)
  and USRNet (plain4) at small width, on the JAX model's initial weights
  carried across by the ``*_from_jax`` converters, against
  ``jax.value_and_grad`` of the JAX model's loss: the loss to 1e-5 of
  itself, every gradient to 1e-4 of its tensor's max (USRNet 1e-3: its
  FFT data step; a conv bias before BatchNorm, whose true gradient is 0,
  to 1e-5 of the model's largest gradient); BatchNorm's running mean to 1e-5 of its max, and the
  running variance after the n/(n-1) rescale (flax updates it with the
  biased batch variance, PyTorch and KAIR with the unbiased one) to 1e-4.
  Adam (and, for "BR", the EMA at decay 0.5) fed the JAX gradients gives
  the JAX update to 1e-6, and the EMA copy's BatchNorm statistics are the
  model's (one ``batch_stats`` in JAX). The JAX side is the JAX trainer's
  step composed by hand (for USRNet with ``sf`` a Python int: the JAX
  trainer cannot feed it).
* The trainer's dtype rule on the card (mocked): f32 passes for the zoo,
  and raises before any work, naming the module and its kernel, for
  SwinIR; a batch whose items disagree on ``sf`` raises.
* ``CALayer``, ``RCABlock``, ``RCAGroup``, ``ESA``, ``CFRB`` and
  ``NonLocalBlock2D`` against the JAX blocks (``block_from_jax``, 1e-5 of
  max|ref|), and ``cli/train_bench --device cpu`` against the JAX file's
  JSON keys and their types.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kair_tpu.ops import blocks as jblocks
from kair_tpu.train import losses as jlosses
from kair_tpu.train.trainer import PlainTrainer as JaxTrainer
from kair_tpu_torch.ckpt import torch_convert as tt
from kair_tpu_torch.ops import blocks
from kair_tpu_torch.train import trainer as trainer_mod
from kair_tpu_torch.train.trainer import PlainTrainer, scale_factor

LOSS_TOL = 1e-5
GRAD_TOL = {"usrnet": 1e-3}
BN_MEAN_TOL, BN_VAR_TOL = 1e-5, 1e-4
UPDATE_TOL = 1e-6
ZERO_GRAD = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the suite runs six workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _options(net: dict, model: str = "plain", e_decay: float = 0):
    return {"model": model, "netG": net,
            "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 1e-3,
                      "G_scheduler_milestones": [10 ** 9],
                      "E_decay": e_decay}}


def _batch(name: str, rng):
    b = 4
    if name == "usrnet":
        k = rng.random((b, 25, 25, 1)).astype(np.float32) ** 4
        return {"L": rng.random((b, 16, 16, 3)).astype(np.float32),
                "H": rng.random((b, 32, 32, 3)).astype(np.float32),
                "k": k / k.sum((1, 2), keepdims=True),
                "sigma": np.full((b, 1, 1, 1), 0.02, np.float32),
                "sf": [2] * b}
    c = 3 if name == "ffdnet" else 1
    batch = {"L": rng.random((b, 16, 16, c)).astype(np.float32),
             "H": rng.random((b, 16, 16, c)).astype(np.float32)}
    if name == "ffdnet":
        batch["C"] = rng.random((b, 1, 1, 1)).astype(np.float32) * 0.2
    return batch


# name: (netG, trainer model, extra keys, *_from_jax)
CASES = {
    "dncnn-R": ({"net_type": "dncnn", "in_nc": 1, "out_nc": 1, "nc": 16,
                 "nb": 5, "act_mode": "R"}, "plain", (),
                lambda v: tt.dncnn_from_jax(v, "R")),
    "dncnn-BR": ({"net_type": "dncnn", "in_nc": 1, "out_nc": 1, "nc": 16,
                  "nb": 5, "act_mode": "BR"}, "plain", (),
                 lambda v: tt.dncnn_from_jax(v, "BR")),
    "ffdnet": ({"net_type": "ffdnet", "in_nc": 3, "out_nc": 3, "nc": 16,
                "nb": 4, "act_mode": "R"}, "plain2", ("C",),
               lambda v: tt.ffdnet_from_jax(v, "R")),
    "usrnet": ({"net_type": "usrnet", "n_iter": 2, "h_nc": 16, "in_nc": 4,
                "out_nc": 3, "nc": [8, 16, 32, 64], "nb": 1, "act_mode": "R",
                "upsample_mode": "convtranspose",
                "downsample_mode": "strideconv"}, "plain4",
               ("k", "sf", "sigma"), lambda v: tt.usrnet_from_jax(v)),
}


def _jax_step(name, opt, batch, e_decay):
    """(loss, grads, new params, new batch_stats, initial variables, new
    EMA) of one JAX step, as the JAX trainer's jitted step composes it
    (``kair_tpu/train/trainer.py:108-138``), run unjitted so that the
    update takes the very gradients compared (Adam turns a near-zero
    gradient's rounding noise into a full step); for USRNet with ``sf`` a
    Python int."""
    jt = JaxTrainer(opt, extra_keys=CASES[name][2])
    key = jax.random.PRNGKey(0)
    arrays = {k: jnp.asarray(v) for k, v in batch.items() if k != "sf"}
    args = [arrays["L"]] + [scale_factor(batch["sf"]) if k == "sf" else
                            arrays[k] for k in CASES[name][2]]
    static = tuple(i for i, a in enumerate(args) if isinstance(a, int))
    variables = dict(jax.jit(jt.model.init, static_argnums=tuple(
        i + 1 for i in static))(key, *args))
    params, stats = variables["params"], variables.get("batch_stats")

    def loss_of(p):
        if stats is None:
            e, new_stats = jt.model.apply({"params": p}, *args,
                                          train=True), None
        else:
            e, mut = jt.model.apply({"params": p, "batch_stats": stats},
                                    *args, train=True,
                                    mutable=["batch_stats"])
            new_stats = mut["batch_stats"]
        return jlosses.l1_loss(e.astype(jnp.float32), arrays["H"]), new_stats

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(params)
    updates, _ = jt.tx.update(grads, jt.tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    new_ema = jax.tree_util.tree_map(
        lambda e, p: e * e_decay + p * (1 - e_decay), params, new_params) \
        if e_decay else None
    return loss, grads, new_params, new_stats, variables, new_ema


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(sd, model):
    names = {n for n, _ in model.named_parameters()}
    return {k: v for k, v in sd.items() if k in names}


@pytest.mark.parametrize("name", list(CASES))
def test_one_step_matches_jax(name):
    net, model_kind, keys, from_jax = CASES[name]
    e_decay = 0.5 if name == "dncnn-BR" else 0
    opt = _options(net, model_kind, e_decay)
    batch = _batch(name.split("-")[0], np.random.default_rng(0))
    jloss, jgrads, jparams, jstats, jvars, jema = _jax_step(name, opt, batch,
                                                            e_decay)
    sd0 = from_jax(_np(jvars))

    t = PlainTrainer(opt, extra_keys=keys, device="cpu", dtype=torch.float32)
    t.model.load_state_dict(sd0, strict=True)
    if t.ema is not None:
        t.ema.load_state_dict(sd0, strict=True)
    loss = float(t.train_step(batch)["G_loss"])
    assert abs(loss - float(jloss)) <= LOSS_TOL * abs(float(jloss))

    gtol = GRAD_TOL.get(name, 1e-4)
    want = _params(from_jax({"params": _np(jgrads),
                             "batch_stats": _np(jvars.get("batch_stats", {}))}),
                   t.model)
    assert set(want) == {n for n, _ in t.model.named_parameters()}
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for n, p in t.model.named_parameters():
        w = want[n].numpy()
        # a conv bias before BatchNorm has no true gradient: both sides
        # are rounding noise there, held to ZERO_GRAD of the largest one
        scale = np.abs(w).max() if np.abs(w).max() > ZERO_GRAD * top \
            else ZERO_GRAD * top / gtol
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=gtol * scale, err_msg=n)

    if jstats is not None:
        stats = from_jax({"params": _np(jparams), "batch_stats": _np(jstats)})
        n_px = batch["L"].shape[0] * batch["L"].shape[1] * batch["L"].shape[2]
        buffers = dict(t.model.named_buffers())
        old = {k: v for k, v in sd0.items() if k.endswith("running_var")}
        checked = 0
        for k, v in buffers.items():
            if k.endswith("running_mean"):
                w = stats[k].numpy()
                np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                           atol=BN_MEAN_TOL * np.abs(w).max(),
                                           err_msg=k)
                checked += 1
            elif k.endswith("running_var"):
                # new = 0.1 old + 0.9 var: unbiased here, biased in flax
                mine = v.numpy() - 0.1 * old[k].numpy()
                flax = (stats[k].numpy() - 0.1 * old[k].numpy()) \
                    * n_px / (n_px - 1)
                np.testing.assert_allclose(mine, flax, rtol=BN_VAR_TOL,
                                           err_msg=k)
                # control: without the rescale the limit is not met
                assert not np.allclose(mine, flax * (n_px - 1) / n_px,
                                       rtol=BN_VAR_TOL, atol=0), k
                checked += 1
        assert checked == 2 * (net["nb"] - 2)
        # the EMA copy reads the model's statistics (JAX: one batch_stats)
        for k, v in t.ema.named_buffers():
            assert torch.equal(v, buffers[k]), k

    # Adam (and the EMA) fed JAX's gradients land on JAX's update
    t2 = PlainTrainer(opt, extra_keys=keys, device="cpu", dtype=torch.float32)
    t2.model.load_state_dict(sd0, strict=True)
    if t2.ema is not None:
        t2.ema.load_state_dict(sd0, strict=True)
    for n, p in t2.model.named_parameters():
        p.grad = want[n].clone()
    t2.apply_update()
    trees = [(jparams, t2.model)] + ([(jema, t2.ema)] if jema is not None
                                     and t2.ema is not None else [])
    for tree, module in trees:
        new = _params(from_jax({"params": _np(tree), "batch_stats":
                                _np(jvars.get("batch_stats", {}))}), module)
        for n, p in module.named_parameters():
            moved = np.abs(new[n].numpy() - sd0[n].numpy()).max()
            assert moved > 10 * UPDATE_TOL, (n, moved)
            np.testing.assert_allclose(p.detach().numpy(), new[n].numpy(),
                                       rtol=0, atol=UPDATE_TOL, err_msg=n)


def test_usrnet_batch_takes_one_int_scale():
    assert scale_factor([3, 3, 3]) == 3 and scale_factor(2) == 2
    with pytest.raises(ValueError, match=r"\[1, 3\]"):
        scale_factor([1, 3, 1])
    net, kind, keys, _ = CASES["usrnet"]
    t = PlainTrainer(_options(net, kind), extra_keys=keys, device="cpu",
                     dtype=torch.float32)
    batch = _batch("usrnet", np.random.default_rng(1))
    args = t._args(batch)
    assert args[2] == 2 and type(args[2]) is int
    batch["sf"] = [2, 2, 4, 2]
    with pytest.raises(ValueError, match="disagree on sf"):
        t.train_step(batch)


class _OnTheCard:
    """PlainTrainer believing it is on the card, with no copy made."""

    def __init__(self, monkeypatch):
        monkeypatch.setattr(trainer_mod, "default_device",
                            lambda d=None: torch.device("cuda"))
        monkeypatch.setattr(torch.nn.Module, "to", lambda self, *a, **k: self)


def test_f32_on_the_card_for_the_zoo_not_for_swinir(monkeypatch):
    _OnTheCard(monkeypatch)
    for name in ("dncnn-BR", "ffdnet", "usrnet"):
        net, kind, keys, _ = CASES[name]
        t = PlainTrainer(_options(net, kind), extra_keys=keys,
                         dtype=torch.float32)
        assert t.dtype == torch.float32 and t.device.type == "cuda"
    swinir = {"net_type": "swinir", "upscale": 1, "in_nc": 1, "img_size": 16,
              "window_size": 8, "depths": [2], "embed_dim": 24,
              "num_heads": [4], "mlp_ratio": 2, "upsampler": None,
              "fuse_block": True, "use_checkpoint": True}
    with pytest.raises(NotImplementedError,
                       match=r"layers\.0\.residual_group\.blocks\.0 "
                             r"\(SwinBlock\) runs swin_block_2d and "
                             r"swin_block_2d_bwd, which takes bfloat16"):
        PlainTrainer(_options(swinir), dtype=torch.float32)
    PlainTrainer(_options(swinir), dtype=torch.bfloat16)


def test_bf16_only_routes_name_their_kernels():
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.models.vrt import DCNv2PackFlowGuided
    assert trainer_mod.bf16_only_route(define_g(_options(
        CASES["usrnet"][0]))) is None
    assert trainer_mod.bf16_only_route(torch.nn.Sequential(
        DCNv2PackFlowGuided(16, 2, deform_impl="mxu"))) is None
    assert "kair_dcn" in trainer_mod.bf16_only_route(torch.nn.Sequential(
        DCNv2PackFlowGuided(16, 2)))


# name: (JAX block, port block, input channels, map side)
BLOCKS = {
    "calayer": (lambda: jblocks.CALayer(32, 4), lambda: blocks.CALayer(32, 4),
                32, 12),
    "rcablock": (lambda: jblocks.RCABlock(32, 4),
                 lambda: blocks.RCABlock(32, 4), 32, 12),
    "rcagroup": (lambda: jblocks.RCAGroup(32, 4, nb=2),
                 lambda: blocks.RCAGroup(32, 4, nb=2), 32, 12),
    "esa": (lambda: jblocks.ESA(32, 4), lambda: blocks.ESA(32, 4), 32, 24),
    "cfrb": (lambda: jblocks.CFRB(20), lambda: blocks.CFRB(20), 20, 24),
    "nonlocal": (lambda: jblocks.NonLocalBlock2D(16),
                 lambda: blocks.NonLocalBlock2D(16), 16, 8),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_blocks_match_jax(kind):
    jm, tm, c, s = BLOCKS[kind]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, s, s + 2, c)).astype(np.float32)
    variables = jax.jit(jm().init)(jax.random.PRNGKey(0), jnp.asarray(x))
    # moved off the initialisers' zeros, so every bias counts
    variables = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        variables)
    ref = np.asarray(jax.jit(jm().apply)(variables, jnp.asarray(x)))
    model = tm()
    model.load_state_dict(tt.block_from_jax(_np(variables), kind), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_train_bench_prints_the_jax_files_keys(monkeypatch):
    from kair_tpu.cli import train_bench as jtb
    from kair_tpu_torch.cli import train_bench
    argv = ["--batch", "2", "--patch", "16", "--nc", "8", "--nb", "3",
            "--steps", "2"]
    # the JAX file turns on a persistent compile cache for the process
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    with contextlib.redirect_stdout(io.StringIO()):
        want = jtb.main(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = train_bench.main(argv + ["--device", "cpu"])
    assert json.loads(buf.getvalue()) == got
    for k, v in want.items():
        assert type(got[k]) is type(v), (k, got[k], v)
    assert got["net"] == "dncnn" and got["step_ms"] > 0
    assert got["mfu"] is None and got["peak_mem_gib"] is None
    for net in ("ffdnet", "usrnet"):
        rep = train_bench.main(["--net", net, "--device", "cpu", "--batch",
                                "2", "--patch", "16", "--steps", "1",
                                "--scale", "2" if net == "usrnet" else "1",
                                "--in_nc", "3"])
        assert rep["net"] == net and rep["step_ms"] > 0


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's would."""

    @property
    def is_cuda(self):
        return True


def test_swinir_trains_on_the_card_only_through_its_kernels(monkeypatch):
    """At another window than 8 (JPEG-CAR's 7) SwinIR refuses f32 on the
    card before any work, and a block in training raises there instead of
    taking the composed path."""
    from kair_tpu_torch.models import swinir as tsw
    _OnTheCard(monkeypatch)
    swinir7 = {"net_type": "swinir", "upscale": 1, "in_nc": 1, "img_size": 14,
               "window_size": 7, "depths": [2], "embed_dim": 24,
               "num_heads": [4], "mlp_ratio": 2, "upsampler": None}
    with pytest.raises(NotImplementedError, match="bfloat16"):
        PlainTrainer(_options(swinir7), dtype=torch.float32)
    block = tsw.SwinBlock(24, (14, 14), 4, 7, 3).train()
    x = torch.zeros(1, 14, 14, 24).as_subclass(_CudaLooking)
    with pytest.raises(NotImplementedError, match="window 7, map 14x14"):
        block(x)
    # on the CPU the same block trains through the plain version
    assert block(torch.zeros(1, 14, 14, 24)).shape == (1, 14, 14, 24)


def _drop_train_handlers() -> None:
    import logging
    logger = logging.getLogger("train")
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


def test_cli_train_usrnet_evaluates_at_checkpoint_test(tmp_path):
    """``cli.train.main`` on a tiny plain4 USRNet option tree: two steps,
    then the test set at ``checkpoint_test`` 2, whose batches carry ``sf``
    as a list (the evaluation must feed it to the model, as training does)."""
    import cv2
    from kair_tpu_torch import config
    from kair_tpu_torch.cli import train as cli_train
    rng = np.random.RandomState(0)
    dirs = {}
    for name, n, side in (("trainH", 4, 40), ("testH", 2, 48)):
        root = tmp_path / name
        root.mkdir()
        for i in range(n):
            img = (rng.rand(side, side, 3) * 255).astype(np.uint8)
            cv2.imwrite(str(root / f"im{i}.png"),
                        cv2.GaussianBlur(img, (0, 0), 2.0))
        dirs[name] = str(root)
    net = {**CASES["usrnet"][0], "init_type": "orthogonal",
           "init_bn_type": "uniform", "init_gain": 0.2}
    opt = {"task": "tiny_usrnet", "model": "plain4", "gpu_ids": [0],
           "scale": 2, "n_channels": 3,
           "path": {"root": str(tmp_path / "runs")},
           "datasets": {
               "train": {"name": "train", "dataset_type": "usrnet",
                         "dataroot_H": dirs["trainH"], "H_size": 32,
                         "scales": [1, 2], "dataloader_shuffle": True,
                         "dataloader_batch_size": 2},
               "test": {"name": "test", "dataset_type": "usrnet",
                        "dataroot_H": dirs["testH"]}},
           "netG": net,
           "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 1e-4,
                     "E_decay": 0, "G_scheduler_type": "MultiStepLR",
                     "G_scheduler_milestones": [10 ** 6],
                     "G_scheduler_gamma": 0.5, "manual_seed": 0,
                     "checkpoint_print": 1, "checkpoint_save": 1000,
                     "checkpoint_test": 2}}
    path = tmp_path / "opt.json"
    path.write_text(json.dumps(opt))
    seen = []
    real = cli_train.evaluate

    def evaluate(trainer, loader, **kw):
        seen.append(real(trainer, loader, **kw))
        return seen[-1]

    _drop_train_handlers()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cli_train, "evaluate", evaluate)
            t = cli_train.main(argv=["--opt", str(path), "--device", "cpu",
                                     "--dtype", "f32", "--max_steps", "2"])
    finally:
        _drop_train_handlers()
    assert t.step == 2 and len(seen) == 1
    psnr, ssim = seen[0]
    assert np.isfinite(psnr) and np.isfinite(ssim) and psnr > 0
    log = open(os.path.join(config.parse(str(path))["path"]["log"],
                            "train.log")).read()
    assert "Average PSNR" in log
