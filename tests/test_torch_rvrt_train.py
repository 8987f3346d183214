"""RVRT training in the port on the CPU, f32, against the JAX package (the
kernels' training routes: tests/test_torch_rvrt_train_kernels.py).

* ``VideoTrainer`` on a tiny RVRT (tests/test_torch_rvrt.py's fixture
  configuration: 8x8 windows, embed 16, 2 heads = 2 groups) against the JAX
  ``VideoTrainer`` on the same weights (``convert_rvrt`` there,
  ``rvrt_from_jax`` back) and batches: three updates with fix_iter 2 over
  RVRT's names (``spynet``, ``deform``). The port runs its default routes
  (``fuse_block`` on, ``deform_impl`` "auto": on the CPU the kernels' plain
  versions inside the training functions), the JAX side the composed block
  and the gather route, with the JAX package's query branch patched into
  the port (ROADMAP Queue 3). The flow group stays bit-equal for two
  updates on both sides and moves at the third; each update agrees within
  1e-1 of its norm per group, as tests/test_torch_vrt_train.py explains
  (Adam divides each moment by its own root mean square, so f32 noise in
  a nearly cancelling gradient moves an entry by up to lr).
* Remat (``use_checkpoint_attn``) leaves the gradients as they are.
* ``VideoRecurrentTrainNonblindDenoisingDataset`` feeds an upscale-1
  non-blind RVRT through ``cli.train.main``; ``evaluate_video`` takes an
  RVRT.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu_torch.models import rvrt as trvrt
from tests.test_torch_rvrt import FIXTURE_CFG, jax_query_branch, seeded_rvrt
from tests.test_torch_vrt_train import fresh_train_logger  # noqa: F401

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_options(remat=False, **net):
    net = {"net_type": "rvrt", **{k: list(v) if isinstance(v, tuple) else v
                                  for k, v in FIXTURE_CFG.items()},
           "use_checkpoint_attn": remat, **net}
    return {"model": "vrt", "netG": net, "scale": net.get("upscale", 4),
            "train": {"G_lossfn_type": "charbonnier", "G_charbonnier_eps": 1e-9,
                      "G_optimizer_lr": 4e-4, "G_optimizer_betas": [0.9, 0.99],
                      "G_scheduler_type": "CosineAnnealingWarmRestarts",
                      "G_scheduler_periods": 300000,
                      "G_scheduler_eta_min": 1e-7, "E_decay": 0,
                      "fix_iter": 2, "fix_keys": ["spynet", "deform"],
                      "fix_lr_mul": 0.25},
            "val": {"num_frame_testing": 0, "size_patch_testing": 0}}


def tiny_batches():
    rng = np.random.RandomState(19)
    return [{"L": rng.rand(1, 4, 64, 64, 3).astype(np.float32),
             "H": rng.rand(1, 4, 256, 256, 3).astype(np.float32)}
            for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX VideoTrainer updates (fuse_block off, the gather route)
    from the port's seeded weights; the state dicts after each, through
    ``rvrt_from_jax``."""
    from kair_tpu.ckpt.torch_convert import convert_rvrt
    from kair_tpu.train.trainer import TrainState
    from kair_tpu.train.video import VideoTrainer as JVideoTrainer
    from kair_tpu_torch.ckpt.torch_convert import rvrt_from_jax

    sd = seeded_rvrt(FIXTURE_CFG, seed=3).state_dict()
    variables = convert_rvrt({k: v.numpy() for k, v in sd.items()},
                             num_blocks=FIXTURE_CFG["num_blocks"],
                             depths=FIXTURE_CFG["depths"])
    trainer = JVideoTrainer(tiny_options(fuse_block=False,
                                         deform_impl="gather"))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=trainer.tx.init(params))
    step = trainer.make_train_step(donate=False)
    sds = []
    for batch in tiny_batches():
        state, _ = step(state, batch)
        sds.append({k: v.numpy() for k, v in rvrt_from_jax(
            {"params": state.params}).items()})
    return sd, sds


def _flow(name):
    return "spynet" in name or "deform" in name


def test_video_trainer_trains_rvrt_as_jax_does(jax_run):
    from kair_tpu_torch.train.select import define_trainer
    from kair_tpu_torch.train.video import VideoTrainer

    sd0, want = jax_run
    trainer = define_trainer(tiny_options(), dtype=torch.float32, device="cpu")
    assert isinstance(trainer, VideoTrainer)
    assert isinstance(trainer.model, trvrt.RVRT)
    assert trainer.model.backbone["forward_1"].main[5][0].residual_group \
        .blocks[0].fuse_block
    trainer.model.load_state_dict(sd0, strict=True)
    names = [n for n, _ in trainer.model.named_parameters()]
    assert any("deform_align" in n for n in names if _flow(n))
    assert {g["name"] for g in trainer.optimizer.param_groups} == {"normal",
                                                                   "flow"}
    prev = {n: sd0[n].numpy() for n in names}
    with mock.patch.object(trvrt.RVRT, "query_branch",
                           staticmethod(jax_query_branch)):
        for i, batch in enumerate(tiny_batches()):
            trainer.train_step(batch)
            got = {n: p.detach().numpy().copy()
                   for n, p in trainer.model.named_parameters()}
            for group in (True, False):
                ns = [n for n in names if _flow(n) == group]
                d_got = np.concatenate([(got[n] - prev[n]).ravel() for n in ns])
                d_want = np.concatenate([(want[i][n] - prev[n]).ravel()
                                         for n in ns])
                if group and i < 2:
                    # frozen: bit-equal on both sides for fix_iter updates
                    assert not d_got.any() and not d_want.any(), i
                    continue
                rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
                assert rel <= 1e-1, (i, "flow" if group else "normal", rel)
                assert np.linalg.norm(d_want) > 1e-4
            prev = got


def test_remat_leaves_the_rvrt_gradients_as_they_are():
    """``use_checkpoint_attn`` reaches every TMSAG of the RVRT that
    ``define_trainer`` builds; a backbone's gradients are the same with
    the STL block pairs recomputed in the backward."""
    from kair_tpu_torch.models import vrt as tvrt
    from kair_tpu_torch.train.select import define_trainer
    sd0 = seeded_rvrt(FIXTURE_CFG, seed=4).state_dict()
    x = torch.from_numpy(np.random.RandomState(5).rand(
        1, 2, 16, 16, 4 * 16).astype(np.float32))
    grads = []
    for remat in (False, True):
        model = define_trainer(tiny_options(remat), dtype=torch.float32,
                               device="cpu").model
        groups = [m for m in model.modules() if isinstance(m, tvrt.TMSAG)]
        assert len(groups) == 6 and all(m.remat == remat for m in groups)
        model.load_state_dict(sd0, strict=True)
        backbone = model.backbone["backward_2"]
        backbone(x).square().sum().backward()
        grads.append({n: p.grad.clone()
                      for n, p in backbone.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-7)


def _write_gt_clips(root, clips, frames, size, seed):
    from kair_tpu_torch.utils import image as im
    rng = np.random.RandomState(seed)
    for clip in clips:
        d = root / clip
        d.mkdir(parents=True)
        for f in range(frames):
            img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
            im.imsave(img, str(d / f"{f:08d}.png"))


@pytest.mark.usefixtures("fresh_train_logger")
def test_nonblind_denoising_dataset_trains_an_upscale_1_rvrt(tmp_path):
    """``cli.train.main`` on a tiny non-blind denoising RVRT (upscale 1,
    four input channels: the frames and the σ map; SpyNet sees the frames
    at a quarter size, so 256x256) fed by
    ``VideoRecurrentTrainNonblindDenoisingDataset``: one update, a
    checkpoint, and ``evaluate_video`` on a σ-noised test set."""
    import os
    from kair_tpu_torch.cli import train as cli_train
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.data.datasets import define_dataset

    _write_gt_clips(tmp_path / "train", ("c0", "c1"), 3, 256, 13)
    _write_gt_clips(tmp_path / "test" / "gt", ("t0",), 2, 256, 14)
    (tmp_path / "test" / "lq").symlink_to(tmp_path / "test" / "gt")
    ds_opt = {"name": "train", "dataset_type":
              "VideoRecurrentTrainNonblindDenoisingDataset",
              "dataroot_gt": str(tmp_path / "train"),
              "dataroot_lq": str(tmp_path / "train"), "num_frame": 2,
              "gt_size": 256, "sigma_min": 10, "sigma_max": 20,
              "dataloader_batch_size": 1}
    batch = next(Loader(define_dataset(dict(ds_opt)), 1, seed=0).epoch(0))
    assert batch["L"].shape == (1, 2, 256, 256, 4)
    assert batch["H"].shape == (1, 2, 256, 256, 3)
    sigma = batch["L"][..., 3]
    assert np.ptp(sigma) == 0 and 10 / 255 <= sigma.flat[0] <= 20 / 255

    opt = tiny_options(upscale=1, nonblind_denoising=True)
    opt.update({
        "task": "tiny_rvrt_dn", "gpu_ids": [0], "n_channels": 3,
        "path": {"root": str(tmp_path / "runs")},
        "datasets": {
            "train": ds_opt,
            "test": {"name": "test", "dataset_type": "VideoRecurrentTestDataset",
                     "dataroot_gt": str(tmp_path / "test" / "gt"),
                     "dataroot_lq": str(tmp_path / "test" / "lq"),
                     "sigma": 15}}})
    opt["netG"].pop("window_size")          # evaluate_video: RVRT's default
    opt["train"].update({"checkpoint_test": 1, "checkpoint_save": 1,
                         "checkpoint_print": 1, "manual_seed": 3})
    path = tmp_path / "tiny_rvrt_dn.json"
    path.write_text(json.dumps(opt))
    t = cli_train.main(argv=["--opt", str(path), "--device", "cpu", "--dtype",
                             "f32", "--max_steps", "1"])
    assert isinstance(t.model, trvrt.RVRT) and t.model.upscale == 1
    assert t.step == 1
    task = tmp_path / "runs" / "tiny_rvrt_dn"
    assert {"1_G.pth", "1_optimizerG.pth"} <= set(os.listdir(task / "models"))
    log = (task / "train.log").read_text()
    assert "t0" in log and "Average PSNR" in log
