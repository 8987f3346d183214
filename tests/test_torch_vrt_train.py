"""VRT training in the port on the CPU, f32, against the JAX package (the
block kernels' training functions: tests/test_torch_vrt_train_kernels.py).

* ``VideoTrainer`` against the JAX ``VideoTrainer`` on a tiny VRT (the
  tests/test_pallas_bilin.py configuration, 2-frame 64x64 clips), the same
  weights on both sides, the gather route: three updates with fix_iter 2.
  The flow group (spynet, pa_deform) stays bit-equal for two updates on
  both sides and moves at the third with the moments accumulated over all
  three; each update agrees within 1e-1 of its norm per group. The
  gradients agree to about 3e-5, but Adam divides each moment by its own
  root mean square, so where the steps' gradients nearly cancel (the
  upsampler's conv weights, summed over 256x256 pixels in another order)
  f32 noise moves an entry by up to lr: 0.0019, 0.013 and 0.035 of the
  update's norm after updates 1, 2 and 3 on the normal group, 0.035 on the
  flow group's first. A wrong multiplier would move it by 7, a moment
  started afresh by the sign-of-gradient steps that the last assertion
  rules out.
* ``VideoRecurrentTrainDataset`` against the JAX class, batch for batch
  over two epochs from one seed, on seeded PNG clips in a temporary folder.
* ``cli.train.evaluate_video`` against the JAX one on the trained tiny
  model and seeded test clips.
* Remat (``use_checkpoint_attn``) leaves the gradients as they are.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# VideoTrainer against the JAX VideoTrainer
# ---------------------------------------------------------------------------

TINY = dict(upscale=4, window_size=(2, 8, 8), depths=(2,) * 8,
            embed_dims=(12,) * 7 + (16,), num_heads=(2,) * 8, pa_frames=2,
            deformable_groups=2)
STEPS = 3


def tiny_options(remat=False):
    net = {"net_type": "vrt", **{k: list(v) if isinstance(v, tuple) else v
                                 for k, v in TINY.items()},
           "deform_impl": "gather", "use_checkpoint_attn": remat}
    return {"model": "vrt", "netG": net, "scale": 4,
            "train": {"G_lossfn_type": "charbonnier", "G_charbonnier_eps": 1e-9,
                      "G_optimizer_lr": 4e-4, "G_optimizer_betas": [0.9, 0.99],
                      "G_scheduler_type": "CosineAnnealingWarmRestarts",
                      "G_scheduler_periods": 300000,
                      "G_scheduler_eta_min": 1e-7, "E_decay": 0,
                      "fix_iter": 2, "fix_keys": ["spynet", "deform"],
                      "fix_lr_mul": 0.125},
            "val": {"num_frame_testing": 0, "size_patch_testing": 0}}


def tiny_batches():
    rng = np.random.RandomState(9)
    return [{"L": rng.rand(1, 2, 64, 64, 3).astype(np.float32),
             "H": rng.rand(1, 2, 256, 256, 3).astype(np.float32)}
            for _ in range(STEPS)]


def seeded_state_dict():
    """The tiny VRT's state dict with the offset nets' last conv nonzero
    (fractional taps, moving pa_deform) and a rel-pos bias that matters."""
    from kair_tpu_torch.models.vrt import VRT
    torch.manual_seed(0)
    model = VRT(**TINY)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset.6" in name:
                p.normal_(0, 0.02)
            elif "relative_position_bias_table" in name:
                p.normal_(0, 0.5)
    return model.state_dict()


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
def jax_run():
    """Three JAX VideoTrainer updates from the seeded weights; the state
    dicts after each (in KAIR's keys, through vrt_from_jax), the trainer and
    the last state. One jit of the step serves every case."""
    from kair_tpu.ckpt.torch_convert import convert_vrt
    from kair_tpu.train.trainer import TrainState
    from kair_tpu.train.video import VideoTrainer as JVideoTrainer
    from kair_tpu_torch.ckpt.torch_convert import vrt_from_jax

    sd = seeded_state_dict()
    variables = convert_vrt({k: v.numpy() for k, v in sd.items()},
                            depths=TINY["depths"], pa_frames=2, upscale=4)
    trainer = JVideoTrainer(tiny_options())
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=trainer.tx.init(params))
    step = trainer.make_train_step(donate=False)
    sds = []
    for batch in tiny_batches():
        state, _ = step(state, batch)
        sds.append({k: v.numpy() for k, v in vrt_from_jax(
            {"params": state.params}, TINY["window_size"]).items()})
    return sd, sds, trainer, state


def _flow(name):
    return "spynet" in name or "deform" in name


def test_video_trainer_matches_jax_over_three_updates(jax_run):
    from kair_tpu_torch.train.select import define_trainer
    from kair_tpu_torch.train.video import VideoTrainer

    sd0, want, _, _ = jax_run
    trainer = define_trainer(tiny_options(), dtype=torch.float32, device="cpu")
    assert isinstance(trainer, VideoTrainer)
    trainer.model.load_state_dict(sd0, strict=True)
    names = [n for n, _ in trainer.model.named_parameters()]
    assert any(_flow(n) for n in names) and not all(_flow(n) for n in names)
    prev = {n: sd0[n].numpy() for n in names}
    for i, batch in enumerate(tiny_batches()):
        trainer.train_step(batch)
        got = {n: p.detach().numpy().copy()
               for n, p in trainer.model.named_parameters()}
        for group in (True, False):
            ns = [n for n in names if _flow(n) == group]
            d_got = np.concatenate([(got[n] - prev[n]).ravel() for n in ns])
            d_want = np.concatenate([(want[i][n] - prev[n]).ravel() for n in ns])
            if group and i < 2:
                # frozen: bit-equal on both sides for fix_iter updates
                assert not d_got.any() and not d_want.any(), i
                continue
            rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
            assert rel <= 1e-1, (i, "flow" if group else "normal", rel)
            # the update itself is what moves the parameters
            assert np.linalg.norm(d_want) > 1e-4
        prev = got
    # the third flow update used moments accumulated over all three
    # gradients: Adam from fresh moments would give ±lr·mul per entry
    flow = [n for n in names if _flow(n)]
    step3 = np.concatenate([(want[2][n] - want[1][n]).ravel() for n in flow])
    lr3 = 4e-4 * 0.125
    assert np.mean(np.abs(np.abs(step3) - lr3) < 1e-3 * lr3) < 0.5


def test_remat_leaves_the_gradients_as_they_are():
    from kair_tpu_torch.train.select import define_trainer
    sd0 = seeded_state_dict()
    batch = tiny_batches()[0]
    grads = []
    for remat in (False, True):
        trainer = define_trainer(tiny_options(remat), dtype=torch.float32,
                                 device="cpu")
        trainer.model.load_state_dict(sd0, strict=True)
        trainer.compute_grads(batch)
        grads.append({n: p.grad.clone()
                      for n, p in trainer.model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# data and evaluation against the JAX package
# ---------------------------------------------------------------------------

def _write_clips(root, clips, frames, size, scale, seed):
    from kair_tpu_torch.utils import image as im
    rng = np.random.RandomState(seed)
    for clip in clips:
        for sub, s in (("gt", size), ("lq", (size[0] // scale,
                                             size[1] // scale))):
            d = root / sub / clip
            d.mkdir(parents=True)
            for f in range(frames):
                img = (rng.rand(s[0], s[1], 3) * 255).astype(np.uint8)
                im.imsave(img, str(d / f"{f:08d}.png"))


def test_video_train_dataset_matches_jax(tmp_path):
    from kair_tpu.data.base import Loader as JLoader
    from kair_tpu.data.dataset_video import \
        VideoRecurrentTrainDataset as JDataset
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.data.datasets import define_dataset

    _write_clips(tmp_path, ("000", "001", "002"), 7, (40, 48), 4, 5)
    opt = {"dataset_type": "VideoRecurrentTrainDataset", "name": "REDS",
           "val_partition": "REDS4", "dataroot_gt": str(tmp_path / "gt"),
           "dataroot_lq": str(tmp_path / "lq"), "scale": 4, "gt_size": 16,
           "num_frame": 3, "interval_list": [1, 2], "random_reverse": True,
           "use_hflip": True, "use_rot": True, "filename_tmpl": "08d",
           "filename_ext": "png"}
    ds = define_dataset(dict(opt))
    assert len(ds) == 14 and not any(k.startswith("000/") for k in ds.keys)
    got = Loader(ds, 3, seed=4)
    want = JLoader(JDataset(dict(opt)), 3, seed=4)
    for epoch in range(2):
        pairs = list(zip(got.epoch(epoch), want.epoch(epoch)))
        assert len(pairs) == 4
        for a, b in pairs:
            assert a["key"] == b["key"]
            assert a["L"].shape == (3, 3, 4, 4, 3) and a["H"].shape == (3, 3, 16, 16, 3)
            np.testing.assert_array_equal(a["L"], b["L"])
            np.testing.assert_array_equal(a["H"], b["H"])


def test_evaluate_video_matches_jax(jax_run, tmp_path):
    from kair_tpu.cli.train import evaluate_video as j_evaluate_video
    from kair_tpu.data.base import Loader as JLoader
    from kair_tpu.data.dataset_video import \
        VideoRecurrentTestDataset as JTestDataset
    from kair_tpu_torch.cli.train import evaluate_video
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.data.datasets import define_dataset
    from kair_tpu_torch.train.select import define_trainer
    from kair_tpu_torch.ckpt.torch_convert import vrt_from_jax

    _, _, jtrainer, jstate = jax_run
    _write_clips(tmp_path, ("clipA", "clipB"), 2, (256, 256), 4, 8)
    ds_opt = {"dataset_type": "VideoRecurrentTestDataset",
              "dataroot_gt": str(tmp_path / "gt"),
              "dataroot_lq": str(tmp_path / "lq"), "cache_data": True}
    opt = tiny_options()
    logger = logging.getLogger("test_evaluate_video")
    want = j_evaluate_video(jtrainer, jstate, JLoader(
        JTestDataset(dict(ds_opt)), 1, shuffle=False, drop_last=False),
        opt, logger)
    trainer = define_trainer(opt, dtype=torch.float32, device="cpu")
    trainer.model.load_state_dict(
        vrt_from_jax({"params": jstate.params}, TINY["window_size"]))
    got = evaluate_video(trainer, Loader(define_dataset(dict(ds_opt)), 1,
                                         shuffle=False, drop_last=False),
                         opt, logger)
    assert abs(got[0] - want[0]) < 0.02 and abs(got[1] - want[1]) < 1e-3, (
        got, want)


def test_train_bench_prints_the_jax_keys():
    """``cli.train_bench`` on the tiny VRT on the CPU: one JSON report with
    the JAX package's keys (device "cpu", no MFU or memory there)."""
    from unittest import mock
    from kair_tpu_torch.cli import train_bench
    net = {"net_type": "vrt", **{k: list(v) if isinstance(v, tuple) else v
                                 for k, v in TINY.items()}}
    with mock.patch.dict(train_bench.VRT_NET, net, clear=True), \
            mock.patch.object(train_bench, "FRAMES", 2):
        rep = train_bench.main(["--net", "vrt", "--device", "cpu", "--batch",
                                "1", "--steps",
                                "1", "--deform", "mxu", "--fuse", "--remat"])
    for k in ("step_ms", "steps_per_s", "patches_per_s", "megapixels_per_s",
              "device"):
        assert k in rep
    assert rep["device"] == "cpu" and rep["mfu"] is None and rep["step_ms"] > 0


@pytest.mark.usefixtures("fresh_train_logger")
def test_cli_train_trains_vrt_and_evaluates_video(tmp_path):
    """``cli.train.main`` on a tiny VRT option tree (model "vrt", a
    VideoRecurrentTrainDataset and a VideoRecurrentTestDataset): a
    VideoTrainer takes two updates, checkpoints, and evaluates the test
    clips through ``evaluate_video`` at checkpoint_test."""
    import json
    import os
    from kair_tpu_torch.cli import train as cli_train
    from kair_tpu_torch.train.video import VideoTrainer

    _write_clips(tmp_path / "train", ("c0", "c1"), 3, (256, 256), 4, 11)
    _write_clips(tmp_path / "test", ("t0",), 2, (256, 256), 4, 12)
    opt = tiny_options()
    opt.update({
        "task": "tiny_vrt", "gpu_ids": [0], "n_channels": 3,
        "path": {"root": str(tmp_path / "runs")},
        "datasets": {
            "train": {"name": "train", "dataset_type":
                      "VideoRecurrentTrainDataset",
                      "dataroot_gt": str(tmp_path / "train" / "gt"),
                      "dataroot_lq": str(tmp_path / "train" / "lq"),
                      "num_frame": 2, "gt_size": 256,
                      "dataloader_batch_size": 1},
            "test": {"name": "test", "dataset_type": "VideoRecurrentTestDataset",
                     "dataroot_gt": str(tmp_path / "test" / "gt"),
                     "dataroot_lq": str(tmp_path / "test" / "lq")}}})
    opt["train"].update({"checkpoint_test": 2, "checkpoint_save": 2,
                         "checkpoint_print": 1, "manual_seed": 3})
    path = tmp_path / "tiny_vrt.json"
    path.write_text(json.dumps(opt))
    t = cli_train.main(argv=["--opt", str(path), "--device", "cpu", "--dtype",
                             "f32", "--max_steps", "2"])
    assert isinstance(t, VideoTrainer) and t.step == 2
    task = tmp_path / "runs" / "tiny_vrt"
    assert {"2_G.pth", "2_optimizerG.pth"} <= set(os.listdir(task / "models"))
    log = (task / "train.log").read_text()
    assert "t0" in log and "Average PSNR" in log
