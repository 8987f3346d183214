"""The port's training CLIs data-parallel on the CPU: ``gpu_ids`` of two
entries with ``--device cpu`` spawns two gloo ranks (the counterpart of
``tests/test_parallel.py::test_cli_train_data_parallel``).

* ``cli.train`` (DnCNN, B=8): three steps on two ranks log the
  data-parallel line, rank 0 alone logs and writes (another rank's write
  raises in ``ckpt.checkpoint``), and the last G equals one process's on
  the same batches within 1e-5.
* ``cli.train_gan`` (MSRResNet0 against a VGG-style D with BatchNorm) and
  ``cli.train_spect`` (the SPECT SwinIR of ``test_torch_spect_train``,
  with an evaluation at step 2 on rank 0 while rank 1 waits) for two steps.
* A batch that the ranks do not divide stays in one process with the JAX
  CLI's log line.
* The CLIs' spawn path waits for ranks that run for (simulated) hours,
  and still raises for a rank that died without a result.
"""

import json
import logging
import os
import queue
import types

import numpy as np
import pytest
import torch

from kair_tpu_torch.ckpt import checkpoint as ck
from kair_tpu_torch.cli import train as cli_train
from kair_tpu_torch.cli import train_gan, train_spect
from kair_tpu_torch.parallel.mesh import Mesh
from kair_tpu_torch.utils.png import write_png


@pytest.fixture(autouse=True)
def fresh_loggers(monkeypatch):
    """One process runs several CLIs whose loggers keep their first
    handlers: each run gets its own train.log; the ranks a thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    def drop():
        for name in ("train", "train_gan", "train_spect"):
            logger = logging.getLogger(name)
            for h in list(logger.handlers):
                h.close()
                logger.removeHandler(h)
    drop()
    yield
    drop()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpH")
    rng = np.random.RandomState(0)
    for i in range(16):
        write_png(str(root / f"im{i}.png"),
                  (rng.rand(48, 48) * 255).astype(np.uint8))
    rgb = tmp_path_factory.mktemp("dpRGB")
    for i in range(4):
        write_png(str(rgb / f"im{i}.png"),
                  (rng.rand(96, 96, 3) * 255).astype(np.uint8))
    return str(root), str(rgb)


def _write(tmp_path, name, opt):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(opt))
    return str(path)


def dncnn_options(tmp_path, h_dir, gpu_ids, batch=8, task="dp"):
    return _write(tmp_path, task, {
        "task": task, "model": "plain", "gpu_ids": gpu_ids, "scale": 1,
        "n_channels": 1, "path": {"root": str(tmp_path / "runs")},
        "datasets": {"train": {
            "name": "t", "dataset_type": "dncnn", "dataroot_H": h_dir,
            "H_size": 16, "sigma": 25, "sigma_test": 25,
            "dataloader_shuffle": True, "dataloader_num_workers": 0,
            "dataloader_batch_size": batch}},
        "netG": {"net_type": "dncnn", "in_nc": 1, "out_nc": 1, "nc": 8,
                 "nb": 3, "act_mode": "R"},
        "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 1e-3,
                  "G_scheduler_milestones": [1000], "E_decay": 0,
                  "manual_seed": 0, "checkpoint_print": 1,
                  "checkpoint_save": 1, "checkpoint_test": 1000}})


def _log(tmp_path, task):
    with open(tmp_path / "runs" / task / "train.log") as f:
        return f.read()


def test_cli_train_data_parallel_on_two_ranks(tmp_path, images):
    h_dir, _ = images
    assert cli_train.main(argv=["--opt", dncnn_options(tmp_path, h_dir, [0, 1]),
                                "--device", "cpu", "--dtype", "f32",
                                "--max_steps", "3"]) is None
    log = _log(tmp_path, "dp")
    assert "data-parallel over 2 ranks (4/rank)" in log
    for step in (1, 2, 3):       # rank 0 alone logs: one line a step
        assert log.count(f"iter:{step:8,d}") == 1, step
    assert log.count("Saving the model.") == 3
    dp = ck.load(str(tmp_path / "runs" / "dp" / "models" / "3_G.pth"))
    assert all(torch.isfinite(v).all() for v in dp.values())

    one = cli_train.main(argv=["--opt", dncnn_options(
        tmp_path, h_dir, [0], task="one"), "--device", "cpu", "--dtype",
        "f32", "--max_steps", "3"])
    for k, v in one.model.state_dict().items():
        np.testing.assert_allclose(dp[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_a_rank_other_than_0_may_not_write(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    with pytest.raises(RuntimeError, match="only rank 0"):
        ck.save_tagged(str(tmp_path), 1, "G", {"w": torch.zeros(1)})
    assert not os.listdir(tmp_path)


def test_indivisible_batch_stays_in_one_process(tmp_path, images):
    h_dir, _ = images
    trainer = cli_train.main(argv=["--opt", dncnn_options(
        tmp_path, h_dir, [0, 1, 2], task="odd"), "--device", "cpu",
        "--dtype", "f32", "--max_steps", "1"])
    assert trainer is not None and trainer.mesh is None
    assert "batch 8 not divisible by 3 devices; staying single-device" in \
        _log(tmp_path, "odd")


def test_cli_train_gan_data_parallel_on_two_ranks(tmp_path, images):
    _, rgb = images
    path = _write(tmp_path, "gan", {
        "task": "gan", "model": "gan", "scale": 2, "n_channels": 3,
        "gpu_ids": [0, 1], "path": {"root": str(tmp_path / "runs")},
        "datasets": {"train": {"name": "t", "dataset_type": "sr",
                               "dataroot_H": rgb, "dataroot_L": None,
                               "H_size": 96, "dataloader_shuffle": True,
                               "dataloader_num_workers": 0,
                               "dataloader_batch_size": 2}},
        "netG": {"net_type": "msrresnet0", "in_nc": 3, "out_nc": 3, "nc": 8,
                 "nb": 1, "upscale": 2, "scale": 2,
                 "upsample_mode": "pixelshuffle"},
        "netD": {"net_type": "discriminator_vgg_96", "in_nc": 3,
                 "base_nc": 4, "act_mode": "BL"},
        "train": {"G_lossfn_type": "l1", "G_lossfn_weight": 1e-2,
                  "F_lossfn_weight": 0, "gan_type": "ragan",
                  "D_lossfn_weight": 5e-3, "E_decay": 0.999,
                  "G_optimizer_lr": 1e-4, "D_optimizer_lr": 1e-4,
                  "manual_seed": 7, "checkpoint_save": 2,
                  "checkpoint_print": 1, "checkpoint_test": 10 ** 6}})
    assert train_gan.main(argv=["--opt", path, "--device", "cpu",
                                "--max_steps", "2"]) is None
    log = _log(tmp_path, "gan")
    assert "data-parallel over 2 ranks (1/rank)" in log
    assert log.count("iter:       2") == 1
    models = tmp_path / "runs" / "gan" / "models"
    assert {"2_G.pth", "2_D.pth", "2_E.pth"} <= set(os.listdir(models))


def test_cli_train_spect_data_parallel_on_two_ranks(tmp_path):
    from tests.test_torch_spect_train import SWINIR, _options
    import tests.test_torch_spect_train as spect_tests
    root = tmp_path / "scans"
    rng = np.random.default_rng(0)
    from kair_tpu_torch.data import dataset_spect
    from kair_tpu_torch.utils.spect import binomial_thin
    for sub in ("H", "L", "vH", "vL"):
        os.makedirs(root / sub)
    for i in range(3):
        h = rng.poisson(spect_tests._phantom(rng)).astype(np.float32)
        a, b = ("H", "L") if i < 2 else ("vH", "vL")
        dataset_spect.write_spect_dat(str(root / a / f"s{i}.dat"), h)
        dataset_spect.write_spect_dat(str(root / b / f"s{i}.dat"),
                                      binomial_thin(h, 1 / 8, rng))
    path = _options(str(root), str(tmp_path), "spect", dict(SWINIR))
    opt = json.load(open(path))
    opt["gpu_ids"] = [0, 1]
    opt["train"]["lpips_local_repeat_n"] = 1
    json.dump(opt, open(path, "w"))
    assert train_spect.main(argv=["--opt", path, "--device", "cpu",
                                  "--dtype", "f32", "--max_steps", "2"]) is None
    task = tmp_path / "runs_spect" / "spect"
    log = open(task / "train.log").read()
    assert "data-parallel over 2 ranks (1/rank)" in log
    assert log.count("[val_1]") == 1 and log.count("[val_1_poisson]") == 1
    assert (task / "models" / "2_G.pth").exists()
    assert [f for _, _, fs in os.walk(task) for f in fs].count(
        "metrics.csv") == 1


@pytest.mark.parametrize("rank_state", ["running", "dead"])
def test_cli_spawn_has_no_wall_time_limit(monkeypatch, rank_state):
    """``cli.train.spawn_ranks`` through ``launch.spawn`` on fake ranks
    and a fake queue whose every empty poll advances a clock: ranks that
    report only after 100 hours of polls finish the run, none terminated;
    a rank that exited without a result still raises."""
    clock = {"s": 0.0}
    report_at = 100 * 3600.0

    class FakeQueue:
        def __init__(self):
            self.items = []

        def put(self, item):
            self.items.append(item)

        def get(self, timeout):
            if clock["s"] < report_at or not self.items:
                clock["s"] += timeout
                raise queue.Empty
            return self.items.pop(0)

        def empty(self):
            return not self.items

    class FakeRank:
        def __init__(self, target, args):
            self.rank, self.results = args[0], args[-1]
            self.exitcode = None if rank_state == "running" else 1

        def start(self):
            if rank_state == "running":
                self.results.put((self.rank, True, None))

        def is_alive(self):
            return rank_state == "running"

        def terminate(self):
            assert rank_state == "dead", "a running rank was terminated"

        def join(self, timeout=None):
            pass

    fake = types.SimpleNamespace(Queue=FakeQueue, Process=FakeRank)
    monkeypatch.setattr(torch.multiprocessing, "get_context",
                        lambda method: fake)
    mesh = Mesh({"data": 2, "model": 1, "tile": 1})
    if rank_state == "running":
        assert cli_train.spawn_ranks(cli_train.main, mesh, "cpu", None,
                                     []) is None
        assert clock["s"] >= report_at
    else:
        with pytest.raises(RuntimeError, match="exited with code 1 without "
                                               "a result"):
            cli_train.spawn_ranks(cli_train.main, mesh, "cpu", None, [])
