"""GAN training entry point (counterpart of ``kair_tpu/cli/train_gan.py``;
reference main_train_gan.py:61-254), with the fork's CSV metric history,
correlation plots and best-PSNR retention.

    python -m kair_tpu_torch.cli.train_gan --opt options/train_msrresnet_gan.json \
        --vgg model_zoo/vgg19.pth

``--vgg`` is the path of a local torchvision ``vgg19`` state dict, required
when the option file sets ``F_lossfn_weight`` > 0: the perceptual loss
refuses random features. Runs on the card (``--device cpu`` runs the
kernels' plain versions); ``--dtype`` defaults to f32, as in the JAX CLI:
a SwinIR G runs the f32 kernels, with TF32 off for cuBLAS and cuDNN
(``exact_f32``); ``--dtype bf16`` runs the bf16 ones. Checkpoints are
KAIR's tagged state dicts under ``path.models`` (``<iter>_G.pth``,
``_D``, ``_E``, ``_optimizerG``, ``_optimizerD``); a run resumes from the
newest ``_G`` file, and the best PSNR's G (or E) goes to
``bestmodel/best_psnr_G.pth``. ``gpu_ids`` with several entries trains
data-parallel as ``cli.train`` does: G's and D's gradients averaged over
the ranks, rank 0 alone logging, saving and evaluating.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from kair_tpu_torch import config as opt_util
from kair_tpu_torch import exact_f32
from kair_tpu_torch.ckpt import checkpoint as ck
from kair_tpu_torch.cli.train import (DTYPES, choose_mesh, evaluate,
                                      join_launched_group, rank_logger,
                                      spawn_ranks, train_batch_size)
from kair_tpu_torch.data.base import Loader
from kair_tpu_torch.data.datasets import define_dataset, make_train_loader
from kair_tpu_torch.parallel import launch
from kair_tpu_torch.parallel.mesh import shard_batch
from kair_tpu_torch.train.select import define_trainer
from kair_tpu_torch.utils.metrics_log import MetricsLogger


def main(json_path: Optional[str] = None, argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", type=str, default=json_path,
                        required=json_path is None)
    parser.add_argument("--dtype", type=str, default="f32", choices=list(DTYPES))
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--vgg", type=str, default=None,
                        help="local torchvision vgg19 state dict (.pth) for "
                             "the perceptual loss")
    args = parser.parse_args(argv)

    join_launched_group(args.device)
    opt = opt_util.parse(args.opt, is_train=True)
    main_rank = launch.is_main_process()
    if main_rank:
        for d in ("models", "images", "options", "log"):
            os.makedirs(opt["path"].get(d) or opt["path"]["task"],
                        exist_ok=True)
        opt_util.save(opt)
    launch.barrier()
    logger = rank_logger("train_gan", os.path.join(opt["path"]["log"],
                                                   "train.log"))

    seed = opt["train"].get("manual_seed") or 1234
    np.random.seed(seed)
    torch.manual_seed(seed)

    ds_train = opt["datasets"].get("train")
    if ds_train is None:
        raise ValueError(f"{args.opt}: no 'train' entry under 'datasets'")
    mesh = choose_mesh(opt, args.device, logger.info)
    if mesh is not None and not torch.distributed.is_initialized():
        spawn_ranks(main, mesh, args.device, json_path, argv)
        return None

    train_loader = make_train_loader(ds_train, train_batch_size(ds_train),
                                     seed=seed, info=logger.info)
    ds_test = opt["datasets"].get("test")
    test_loader = (Loader(define_dataset(ds_test), 1, shuffle=False,
                          drop_last=False) if ds_test else None)

    vgg_state = None
    if args.vgg:
        vgg_state = torch.load(args.vgg, map_location="cpu", weights_only=True)
    exact_f32(args.device, DTYPES[args.dtype])
    trainer = define_trainer(opt, dtype=DTYPES[args.dtype], device=args.device,
                             vgg_state=vgg_state)
    mlog = MetricsLogger(opt["path"]["log"]) if main_rank else None

    models = opt["path"]["models"]
    init_iter, init_path = opt_util.find_last_checkpoint(models, "G")
    if init_path and os.path.exists(init_path):
        logger.info(f"resume from {init_path} @ {init_iter}")
        trainer.resume(init_path, init_iter)
    if mesh is not None:
        trainer.use_mesh(mesh)
    current_step = int(init_iter)

    ot = opt["train"]
    print_every = ot.get("checkpoint_print") or 200
    save_every = ot.get("checkpoint_save") or 5000
    test_every = ot.get("checkpoint_test") or 5000
    max_iter = args.max_steps or ot.get("max_iter") or 10 ** 8
    border = opt.get("scale") or 1
    best_psnr = -1.0

    def test_and_keep_best(step: int, m: dict, best_psnr: float) -> float:
        psnr, ssim = evaluate(trainer, test_loader, border=border,
                              use_ema=True)
        logger.info(f"<iter:{step:8,d}> PSNR {psnr:.2f} dB SSIM {ssim:.4f}")
        mlog.log(step, {"psnr": psnr, "ssim": ssim,
                        **{k: float(v) for k, v in m.items()}})
        try:
            mlog.plot_correlations()
        except ImportError as e:
            logger.info(f"no correlation plots: {e}")
        if psnr > best_psnr:
            src = trainer.ema if trainer.ema is not None else trainer.model
            ck.save_best(models, "psnr", "G", src.state_dict())
            logger.info(f"new best PSNR {psnr:.2f} dB: saved bestmodel")
        return max(psnr, best_psnr)

    t0 = time.time()
    for epoch in range(10 ** 9):
        for batch in train_loader.epoch(epoch + seed):
            if current_step >= max_iter:
                if main_rank:
                    trainer.save(models, current_step)
                logger.info("reached max_iter")
                return trainer
            current_step += 1
            if mesh is not None:
                batch = shard_batch(mesh, batch)
            m = trainer.train_step(batch,
                                   update_g=trainer.should_update_g(current_step))

            if current_step % print_every == 0:
                msg = ", ".join(f"{k}:{float(v):.3e}" for k, v in m.items())
                ips = (current_step - init_iter) / max(time.time() - t0, 1e-9)
                logger.info(f"<iter:{current_step:8,d}> {msg} it/s:{ips:.2f}")
            if current_step % save_every == 0 and main_rank:
                trainer.save(models, current_step)
            if current_step % test_every == 0 and test_loader is not None:
                if main_rank:
                    best_psnr = test_and_keep_best(current_step, m, best_psnr)
                launch.barrier()


if __name__ == "__main__":
    main()
