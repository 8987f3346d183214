"""Training entry point (counterpart of ``kair_tpu/cli/train.py``; reference
``main_train_psnr.py`` :32-246), driven by the same JSON option files.

    python -m kair_tpu_torch.cli.train \
        --opt options/swinir/train_swinir_sr_classical_x4.json --dtype bf16

``model: "vrt"`` trains through ``train/video.VideoTrainer`` (e.g.
``options/vrt/001_train_vrt_videosr_bi_reds_6frames.json``) and evaluates
video test sets with ``evaluate_video``.

Runs on the card in bf16 (autocast over f32 parameters); ``--device cpu``
runs the kernels' plain versions on the CPU, where ``--dtype f32`` is the
usual choice. Checkpoints are KAIR's tagged state dicts under
``path.models`` (``<iter>_G.pth``, ``<iter>_E.pth``,
``<iter>_optimizerG.pth``); a run resumes from the newest ``_G`` file.
Data parallelism over several cards (``gpu_ids``) is a later slice: the
run trains on one card with the option file's batch.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import Optional

import numpy as np
import torch

from kair_tpu_torch import config as opt_util
from kair_tpu_torch.ckpt import checkpoint as ck
from kair_tpu_torch.data.base import Loader
from kair_tpu_torch.data.datasets import define_dataset, make_train_loader
from kair_tpu_torch.train.select import define_trainer
from kair_tpu_torch.train.trainer import PlainTrainer
from kair_tpu_torch.utils import image as im
from kair_tpu_torch.utils.logger import setup_logger

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build_trainer(opt, dtype: Optional[torch.dtype] = torch.bfloat16,
                  device=None) -> PlainTrainer:
    return define_trainer(opt, dtype=dtype, device=device)


def evaluate(trainer: PlainTrainer, test_loader: Loader, border: int = 0,
             use_ema: bool = False, logger=None):
    """PSNR/SSIM over a test set (reference main_train_psnr.py:208-246)."""
    psnrs, ssims = [], []
    for batch in test_loader.epoch(0):
        e = trainer.eval_step({k: v for k, v in batch.items()
                               if isinstance(v, np.ndarray)},
                              use_ema=use_ema).cpu().numpy()
        for i in range(e.shape[0]):
            img_e = im.nhwc_to_uint(e[i:i + 1])
            img_h = im.nhwc_to_uint(batch["H"][i:i + 1])
            psnrs.append(im.calculate_psnr(img_e, img_h, border=border))
            ssims.append(im.calculate_ssim(img_e, img_h, border=border))
            if logger:
                name = os.path.basename(batch.get("H_path", ["?"])[i])
                logger.info(f"{name:>20s} | {psnrs[-1]:<4.2f}dB")
    return float(np.mean(psnrs)), float(np.mean(ssims))


def evaluate_video(trainer: PlainTrainer, test_loader: Loader, opt: dict,
                   logger=None, use_ema: bool = True):
    """Per-folder tiled video evaluation (counterpart of the JAX package's
    ``evaluate_video``; reference main_train_vrt.py:205-246): clips of
    ``val.num_frame_testing`` frames, patches of ``val.size_patch_testing``,
    PSNR/SSIM per frame averaged per folder, then over folders. The EMA
    copy when there is one; on the card a bf16 copy (SpyNet in f32, as
    ``cli.test_video`` serves it), on the CPU an f32 copy."""
    import copy
    from kair_tpu_torch.eval.video_test import test_video
    from kair_tpu_torch.models.vrt import cast_for_inference

    val = opt.get("val") or {}
    ws = tuple((opt.get("netG") or {}).get("window_size") or (6, 8, 8))
    sf = opt.get("scale") or 1
    src = trainer.ema if (use_ema and trainer.ema is not None) else trainer.model
    dt = torch.bfloat16 if trainer.device.type == "cuda" else torch.float32
    net = cast_for_inference(copy.deepcopy(src), trainer.device, dt)

    def fwd(a):
        with torch.inference_mode():
            return net(torch.from_numpy(np.ascontiguousarray(a)).to(
                trainer.device)).float()

    psnrs, ssims = [], []
    for batch in test_loader.epoch(0):
        out = test_video(
            fwd, batch["L"], sf=sf, window_size=ws,
            num_frame_testing=val.get("num_frame_testing") or 0,
            num_frame_overlapping=val.get("num_frame_overlapping") or 2,
            size_patch_testing=val.get("size_patch_testing") or 0,
            patch_overlap=val.get("overlap_size") or 20)
        folder = batch.get("folder", ["?"])[0]
        gts = [(np.clip(batch["H"][0, i], 0, 1) * 255.0).round().astype(np.uint8)
               for i in range(out.shape[1])]
        outs = [im.nhwc_to_uint(out[:, i]) for i in range(out.shape[1])]
        psnr = float(np.mean([im.calculate_psnr(e, g, border=0)
                              for e, g in zip(outs, gts)]))
        ssim = float(np.mean([im.calculate_ssim(e, g, border=0)
                              for e, g in zip(outs, gts)]))
        psnrs.append(psnr)
        ssims.append(ssim)
        if logger:
            logger.info(f"  {folder:20s} PSNR: {psnr:.2f} dB; SSIM: {ssim:.4f}")
    return float(np.mean(psnrs)), float(np.mean(ssims))


def main(json_path: Optional[str] = None, argv=None) -> PlainTrainer:
    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", type=str, default=json_path,
                        required=json_path is None)
    parser.add_argument("--dtype", type=str, default="bf16", choices=list(DTYPES))
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps")
    args = parser.parse_args(argv)

    opt = opt_util.parse(args.opt, is_train=True)
    for d in ("models", "images", "options", "log"):
        os.makedirs(opt["path"].get(d) or opt["path"]["task"], exist_ok=True)
    opt_util.save(opt)
    logger = setup_logger("train", os.path.join(opt["path"]["log"], "train.log"))
    logger.info(opt_util.dict2str(opt))

    seed = opt["train"].get("manual_seed")
    if seed is None:
        seed = random.randint(1, 10000)
    logger.info(f"Random seed: {seed}")
    np.random.seed(seed)
    torch.manual_seed(seed)

    trainer = build_trainer(opt, dtype=DTYPES[args.dtype], device=args.device)
    if (opt.get("num_gpu") or 0) > 1:
        logger.info(f"gpu_ids lists {opt['num_gpu']} cards: data parallelism "
                    "is a later slice of the port; training on one card with "
                    "the option file's batch")

    train_loader = test_loader = None
    test_is_video = False
    for phase, ds_opt in opt["datasets"].items():
        if phase == "train":
            train_loader = make_train_loader(
                ds_opt, ds_opt.get("dataloader_batch_size") or 16, seed=seed,
                info=logger.info)
        elif phase == "test":
            test_loader = Loader(define_dataset(ds_opt), 1, shuffle=False,
                                 drop_last=False)
            test_is_video = "video" in (ds_opt.get("dataset_type")
                                        or "").lower()
    if train_loader is None:
        raise ValueError(f"{args.opt}: no 'train' entry under 'datasets'")

    # auto-resume (reference main_train_psnr.py:63-69)
    init_iter, init_path = opt_util.find_last_checkpoint(
        opt["path"]["models"], "G",
        pretrained_path=opt["path"].get("pretrained_netG"))
    if init_path and os.path.exists(init_path):
        logger.info(f"resume from {init_path} @ iter {init_iter}")
        trainer.resume(init_path, init_iter)
    current_step = int(init_iter)

    ot = opt["train"]
    checkpoint_print = ot.get("checkpoint_print") or 200
    checkpoint_save = ot.get("checkpoint_save") or 5000
    checkpoint_test = ot.get("checkpoint_test") or 5000
    max_iter = args.max_steps or ot.get("max_iter") or 10 ** 8
    border = opt.get("scale") or 1
    models = opt["path"]["models"]

    t0 = time.time()
    for epoch in range(10 ** 9):
        for batch in train_loader.epoch(epoch + seed):
            if current_step >= max_iter:
                logger.info("reached max_iter, stopping")
                trainer.save(models, current_step)
                return trainer
            current_step += 1
            metrics = trainer.train_step(batch)
            trainer.apply_regularizers(current_step)

            if current_step % checkpoint_print == 0:
                lr = trainer.current_lr(current_step)
                ips = (current_step - init_iter) / max(time.time() - t0, 1e-9)
                logger.info(f"<epoch:{epoch:3d}, iter:{current_step:8,d}, "
                            f"lr:{lr:.3e}> G_loss: {float(metrics['G_loss']):.3e} "
                            f"it/s: {ips:.2f}")
            if current_step % checkpoint_save == 0:
                logger.info("Saving the model.")
                trainer.save(models, current_step)
                if ot.get("keep_only_latest"):
                    for tag in ("G", "E", "optimizerG"):
                        ck.prune_old(models, tag, current_step)
            if current_step % checkpoint_test == 0 and test_loader is not None:
                if test_is_video:
                    psnr, ssim = evaluate_video(trainer, test_loader, opt,
                                                logger)
                else:
                    psnr, ssim = evaluate(trainer, test_loader, border=border)
                logger.info(f"<epoch:{epoch:3d}, iter:{current_step:8,d}, "
                            f"Average PSNR : {psnr:<.2f}dB, SSIM : {ssim:<.4f}")


if __name__ == "__main__":
    main()
