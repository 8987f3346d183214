"""Training entry point (counterpart of ``kair_tpu/cli/train.py``; reference
``main_train_psnr.py`` :32-246), driven by the same JSON option files.

    python -m kair_tpu_torch.cli.train \
        --opt options/swinir/train_swinir_sr_classical_x4.json --dtype bf16

``model: "vrt"`` trains a VRT or an RVRT (``netG.net_type``) through
``train/video.VideoTrainer`` (e.g.
``options/vrt/001_train_vrt_videosr_bi_reds_6frames.json``) and evaluates
video test sets with ``evaluate_video``.

Runs on the card in bf16 (autocast over f32 parameters) unless ``--dtype
f32`` is given: then the f32 kernels, with TF32 off for cuBLAS and cuDNN
(``exact_f32``); VRT and RVRT still raise in f32 on the card before any
work (``train/trainer.bf16_only_route``). ``--device cpu`` runs the
kernels' plain versions on the CPU, where ``--dtype f32`` is the usual
choice. Checkpoints are KAIR's tagged state dicts under
``path.models`` (``<iter>_G.pth``, ``<iter>_E.pth``,
``<iter>_optimizerG.pth``); a run resumes from the newest ``_G`` file.

Several cards: ``gpu_ids`` with n entries spawns n ranks on this host
(``parallel.launch.spawn``; NCCL, one card each) when n cards exist and
the batch divides n, else trains on one card and says why; under
``torchrun`` or SLURM each process joins the group the launcher names.
Each rank steps on its rows of the option file's batch and the gradients
are averaged over the ranks (``train/trainer.PlainTrainer.use_mesh``);
rank 0 alone logs, saves and evaluates while the others wait.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import shutil
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from kair_tpu_torch import config as opt_util
from kair_tpu_torch import exact_f32
from kair_tpu_torch.ckpt import checkpoint as ck
from kair_tpu_torch.data.base import Loader
from kair_tpu_torch.data.datasets import define_dataset, make_train_loader
from kair_tpu_torch.parallel import launch
from kair_tpu_torch.parallel.mesh import Mesh, data_parallel_mesh, shard_batch
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
    """PSNR/SSIM over a test set (reference main_train_psnr.py:208-246).
    The model takes the batch's arrays and the trainer's extra keys, lists
    among them (USRNet's ``sf``); the path lists stay behind."""
    psnrs, ssims = [], []
    for batch in test_loader.epoch(0):
        e = trainer.eval_step({k: v for k, v in batch.items()
                               if isinstance(v, np.ndarray)
                               or k in trainer.extra_keys},
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
    copy when there is one; on the card a copy in the trainer's dtype (bf16:
    SpyNet in f32, as ``cli.test_video`` serves it), on the CPU an f32 copy. VRT or RVRT:
    the window defaults to the network's own ((6, 8, 8) and (2, 8, 8))."""
    import copy
    from kair_tpu_torch.eval.video_test import test_video
    from kair_tpu_torch.models.vrt import cast_for_inference

    val = opt.get("val") or {}
    net = opt.get("netG") or {}
    ws = tuple(net.get("window_size") or (
        (2, 8, 8) if net.get("net_type") == "rvrt" else (6, 8, 8)))
    sf = opt.get("scale") or 1
    src = trainer.ema if (use_ema and trainer.ema is not None) else trainer.model
    dt = trainer.dtype if trainer.device.type == "cuda" else torch.float32
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


def make_parser(json_path: Optional[str] = None) -> argparse.ArgumentParser:
    """The arguments every training CLI of the port takes."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", type=str, default=json_path,
                        required=json_path is None)
    parser.add_argument("--dtype", type=str, default="bf16", choices=list(DTYPES))
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N optimizer steps")
    return parser


@dataclass
class Run:
    """A training run as ``prepare`` sets it up: the trainer resumed at
    ``init_iter``, its train loader, where to stop, and the data-parallel
    mesh (None: one process). A run whose ranks are still to be spawned
    has a mesh and neither a trainer nor a loader."""
    opt: dict
    logger: logging.Logger
    seed: int
    trainer: Optional[PlainTrainer]
    train_loader: Optional[Loader]
    init_iter: int
    max_iter: int
    mesh: Optional[Mesh] = None


def rank_logger(name: str, log_path: str) -> logging.Logger:
    """The run's logger: rank 0's writes ``log_path`` and the console,
    another rank's nothing."""
    if launch.is_main_process():
        return setup_logger(name, log_path)
    logger = logging.getLogger(f"{name}.rank{dist.get_rank()}")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def train_batch_size(ds_opt: dict) -> int:
    """The global batch of a train option block (16 when unset)."""
    return ds_opt.get("dataloader_batch_size") or 16


def choose_mesh(opt: dict, device, log) -> Optional[Mesh]:
    """The run's data-parallel mesh: ``data_parallel_mesh`` on ``gpu_ids``
    (or the group a launcher started) and the option file's batch, read
    before any loader is built: a process that spawns the ranks builds
    none."""
    return data_parallel_mesh(opt.get("num_gpu"),
                              train_batch_size(opt["datasets"]["train"]), log,
                              device=device)


def join_launched_group(device) -> None:
    """Join the process group that torchrun or SLURM started this process
    in (nothing for a single process)."""
    if launch.launched_world() > 1 and not dist.is_initialized():
        launch.initialize_multihost(device=device)


def _main_on_rank(main_fn: Callable, json_path: Optional[str], argv) -> None:
    main_fn(json_path, argv)


def spawn_ranks(main_fn: Callable, mesh: Mesh, device, json_path, argv) -> None:
    """Run ``main_fn(json_path, argv)`` on the mesh's ranks (this host,
    one card each; gloo on the CPU) and wait for them."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    launch.spawn(_main_on_rank, mesh.shape["data"], device=device,
                 args=(main_fn, json_path, argv))


def prepare(args: argparse.Namespace, logger_name: str = "train",
            default_seed: Optional[int] = None, restart: bool = False) -> Run:
    """Parse the option file, make the run's folders (``restart`` wipes the
    task folder first), log, seed, build the trainer and the train loader,
    and resume from the newest ``_G`` checkpoint (or ``pretrained_netG``;
    reference main_train_psnr.py:63-69). Without ``train.manual_seed`` the
    seed is ``default_seed`` when given (a ``manual_seed`` of 0 too, as the
    SPECT CLI reads it), else drawn at random. Under several ranks
    (``choose_mesh``) rank 0 alone touches the run's folders and logs;
    when the ranks are still to be spawned, the Run has neither a trainer
    nor a loader."""
    join_launched_group(args.device)
    opt = opt_util.parse(args.opt, is_train=True)
    main = launch.is_main_process()
    if restart and main and os.path.isdir(opt["path"]["task"]):
        shutil.rmtree(opt["path"]["task"])
    if main:
        for d in ("models", "images", "options", "log"):
            os.makedirs(opt["path"].get(d) or opt["path"]["task"],
                        exist_ok=True)
        opt_util.save(opt)
    launch.barrier()
    logger = rank_logger(logger_name,
                         os.path.join(opt["path"]["log"], "train.log"))
    logger.info(opt_util.dict2str(opt))

    seed = opt["train"].get("manual_seed")
    if default_seed is not None:
        seed = seed or default_seed
    elif seed is None:
        seed = random.randint(1, 10000)
    logger.info(f"Random seed: {seed}")
    np.random.seed(seed)
    torch.manual_seed(seed)

    ds_opt = opt["datasets"].get("train")
    if ds_opt is None:
        raise ValueError(f"{args.opt}: no 'train' entry under 'datasets'")
    max_iter = args.max_steps or opt["train"].get("max_iter") or 10 ** 8
    mesh = choose_mesh(opt, args.device, logger.info)
    if mesh is not None and not dist.is_initialized():
        return Run(opt, logger, seed, None, None, 0, max_iter, mesh)

    train_loader = make_train_loader(ds_opt, train_batch_size(ds_opt),
                                     seed=seed, info=logger.info)
    exact_f32(args.device, DTYPES[args.dtype])
    trainer = build_trainer(opt, dtype=DTYPES[args.dtype], device=args.device)
    init_iter, init_path = opt_util.find_last_checkpoint(
        opt["path"]["models"], "G",
        pretrained_path=opt["path"].get("pretrained_netG"))
    if init_path and os.path.exists(init_path):
        logger.info(f"resume from {init_path} @ {init_iter}")
        trainer.resume(init_path, init_iter)
    if mesh is not None:
        trainer.use_mesh(mesh)
    return Run(opt, logger, seed, trainer, train_loader, int(init_iter),
               max_iter, mesh)


def train_loop(run: Run, save_every: int, test_every: int, prune: bool,
               on_test: Optional[Callable[[int, int], None]] = None
               ) -> PlainTrainer:
    """Step from ``run.init_iter`` to ``run.max_iter``: the regularizers
    after each step, a log line every ``train.checkpoint_print`` steps,
    checkpoints every ``save_every`` (the older ones pruned when
    ``prune``), ``on_test(step, epoch)`` every ``test_every``, and the
    last step saved. Under a mesh each rank steps on its rows of the
    batch; rank 0 alone saves and tests while the others wait."""
    trainer, logger = run.trainer, run.logger
    main = launch.is_main_process()
    models = run.opt["path"]["models"]
    print_every = run.opt["train"].get("checkpoint_print") or 200
    step = run.init_iter
    t0 = time.time()
    for epoch in range(10 ** 9):
        for batch in run.train_loader.epoch(epoch + run.seed):
            if step >= run.max_iter:
                logger.info("reached max_iter, stopping")
                if main:
                    trainer.save(models, step)
                return trainer
            step += 1
            if run.mesh is not None:
                batch = shard_batch(run.mesh, batch)
            metrics = trainer.train_step(batch)
            trainer.apply_regularizers(step)

            if step % print_every == 0:
                lr = trainer.current_lr(step)
                ips = (step - run.init_iter) / max(time.time() - t0, 1e-9)
                logger.info(f"<epoch:{epoch:3d}, iter:{step:8,d}, "
                            f"lr:{lr:.3e}> G_loss: {float(metrics['G_loss']):.3e} "
                            f"it/s: {ips:.2f}")
            if step % save_every == 0 and main:
                logger.info("Saving the model.")
                trainer.save(models, step)
                if prune:
                    for tag in ("G", "E", "optimizerG"):
                        ck.prune_old(models, tag, step)
            if on_test is not None and step % test_every == 0:
                if main:
                    on_test(step, epoch)
                launch.barrier()


def main(json_path: Optional[str] = None, argv=None
         ) -> Optional[PlainTrainer]:
    """Train; returns the trainer (None where this process spawned the
    ranks that trained)."""
    args = make_parser(json_path).parse_args(argv)
    run = prepare(args)
    if run.trainer is None:
        spawn_ranks(main, run.mesh, args.device, json_path, argv)
        return None
    opt, logger = run.opt, run.logger
    ds_opt = opt["datasets"].get("test")
    test_loader = (Loader(define_dataset(ds_opt), 1, shuffle=False,
                          drop_last=False) if ds_opt else None)
    test_is_video = "video" in ((ds_opt or {}).get("dataset_type") or
                                "").lower()
    border = opt.get("scale") or 1

    def on_test(step: int, epoch: int) -> None:
        if test_is_video:
            psnr, ssim = evaluate_video(run.trainer, test_loader, opt, logger)
        else:
            psnr, ssim = evaluate(run.trainer, test_loader, border=border)
        logger.info(f"<epoch:{epoch:3d}, iter:{step:8,d}, "
                    f"Average PSNR : {psnr:<.2f}dB, SSIM : {ssim:<.4f}")

    ot = opt["train"]
    return train_loop(run, save_every=ot.get("checkpoint_save") or 5000,
                      test_every=ot.get("checkpoint_test") or 5000,
                      prune=bool(ot.get("keep_only_latest")),
                      on_test=on_test if test_loader is not None else None)


if __name__ == "__main__":
    main()
