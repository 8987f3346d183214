"""Training-step throughput on the card (counterpart of
``kair_tpu/cli/train_bench.py``): one seeded batch, ``--steps`` training
steps timed with CUDA events after two warm-up steps.

    python -m kair_tpu_torch.cli.train_bench --net dncnn --batch 64 --patch 64
    python -m kair_tpu_torch.cli.train_bench --net swinir --remat \
        --batch 8 --patch 64 --scale 4
    python -m kair_tpu_torch.cli.train_bench --net vrt --deform mxu --fuse \
        --remat --batch 8

``--net`` takes any CNN-zoo ``net_type`` (dncnn, the default, fdncnn,
ircnn, ffdnet, srmd, dpsr, msrresnet0, msrresnet1, rrdb, rrdbnet, imdn,
drunet, usrnet), ``swinir`` or ``vrt``:

* the zoo nets train through ``PlainTrainer`` (Adam 2e-4, L1, EMA 0.999,
  as the JAX file); ``--in_nc`` is the image's channels and the batch
  carries what each net takes beside it (FFDNet's σ, the noise-level map
  of FDnCNN, DPSR and DRUNet, SRMD's PCA and σ maps, USRNet's kernel, sf
  and σ); ``--nc`` / ``--nb`` override the width and depth (absent: the
  net's own, which for the default DnCNN are the JAX file's 64 / 17);
  ``--scale`` is the SR factor (LR patches of ``--patch``);
* ``swinir``: SwinIR-M's body (embed 180, depths 6x6, 6 heads, window 8,
  MLP ratio 2), pixelshuffle at ``--scale`` > 1, else the denoising head;
  ``--remat`` is KAIR's ``use_checkpoint``. Training always runs the
  block kernels, so ``--fuse`` (the JAX file's switch to its fused block)
  is accepted and changes nothing here;
* ``vrt``: the released 001 REDS recipe's network (6-frame clips, 64x64
  LR crops, x4, embed 120x7 + 180x6, depths 8x7 + 4x6, 12 deformable
  groups; Charbonnier loss, Adam at 4e-4, fix_iter 20000 over spynet and
  deform) through ``VideoTrainer``; ``--deform`` picks the alignment's
  sampler (``gather``, ``mxu``: the bilinear kernels, ``fused``: the DCN
  kernel), ``--fuse`` the TMSA and self block kernels, ``--remat`` KAIR's
  ``use_checkpoint_attn``.

Prints one JSON line with the JAX file's keys (``net``, ``batch``,
``patch``, ``dtype``, ``step_ms``, ``steps_per_s``, ``patches_per_s``,
``megapixels_per_s`` over LR patches, ``device``) plus ``mfu`` (3 x one
forward's FLOP over the card's peak for the dtype, recompute not counted:
the analytic count for SwinIR and VRT, FlopCounterMode's for the zoo) and
``peak_mem_gib``; the VRT line also has ``deform``, ``fuse`` and
``remat``. ``--dtype`` is bf16 (autocast over f32 parameters; the card's
default) or f32 (the CPU's default), which the zoo and SwinIR (its f32
kernels) take on the card and VRT refuses there; f32 on the card runs with
TF32 off (cuDNN and cuBLAS, ``exact_f32``), so that its mfu is over the
f32 peak.
``--device cpu`` runs the plain versions (a timing there is the CPU's, not
the card's; mfu and peak_mem_gib null). ``--profile DIR`` traces one more
step after the timed ones (``utils/profiling``: a Chrome trace in DIR)
and prints its top operators to stderr.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from kair_tpu_torch import exact_f32

# the network of options/vrt/001_train_vrt_videosr_bi_reds_6frames.json
VRT_NET = {"net_type": "vrt", "upscale": 4, "img_size": [6, 64, 64],
           "window_size": [6, 8, 8], "depths": [8] * 7 + [4] * 6,
           "indep_reconsts": [11, 12], "embed_dims": [120] * 7 + [180] * 6,
           "num_heads": [6] * 13, "pa_frames": 2, "deformable_groups": 12}
# SwinIR-M's body, as the JAX file builds it
SWINIR_NET = {"net_type": "swinir", "embed_dim": 180, "depths": [6] * 6,
              "num_heads": [6] * 6, "window_size": 8, "mlp_ratio": 2.0}
FRAMES = 6
WARMUP = 2
# zoo nets whose input carries a noise-level map, and SRMD's 15 PCA
# channels beside it
SIGMA_MAP = ("fdncnn", "dpsr", "drunet", "srmd")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def zoo_setup(args, rng):
    """(netG, trainer extra keys, batch) of a zoo net on one seeded batch."""
    from kair_tpu_torch.degrade import sisr
    net, c, p, s, b = args.net, args.in_nc, args.patch, args.scale, args.batch
    extra = {"srmd": 16}.get(net, 1 if net in SIGMA_MAP else 0)
    netg = {"net_type": net, "in_nc": c + extra + (net == "usrnet"),
            "out_nc": c, "scale": s, "upscale": s, "sf": s}
    if args.nc is not None:
        netg["nc" if net != "rrdbnet" else "nf"] = args.nc
    if args.nb is not None:
        netg["nb"] = args.nb
    lr = rng.rand(b, p, p, c).astype(np.float32)
    batch = {"L": lr, "H": rng.rand(b, p * s, p * s, c).astype(np.float32)}
    sigma = np.full((b, 1, 1, 1), 25 / 255, np.float32)
    if extra:
        maps = [np.broadcast_to(sigma, (b, p, p, 1))]
        if net == "srmd":
            pca = sisr.pca_project(sisr.anisotropic_gaussian(15),
                                   sisr.load_srmd_pca()).astype(np.float32)
            maps.insert(0, np.broadcast_to(pca, (b, p, p, 15)))
        batch["L"] = np.concatenate([lr] + maps, -1)
    keys = ()
    if net == "ffdnet":
        batch["C"], keys = sigma, ("C",)
    elif net == "usrnet":
        k = sisr.load_kernels_12()[0].astype(np.float32)
        batch.update(k=np.broadcast_to((k / k.sum())[None, :, :, None],
                                       (b,) + k.shape + (1,)).copy(),
                     sf=[s] * b, sigma=sigma)
        keys = ("k", "sf", "sigma")
    return netg, keys, batch


def zoo_flops(trainer, batch) -> int:
    """One forward's FLOP of the trainer's model on the batch, counted in
    eval mode (BatchNorm's running statistics stay as they are)."""
    from kair_tpu_torch.cli.challenge import count_flops
    trainer.model.eval()
    try:
        return count_flops(trainer.model, *trainer._args(batch))
    finally:
        trainer.model.train()


def main(argv=None) -> dict:
    from kair_tpu_torch import default_device
    from kair_tpu_torch.train.trainer import PlainTrainer
    from kair_tpu_torch.train.video import VideoTrainer
    from kair_tpu_torch.utils.summary import (PEAKS, card_for_device_name,
                                              swinir_flops_per_lr_pixel,
                                              vrt_flops_per_clip)

    parser = argparse.ArgumentParser()
    parser.add_argument("--net", default="dncnn",
                        help="a zoo net_type, swinir or vrt")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--patch", type=int, default=64)
    parser.add_argument("--in_nc", type=int, default=1)
    parser.add_argument("--nc", type=int, default=None)
    parser.add_argument("--nb", type=int, default=None)
    parser.add_argument("--scale", type=int, default=1)
    parser.add_argument("--dtype", choices=list(DTYPES), default=None,
                        help="bf16 (the card's default) or f32 (the CPU's)")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--deform", choices=["gather", "mxu", "fused"],
                        default="gather")
    parser.add_argument("--fuse", action="store_true",
                        help="vrt: the TMSA and self block kernels; "
                             "swinir: accepted for the JAX file's flags, "
                             "changes nothing (training always runs the "
                             "block kernels)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the blocks in the backward "
                             "(swinir: use_checkpoint, vrt: "
                             "use_checkpoint_attn)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="trace one step after the timed ones into DIR "
                             "(torch.profiler) and print its top operators")
    args = parser.parse_args(argv)

    device = default_device(args.device)
    dtype = DTYPES.get(args.dtype)
    # f32 as it is, not TF32: the mfu below divides by the f32 peak
    exact_f32(device, dtype)
    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    p = args.patch
    report = {"net": args.net, "batch": args.batch, "patch": p}
    if args.net == "vrt":
        opt = {"netG": {**VRT_NET, "fuse_block": bool(args.fuse),
                        "use_checkpoint_attn": bool(args.remat),
                        "deform_impl": args.deform},
               "train": {"G_lossfn_type": "charbonnier",
                         "G_optimizer_lr": 4e-4,
                         "G_scheduler_milestones": [10 ** 9], "E_decay": 0,
                         "fix_iter": 20000, "fix_keys": ["spynet", "deform"],
                         "fix_lr_mul": 0.125}}
        trainer = VideoTrainer(opt, dtype=dtype, device=device)
        batch = {"L": rng.rand(args.batch, FRAMES, p, p, 3).astype(np.float32),
                 "H": rng.rand(args.batch, FRAMES, 4 * p, 4 * p, 3)
                 .astype(np.float32)}
        flops = lambda: vrt_flops_per_clip(frames=FRAMES, h=p, w=p) * args.batch
        report.update(deform=args.deform, fuse=bool(args.fuse),
                      remat=bool(args.remat))
    else:
        train = {"G_lossfn_type": "l1", "G_optimizer_lr": 2e-4,
                 "G_scheduler_milestones": [10 ** 9], "E_decay": 0.999}
        if args.net == "swinir":
            s = args.scale
            netg = {**SWINIR_NET, "in_nc": args.in_nc, "upscale": s,
                    "img_size": p, "use_checkpoint": bool(args.remat),
                    "upsampler": "pixelshuffle" if s > 1 else ""}
            keys = ()
            batch = {"L": rng.rand(args.batch, p, p, args.in_nc)
                     .astype(np.float32),
                     "H": rng.rand(args.batch, p * s, p * s, args.in_nc)
                     .astype(np.float32)}
            flops = lambda: swinir_flops_per_lr_pixel(
                in_chans=args.in_nc, upscale=s, upsampler=netg["upsampler"]
            ) * args.batch * p * p
        else:
            netg, keys, batch = zoo_setup(args, rng)
            flops = lambda: zoo_flops(trainer, batch)
        trainer = PlainTrainer({"netG": netg, "train": train},
                               extra_keys=keys, dtype=dtype, device=device)
        batch = {k: v if isinstance(v, list) else torch.from_numpy(v).to(device)
                 for k, v in batch.items()}

    report["dtype"] = "bf16" if trainer.dtype == torch.bfloat16 else "f32"
    for _ in range(WARMUP):
        trainer.train_step(batch)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s_ev, e_ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        s_ev.record()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = trainer.train_step(batch)["G_loss"]
    if cuda:
        e_ev.record()
        torch.cuda.synchronize()
        per_step = s_ev.elapsed_time(e_ev) / 1e3 / args.steps
    else:
        float(loss)
        per_step = (time.perf_counter() - t0) / args.steps
    if args.profile:
        import sys
        from kair_tpu_torch.utils.profiling import print_trace_summary, trace
        with trace(args.profile):
            trainer.train_step(batch)
        print_trace_summary(args.profile,
                            printer=lambda *a: print(*a, file=sys.stderr))
    report.update({
        "step_ms": round(per_step * 1e3, 3),
        "steps_per_s": round(1.0 / per_step, 2),
        "patches_per_s": round(args.batch / per_step, 1),
        "megapixels_per_s": round(args.batch * p * p / per_step / 1e6, 3),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "mfu": None, "peak_mem_gib": None})
    if cuda:
        card = card_for_device_name(report["device"])
        if card:
            peak = PEAKS[card]["bf16_tflops" if trainer.dtype == torch.bfloat16
                               else "fp32_tflops"]
            report["mfu"] = round(3 * flops() / per_step / 1e12 / peak, 4)
        report["peak_mem_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
