"""Training-step throughput of VRT-001 on the card (counterpart of the VRT
branch of ``kair_tpu/cli/train_bench.py``, :78-99).

    python -m kair_tpu_torch.cli.train_bench --net vrt --deform mxu --fuse \
        --remat --batch 8

Builds ``VideoTrainer`` on the released 001 REDS recipe's network (6-frame
clips, 64x64 LR crops, x4, embed 120x7 + 180x6, depths 8x7 + 4x6, 12
deformable groups; Charbonnier loss, Adam at 4e-4, fix_iter 20000 over
spynet and deform) in bf16, feeds one seeded batch, and times ``--steps``
training steps with CUDA events after two warm-up steps. Prints one JSON
line with the JAX package's keys (``step_ms``, ``steps_per_s``,
``patches_per_s``, ``megapixels_per_s`` over LR patches as it counts them,
``device``) plus ``mfu`` (3 x the analytic forward FLOP of
``utils/summary.vrt_flops_per_clip`` per clip over the card's bf16 peak;
recompute not counted) and ``peak_mem_gib``. ``--deform`` picks the
alignment's sampler (``gather``, ``mxu``: the bilinear kernels, ``fused``:
the DCN kernel); ``--fuse`` the TMSA and self block kernels; ``--remat``
KAIR's ``use_checkpoint_attn``. ``--device cpu`` runs the plain versions
in f32 (a timing there is the CPU's, not the card's).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# the network of options/vrt/001_train_vrt_videosr_bi_reds_6frames.json
VRT_NET = {"net_type": "vrt", "upscale": 4, "img_size": [6, 64, 64],
           "window_size": [6, 8, 8], "depths": [8] * 7 + [4] * 6,
           "indep_reconsts": [11, 12], "embed_dims": [120] * 7 + [180] * 6,
           "num_heads": [6] * 13, "pa_frames": 2, "deformable_groups": 12}
FRAMES = 6
WARMUP = 2


def main(argv=None) -> dict:
    from kair_tpu_torch import default_device
    from kair_tpu_torch.train.video import VideoTrainer
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              vrt_flops_per_clip)

    parser = argparse.ArgumentParser()
    parser.add_argument("--net", choices=["vrt"], default="vrt")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--patch", type=int, default=64)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--deform", choices=["gather", "mxu", "fused"],
                        default="gather")
    parser.add_argument("--fuse", action="store_true",
                        help="the TMSA and self block kernels")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the block pairs in the backward")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = default_device(args.device)
    netg = {**VRT_NET, "fuse_block": bool(args.fuse),
            "use_checkpoint_attn": bool(args.remat),
            "deform_impl": args.deform}
    opt = {"netG": netg,
           "train": {"G_lossfn_type": "charbonnier", "G_optimizer_lr": 4e-4,
                     "G_scheduler_milestones": [10 ** 9], "E_decay": 0,
                     "fix_iter": 20000, "fix_keys": ["spynet", "deform"],
                     "fix_lr_mul": 0.125}}
    torch.manual_seed(0)
    trainer = VideoTrainer(opt, device=device)
    rng = np.random.RandomState(0)
    p = args.patch
    batch = {"L": torch.from_numpy(rng.rand(args.batch, FRAMES, p, p, 3)
                                   .astype(np.float32)).to(device),
             "H": torch.from_numpy(rng.rand(args.batch, FRAMES, 4 * p, 4 * p, 3)
                                   .astype(np.float32)).to(device)}
    for _ in range(WARMUP):
        trainer.train_step(batch)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        loss = trainer.train_step(batch)["G_loss"]
    if cuda:
        e.record()
        torch.cuda.synchronize()
        per_step = s.elapsed_time(e) / 1e3 / args.steps
    else:
        float(loss)
        per_step = (time.perf_counter() - t0) / args.steps
    report = {
        "net": args.net, "batch": args.batch, "patch": p,
        "dtype": "bf16" if trainer.dtype == torch.bfloat16 else "f32",
        "deform": args.deform, "fuse": bool(args.fuse),
        "remat": bool(args.remat),
        "step_ms": round(per_step * 1e3, 3),
        "steps_per_s": round(1.0 / per_step, 2),
        "patches_per_s": round(args.batch / per_step, 1),
        "megapixels_per_s": round(args.batch * p * p / per_step / 1e6, 3),
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "mfu": None, "peak_mem_gib": None}
    if cuda:
        peak = peak_bf16_tflops(report["device"])
        flops = 3 * vrt_flops_per_clip(frames=FRAMES, h=p, w=p) * args.batch
        if peak:
            report["mfu"] = round(flops / per_step / 1e12 / peak, 4)
        report["peak_mem_gib"] = round(
            torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
