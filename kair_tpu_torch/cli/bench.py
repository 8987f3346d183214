"""SwinIR-M ×4 classical-SR throughput on one card (the port's counterpart
of the root ``bench.py``, which stays the JAX package's).

    python -m kair_tpu_torch.cli.bench [--profile]

SwinIR-M ×4 (embed 180, depths 6×6, 6 heads, window 8, MLP ratio 2,
pixelshuffle head; docs/README_SwinIR.md classical SR) with seeded weights,
bf16, the fused block kernels, on a seeded batch of 16 128×128 LR images;
ten forwards timed by CUDA events after two warm-ups (``utils/timing``,
the median). Prints one JSON line: ``metric``, ``value``
(LR MP/s), ``unit``, ``vs_baseline`` (null: KAIR publishes no MP/s),
``tflops`` and ``mfu`` (``utils/summary.swinir_flops_per_lr_pixel``,
26,150,616 FLOP a LR pixel, over the card's dense bf16 peak; null on an
unknown card), ``device_kind``, ``flops_per_lr_pixel``, ``ms_per_forward``
and ``ms_min`` (the least launch).
``--profile`` adds ``profile``: device ms by kernel and the idle share of
one forward (torch.profiler). ``--batch`` changes the batch (1 profiles the
latency case). ``--device cpu`` runs the plain versions in f32 (a CPU
time).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

SIZE = 128      # LR side
ITERS = 10      # timed forwards


def build_swinir_m(fuse: bool = True) -> nn.Module:
    """SwinIR-M ×4 with its own seeded initialisation, f32 on the CPU."""
    from kair_tpu_torch.cli.test import SWINIR_X4
    from kair_tpu_torch.models.swinir import SwinIR
    torch.manual_seed(0)
    return SwinIR(img_size=64, fuse_block=fuse, **SWINIR_X4)


def main(argv=None, build: Optional[Callable[[], nn.Module]] = None) -> dict:
    """``build``: () → module (default :func:`build_swinir_m`). The FLOP
    count is SwinIR-M ×4's, so with another ``build`` ``tflops``, ``mfu``
    and ``flops_per_lr_pixel`` are null."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--profile", action="store_true",
                        help="device ms by kernel and the idle share of one "
                             "forward (torch.profiler)")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from kair_tpu_torch import default_device
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              swinir_flops_per_lr_pixel)
    from kair_tpu_torch.utils.timing import device_profile, median_min_ms

    dev = default_device(args.device)
    cuda = dev.type == "cuda"
    model = (build or build_swinir_m)().eval().to(
        dev, torch.bfloat16 if cuda else torch.float32)
    x = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch, SIZE, SIZE, 3).astype(np.float32)).to(dev)
    with torch.inference_mode():
        ms, ms_min = median_min_ms(lambda: model(x), ITERS, 2, cuda)
    mp_s = args.batch * SIZE * SIZE / (ms / 1e3) / 1e6
    fppx = None if build else swinir_flops_per_lr_pixel()
    tflops = mp_s * 1e6 * fppx / 1e12 if fppx else None
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = peak_bf16_tflops(kind) if cuda else None
    report = {
        "metric": "SwinIR-M x4 SR throughput (LR megapixels/sec/chip, "
                  f"{'bf16' if cuda else 'f32'}, B={args.batch} of "
                  f"{SIZE}x{SIZE})",
        "value": round(mp_s, 4),
        "unit": "MP/s/chip" if cuda else "MP/s (cpu)",
        "vs_baseline": None,
        "tflops": round(tflops, 3) if tflops else None,
        "mfu": round(tflops / peak, 4) if tflops and peak else None,
        "device_kind": kind,
        "flops_per_lr_pixel": round(fppx) if fppx else None,
        "ms_per_forward": round(ms, 3),
        "ms_min": round(ms_min, 3),
    }
    if args.profile and cuda:
        with torch.inference_mode():
            report["profile"] = device_profile(lambda: model(x), 1, ms)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
