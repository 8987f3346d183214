"""Where the conv tail kernel's cycles go, on the card.

    python -m kair_tpu_torch.cli.profile_conv [--reps 10]

Builds ``csrc/`` with ``-DKAIR_PROFILE`` into a library of its own (the
normal build has no marks) and runs ``csrc/conv_block.cu`` at SwinIR-M's
tail (B=16, 128x128, C=180) and JPEG-CAR's (B=8, 126x126, C=180), bf16,
seeded. For each it prints, beside the card's name and power limit:

* the SM clock cycles that warpgroup 0 of each thread block spent waiting
  for a halo chunk, waiting for a weight stage, in the products (ldmatrix,
  wgmma and its wait) and in the epilogue, averaged over the blocks, with
  each stage's share;
* the kernel's time (CUDA events, median of ``--reps``) in the profile
  build as it is and in its products-only mode (no loads, no epilogue: the
  consumers run the products on whatever shared memory holds), and the
  products' share of the time.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess

import torch

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.conv_block import _launch, pack_conv3x3

STAGES = ("halo wait", "weight wait", "products", "epilogue")
SHAPES = (("SwinIR-M", 16, 128, 128, 0), ("JPEG-CAR", 8, 126, 126, 3))


def timed(fn, reps: int) -> float:
    """Median ms of fn() by CUDA events, after two warm-up runs."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_conv needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    lib = _build.library(profile=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counts = (ctypes.c_ulonglong * len(STAGES))()
    c = 180
    g = torch.Generator().manual_seed(args.seed)
    print(f"{card}; C={c} bf16, {args.reps} launches per reading")
    for what, b, h, w, phase in SHAPES:
        y = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
        res = torch.randn(b, h, w, c, generator=g).to(dev, torch.bfloat16)
        wt = torch.randn(c, c, 3, 3, generator=g) / math.sqrt(9 * c)
        wpk = pack_conv3x3(wt.to(dev))
        bias = (torch.randn(c, generator=g) * 0.1).to(dev)
        out = torch.empty_like(y)
        tiles = b * -(-h // 6) * -(-w // 32)
        blocks = min(tiles, sms)

        def run():
            _launch(lib, y, res, wpk, bias, out, phase)

        res_ms = {}
        for mode in range(2):   # full, products only
            _build.check(lib.kair_conv_stage_cycles(counts, mode), "counters")
            res_ms[mode] = timed(run, args.reps)
            _build.check(lib.kair_conv_stage_cycles(counts, mode), "counters")
            if mode == 0:
                per_block = [v / (blocks * (args.reps + 2)) for v in counts]
        _build.check(lib.kair_conv_stage_cycles(counts, 0), "counters")
        total = sum(per_block)
        flops = 2.0 * b * h * w * 9 * c * c
        print(f"{what} B={b} {h}x{w} phase {phase}: {tiles} tiles on {blocks} "
              f"blocks; cycles per block (warpgroup 0): " + ", ".join(
                  f"{n} {v:.0f} ({v / total:.3f})"
                  for n, v in zip(STAGES, per_block)))
        print(f"{what}: kernel {res_ms[0]:.4f} ms ({flops / res_ms[0] / 1e9:.1f} "
              f"TFLOP/s), products only {res_ms[1]:.4f} ms "
              f"({flops / res_ms[1] / 1e9:.1f} TFLOP/s): the products "
              f"{res_ms[1] / res_ms[0]:.3f} of the time")


if __name__ == "__main__":
    main()
