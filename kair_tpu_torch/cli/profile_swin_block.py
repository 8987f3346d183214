"""Per-stage cycle profile of the fused Swin-block kernel on the card.

    python -m kair_tpu_torch.cli.profile_swin_block [--batch 16] [--size 128]

Builds ``csrc/`` with ``-DKAIR_PROFILE`` into a library of its own (the
normal build has no marks), runs the kernel at SwinIR-M width (C=180, 6
heads, hidden 360, bf16) on a seeded B×size×size map, shifted (phase +4,
shift mask) and unshifted, and prints the SM clock cycles that each stage
took per thread block, averaged over the blocks of ``--reps`` launches, with
each stage's share, beside the card's name and power limit. Every thread
block waits at a barrier before each mark, so a stage's count includes its
slowest warp's wait.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams, _launch,
                                                    pack_swin_block)
from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor

STAGES = ("load", "LN1", "qkv", "QK", "softmax", "PV", "proj", "LN2",
          "fc1", "fc2")


def seeded_params(c: int, nh: int, hidden: int, seed: int,
                  device) -> SwinBlockParams:
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=0.05, mean=0.0):
        return (torch.randn(*shape, generator=g) * std + mean).to(
            device, torch.bfloat16)

    return SwinBlockParams(
        rnd(3 * c, c, std=0.1), rnd(3 * c), rnd(c, c), rnd(c),
        rnd(225, nh, std=0.5), rnd(c, mean=1.0), rnd(c), rnd(c, mean=1.0),
        rnd(c), rnd(hidden, c), rnd(hidden), rnd(c, hidden), rnd(c))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_swin_block needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    c, nh, hidden, s = 180, 6, 360, args.size
    p = seeded_params(c, nh, hidden, args.seed, dev)
    pk = pack_swin_block(p, nh)
    g = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn(args.batch, s, s, c, generator=g).to(dev, torch.bfloat16)
    out = torch.empty_like(x)
    lib = _build.library(profile=True)
    counts = (ctypes.c_ulonglong * len(STAGES))()
    blocks = args.batch * (s // 8) ** 2 * args.reps
    print(f"{card}; B={args.batch} {s}x{s} C={c} nh={nh} hidden={hidden} "
          f"bf16, {args.reps} launches of {blocks // args.reps} blocks")
    for name, phase, mask in (("shifted", 4, shift_mask_tensor(s, s, 8, 4, dev)),
                              ("plain", 0, None)):
        _launch(lib, x, out, pk, nh, mask, phase)         # warm-up
        torch.cuda.synchronize()
        _build.check(lib.kair_swin_stage_cycles(counts), "stage counters")
        for _ in range(args.reps):
            _launch(lib, x, out, pk, nh, mask, phase)
        torch.cuda.synchronize()
        _build.check(lib.kair_swin_stage_cycles(counts), "stage counters")
        per_block = [v / blocks for v in counts]
        total = sum(per_block)
        print(f"{name}: {total:.0f} cycles/block: " + ", ".join(
            f"{st} {v:.0f} ({v / total:.1%})"
            for st, v in zip(STAGES, per_block)), flush=True)


if __name__ == "__main__":
    main()
