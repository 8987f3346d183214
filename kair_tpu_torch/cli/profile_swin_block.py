"""Where the fused Swin-block kernel's cycles go, on the card
(``csrc/swin_block_wgmma.cu``).

    python -m kair_tpu_torch.cli.profile_swin_block [--reps 10]

Builds ``csrc/`` with ``-DKAIR_PROFILE`` into a library of its own (the
normal build has no marks) and runs the kernel at SwinIR-M width (C=180,
6 heads, hidden 360, bf16, seeded): B=16 of 128×128 at window 8 and B=8 of
126×126 at window 7 (JPEG-CAR), shifted (with the shift mask). For each it
prints, beside the card's name and power limit, the kernel's time in the
profile build (CUDA events, median of ``--reps``) in full and with the
products only (the weight ring and the qkv, proj, fc1 and fc2 wgmmas,
nothing else); and, with the stage marks on, the SM clock cycles that
thread 0 of consumer warpgroup 0 of each thread block spent in each stage
(load + LN1, waiting for a weight stage, qkv, attention, proj, LN2, MLP,
store), averaged over the blocks, with each stage's share. The profile
build reads its mode at run time, which costs registers, so it runs slower
than the normal build: read its shares, and time the kernel with
``ab_kernels.py`` or ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess

import torch

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams, _launch,
                                                    grid_blocks,
                                                    pack_swin_block)
from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor

STAGES = ("load+LN1", "ring wait", "qkv", "attention", "proj", "LN2", "MLP",
          "store")
SHAPES = (("SwinIR-M ws 8", 16, 128, 8, 4), ("JPEG-CAR ws 7", 8, 126, 7, 3))


def seeded_params(c: int, nh: int, hidden: int, seed: int, device,
                  ws: int = 8) -> SwinBlockParams:
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=0.05, mean=0.0):
        return (torch.randn(*shape, generator=g) * std + mean).to(
            device, torch.bfloat16)

    return SwinBlockParams(
        rnd(3 * c, c, std=0.1), rnd(3 * c), rnd(c, c), rnd(c),
        rnd((2 * ws - 1) ** 2, nh, std=0.5), rnd(c, mean=1.0), rnd(c),
        rnd(c, mean=1.0), rnd(c), rnd(hidden, c), rnd(hidden), rnd(c, hidden),
        rnd(c))


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


def split(counts, names, blocks: float) -> str:
    per_block = [v / blocks for v in counts]
    total = sum(per_block)
    return f"{total:.0f} cycles/block: " + ", ".join(
        f"{n} {v:.0f} ({v / total:.3f})" for n, v in zip(names, per_block))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_swin_block needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    c, nh, hidden = 180, 6, 360
    lib = _build.library(profile=True)
    wg = (ctypes.c_ulonglong * len(STAGES))()
    print(f"{card}; C={c} nh={nh} hidden={hidden} bf16, shifted, {args.reps} "
          "launches per reading")
    for what, b, s, ws, phase in SHAPES:
        p = seeded_params(c, nh, hidden, args.seed, dev, ws)
        pk = pack_swin_block(p, nh)
        g = torch.Generator().manual_seed(args.seed + 1)
        x = torch.randn(b, s, s, c, generator=g).to(dev, torch.bfloat16)
        out = torch.empty_like(x)
        mask = shift_mask_tensor(s, s, ws, phase, dev)
        windows = b * (s // ws) ** 2
        runs = args.reps + 2

        ms = {}
        for mode in (0, 1, 2):      # full, products only, marks
            _build.check(lib.kair_swin_wg_cycles(wg, mode), "counters")
            ms[mode] = timed(lambda: _launch(lib, x, out, pk, nh, mask, phase,
                                             ws), args.reps)
            _build.check(lib.kair_swin_wg_cycles(wg, mode), "counters")
        reset = (ctypes.c_ulonglong * len(STAGES))()
        _build.check(lib.kair_swin_wg_cycles(reset, 0), "counters")
        print(f"{what} B={b} {s}x{s}, wgmma: {windows} windows on "
              f"{grid_blocks(windows, sms)} blocks; {ms[0]:.4f} ms, products "
              f"only {ms[1]:.4f} ms ({ms[1] / ms[0]:.3f}); with the marks "
              f"{ms[2]:.4f} ms, warpgroup 0 "
              + split(wg, STAGES, grid_blocks(windows, sms) * runs), flush=True)


if __name__ == "__main__":
    main()
