"""Where the DCN kernel's cycles go, on the card.

    python -m kair_tpu_torch.cli.profile_dcn [--reps 20]

Builds ``csrc/`` with ``-DKAIR_PROFILE`` into a library of its own (the
normal build has no marks) and runs ``csrc/dcn_block.cu`` at VRT-001's call
(Cin 120, Cout 120, 12 groups) on 64x64 and 8x8 at N=1 and on 64x64 at
N=8, and at presets 003-004's cg 15 (Cin 240, 16 groups) on 64x64 at N=1,
bf16, seeded offsets of up to ±6 px. For each it prints, beside the card's
name and power limit, the tiles and splits, the device time of the call's
kernels (torch.profiler, ``--reps`` calls) and the SM clock cycles that
thread 0 of each block spent in each stage (the tap table, waiting at its
barrier, the column tile, waiting at its barrier, waiting for the weight
stage, the products), averaged over the blocks, with each stage's share.
The profile build's marks cost a little time: read the shares.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.dcn_block import (_launch, dcn_splits,
                                                  pack_dcn_weight)

STAGES = ("table", "table barrier", "columns", "columns barrier",
          "weight wait", "products")
CASES = (  # (what, N, H, W, Cin, Cout, dg)
    ("VRT-001 stage 1", 1, 64, 64, 120, 120, 12),
    ("VRT-001 8x8", 1, 8, 8, 120, 120, 12),
    ("VRT-001 stage 1 B=8", 8, 64, 64, 120, 120, 12),
    ("cg 15 stage 1", 1, 64, 64, 240, 120, 16),
)


def device_ms(fn, reps: int) -> float:
    """Device ms per call of fn()'s kernels, from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_dcn needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    lib = _build.library(profile=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    counts = (ctypes.c_ulonglong * len(STAGES))()
    g = torch.Generator().manual_seed(args.seed)
    print(f"{card}; bf16, {args.reps} calls per reading")
    for what, n, h, w, cin, cout, dg in CASES:
        x = torch.randn(n, h, w, cin, generator=g).to(dev, torch.bfloat16)
        off = (torch.rand(n, h, w, dg * 18, generator=g) * 12 - 6).to(dev)
        mask = torch.sigmoid(torch.randn(n, h, w, dg * 9, generator=g)).to(dev)
        wt = torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5
        pk = pack_dcn_weight(wt.to(dev), dg)
        bias = (torch.randn(cout, generator=g) * 0.1).to(dev)
        tiles, splits = dcn_splits(n, h, w, cin, dg, sms)

        def run():
            _launch(lib, x, off, mask, pk, bias, dg, splits)

        ms = device_ms(run, args.reps)
        torch.cuda.synchronize()
        _build.check(lib.kair_dcn_stage_cycles(counts), "counters")
        for _ in range(args.reps):
            run()
        torch.cuda.synchronize()
        _build.check(lib.kair_dcn_stage_cycles(counts), "counters")
        per_block = [v / (tiles * splits * args.reps) for v in counts]
        total = sum(per_block)
        print(f"{what} ({n}x{h}x{w}, {cin}->{cout}, dg {dg}): {tiles} tiles x "
              f"{splits} splits; device {ms:.4f} ms a call; cycles per block "
              f"(thread 0) {total:.0f}: " + ", ".join(
                  f"{s} {v:.0f} ({v / total:.3f})"
                  for s, v in zip(STAGES, per_block)))


if __name__ == "__main__":
    main()
