"""Where the Swin-block backward's cycles go, on the card
(``csrc/swin_block_bwd_wgmma.cu``).

    python -m kair_tpu_torch.cli.profile_swin_bwd [--reps 10]

Builds ``csrc/`` with ``-DKAIR_PROFILE`` into a library of its own (the
normal build has no marks) and runs the backward at SwinIR-M's training
shape (B=32 of 48x48, C=180, 6 heads, hidden 360, bf16 activations, f32
parameters, seeded, shifted: phase 4 with the shift mask). It prints,
beside the card's name and power limit, the profile build's time (CUDA
events, median of ``--reps``) and the SM clock cycles that thread 0 of
consumer warpgroup 0 of each pass-1 thread block spent in each stage (load +
LN1, waiting for a weight stage, the recompute's products and LN2, attention
forward, MLP backward, attention backward, dqkv Wqkv^T and the LN1
backward, stores of the weight-grad operands, waiting for a head's tiles,
the score-bias and LayerNorm partial sums), averaged over the blocks,
with each stage's share. The marks cost registers and instructions, so the
profile build runs slower than the normal one: read its shares, and time
the kernel with ``ab_kernels.py`` or ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.swin_block import (_launch_bwd, grid_blocks,
                                                    ln_params,
                                                    pack_swin_block)
from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
from kair_tpu_torch.cli.profile_swin_block import seeded_params, split, timed

STAGES = ("load+LN1", "ring wait", "recompute", "attention fwd", "MLP bwd",
          "attention bwd", "dqkv Wqkv^T + LN1 bwd", "operand stores",
          "head-tile wait", "partial sums")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_swin_bwd needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, s, c, nh, hidden, phase = 32, 48, 180, 6, 360, 4
    lib = _build.library(profile=True)
    p = seeded_params(c, nh, hidden, args.seed, dev)
    p = type(p)(*[t.float() for t in p])
    pk = pack_swin_block(p, nh, folded=False)
    ln = ln_params(p)
    g = torch.Generator().manual_seed(args.seed + 1)
    x = torch.randn(b, s, s, c, generator=g).to(dev, torch.bfloat16)
    dy = torch.randn(b, s, s, c, generator=g).to(dev, torch.bfloat16)
    mask = shift_mask_tensor(s, s, 8, 4, dev)
    windows = b * (s // 8) ** 2
    counts = (ctypes.c_ulonglong * len(STAGES))()
    _build.check(lib.kair_swin_bwd_cycles(counts), "counters")
    ms = timed(lambda: _launch_bwd(lib, x, dy, pk, ln, nh, hidden, mask, phase),
               args.reps)
    _build.check(lib.kair_swin_bwd_cycles(counts), "counters")
    blocks = grid_blocks(windows, sms) * (args.reps + 2)
    print(f"{card}; C={c} nh={nh} hidden={hidden}, B={b} {s}x{s} phase "
          f"{phase}, {windows} windows on {grid_blocks(windows, sms)} blocks: "
          f"profile build {ms:.4f} ms a call (passes 1 and 2 and the sums); "
          "warpgroup 0 " + split(counts, STAGES, blocks), flush=True)


if __name__ == "__main__":
    main()
