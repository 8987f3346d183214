"""Time the Swin-block, conv-tail, bilinear-sampler and 3-D window-block
kernels of two checkouts on one card.

    python3 ab_kernels.py <other checkout>

Runs phases 2 (``swin_block``, the block at window 8), 3 (``conv3x3``), 6
(``swin_bwd``, the block's backward), 8 (``swin_win``, the block below
window 8), 9 (``window_msa``, attention only), 13 (``tmsa``, VRT's TMSA
block), 14 (``self6``, VRT's self block), 17 (``stl2``, RVRT's STL2 block)
and 20 (``bilin``) of each checkout's own ``chip_smoke.py``, each
checkout in a fresh process whose working directory is that checkout (so
each builds and loads its own kernels), in turns: other, this, this,
other; then, in each checkout, VRT's TMSA and self blocks at the training
step's B=8 calls (8x6x64x64: TMSA C=120, self C=120 and C=180 at wd 6)
through that checkout's own wrappers and weight pack. It prints the card's
name and power limit, then each run's phase lines: kernel, plain-version
and library times, bounds and errors, as that checkout's phases report
them. Comparing two kernel versions is only
sound inside one such call, on one card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SNIPPET = """
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
import chip_smoke
from kair_tpu_torch.ops.kernels import _build
_build.library()
chip_smoke.phase_swin([])
chip_smoke.phase_conv([])
chip_smoke.phase_swin_bwd([])
chip_smoke.phase_swin_win([])
chip_smoke.phase_window_msa([])
chip_smoke.phase_tmsa([])
chip_smoke.phase_self6([])
chip_smoke.phase_stl2([])
chip_smoke.phase_bilin([])

# VRT's blocks at the training step's B=8 calls, this checkout's own pack
from kair_tpu_torch.ops.kernels import self6_block, tmsa_block, win3d
pack = getattr(win3d, "pack_win3d_stages", None) or win3d.pack_win3d
gen = torch.Generator().manual_seed(chip_smoke.SEED + 22)
dev = torch.device("cuda")
times = []
for name, c, wd in (("TMSA C=120", 120, 2), ("self C=120 wd 6", 120, 6),
                    ("self C=180 wd 6", 180, 6)):
    mutual = name.startswith("TMSA")
    p = chip_smoke.win3d_params(c, 6, wd, mutual, gen, dev)
    pk = pack(p, 6)
    x = torch.randn(8, 6, 64, 64, c, generator=gen).to(dev, torch.bfloat16)
    if mutual:
        fn = lambda: tmsa_block.tmsa_block(x, p, 6, (1, 4, 4), packed=pk)
    else:
        fn = lambda: self6_block.self6_block(x, p, 6, wd, (0, 4, 4), packed=pk)
    times.append(f"{name} {chip_smoke.cuda_ms(fn, warmup=3, reps=20):.4f} ms")
print("phase ab_vrt_b8: 8x6x64x64, median of 20: " + ", ".join(times))
"""


def main(argv: list) -> int:
    if len(argv) != 1:
        raise SystemExit(__doc__)
    other = Path(argv[0]).resolve()
    if not (other / "chip_smoke.py").is_file():
        raise SystemExit(f"{other} holds no chip_smoke.py")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rc = 0
    for i, root in enumerate((other, ROOT, ROOT, other)):
        name = "this" if root == ROOT else "other"
        proc = subprocess.run([sys.executable, "-c", SNIPPET], cwd=root,
                              capture_output=True, text=True, timeout=900)
        print(f"--- run {i + 1}: {name} ({root}), exit {proc.returncode}",
              flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith("phase "):
                print(line, flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
