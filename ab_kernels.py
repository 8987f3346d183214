"""Time the Swin-block, conv-tail and bilinear-sampler kernels of two
checkouts on one card.

    python3 ab_kernels.py <other checkout>

Runs phases 2 (``swin_block``, the block at window 8), 3 (``conv3x3``), 8
(``swin_win``, the block below window 8), 9 (``window_msa``, attention
only) and 20 (``bilin``) of each checkout's own ``chip_smoke.py``, each
checkout in a fresh process whose working directory is that checkout (so
each builds and loads its own kernels), in turns: other, this, this,
other. It prints the card's name and power limit, then each run's
phase lines: kernel, plain-version and library times, bounds and errors, as
that checkout's phases report them. Comparing two kernel versions is only
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
chip_smoke.phase_swin_win([])
chip_smoke.phase_window_msa([])
chip_smoke.phase_bilin([])
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
