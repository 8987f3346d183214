"""Time the Swin-block, conv-tail, bilinear-sampler, 3-D window-block, DCN
and GDA kernels of two checkouts on one card.

    python3 ab_kernels.py <other checkout> [phase ...]

Runs phases 2 (``swin_block``, the block at window 8), 3 (``conv3x3``), 6
(``swin_bwd``, the block's backward), 8 (``swin_win``, the block below
window 8), 9 (``window_msa``, attention only), 11 (``unfused``, SwinIR-M's
forward through the window-attention kernel), 13 (``tmsa``, VRT's TMSA
block), 14 (``self6``, VRT's self block), 15 (``dcn``, VRT's DCN), 17
(``stl2``, RVRT's STL2 block), 18 (``gda``, RVRT's guided deformable
attention) and 20 (``bilin``) of each checkout's own
``chip_smoke.py``, each checkout in a fresh process whose working
directory is that checkout (so each builds and loads its own kernels, and
prints its build's wall seconds), in turns: other, this, this, other;
then, in each checkout, VRT's TMSA and self blocks at the training step's
B=8 calls (``vrt_b8``, 8x6x64x64: TMSA C=120, self C=120 and C=180 at wd
6) through that checkout's own wrappers and weight pack. ``route_host``
(run only when named) times on the host ``TMSA.kernel_route`` over
RVRT-001's 20 window blocks at its 2x64x64 clip slots: the routing each
block's forward does, per call and for the clip's 68 block calls (4 + 64
launches, phase 19). Phase names after
the checkout run only those phases (``python3 ab_kernels.py ../parent
bilin``); with none, all of the above run. ``vrt``, ``rvrt`` and
``vrt_train`` (phases 16, 19 and 21, whole models) run only when named.
It prints the card's name and power limit, then each run's phase lines:
kernel, plain-version and library times, bounds and errors, as that
checkout's phases report them. Comparing two kernel versions is only sound
inside one such call, on one card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HEAD = """
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
import time
import chip_smoke
from kair_tpu_torch.ops.kernels import _build
t0 = time.monotonic()
_build.library()
print(f"phase ab_build: {time.monotonic() - t0:.1f} s to build and load "
      f"{len(_build.sources())} sources", flush=True)
"""
PHASES = {
    "swin_block": "chip_smoke.phase_swin([])",
    "conv3x3": "chip_smoke.phase_conv([])",
    "swin_bwd": "chip_smoke.phase_swin_bwd([])",
    "swin_win": "chip_smoke.phase_swin_win([])",
    "window_msa": "chip_smoke.phase_window_msa([])",
    "unfused": "chip_smoke.phase_unfused([], chip_smoke.nvidia_smi(), "
               "_build.BUILD_DIR)",
    "tmsa": "chip_smoke.phase_tmsa([])",
    "self6": "chip_smoke.phase_self6([])",
    "dcn": "chip_smoke.phase_dcn([])",
    "stl2": "chip_smoke.phase_stl2([])",
    "gda": "chip_smoke.phase_gda([])",
    "bilin": "chip_smoke.phase_bilin([])",
}
# whole models, run only when named: VRT-001's clip (16), RVRT-001's clip
# (19) and VRT-001's training (21), each with its device time by kernel
MODEL_PHASES = {
    "vrt": "chip_smoke.phase_vrt([], chip_smoke.nvidia_smi())",
    "rvrt": "chip_smoke.phase_rvrt([], chip_smoke.nvidia_smi())",
    "vrt_train": "chip_smoke.phase_vrt_train([], chip_smoke.nvidia_smi(), "
                 "_build.BUILD_DIR)",
}
VRT_B8 = """
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
ROUTE_HOST = """
# the host time of TMSA.kernel_route over RVRT-001's blocks at its clip slots
from kair_tpu_torch.cli.test_video import RVRT_TASKS
from kair_tpu_torch.models.rvrt import RVRT
from kair_tpu_torch.models.vrt import TMSA
from kair_tpu_torch.ops.window3d import get_window_size
with torch.device("meta"):
    model = RVRT(**RVRT_TASKS["001_RVRT_videosr_bi_REDS_30frames"]).eval()
calls = [(m, *get_window_size((2, 64, 64), m.window_size, m.shift_size))
         for m in model.modules() if isinstance(m, TMSA)]
routes = [m.kernel_route(2, 64, 64, ws, ss) for m, ws, ss in calls]
per = []
for _ in range(5):
    t0 = time.perf_counter()
    for _ in range(2000):
        for m, ws, ss in calls:
            m.kernel_route(2, 64, 64, ws, ss)
    per.append((time.perf_counter() - t0) / 2000 / len(calls) * 1e6)
per.sort()
print(f"phase ab_route_host: TMSA.kernel_route over {len(calls)} blocks "
      f"({routes.count('stl2')} stl2, {routes.count('stl1')} stl1), "
      f"median of 5 x 2000 passes {per[2]:.3f} us a call (range "
      f"{per[0]:.3f}-{per[-1]:.3f}), x 68 block calls a clip "
      f"{per[2] * 68 / 1000:.4f} ms", flush=True)
"""
EXTRA = {"vrt_b8": VRT_B8, "route_host": ROUTE_HOST}


def main(argv: list) -> int:
    names = argv[1:] or [*PHASES, "vrt_b8"]
    known = {**PHASES, **MODEL_PHASES}
    if not argv or any(n not in known and n not in EXTRA for n in names):
        raise SystemExit(__doc__)
    snippet = HEAD + "\n".join(known[n] for n in names if n in known) + \
        "".join(EXTRA[n] for n in EXTRA if n in names)
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
        proc = subprocess.run([sys.executable, "-c", snippet], cwd=root,
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
