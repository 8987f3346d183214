#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

The main path is SwinIR-M ×4 classical-SR inference (embed 180, depths
6×6, 6 heads, window 8, MLP ratio 2, pixelshuffle head, bf16) through the
port's two hand-written kernels: the fused Swin block and the fused
conv3x3 + residual tail; then training, then the rest of SwinIR's
inference routes: JPEG-CAR at window 7 (the window-block kernel), the
unfused route (the window-attention kernel) and SwinIR-L. Phases, one
flushed line each with its seconds:

  0 device      card name, power limit (nvidia-smi), torch and CUDA versions
  1 build       the kernels, from csrc/, with one plain nvcc call
  2 swin_block  kernel against its plain version at B=16, 128x128, C=180,
                at the main path's 1x64x72, and at SwinIR-L's width (B=4,
                128x128, C=240, 8 heads, hidden 480), shifted and not, with
                the dropped-mask control
  3 conv3x3     the same for the conv kernel, plus the F.conv2d yardstick
  4 main_path   a seeded KAIR-keyed state dict → .pth → cli.test.build_preset
                → test_pad → model on the card, for a 256x256 and a 256x280
                HR image (LR 64x64, and 64x70 padded to 64x72); kernel launch
                counts; output against the same weights run in f32 on the
                CPU, with a control that the comparison sees a dropped mask
  5 throughput  batch 16 of 128x128 LR: ms per forward, LR MP/s, MFU
  6 swin_bwd    the block backward kernel against its plain version at the
                training shape B=32, 48x48, C=180 (unshifted, shifted with
                the mask) and 1x48x56 (shifted): dx and the 13 parameter
                grads, with a dropped-mask control; its time, bound, the
                plain version's and the forward kernel's times
  7 train       SwinIR-M x4 training from the shipped option file
                (options/swinir/train_swinir_sr_classical_x4.json) through
                config.parse → cli.train.build_trainer, bf16, batches of 32
                from the port's Loader over seeded smooth images: (a) one
                gradient on the card against the f32 CPU run on the same
                weights and a B=2 batch, with a dropped-mask control; (b) 2
                warm-up and 8 timed steps, 36 forward and 36 backward block
                launches per step and no conv kernel; (c) save, then resume
                in a fresh trainer with equal G, E and optimizer state; (d)
                device time per step by kernel, from torch.profiler
  8 swin_win    the window-block kernel (windows up to 8, padded to 64 rows)
                against its plain version: window 7 at B=8, 126x126, C=180,
                shifted (phase 3) and not; window 4 on 1x12x20 and window 7
                on 1x21x35 (odd window counts); dropped-mask control; time
                and bound
  9 window_msa  the window-attention kernel against the composed window_msa
                at B=16, 128x128, C=180, with and without the mask and the
                qkv bias; the same control; time and bound
 10 jpeg_car    KAIR's 006 JPEG-CAR SwinIR-M (color, window 7, img_range 255)
                from an option tree through define_g: B=8 of 126x126 on the
                card, 36 window-block and 7 conv launches, no composed
                block; image 0 against the f32 CPU run (also in gray
                levels) with the dropped-mask control; ms, LR MP/s, MFU;
                device time per forward by kernel, from torch.profiler
 11 unfused     SwinIR-M x4 through cli.test.build_preset with fuse off:
                36 window-attention launches per B=16 128x128 forward;
                against the fused forward and the f32 CPU run; its time
 12 swinir_l    KAIR's real-world SwinIR-L x4 (embed 240, depths 9x6, 8
                heads, 3conv, nearest+conv): 54 block launches per B=4
                128x128 forward; a 64x64 image against the f32 CPU run,
                the error after each stage and with the 3conv tails and the
                head's convs in f32; its time

Any failed check raises and the script exits non-zero; a watchdog ends a
hung run with a traceback. The line before the last is one JSON object with
every kernel's numbers; the last line is {"ok": true, "device": {...}}.
Needs a CUDA card and the CUDA toolkit (nvcc); imports nothing of JAX.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

WATCHDOG_S = 590          # the whole run, build included, stays under 10 min
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    """Times one phase and prints `phase <name>: <s> s | <what was checked>`."""

    def __init__(self, name: str):
        self.name = name
        self.notes = []

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t0
        status = "FAILED" if exc_type else "ok"
        log(f"phase {self.name}: {dt:.2f} s {status} | " + "; ".join(self.notes))
        return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, warmup: int = 3, reps: int = 10) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it) at the H100 SXM's published peaks."""
    from kair_tpu_torch.utils.summary import PEAKS
    pk = PEAKS["H100 SXM"]
    t_ops = flops / (pk["bf16_tflops"] * 1e12) * 1e3
    t_mem = nbytes / (pk["hbm_tbps"] * 1e12) * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def compare(got, ref):
    d = (got.float() - ref.float()).abs()
    ref_max = ref.float().abs().max().item()
    return d.max().item(), d.max().item() / max(ref_max, 1e-30), ref_max, \
        d.mean().item()


def swin_params(c: int, nh: int, hidden: int, gen, device, dtype, ws: int = 8):
    """Seeded block weights for a ws x ws window, scaled so the softmax is
    far from uniform and every term of the block moves the output."""
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import SwinBlockParams

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to(device, dtype)

    return SwinBlockParams(
        qkv_weight=rnd(3 * c, c, std=0.1), qkv_bias=rnd(3 * c, std=0.1),
        proj_weight=rnd(c, c, std=0.05), proj_bias=rnd(c, std=0.1),
        rel_table=rnd((2 * ws - 1) ** 2, nh, std=0.5),
        norm1_weight=rnd(c, std=0.1, mean=1.0), norm1_bias=rnd(c, std=0.1),
        norm2_weight=rnd(c, std=0.1, mean=1.0), norm2_bias=rnd(c, std=0.1),
        fc1_weight=rnd(hidden, c, std=0.05), fc1_bias=rnd(hidden, std=0.1),
        fc2_weight=rnd(c, hidden, std=0.05), fc2_bias=rnd(c, std=0.1))


def phase_swin(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import (pack_swin_block,
                                                        swin_block_2d,
                                                        swin_block_2d_reference)
    from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
    from kair_tpu_torch.utils.summary import swinir_block_flops_per_token

    b, h, w, c, nh, hidden = 16, 128, 128, 180, 6, 360
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    p = swin_params(c, nh, hidden, gen, dev, torch.bfloat16)
    x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    pk = pack_swin_block(p, nh)
    mask = shift_mask_tensor(h, w, 8, 4, dev)
    tol = 1e-2
    with Phase("2 swin_block") as ph:
        ph.note(f"B={b} {h}x{w} C={c} nh={nh} bf16; limit max_abs <= {tol} * "
                "max|ref| (qkv, probabilities and MLP hidden are stored in "
                "bf16, f32 accumulation; plain version in f32 from the same "
                "bf16 inputs)")
        # the main path's second image: LR 64x72, a width of 8 mod 16
        x72 = x[:1, :64, :72].contiguous()
        cases = [(x, 0, None), (x, 4, mask), (x, -4, None),
                 (x72, 4, shift_mask_tensor(64, 72, 8, 4, dev))]
        errs = []
        for xin, phase, m in cases:
            got = swin_block_2d(xin, p, nh, m, phase, packed=pk)
            ref = swin_block_2d_reference(xin.float(), p, nh, m, phase)
            torch.cuda.synchronize()
            e_abs, e_rel, ref_max, e_mean = compare(got, ref)
            what = (f"{tuple(xin.shape[:3])} phase {phase:+d} mask="
                    f"{'shift' if m is not None else 'none'}")
            ph.note(f"{what}: max_abs {e_abs:.4g} max_rel {e_rel:.4g} mean_abs "
                    f"{e_mean:.3g} (max|ref| {ref_max:.3g})")
            require(e_rel <= tol, f"swin_block_2d {what} max_rel {e_rel:.4g} "
                    f"> {tol}")
            if m is not None:
                # the check must be able to see a dropped mask
                no_mask = swin_block_2d_reference(xin.float(), p, nh, None, phase)
                eff = (no_mask - ref).abs().max().item()
                ph.note(f"mask effect {eff:.3g}")
                require(eff > tol * ref_max and eff > 3 * e_abs,
                        "mask effect not above the limit and the kernel error")
            errs.append(e_abs)
        # SwinIR-L's width, whose shared-memory layout overlaps x1 with
        # q/k/v and the MLP hidden layer with the scores
        bl, cl, nhl, hl = 4, 240, 8, 480
        pl = swin_params(cl, nhl, hl, gen, dev, torch.bfloat16)
        xl = torch.randn(bl, h, w, cl, generator=gen).to(dev, torch.bfloat16)
        pkl = pack_swin_block(pl, nhl)
        for phase, m in ((0, None), (4, mask)):
            got = swin_block_2d(xl, pl, nhl, m, phase, packed=pkl)
            ref = swin_block_2d_reference(xl.float(), pl, nhl, m, phase)
            control = None if m is None else swin_block_2d_reference(
                xl.float(), pl, nhl, None, phase)
            errs.append(check_case(
                ph, f"C={cl} nh={nhl} hidden={hl} {tuple(xl.shape[:3])} phase "
                f"{phase:+d} mask={'shift' if m is not None else 'none'}",
                got, ref, tol, control))
        ms_l = cuda_ms(lambda: swin_block_2d(xl, pl, nhl, mask, 4, packed=pkl))
        flops_l = bl * h * w * swinir_block_flops_per_token(cl, nhl, 8, hl / cl)
        bms_l, by_l = bound_ms(flops_l, 2 * 2 * bl * h * w * cl + 4 * mask.numel()
                               + block_weight_bytes(cl, nhl, hl, 64))
        ph.note(f"C={cl} kernel {ms_l:.3f} ms (B={bl} shifted, median of 10); "
                f"bound {bms_l:.4f} ms ({by_l})")
        ms = cuda_ms(lambda: swin_block_2d(x, p, nh, mask, 4, packed=pk))
        plain_ms = cuda_ms(lambda: swin_block_2d_reference(
            x.float(), p, nh, mask, 4), warmup=1, reps=5)
        tokens = b * h * w
        flops = tokens * swinir_block_flops_per_token(c, nh, 8, hidden / c)
        weights = 2 * (3 * c * c + c * c + 2 * c * hidden) \
            + 4 * (3 * c + c + hidden + c + 4 * c) + 4 * nh * 64 * 64
        nbytes = 2 * 2 * tokens * c + weights + 4 * mask.numel()
        bms, by = bound_ms(flops, nbytes)
        ph.note(f"kernel {ms:.3f} ms (shifted, median of 10); plain f32 "
                f"{plain_ms:.3f} ms; bound {bms:.4f} ms ({by}); "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
    report.append(dict(
        name="swin_block_2d", route="cuda",
        source="kair_tpu_torch/csrc/swin_block.cu",
        replaces="kair_tpu/ops/pallas/swin_block.py:701",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


def phase_conv(report: list) -> None:
    import torch
    import torch.nn.functional as F
    from kair_tpu_torch.ops.kernels.conv_block import (
        conv3x3_residual, conv3x3_residual_reference, pack_conv3x3)

    b, h, w, c = 16, 128, 128, 180
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    y = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    res = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    wt = (torch.randn(c, c, 3, 3, generator=gen) / math.sqrt(9 * c)).to(
        dev, torch.bfloat16)
    bias = (torch.randn(c, generator=gen) * 0.1).to(dev, torch.bfloat16)
    wpk = pack_conv3x3(wt)
    tol = 1e-2
    with Phase("3 conv3x3") as ph:
        ph.note(f"B={b} {h}x{w} C={c} bf16; cudnn.allow_tf32="
                f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
                f"{torch.backends.cuda.matmul.allow_tf32} float32_matmul_"
                f"precision={torch.get_float32_matmul_precision()}; limit max_abs <= "
                f"{tol} * max|ref| (bf16 output rounding, f32 accumulation "
                "in another order)")
        # the last case is the main path's LR 64x72 (a partial column tile)
        y72, r72 = y[:1, :64, :72].contiguous(), res[:1, :64, :72].contiguous()
        errs = []
        for yin, rin, phase in ((y, res, 0), (y, res, 4), (y72, r72, 4)):
            got = conv3x3_residual(yin, rin, wt, bias, phase, packed_weight=wpk)
            ref = conv3x3_residual_reference(yin.float(), rin.float(), wt, bias,
                                             phase)
            torch.cuda.synchronize()
            e_abs, e_rel, ref_max, e_mean = compare(got, ref)
            what = f"{tuple(yin.shape[:3])} phase {phase}"
            ph.note(f"{what}: max_abs {e_abs:.4g} max_rel {e_rel:.4g} "
                    f"mean_abs {e_mean:.3g} (max|ref| {ref_max:.3g})")
            require(e_rel <= tol, f"conv3x3_residual {what} max_rel "
                    f"{e_rel:.4g} > {tol}")
            errs.append(e_abs)
        ms = cuda_ms(lambda: conv3x3_residual(y, res, wt, bias, 0,
                                              packed_weight=wpk))
        plain_ms = cuda_ms(lambda: conv3x3_residual_reference(
            y.float(), res.float(), wt, bias, 0), warmup=1, reps=5)
        # yardstick only, never used by the port: cuDNN channels-last bf16
        y_cl, r_cl = y.permute(0, 3, 1, 2), res.permute(0, 3, 1, 2)
        lib_ms = cuda_ms(lambda: F.conv2d(y_cl, wt, bias, padding=1).add_(r_cl))
        flops = 2.0 * b * h * w * 9 * c * c
        nbytes = 3 * 2 * b * h * w * c + 2 * 9 * c * c + 2 * c
        bms, by = bound_ms(flops, nbytes)
        ph.note(f"kernel {ms:.3f} ms; plain f32 {plain_ms:.3f} ms; F.conv2d "
                f"bf16 channels-last + add {lib_ms:.3f} ms; bound {bms:.4f} ms "
                f"({by}); {flops / ms / 1e9:.1f} TFLOP/s")
    report.append(dict(
        name="conv3x3_residual", route="cuda",
        source="kair_tpu_torch/csrc/conv_block.cu",
        replaces="kair_tpu/ops/pallas/conv_block.py:94",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms))


def smooth_image(h: int, w: int, seed: int):
    """Seeded smooth RGB uint8 image: a few low-frequency sinusoids."""
    import numpy as np
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64) / max(h, w)
    img = np.zeros((h, w, 3))
    for ch in range(3):
        acc = 0.5 * np.ones((h, w))
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 4.0, 2)
            ph = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(0.05, 0.15) * np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)
        img[..., ch] = acc
    return np.uint8((np.clip(img, 0, 1) * 255).round())


# Block weights of the main path, drawn like swin_params: KAIR's own
# initialisation (Linear std 0.02) leaves the 36 blocks so close to the
# identity that a wrong block would not show in the output.
BLOCK_INIT = {"attn.qkv.weight": (0.0, 0.1), "attn.qkv.bias": (0.0, 0.1),
              "attn.proj.weight": (0.0, 0.05), "attn.proj.bias": (0.0, 0.1),
              "attn.relative_position_bias_table": (0.0, 0.5),
              "norm1.weight": (1.0, 0.1), "norm1.bias": (0.0, 0.1),
              "norm2.weight": (1.0, 0.1), "norm2.bias": (0.0, 0.1),
              "mlp.fc1.weight": (0.0, 0.05), "mlp.fc1.bias": (0.0, 0.1),
              "mlp.fc2.weight": (0.0, 0.05), "mlp.fc2.bias": (0.0, 0.1)}


def main_path_state_dict(seed: int) -> dict:
    """Seeded SwinIR-M x4 state dict with KAIR's key names: KAIR's
    initialisation, the Swin blocks' tensors redrawn by BLOCK_INIT."""
    import torch
    from kair_tpu_torch.cli.test import SWINIR_X4
    from kair_tpu_torch.models.swinir import SwinIR

    torch.manual_seed(seed)
    sd = SwinIR(img_size=64, **SWINIR_X4).state_dict()
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if ".residual_group.blocks." in k:
            mean_std = BLOCK_INIT.get(k.split(".", 5)[-1])
            if mean_std is not None:
                sd[k] = torch.randn(v.shape, generator=gen) * mean_std[1] \
                    + mean_std[0]
    return sd


def cpu_forward_without_shift_mask(model, lr):
    """The f32 CPU forward with the shifted blocks' 0/-100 mask left out:
    the control that the main-path comparison can see one wrong term."""
    from kair_tpu_torch.cli.test import make_forward
    from kair_tpu_torch.eval.test_modes import test_pad
    from kair_tpu_torch.models import swinir as msw

    with_mask = msw.shift_mask_tensor
    msw.shift_mask_tensor = lambda *a: None
    try:
        return test_pad(make_forward(model), lr, modulo=8, sf=4)
    finally:
        msw.shift_mask_tensor = with_mask


def phase_main_path(report: list, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.test import build_preset, make_forward
    from kair_tpu_torch.eval.test_modes import test_pad
    from kair_tpu_torch.ops.kernels.conv_block import conv3x3_residual
    from kair_tpu_torch.ops.kernels.swin_block import swin_block_2d
    from kair_tpu_torch.utils import image as im

    tol = 2e-2
    with Phase("4 main_path") as ph:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            path = f"{tmp}/swinir_m_x4_seed{SEED}.pth"
            torch.save({"params": main_path_state_dict(SEED)}, path)
            gpu_model, kind, n_ch = build_preset("swinir_classical_x4", path,
                                                 device="cuda",
                                                 dtype=torch.bfloat16)
            cpu_model, _, _ = build_preset("swinir_classical_x4", path,
                                           device="cpu", dtype=torch.float32)
        ph.note(f"SwinIR-M x4 ({sum(p.numel() for p in gpu_model.parameters())} "
                f"params, blocks drawn by BLOCK_INIT) bf16 on cuda; limit "
                f"max_abs <= {tol} * max|ref| against the f32 CPU run (bf16 "
                "activations through 36 blocks, 7 fused tails and the head); "
                "control: the CPU run without the shift mask must differ by "
                "more than the limit and 3x the error")
        # 256x256 HR, and a width whose LR (70) test_pad takes to 72 = 8 mod 16
        images = [(f"HR {hh}x{ww}", smooth_image(hh, ww, SEED + i))
                  for i, (hh, ww) in enumerate(((256, 256), (256, 280)))]
        swin_block_2d.launches = 0
        conv3x3_residual.launches = 0
        outs = []
        for n, (name, img_h) in enumerate(images, 1):
            lr = im.hwc_to_nhwc(im.imresize_np(im.uint2single(img_h), 1 / 4,
                                               True).astype(np.float32))
            e_gpu = test_pad(make_forward(gpu_model), lr, modulo=8, sf=4)
            torch.cuda.synchronize()
            n_swin, n_conv = swin_block_2d.launches, conv3x3_residual.launches
            require(n_swin == 36 * n and n_conv == 7 * n,
                    f"{name}: expected 36 swin and 7 conv launches per "
                    f"forward, got {n_swin}/{n_conv} after {n} forwards")
            outs.append((name, img_h, lr, e_gpu))
        for k in report:
            k["launches"] = n_swin if k["name"] == "swin_block_2d" else n_conv
        ph.note(f"launches in {len(images)} forwards: swin_block_2d {n_swin}, "
                f"conv3x3_residual {n_conv} (36 and 7 per forward)")

        for name, img_h, lr, e_gpu in outs:
            e_cpu = test_pad(make_forward(cpu_model), lr, modulo=8, sf=4)
            require(e_gpu.shape == (1,) + img_h.shape and np.isfinite(e_gpu).all(),
                    f"{name}: output shape {e_gpu.shape} or non-finite values")
            ref_max = np.abs(e_cpu).max()
            err = np.abs(e_gpu - e_cpu).max()
            effect = np.abs(cpu_forward_without_shift_mask(cpu_model, lr)
                            - e_cpu).max()
            psnr = im.calculate_psnr(im.nhwc_to_uint(e_gpu), img_h, border=4)
            ph.note(f"{name} (LR {lr.shape[1]}x{lr.shape[2]}): max_abs "
                    f"{err:.4g} max_rel {err / ref_max:.4g} mean_abs "
                    f"{np.abs(e_gpu - e_cpu).mean():.3g}; shift-mask effect "
                    f"max_rel {effect / ref_max:.4g}; PSNR vs HR {psnr:.2f} dB "
                    "(random weights: information only)")
            require(err <= tol * ref_max,
                    f"{name}: main path max_rel {err / ref_max:.4g} > {tol}")
            require(effect > tol * ref_max and effect > 3 * err,
                    f"{name}: the shift-mask control ({effect / ref_max:.4g}) "
                    "is not above the limit and 3x the error")


def phase_throughput(card: str) -> None:
    import torch
    from kair_tpu_torch.models.swinir import SwinIR
    from kair_tpu_torch.cli.test import SWINIR_X4
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              swinir_flops_per_lr_pixel)

    b, s = 16, 128
    with Phase("5 throughput") as ph:
        torch.manual_seed(SEED)
        model = SwinIR(img_size=64, **SWINIR_X4).to("cuda", torch.bfloat16).eval()
        x = torch.rand(b, s, s, 3, device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), warmup=2, reps=10)
        mp_s = b * s * s / (ms / 1e3) / 1e6
        tflops = swinir_flops_per_lr_pixel() * b * s * s / (ms / 1e3) / 1e12
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        mfu = tflops / peak if peak else None
        ph.note(f"SwinIR-M x4 bf16 B={b} {s}x{s} LR: ms_per_forward {ms:.2f}, "
                f"{mp_s:.4f} LR MP/s, {tflops:.1f} TFLOP/s, MFU "
                f"{'n/a' if mfu is None else f'{mfu:.4f}'} of the bf16 dense "
                f"peak [{card}]")
        require(math.isfinite(ms) and ms > 0, "throughput timing")


def phase_swin_bwd(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams,
                                                        pack_swin_block,
                                                        swin_block_2d,
                                                        swin_block_2d_bwd,
                                                        swin_block_2d_bwd_reference)
    from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
    from kair_tpu_torch.utils.summary import swinir_block_bwd_flops_per_token

    b, h, w, c, nh, hidden = 32, 48, 48, 180, 6, 360
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    # f32 parameters, as the trainer holds them; bf16 activations
    p = swin_params(c, nh, hidden, gen, dev, torch.float32)
    x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    dy = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
    x56 = torch.randn(1, 48, 56, c, generator=gen).to(dev, torch.bfloat16)
    dy56 = torch.randn(1, 48, 56, c, generator=gen).to(dev, torch.bfloat16)
    mask = shift_mask_tensor(h, w, 8, 4, dev)
    names = ("dx",) + SwinBlockParams._fields
    tol = 2e-2
    with Phase("6 swin_bwd") as ph:
        ph.note(f"B={b} {h}x{w} C={c} nh={nh}, bf16 x and dy, f32 parameters; "
                f"limit per tensor max_abs <= {tol} * max|ref| for dx and each "
                "of the 13 grads (bf16 operands and stored intermediates, f32 "
                "accumulation; plain version: autograd in f32 from the same "
                "inputs); control: without the mask the plain dx must differ "
                "by more than the limit and 3x the error")
        errs = []
        pkb = pack_swin_block(p, nh, folded=False)     # as the model caches it
        for xin, dyin, m in ((x, dy, None), (x, dy, mask),
                             (x56, dy56, shift_mask_tensor(48, 56, 8, 4, dev))):
            dx, g = swin_block_2d_bwd(xin, dyin, p, nh, m, pkb)
            torch.cuda.synchronize()
            rdx, rg = swin_block_2d_bwd_reference(xin, dyin, p, nh, m)
            worst, worst_name, dx_abs = 0.0, "", 0.0
            for name, got, ref in zip(names, (dx,) + tuple(g), (rdx,) + tuple(rg)):
                e_abs, e_rel, _, _ = compare(got, ref)
                require(e_rel <= tol, f"swin_block_2d_bwd {tuple(xin.shape[:3])} "
                        f"{name}: max_rel {e_rel:.4g} > {tol}")
                if name == "dx":
                    dx_abs = e_abs
                    errs.append(e_abs)
                if e_rel > worst:
                    worst, worst_name = e_rel, name
            what = (f"{tuple(xin.shape[:3])} mask="
                    f"{'shift' if m is not None else 'none'}")
            note = f"{what}: worst max_rel {worst:.4g} ({worst_name})"
            if m is not None:
                ndx, _ = swin_block_2d_bwd_reference(xin, dyin, p, nh, None)
                eff = (ndx.float() - rdx.float()).abs().max().item()
                ref_max = rdx.float().abs().max().item()
                note += f"; mask effect on dx max_rel {eff / ref_max:.4g}"
                require(eff > tol * ref_max and eff > 3 * dx_abs,
                        "mask effect not above the limit and the kernel error")
            ph.note(note)
        ms = cuda_ms(lambda: swin_block_2d_bwd(x, dy, p, nh, mask, pkb))
        plain_ms = cuda_ms(lambda: swin_block_2d_bwd_reference(
            x, dy, p, nh, mask), warmup=1, reps=5)
        pk = pack_swin_block(p, nh)
        fwd_ms = cuda_ms(lambda: swin_block_2d(x, p, nh, mask, 0, packed=pk))
        tokens = b * h * w
        flops = tokens * swinir_block_bwd_flops_per_token(c, 8, hidden / c)
        n_params = sum(t.numel() for t in p)
        # x and dy read, dx written (bf16); parameters read and grads written
        # (f32); the mask read
        nbytes = 3 * 2 * tokens * c + 2 * 4 * n_params + 4 * mask.numel()
        bms, by = bound_ms(flops, nbytes)
        ph.note(f"kernel {ms:.3f} ms (shifted, median of 10); plain f32 "
                f"{plain_ms:.3f} ms; forward kernel at this shape {fwd_ms:.3f} "
                f"ms; bound {bms:.4f} ms ({by}); {flops / ms / 1e9:.1f} TFLOP/s; "
                "max_abs_err in the kernels line is dx's")
    report.append(dict(
        name="swin_block_2d_bwd", route="cuda",
        source="kair_tpu_torch/csrc/swin_block_bwd.cu",
        replaces="kair_tpu/ops/pallas/swin_block.py:588",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


OPTION_FILE = "options/swinir/train_swinir_sr_classical_x4.json"


def train_options(tmp: str):
    """The shipped option file, parsed by the port, with its output paths
    and image folder moved into `tmp`."""
    from kair_tpu_torch import config
    raw = config.load_json_with_comments(
        os.path.join(os.path.dirname(os.path.abspath(__file__)), OPTION_FILE))
    raw["path"]["root"] = os.path.join(tmp, "runs")
    raw["datasets"]["train"]["dataroot_H"] = os.path.join(tmp, "trainH")
    path = os.path.join(tmp, os.path.basename(OPTION_FILE))
    with open(path, "w") as f:
        json.dump(raw, f)
    return config.parse(path)


def seeded_sr_dataset(ds_opt, n_images: int = 64, size: int = 200):
    """The port's DatasetSR over `n_images` seeded smooth HR images (the card
    has no image set and no cv2): its two file-system hooks replaced."""
    from kair_tpu_torch.data.datasets import DatasetSR

    class SeededSR(DatasetSR):
        cache: dict = {}

        def image_paths(self, root):
            return [f"{root}/seed{i}.png" for i in range(n_images)]

        def read_uint(self, path):
            if path not in self.cache:
                seed = int(path.rsplit("seed", 1)[1].split(".")[0])
                self.cache[path] = smooth_image(size, size, SEED + 100 + seed)
            return self.cache[path]

    return SeededSR(ds_opt)


def seeded_train_weights(model, seed: int) -> dict:
    """The model's state dict with the Swin blocks' tensors redrawn by
    BLOCK_INIT, so that a wrong block term shows in the gradients."""
    import torch
    sd = model.state_dict()
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        mean_std = BLOCK_INIT.get(k.split(".", 5)[-1]) \
            if ".residual_group.blocks." in k else None
        if mean_std is not None:
            sd[k] = (torch.randn(v.shape, generator=gen) * mean_std[1]
                     + mean_std[0]).to(v)
    return sd


def grads_of(trainer, batch) -> dict:
    trainer.compute_grads(batch)
    return {n: p.grad.detach().float().cpu()
            for n, p in trainer.model.named_parameters()}


def kernel_name(key: str) -> str:
    """A profiler key without its namespace noise, template and arguments."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return key.split("(")[0].split("<")[0].strip()[:60]


def device_breakdown(fn, runs: int, ms: float, what: str) -> str:
    """Device time per run of ``fn`` (which does ``runs`` runs) by kernel,
    from torch.profiler, device events only (a CPU op that launched a
    ctypes-bound kernel would count that kernel's time again), and the
    idle share against ``ms`` per run timed with CUDA events."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or ev.key.startswith("Optimizer.")):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / runs, ev.count // runs, ev.key))
    if not rows:
        return "the profiler saw no device time"
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return (f"device time per {what} (profiler, {runs} runs): busy "
            f"{busy:.2f} ms of the {ms:.2f} ms {what}, idle share "
            f"{1 - busy / ms:.4f}; " + ", ".join(
                f"{kernel_name(name)} {t:.2f} ms x{n}"
                for t, n, name in rows[:8]))


def rel_norm(a: dict, b: dict, names) -> float:
    import torch
    num = torch.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in names))
    den = torch.sqrt(sum((b[n] ** 2).sum() for n in names))
    return (num / den).item()


def phase_train(report: list, card: str, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch import config
    from kair_tpu_torch.cli.train import build_trainer
    from kair_tpu_torch.data.base import Loader
    from kair_tpu_torch.models import swinir as msw
    from kair_tpu_torch.ops.kernels.conv_block import conv3x3_residual
    from kair_tpu_torch.ops.kernels.swin_block import (swin_block_2d,
                                                        swin_block_2d_bwd)
    from kair_tpu_torch.train.trainer import PlainTrainer
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              swinir_flops_per_lr_pixel)

    # measured by this phase on an H100 (PERF.md): 0.0075 over all
    # parameters and 0.035 at the worst block parameter (a relative-position
    # table). Dropping the mask moves the global norm by 0.025 (it touches
    # the border windows only) and a block parameter by 0.67: each limit
    # lies between the sound reading and the control's
    tol_global, tol_param = 1.5e-2, 1e-1
    warmup, timed = 2, 8
    with Phase("7 train") as ph, tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        opt = train_options(tmp)
        ds_opt = opt["datasets"]["train"]
        bs = ds_opt["dataloader_batch_size"]
        trainer = build_trainer(opt, dtype=torch.bfloat16)
        torch.manual_seed(SEED)
        sd = seeded_train_weights(trainer.model, SEED + 3)
        trainer.model.load_state_dict(sd)
        trainer.ema.load_state_dict(sd)
        net = opt["netG"]
        ph.note(f"{OPTION_FILE}: embed {net['embed_dim']}, depths "
                f"{net['depths']}, heads {net['num_heads']}, window "
                f"{net['window_size']}, batch {bs}, H_size {ds_opt['H_size']}, "
                f"{opt['train']['G_lossfn_type']}, Adam "
                f"{opt['train']['G_optimizer_lr']}, EMA {opt['train']['E_decay']}; "
                f"{sum(p.numel() for p in trainer.model.parameters())} params "
                "(blocks drawn by BLOCK_INIT)")
        loader = Loader(seeded_sr_dataset(ds_opt), bs, seed=SEED)
        batches, epoch = [], 0
        while len(batches) < warmup + timed:
            batches += [{k: v for k, v in bt.items() if isinstance(v, np.ndarray)}
                        for bt in loader.epoch(epoch)]
            epoch += 1
        batches = batches[:warmup + timed]
        hs, sf = ds_opt["H_size"], opt["scale"]
        lr_hw = batches[0]["L"].shape[1:3]
        require(batches[0]["L"].shape == (bs, hs // sf, hs // sf, 3)
                and batches[0]["H"].shape == (bs, hs, hs, 3),
                f"batch shapes {batches[0]['L'].shape} {batches[0]['H'].shape}")

        # (a) the gradient on the card against the f32 CPU run
        small = {k: v[:2] for k, v in batches[0].items()}
        g_card = grads_of(trainer, small)
        cpu = PlainTrainer(opt, device="cpu", dtype=torch.float32)
        cpu.model.load_state_dict(sd)
        g_cpu = grads_of(cpu, small)
        with_mask = msw.shift_mask_tensor
        msw.shift_mask_tensor = lambda *a: None
        try:
            g_nomask = grads_of(cpu, small)
        finally:
            msw.shift_mask_tensor = with_mask
        names = list(g_cpu)
        block = [n for n in names if ".residual_group.blocks." in n]
        err = rel_norm(g_card, g_cpu, names)
        per = {n: rel_norm(g_card, g_cpu, [n]) for n in block}
        worst = max(per, key=per.get)
        eff = {n: rel_norm(g_nomask, g_cpu, [n]) for n in block}
        eff_worst = max(eff, key=eff.get)
        eff_global = rel_norm(g_nomask, g_cpu, names)
        ph.note(f"(a) gradient, B=2, bf16 card vs f32 CPU: relative norm error "
                f"{err:.4g} over all parameters (limit {tol_global}), worst "
                f"block parameter {worst} {per[worst]:.4g} (limit {tol_param}); "
                f"control, the CPU run without the shift mask: "
                f"{eff_global:.4g} over all parameters, "
                f"{eff[eff_worst]:.4g} at {eff_worst}")
        require(err <= tol_global, f"gradient error {err:.4g} > {tol_global}")
        require(per[worst] <= tol_param,
                f"block parameter {worst}: {per[worst]:.4g} > {tol_param}")
        require(eff_global > tol_global,
                "the dropped-mask control is not above the global limit")
        require(eff[eff_worst] > tol_param and eff[eff_worst] > 3 * per[worst],
                "the dropped-mask control is not above the per-parameter limit "
                "and 3x the worst error")

        # (b) steps: one forward and one backward block launch per block
        swin_block_2d.launches = swin_block_2d_bwd.launches = 0
        conv3x3_residual.launches = 0
        losses = [trainer.train_step(bt)["G_loss"] for bt in batches[:warmup]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        losses += [trainer.train_step(bt)["G_loss"] for bt in batches[warmup:]]
        e.record()
        torch.cuda.synchronize()
        n_fwd, n_bwd = swin_block_2d.launches, swin_block_2d_bwd.launches
        n_conv = conv3x3_residual.launches
        steps, n_blocks = warmup + timed, sum(net["depths"])
        require(n_fwd == n_blocks * steps and n_bwd == n_blocks * steps
                and n_conv == 0,
                f"expected {n_blocks} forward, {n_blocks} backward and 0 conv "
                f"launches per step, got {n_fwd}/{n_bwd}/{n_conv} in {steps} "
                "steps")
        for k in report:
            if k["name"] == "swin_block_2d_bwd":
                k["launches"] = n_bwd
        loss_vals = [float(v) for v in losses]
        require(all(math.isfinite(v) for v in loss_vals), f"losses {loss_vals}")
        ms = s.elapsed_time(e) / timed
        peak_mem = torch.cuda.max_memory_allocated()
        lr_px = bs * lr_hw[0] * lr_hw[1]
        tflops = 3 * swinir_flops_per_lr_pixel() * lr_px / (ms / 1e3) / 1e12
        peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
        mfu = tflops / peak if peak else None
        ph.note(f"(b) launches in {steps} steps: swin_block_2d {n_fwd}, "
                f"swin_block_2d_bwd {n_bwd}, conv3x3_residual {n_conv}; losses "
                f"{loss_vals[0]:.4g} .. {loss_vals[-1]:.4g}; ms_per_step {ms:.2f} "
                f"(mean of {timed}, CUDA events), {bs / (ms / 1e3):.1f} patches/s, "
                f"{lr_px / (ms / 1e3) / 1e6:.4f} LR MP/s, training MFU "
                f"{'n/a' if mfu is None else f'{mfu:.4f}'} (3x the forward's "
                "analytic FLOP, recompute not counted); peak memory "
                f"{peak_mem / 2 ** 30:.2f} GiB [{card}]")

        # (d) where a step's device time goes: two more steps under the
        # profiler
        prof_steps = 2
        ph.note("(d) " + device_breakdown(
            lambda: [trainer.train_step(bt)
                     for bt in batches[warmup:warmup + prof_steps]],
            prof_steps, ms, "step"))

        # (c) save, then resume in a fresh trainer
        from kair_tpu_torch.ckpt import checkpoint as ck
        models = opt["path"]["models"]
        paths = trainer.save(models, trainer.step)
        fresh = build_trainer(opt, dtype=torch.bfloat16)
        step, g_path = config.find_last_checkpoint(models, "G")
        fresh.resume(g_path, step)
        require(step == trainer.step == fresh.step, f"resumed at {step}")
        for name, a, b in (("G", trainer.model.state_dict(), fresh.model.state_dict()),
                           ("E", trainer.ema.state_dict(), fresh.ema.state_dict())):
            require(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
                    f"resumed {name} differs")
        so, sf = ck.load(paths[-1]), fresh.optimizer.state_dict()
        require(so["param_groups"] == sf["param_groups"] and all(
            torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(sf["state"][i][k]).cpu())
            for i, st in so["state"].items() for k, v in st.items()),
            "resumed optimizer state differs")
        ph.note(f"(c) saved {', '.join(os.path.basename(p) for p in paths)}; "
                "a fresh trainer resumed with equal G, E and optimizer state")


def block_weight_bytes(c: int, nh: int, hidden: int, n: int) -> int:
    """Bytes of one block's parameters as the kernels read them: bf16
    matrices, f32 biases and LN vectors, the (nh, n, n) f32 score bias."""
    return (2 * (3 * c * c + c * c + 2 * c * hidden)
            + 4 * (3 * c + c + hidden + c + 4 * c) + 4 * nh * n * n)


def check_case(ph, what, got, ref, tol, control=None) -> float:
    """Require max|got − ref| ≤ tol · max|ref| and, given the plain version
    without the shift mask, that dropping it moves the result by more than
    the limit and 3x the error; note both. Returns the max abs error."""
    e_abs, e_rel, ref_max, e_mean = compare(got, ref)
    note = (f"{what}: max_abs {e_abs:.4g} max_rel {e_rel:.4g} mean_abs "
            f"{e_mean:.3g} (max|ref| {ref_max:.3g})")
    require(e_rel <= tol, f"{what}: max_rel {e_rel:.4g} > {tol}")
    if control is not None:
        eff = (control.float() - ref.float()).abs().max().item()
        note += f"; mask effect max_rel {eff / ref_max:.4g}"
        require(eff > tol * ref_max and eff > 3 * e_abs,
                f"{what}: the dropped-mask control is not above the limit and "
                "3x the error")
    ph.note(note)
    return e_abs


def phase_swin_win(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import (pack_swin_block,
                                                        swin_block_2d,
                                                        swin_block_win_reference)
    from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
    from kair_tpu_torch.utils.summary import swinir_block_flops_per_token

    c, nh, hidden = 180, 6, 360
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 4)
    p7 = swin_params(c, nh, hidden, gen, dev, bf, ws=7)
    p4 = swin_params(c, nh, hidden, gen, dev, bf, ws=4)
    x = torch.randn(8, 126, 126, c, generator=gen).to(dev, bf)
    x21 = torch.randn(1, 21, 35, c, generator=gen).to(dev, bf)
    x12 = torch.randn(1, 12, 20, c, generator=gen).to(dev, bf)
    mask = shift_mask_tensor(126, 126, 7, 3, dev)
    tol = 1e-2
    with Phase("8 swin_win") as ph:
        ph.note(f"window block kernel, C={c} nh={nh} bf16; limit max_abs <= "
                f"{tol} * max|ref| against the f32 plain version on the same "
                "bf16 inputs; control: the shifted cases' plain version "
                "without the mask")
        errs = []
        for xin, p, ws, phase in ((x, p7, 7, 3), (x, p7, 7, 0),
                                  (x21, p7, 7, 3), (x12, p4, 4, 2)):
            h, w = xin.shape[1:3]
            m = shift_mask_tensor(h, w, ws, phase, dev)
            got = swin_block_2d(xin, p, nh, m, phase, ws,
                                packed=pack_swin_block(p, nh))
            ref = swin_block_win_reference(xin.float(), p, nh, m, phase, ws)
            torch.cuda.synchronize()
            control = None if m is None else swin_block_win_reference(
                xin.float(), p, nh, None, phase, ws)
            errs.append(check_case(
                ph, f"{tuple(xin.shape[:3])} ws {ws} ({(h // ws) * (w // ws)} "
                f"windows) phase {phase}", got, ref, tol, control))
        pk = pack_swin_block(p7, nh)
        ms = cuda_ms(lambda: swin_block_2d(x, p7, nh, mask, 3, 7, packed=pk))
        plain_ms = cuda_ms(lambda: swin_block_win_reference(
            x.float(), p7, nh, mask, 3, 7), warmup=1, reps=5)
        tokens = x.numel() // c
        flops = tokens * swinir_block_flops_per_token(c, nh, 7, hidden / c)
        nbytes = (2 * 2 * tokens * c + block_weight_bytes(c, nh, hidden, 49)
                  + 4 * mask.numel())
        bms, by = bound_ms(flops, nbytes)
        ph.note(f"kernel {ms:.3f} ms (B=8 126x126 ws 7 shifted, median of 10); "
                f"plain f32 {plain_ms:.3f} ms; bound {bms:.4f} ms ({by}, "
                f"{flops / 1e9:.1f} GFLOP on the real tokens), "
                f"{bms / ms:.4f} of it; {flops / ms / 1e9:.1f} TFLOP/s")
    report.append(dict(
        name="swin_block_win", route="cuda",
        source="kair_tpu_torch/csrc/swin_block.cu",
        replaces="kair_tpu/ops/pallas/swin_block.py:843",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


def phase_window_msa(report: list) -> None:
    import torch
    from kair_tpu_torch.ops.kernels.window_msa import (pack_window_msa,
                                                       shift_mask_tensor,
                                                       window_msa_win,
                                                       window_msa_win_reference)
    from kair_tpu_torch.utils.summary import window_msa_flops_per_token

    b, h, w, c, nh = 16, 128, 128, 180, 6
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 5)
    p = swin_params(c, nh, 2 * c, gen, dev, bf)
    y = torch.randn(b, h, w, c, generator=gen).to(dev, bf)
    mask = shift_mask_tensor(h, w, 8, 4, dev)
    tol = 1e-2

    def args(qkv_bias, m, phase, f32=False):
        cast = (lambda t: None if t is None else t.float()) if f32 else \
            (lambda t: t)
        return (cast(p.qkv_weight), cast(qkv_bias), cast(p.proj_weight),
                cast(p.proj_bias), cast(p.rel_table), nh, m, phase, 8)

    with Phase("9 window_msa") as ph:
        ph.note(f"window attention kernel on a bf16 B={b} {h}x{w} C={c} map, "
                f"nh={nh}; limit max_abs <= {tol} * max|ref| against the "
                "composed window_msa in f32; control: the shifted cases' "
                "plain version without the mask")
        errs = []
        for qb, m, phase in ((p.qkv_bias, mask, 4), (p.qkv_bias, None, 0),
                             (None, mask, 4)):
            pk = pack_window_msa(*args(qb, m, phase)[:6])
            got = window_msa_win(y, *args(qb, m, phase), packed=pk)
            ref = window_msa_win_reference(y.float(), *args(qb, m, phase, True))
            torch.cuda.synchronize()
            control = None if m is None else window_msa_win_reference(
                y.float(), *args(qb, None, phase, True))
            errs.append(check_case(
                ph, f"phase {phase} mask={'shift' if m is not None else 'none'}"
                f" qkv_bias={'yes' if qb is not None else 'no'}", got, ref, tol,
                control))
        pk = pack_window_msa(*args(p.qkv_bias, mask, 4)[:6])
        ms = cuda_ms(lambda: window_msa_win(y, *args(p.qkv_bias, mask, 4),
                                            packed=pk))
        plain_ms = cuda_ms(lambda: window_msa_win_reference(
            y.float(), *args(p.qkv_bias, mask, 4, True)), warmup=1, reps=5)
        tokens = b * h * w
        flops = tokens * window_msa_flops_per_token(c, 8)
        weights = 2 * 4 * c * c + 4 * 4 * c + 4 * nh * 64 * 64
        nbytes = 2 * 2 * tokens * c + weights + 4 * mask.numel()
        bms, by = bound_ms(flops, nbytes)
        bytes_ms = nbytes / 3.35e12 * 1e3
        ph.note(f"kernel {ms:.3f} ms (shifted, median of 10); plain f32 "
                f"{plain_ms:.3f} ms; bound {bms:.4f} ms ({by}; the bytes alone "
                f"{bytes_ms:.4f} ms), {bms / ms:.4f} of it; "
                f"{flops / ms / 1e9:.1f} TFLOP/s")
    report.append(dict(
        name="window_msa_win", route="cuda",
        source="kair_tpu_torch/csrc/swin_block.cu",
        replaces="kair_tpu/ops/pallas/window_msa.py:271",
        launches=None, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None))


def visible_state_dict(model, seed: int, he_convs=(), img_range: float = 1.0):
    """A seeded state dict in which the Swin blocks move the output: the
    blocks drawn by BLOCK_INIT (``seeded_train_weights``), the convs named
    in ``he_convs`` redrawn He-normal (std sqrt(2 / fan_in)), conv_first
    scaled by 1 / img_range and conv_last by img_range. Under KAIR's
    initialisation the blocks' share of the output is ~1e-3 both at
    img_range 255 (the body sees the input at 255x its scale) and behind
    the five small-gain convs of the nearest+conv head; no comparison could
    see a wrong block there."""
    import torch
    sd = seeded_train_weights(model, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for name in he_convs:
        v = sd[f"{name}.weight"]
        sd[f"{name}.weight"] = torch.randn(v.shape, generator=gen) * math.sqrt(
            2.0 / v[0].numel())
    if img_range != 1.0:
        sd["conv_first.weight"] = sd["conv_first.weight"] / img_range
        sd["conv_last.weight"] = sd["conv_last.weight"] * img_range
        sd["conv_last.bias"] = sd["conv_last.bias"] * img_range
    return sd


def cpu_without_shift_mask(fn):
    """fn() with the shifted blocks' 0/−100 mask left out of the model."""
    from kair_tpu_torch.models import swinir as msw
    with_mask = msw.shift_mask_tensor
    msw.shift_mask_tensor = lambda *a: None
    try:
        return fn()
    finally:
        msw.shift_mask_tensor = with_mask


class LaunchCount:
    """Zero every kernel's launch count (and count calls of the composed
    block route, which the card must never take), read them after."""

    def __enter__(self):
        from kair_tpu_torch.models import swinir as msw
        from kair_tpu_torch.ops.kernels import conv_block, swin_block, window_msa
        # kernel name → (wrapper, its count of that kernel's launches)
        self.fns = {"swin_block_2d": (swin_block.swin_block_2d, "launches"),
                    "swin_block_win": (swin_block.swin_block_2d, "launches_win"),
                    "window_msa_win": (window_msa.window_msa_win, "launches"),
                    "conv3x3_residual": (conv_block.conv3x3_residual, "launches")}
        for f, attr in self.fns.values():
            setattr(f, attr, 0)
        self.composed, self.msw = 0, msw
        self.ref = msw.swin_block_win_reference

        def counted(*a, **kw):
            self.composed += 1
            return self.ref(*a, **kw)
        msw.swin_block_win_reference = counted
        return self

    def __exit__(self, *exc):
        self.msw.swin_block_win_reference = self.ref
        self.counts = {n: getattr(f, attr) for n, (f, attr) in self.fns.items()}
        self.counts["composed"] = self.composed
        return False

    def expect(self, what: str, **want) -> str:
        got = {k: v for k, v in self.counts.items() if v}
        want = {k: v for k, v in want.items() if v}
        require(got == want, f"{what}: launches {got}, expected {want}")
        return ", ".join(f"{k} {v}" for k, v in self.counts.items())


def model_timing(ph, model, x, flops_per_px: float, card: str, what: str):
    """ms per forward (median of 10, CUDA events), LR MP/s and MFU;
    returns the ms."""
    import torch
    from kair_tpu_torch.utils.summary import peak_bf16_tflops
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(x), warmup=2, reps=10)
    b, h, w = x.shape[:3]
    tflops = flops_per_px * b * h * w / (ms / 1e3) / 1e12
    peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
    ph.note(f"{what}: ms_per_forward {ms:.2f}, {b * h * w / (ms / 1e3) / 1e6:.4f} "
            f"LR MP/s, {tflops:.1f} TFLOP/s, MFU "
            f"{'n/a' if not peak else f'{tflops / peak:.4f}'} of the bf16 "
            f"dense peak [{card}]")
    require(math.isfinite(ms) and ms > 0, f"{what} timing")
    return ms


def forward(model, x):
    import torch
    with torch.inference_mode():
        out = model(x)
    if x.is_cuda:
        torch.cuda.synchronize()
    return out.float().cpu()


# KAIR 006_CAR_DFWB_s126w7_SwinIR-M_jpeg{10,20,30,40} (main_test_swinir.py:
# 170-172), color, as an option tree's netG
JPEG_CAR_NET = {"net_type": "swinir", "upscale": 1, "in_nc": 3,
                "img_size": 126, "window_size": 7, "img_range": 255.0,
                "depths": [6] * 6, "embed_dim": 180, "num_heads": [6] * 6,
                "mlp_ratio": 2, "upsampler": "", "resi_connection": "1conv"}


def phase_jpeg_car(report: list, card: str) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.utils.summary import swinir_flops_per_lr_pixel

    b, s, tol = 8, 126, 2e-2
    with Phase("10 jpeg_car") as ph:
        torch.manual_seed(SEED)
        cpu_model = define_g({"netG": dict(JPEG_CAR_NET)}).eval()
        sd = visible_state_dict(cpu_model, SEED + 6, img_range=255.0)
        cpu_model.load_state_dict(sd)
        gpu_model = define_g({"netG": dict(JPEG_CAR_NET)})
        gpu_model.load_state_dict(sd)
        gpu_model = gpu_model.to("cuda", torch.bfloat16).eval()
        ph.note("KAIR 006_CAR_DFWB_s126w7_SwinIR-M (color, embed 180, depths "
                "6x6, 6 heads, window 7, img_range 255) from an option tree "
                "through define_g, bf16 on cuda, blocks by BLOCK_INIT, "
                "conv_first / 255 and conv_last x 255 (visible_state_dict); "
                f"limit max_abs <= {tol} * max|ref| against the f32 CPU run on "
                "image 0; head normalisation and the image residual in f32")
        rng = np.random.RandomState(SEED + 7)
        imgs = np.stack([smooth_image(s, s, SEED + 200 + i) for i in range(b)])
        x = np.clip(imgs / 255.0 + rng.normal(0, 8 / 255, imgs.shape), 0, 1)
        x = torch.from_numpy(x.astype(np.float32))
        xg = x.to("cuda")
        with LaunchCount() as lc:
            out = forward(gpu_model, xg)
        counts = lc.expect("JPEG-CAR forward", swin_block_win=36,
                           conv3x3_residual=7)
        for k in report:
            if k["name"] == "swin_block_win":
                k["launches"] = lc.counts["swin_block_win"]
        ph.note(f"launches in one B={b} {s}x{s} forward: {counts}")
        require(out.shape == x.shape and torch.isfinite(out).all().item(),
                f"output {tuple(out.shape)} or non-finite values")
        ref = forward(cpu_model, x[:1])
        control = cpu_without_shift_mask(lambda: forward(cpu_model, x[:1]))
        e_abs = check_case(ph, f"image 0 ({s}x{s})", out[:1], ref, tol, control)
        ph.note(f"max error {e_abs * 255:.3f} gray levels (of 255)")
        ms = model_timing(ph, gpu_model, xg, swinir_flops_per_lr_pixel(
            window=7, upsampler="", upscale=1), card, f"B={b} {s}x{s}")

        def two_forwards():
            with torch.inference_mode():
                gpu_model(xg)
                gpu_model(xg)
        ph.note(device_breakdown(two_forwards, 2, ms, "forward"))


def phase_unfused(report: list, card: str, build_dir) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.cli.test import SWINIR_X4, build_preset
    from kair_tpu_torch.utils.summary import swinir_flops_per_lr_pixel

    b, s, tol = 16, 128, 2e-2
    with Phase("11 unfused") as ph:
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            path = f"{tmp}/swinir_m_x4_seed{SEED}.pth"
            torch.save({"params": main_path_state_dict(SEED)}, path)
            unfused, _, _ = build_preset("swinir_classical_x4", path, "cuda",
                                         torch.bfloat16, fuse=False)
            fused, _, _ = build_preset("swinir_classical_x4", path, "cuda",
                                       torch.bfloat16, fuse=True)
            cpu_model, _, _ = build_preset("swinir_classical_x4", path, "cpu",
                                           torch.float32, fuse=False)
        ph.note("SwinIR-M x4 (the main path's weights) through "
                "cli.test.build_preset with fuse off: LN1, window-attention "
                "kernel, residual, LN2 and MLP (cuBLAS), cuDNN tails; limit "
                f"max_abs <= {tol} * max|ref| against the fused forward on "
                "the batch and the f32 CPU run on a 64x64 crop, with the "
                "dropped-mask control")
        x = torch.rand(b, s, s, 3, generator=torch.Generator().manual_seed(SEED))
        xg = x.to("cuda")
        with LaunchCount() as lc:
            out = forward(unfused, xg)
        counts = lc.expect("unfused forward", window_msa_win=36)
        for k in report:
            if k["name"] == "window_msa_win":
                k["launches"] = lc.counts["window_msa_win"]
        ph.note(f"launches in one B={b} {s}x{s} forward: {counts}")
        require(out.shape == (b, 4 * s, 4 * s, 3) and torch.isfinite(out).all().item(),
                f"output {tuple(out.shape)} or non-finite values")
        check_case(ph, "against the fused forward", out, forward(fused, xg), tol)
        crop = x[:1, :64, :64].contiguous()
        ref = forward(cpu_model, crop)
        control = cpu_without_shift_mask(lambda: forward(cpu_model, crop))
        check_case(ph, "64x64 crop against f32 CPU", forward(unfused, crop.cuda()),
                   ref, tol, control)
        model_timing(ph, unfused, xg, swinir_flops_per_lr_pixel(), card,
                     f"unfused B={b} {s}x{s}")
        model_timing(ph, fused, xg, swinir_flops_per_lr_pixel(), card,
                     f"fused, same call, B={b} {s}x{s}")


# KAIR 003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN (main_test_swinir.py)
SWINIR_L = dict(upscale=4, in_chans=3, embed_dim=240, depths=(6,) * 9,
                num_heads=(8,) * 9, window_size=8, mlp_ratio=2.0,
                upsampler="nearest+conv", resi_connection="3conv")
NEAREST_CONV_HEAD = ("conv_before_upsample.0", "conv_up1", "conv_up2",
                     "conv_hr", "conv_last")


# the modules whose outputs phase 12 compares stage by stage
SWINIR_L_STAGES = ("conv_first", *(f"layers.{i}" for i in range(9)), "norm",
                   "conv_after_body", *NEAREST_CONV_HEAD)
SWINIR_L_TAILS = (*(f"layers.{i}.conv" for i in range(9)), "conv_after_body")


class stage_outputs(dict):
    """While open, records the f32 CPU copy of each named module's output
    of the model's next forward."""

    def __init__(self, model, names):
        super().__init__()
        mods = dict(model.named_modules())
        self.hooks = [mods[n].register_forward_hook(
            lambda m, a, out, n=n: self.__setitem__(n, out.detach().float().cpu()))
            for n in names]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for hk in self.hooks:
            hk.remove()
        return False


def with_f32_modules(gpu_model, cpu_model, body=(), head=()):
    """A copy of the bf16 card model in which the named modules are the f32
    CPU model's, moved to the card, with their input cast to f32: each of
    ``body`` hands its output back in bf16 (the body's stream stays bf16),
    the ``head`` keeps f32 to the end."""
    import copy
    import torch
    model = copy.deepcopy(gpu_model)
    for name in (*body, *head):
        sub = copy.deepcopy(cpu_model.get_submodule(name)).to("cuda")
        sub.register_forward_pre_hook(lambda m, a: tuple(t.float() for t in a))
        if name in body:
            sub.register_forward_hook(lambda m, a, out: out.to(torch.bfloat16))
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, attr, sub)
    return model


def error_attribution(cpu_model, gpu_model, img, ref, ref_stages,
                      gpu_stages) -> str:
    """max_rel (of each tensor's own max|ref|) of the bf16 card run against
    the f32 CPU run after each stage, and of the output with the 3conv
    tails, the head's convs, both, or every conv computed in f32 on the
    card (what is left then is the Swin blocks' and LayerNorms')."""
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    parts = ["after " + ", ".join(f"{n} {rel(gpu_stages[n], ref_stages[n]):.4g}"
                                  for n in SWINIR_L_STAGES)]
    for what, body, head in (
            ("the 3conv tails", SWINIR_L_TAILS, ()),
            ("the head's convs", (), NEAREST_CONV_HEAD),
            ("tails and head", SWINIR_L_TAILS, NEAREST_CONV_HEAD),
            ("every conv", ("conv_first",) + SWINIR_L_TAILS, NEAREST_CONV_HEAD)):
        model = with_f32_modules(gpu_model, cpu_model, body, head)
        parts.append(f"output max_rel with {what} in f32 "
                     f"{rel(forward(model, img.cuda()), ref):.4g}")
    return "; ".join(parts)


def phase_swinir_l(card: str) -> None:
    import numpy as np
    import torch
    from kair_tpu_torch.models.swinir import SwinIR
    from kair_tpu_torch.utils.summary import swinir_flops_per_lr_pixel

    b, s, tol = 4, 128, 2e-2
    with Phase("12 swinir_l") as ph:
        torch.manual_seed(SEED)
        cpu_model = SwinIR(img_size=64, **SWINIR_L).eval()
        sd = visible_state_dict(cpu_model, SEED + 8, he_convs=NEAREST_CONV_HEAD)
        cpu_model.load_state_dict(sd)
        gpu_model = SwinIR(img_size=64, **SWINIR_L)
        gpu_model.load_state_dict(sd)
        gpu_model = gpu_model.to("cuda", torch.bfloat16).eval()
        ph.note(f"SwinIR-L x4 real-world SR ({sum(p.numel() for p in gpu_model.parameters())} "
                "params; embed 240, depths 9x6, 8 heads, window 8, 3conv, "
                "nearest+conv) bf16 on cuda; blocks by BLOCK_INIT, the head's "
                f"convs He-normal (visible_state_dict); limit max_abs <= {tol} "
                "* max|ref| against the f32 CPU run on a 64x64 image")
        x = torch.rand(b, s, s, 3, generator=torch.Generator().manual_seed(SEED + 9))
        xg = x.to("cuda")
        with LaunchCount() as lc:
            out = forward(gpu_model, xg)
        counts = lc.expect("SwinIR-L forward", swin_block_2d=54)
        ph.note(f"launches in one B={b} {s}x{s} forward: {counts}")
        require(out.shape == (b, 4 * s, 4 * s, 3) and torch.isfinite(out).all().item(),
                f"output {tuple(out.shape)} or non-finite values")
        img = torch.from_numpy(smooth_image(64, 64, SEED + 300).astype(np.float32)
                               / 255.0)[None]
        with stage_outputs(cpu_model, SWINIR_L_STAGES) as ref_stages:
            ref = forward(cpu_model, img)
        control = cpu_without_shift_mask(lambda: forward(cpu_model, img))
        with stage_outputs(gpu_model, SWINIR_L_STAGES) as gpu_stages:
            got = forward(gpu_model, img.cuda())
        check_case(ph, "64x64 image against f32 CPU", got, ref, tol, control)
        ph.note("where the error is: " + error_attribution(
            cpu_model, gpu_model, img, ref, ref_stages, gpu_stages))
        model_timing(ph, gpu_model, xg, swinir_flops_per_lr_pixel(
            240, (6,) * 9, 8, 8, 2.0, 64, 3, 4, "nearest+conv", "3conv"), card,
            f"B={b} {s}x{s}")


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    import torch

    report: list = []
    with Phase("0 device") as ph:
        if not torch.cuda.is_available():
            ph.note("torch.cuda.is_available() is False")
            raise RuntimeError("no CUDA device: chip_smoke needs an NVIDIA card")
        card = nvidia_smi()
        log(card)
        ph.note(f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                f"python {sys.version.split()[0]}")
        # the plain references are f32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    from kair_tpu_torch.ops.kernels import _build
    with Phase("1 build") as ph:
        lib = _build.library()
        ph.note(f"{_build.library_path().name}: one nvcc call, "
                f"{len(_build.sources())} sources")
        for line in _build.build_log().splitlines():
            if "registers" in line or "spill" in line:
                ph.note(line.strip())
        ph.note(f"shared memory per block: conv {lib.kair_conv3x3_shared_bytes(180)} "
                f"B, swin backward {lib.kair_swin_block_bwd_shared_bytes(180, 6, 368)} B")
        # the wrappers' checks mirror the kernels' layout arithmetic
        from kair_tpu_torch.ops.kernels.swin_block import bwd_shared_bytes
        from kair_tpu_torch.ops.kernels.window_msa import shared_bytes
        for c, nh, hp in ((60, 6, 128), (180, 6, 368), (240, 8, 480)):
            blk, att, bwd = (lib.kair_swin_block_shared_bytes(c, nh, hp),
                             lib.kair_window_msa_shared_bytes(c, nh),
                             lib.kair_swin_block_bwd_shared_bytes(c, nh, hp))
            require((blk, att, bwd) == (shared_bytes(c, nh, hp),
                                        shared_bytes(c, nh, 0, block=False),
                                        bwd_shared_bytes(c, nh, hp)),
                    f"shared-memory mirror differs from the kernels at C={c}")
            ph.note(f"C={c}, {nh} heads: block {blk} B, attention {att} B, "
                    f"backward {bwd} B")

    phase_swin(report)
    phase_conv(report)
    phase_main_path(report, _build.BUILD_DIR)
    phase_throughput(card)
    phase_swin_bwd(report)
    phase_train(report, card, _build.BUILD_DIR)
    phase_swin_win(report)
    phase_window_msa(report)
    phase_jpeg_car(report, card)
    phase_unfused(report, card, _build.BUILD_DIR)
    phase_swinir_l(card)
    faulthandler.cancel_dump_traceback_later()

    log(card)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
