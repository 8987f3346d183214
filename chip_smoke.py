#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

The main path is SwinIR-M ×4 classical-SR inference (embed 180, depths
6×6, 6 heads, window 8, MLP ratio 2, pixelshuffle head, bf16) through the
port's two hand-written kernels: the fused Swin block and the fused
conv3x3 + residual tail. Phases, one flushed line each with its seconds:

  0 device      card name, power limit (nvidia-smi), torch and CUDA versions
  1 build       the kernels, from csrc/, with one plain nvcc call
  2 swin_block  kernel against its plain version at B=16, 128x128, C=180,
                and at the main path's 1x64x72
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

WATCHDOG_S = 540          # the whole run, build included, stays under 10 min
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


def swin_params(c: int, nh: int, hidden: int, gen, device, dtype):
    """Seeded block weights, scaled so the softmax is far from uniform and
    every term of the block moves the output."""
    import torch
    from kair_tpu_torch.ops.kernels.swin_block import SwinBlockParams

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(*shape, generator=gen) * std + mean).to(device, dtype)

    return SwinBlockParams(
        qkv_weight=rnd(3 * c, c, std=0.1), qkv_bias=rnd(3 * c, std=0.1),
        proj_weight=rnd(c, c, std=0.05), proj_bias=rnd(c, std=0.1),
        rel_table=rnd(225, nh, std=0.5),
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
        # profiler, device events only (a CPU op that launched a ctypes-bound
        # kernel would count that kernel's time again)
        prof_steps = 2
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for bt in batches[warmup:warmup + prof_steps]:
                trainer.train_step(bt)
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
                rows.append((dev_us / 1e3 / prof_steps, ev.count // prof_steps,
                             ev.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        ph.note(f"(d) device time per step (profiler, {prof_steps} steps): busy "
                f"{busy:.2f} ms of the {ms:.2f} ms step, idle share "
                f"{1 - busy / ms:.4f}; " + ", ".join(
                    f"{kernel_name(name)} {t:.2f} ms x{n}"
                    for t, n, name in rows[:8]) if rows else
                "(d) the profiler saw no device time")

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
        ph.note(f"shared memory: swin {lib.kair_swin_block_shared_bytes(180, 6, 368)} "
                f"B, conv {lib.kair_conv3x3_shared_bytes(180)} B, swin backward "
                f"{lib.kair_swin_block_bwd_shared_bytes(180, 6, 368)} B per block")

    phase_swin(report)
    phase_conv(report)
    phase_main_path(report, _build.BUILD_DIR)
    phase_throughput(card)
    phase_swin_bwd(report)
    phase_train(report, card, _build.BUILD_DIR)
    faulthandler.cancel_dump_traceback_later()

    log(card)
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
