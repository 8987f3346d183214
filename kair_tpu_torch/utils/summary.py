"""Analytic FLOP count and the card's peak rates, for MFU and roofline
bounds (counterparts of ``bench.py:83 swinir_flops_per_lr_pixel`` and the
peak table of ``kair_tpu/utils/summary.py:18-33``).

The table holds NVIDIA's published dense peaks for the H100 SXM (data
sheet and the Hopper architecture white paper). They assume the card's full
700 W power limit; a card set lower runs slower, so every measured number
is reported beside ``nvidia-smi``'s power limit. An unknown card (or the
CPU) gets None, never a guessed number.

The model summary at the end (``count_params``, ``describe_model``,
``cost_analysis``, ``activation_count``, ``summary_report``) measures a
module or a call instead: FLOP by ``FlopCounterMode``, bytes and
activations by a dispatch mode over the aten ops run.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

# dense bf16 tensor-core TFLOP/s, f32 TFLOP/s outside the tensor cores and
# device-memory TB/s, by device name
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bf16_tflops": 989.0, "fp32_tflops": 67.0, "hbm_tbps": 3.35},
}


def card_for_device_name(name: str) -> Optional[str]:
    """Map ``torch.cuda.get_device_name()`` to a PEAKS key. The SXM H100
    reports itself as e.g. "NVIDIA H100 80GB HBM3"; PCIe and NVL parts
    have other peaks and are not in the table."""
    n = name.upper()
    if "PCIE" in n or "NVL" in n:
        return None
    if "H100" in n:
        return "H100 SXM"
    return None


def peak_bf16_tflops(name: str) -> Optional[float]:
    card = card_for_device_name(name)
    return PEAKS[card]["bf16_tflops"] if card else None


def swinir_block_flops_per_token(embed_dim: int = 180, num_heads: int = 6,
                                 window: int = 8, mlp_ratio: float = 2.0
                                 ) -> float:
    """FLOP (mul+add = 2) per token of one Swin block: qkv C·3C, scores and
    PV 2·N·C, proj C·C, MLP 2·C·hidden — 564,480 at SwinIR-M width."""
    c, n = embed_dim, window * window
    return 2.0 * (c * 3 * c + 2 * n * c + c * c
                  + 2 * int(c * mlp_ratio) * c)


def swinir_block_bwd_flops_per_token(embed_dim: int = 180, window: int = 8,
                                     mlp_ratio: float = 2.0) -> float:
    """FLOP per token of the block backward with the forward recomputed
    (``ops/kernels/swin_block.py::swin_block_2d_bwd``): the forward without
    fc2 (its output is not needed), then two products per weight matrix
    (input grad and weight grad) and four attention products (dP, dq, dk,
    dv) — 1,563,840 at SwinIR-M width, 2.77x the forward."""
    c, n, hid = embed_dim, window * window, int(embed_dim * mlp_ratio)
    recompute = 2.0 * (3 * c * c + 2 * n * c + c * c + c * hid)
    backward = 2.0 * 2 * (3 * c * c + c * c + 2 * c * hid) + 2.0 * 4 * n * c
    return recompute + backward


def window_msa_flops_per_token(embed_dim: int = 180, window: int = 8) -> float:
    """FLOP per token of window attention alone (``window_msa_win``): qkv
    C·3C, scores and PV 2·N·C, proj C·C — 305,280 at SwinIR-M width."""
    c, n = embed_dim, window * window
    return 2.0 * (c * 3 * c + 2 * n * c + c * c)


def swinir_flops_per_lr_pixel(embed_dim=180, depths=(6,) * 6, num_heads=6,
                              window=8, mlp_ratio=2.0, num_feat=64,
                              in_chans=3, upscale=4, upsampler="pixelshuffle",
                              resi_connection="1conv") -> float:
    """Analytic FLOP per LR pixel of SwinIR (as bench.py counts it, on the
    unpadded head dim, real tokens only): the blocks, the RSTB and
    after-body convs (one 3x3, or 3conv's 3x3 → 1x1 → 3x3 at C/4),
    conv_first and the head: pixelshuffle, nearest+conv (x4) or the
    denoising / JPEG-CAR conv_last."""
    c, f = embed_dim, num_feat
    dense = sum(depths) * swinir_block_flops_per_token(
        c, num_heads, window, mlp_ratio) / 2.0
    tail = (9 * c * c if resi_connection == "1conv"
            else 9 * c * (c // 4) + (c // 4) ** 2 + 9 * (c // 4) * c)
    convs = 9 * in_chans * c + (len(depths) + 1) * tail
    if upsampler == "pixelshuffle":
        convs += 9 * c * f
        s, area = upscale, 1
        while s > 1:
            r = 3 if s % 3 == 0 else 2
            # each upsample conv runs on `area` pixels per LR pixel
            convs += 9 * f * (f * r * r) * area
            area *= r * r
            s //= r
        convs += 9 * f * in_chans * upscale ** 2    # conv_last at HR size
    elif upsampler == "nearest+conv":
        # conv_up1 at 2x, conv_up2, conv_hr and conv_last at 4x
        convs += 9 * c * f + 9 * f * f * (4 + 16 + 16) + 9 * f * in_chans * 16
    else:
        convs += 9 * c * in_chans
    return 2.0 * (dense + convs)


def tmsa_block_flops_per_token(embed_dim: int = 120, mlp_ratio: float = 2.0
                               ) -> float:
    """FLOP per token of VRT's TMSA mutual block on (2, 8, 8) windows
    (``ops/kernels/tmsa_block.py``): two qkv products C·3C, self scores and
    PV over 128 keys, mutual over 64, a 2C x C proj, GEGLU (fc11, fc12
    C·hidden, fc2 hidden·C) — 495,360 at VRT-001's C=120."""
    c, hid = embed_dim, int(embed_dim * mlp_ratio)
    return 2.0 * (2 * 3 * c * c + 2 * 128 * c + 2 * 64 * c + 2 * c * c
                  + 3 * c * hid)


def self_block_flops_per_token(embed_dim: int = 180, wd: int = 6,
                               mlp_ratio: float = 2.0) -> float:
    """FLOP per token of VRT's self-attention + GEGLU block on (wd, 8, 8)
    windows (``ops/kernels/self6_block.py``): qkv C·3C, scores and PV over
    64·wd keys, proj C·C, GEGLU — 924,480 at C=180, wd 6."""
    c, n, hid = embed_dim, 64 * wd, int(embed_dim * mlp_ratio)
    return 2.0 * (3 * c * c + 2 * n * c + c * c + 3 * c * hid)


def dcn_flops_per_pixel(cin: int = 120, cout: int = 120, taps: int = 9
                        ) -> float:
    """FLOP per output pixel of a modulated deformable conv
    (``ops/kernels/dcn_block.py``): the product of the K·Cin sampled columns
    with the weight, 2·K·Cin·Cout (the bilinear taps and the mask add
    ~7·K·Cin more, counted as well) — 266,760 at VRT-001's stage 1."""
    return 2.0 * taps * cin * cout + 7.0 * taps * cin


def vrt_flops_per_clip(frames: int = 6, h: int = 64, w: int = 64,
                       embed_dims=(120,) * 7 + (180,) * 6,
                       depths=(8,) * 7 + (4,) * 6, window=(6, 8, 8),
                       mul_attn_ratio: float = 0.75, mlp_ratio: float = 2.0,
                       pa_frames: int = 2, deformable_groups: int = 12,
                       upscale: int = 4, num_feat: int = 64,
                       in_chans: int = 3,
                       indep_reconsts=(11, 12)) -> float:
    """Analytic FLOP of one VRT forward on a (frames, h, w) LR clip, video
    SR with pa_frames 2 (KAIR's 001 layout): the 7 U-shaped stages (reshape
    linears, mutual and self blocks, linear1/2, the offset convs, the DCN,
    the GEGLU fusion), stage 8's RTMSA tail, conv_first, conv_after_body
    and the pixel-shuffle head. SpyNet, the warps and LayerNorms are not
    counted (under 3% together). 001 at 1x6x64x64: ~1.10 TFLOP."""
    scales = [1, 2, 4, 8, 4, 2, 1]
    total = 0.0
    c0 = embed_dims[0]
    total += 2.0 * frames * h * w * 9 * (in_chans * (1 + 2 * 4)) * c0
    for i in range(7):
        c, s = embed_dims[i], scales[i]
        px = frames * (h // s) * (w // s)
        if i in (1, 2, 3):
            total += 2.0 * px * 4 * embed_dims[i - 1] * c        # down linear
        elif i in (4, 5, 6):
            total += 2.0 * px * (embed_dims[i - 1] // 4) * c     # up linear
        d1 = int(depths[i] * mul_attn_ratio)
        wd = min(window[0], frames)
        total += px * (d1 * tmsa_block_flops_per_token(c, mlp_ratio)
                       + (depths[i] - d1)
                       * self_block_flops_per_token(c, wd, mlp_ratio))
        total += 2 * 2.0 * px * c * c                          # linear1, 2
        if pa_frames:
            # per aligned frame: offset convs (3C+2 → C → C → C → 27·dg),
            # the DCN, for 2·(frames − 1) alignments; then the GEGLU fusion
            pxf = (h // s) * (w // s)
            n_al = 2 * (frames - 1)
            cin_off = (pa_frames // 2) * (c + 2) + c
            off = 2.0 * 9 * (cin_off * c + 2 * c * c + c * 27 * deformable_groups)
            total += n_al * pxf * (off + dcn_flops_per_pixel(c * pa_frames // 2, c))
            total += 2.0 * px * (2 * 3 * c * 3 * c + 3 * c * c)   # pa_fuse
    c7, c8 = embed_dims[6], embed_dims[7]
    px = frames * h * w
    total += 2.0 * px * c7 * c8                                  # stage 8 head
    for j in range(7, len(depths)):
        cj = embed_dims[j]
        wd = 1 if j in indep_reconsts else min(window[0], frames)
        total += px * (depths[j] * self_block_flops_per_token(cj, wd, mlp_ratio)
                       + 2.0 * cj * cj)
    total += 2.0 * px * embed_dims[-1] * c0                      # conv_after_body
    total += 2.0 * px * 9 * c0 * num_feat                        # conv_before_upsample
    area, s = 1, upscale
    while s > 1:
        total += 2.0 * px * area * 9 * num_feat * num_feat * 4
        area *= 4
        s //= 2
    total += 2.0 * px * area * 9 * num_feat * (num_feat + in_chans)  # tail, last
    return total


def stl_block_flops_per_token(embed_dim: int = 144, n: int = 128,
                              mlp_ratio: float = 2.0) -> float:
    """FLOP per token of RVRT's self-only STL block over n-token windows
    with the plain MLP (``ops/kernels/stl2_block.py`` at n = 128, the 2-D
    Swin block at 64): qkv C·3C, scores and PV over n keys, proj C·C, fc1
    and fc2 C·hidden each — 405,504 at RVRT-001's C=144, n = 128."""
    c, hid = embed_dim, int(embed_dim * mlp_ratio)
    return 2.0 * (3 * c * c + 2 * n * c + c * c + 2 * c * hid)


def gda_flops_per_pixel(channels: int = 288, taps: int = 18) -> float:
    """FLOP per query pixel of guided deformable attention
    (``ops/kernels/gda_block.py``) over ``channels`` (RVRT's 2C) and ``taps``
    (clip·kh·kw) samples: per channel and tap the bilinear samples of k and
    v (four corners each, a multiply and an add per corner), the score's
    multiply-add and the value's — 103,680 at RVRT-001 (2C = 288, 18 taps).
    The kernel does them in f32 outside the tensor cores."""
    return 20.0 * channels * taps


def rvrt_flops_per_clip(frames: int = 8, h: int = 64, w: int = 64,
                        embed_dims=(144, 144, 144), depths=(2, 2, 2),
                        num_blocks=(1, 2, 1), clip_size: int = 2,
                        mlp_ratio: float = 2.0, attention_window=(3, 3),
                        deformable_groups: int = 12, upscale: int = 4, inputconv_groups=(1,) * 6,
                        num_feat: int = 64, in_chans: int = 3) -> float:
    """Analytic FLOP of one RVRT forward on a (frames, h, w) clip (KAIR's
    layout, ``models/rvrt.py``): the feature extraction (the x1 models' two
    stride-2 convs first), the four branches' backbones (input conv, STL2
    blocks, RSTB linears) on every frame and their guided deformable
    attention on every clip after the first (offset net, q/k/v
    projections, the attention, proj, MLP), the reconstruction and the x4
    pixel-shuffle head. SpyNet, the warps and LayerNorms are not counted.
    001 at 1x8x64x64: ~21.2 MFLOP per LR pixel, ~0.695 TFLOP."""
    e0, e1, e2 = embed_dims
    g = inputconv_groups
    feat_px = (h if upscale == 4 else h // 4) * (w if upscale == 4 else w // 4)
    px = frames * feat_px
    conv = lambda cin, cout, k, groups=1: 2.0 * k * k * cin * cout / groups

    def rstb_conv(cin, c, groups, depth, blocks, n):
        return (conv(cin, c, 3, groups) + blocks * (
            depth * stl_block_flops_per_token(c, n, mlp_ratio) + 2.0 * c * c))

    total = 0.0
    if upscale != 4:                  # two stride-2 convs at 1/2 and 1/4 size
        total += frames * (h // 2) * (w // 2) * conv(in_chans, e0, 3)
        total += px * conv(e0, e0, 3)
        total += px * rstb_conv(e0, e0, g[0], depths[0], num_blocks[0], 64)
    else:
        total += px * rstb_conv(in_chans, e0, g[0], depths[0], num_blocks[0], 64)
    k = attention_window[0] * attention_window[1]
    aligned = frames - clip_size       # query frames of the clips after the first
    gda = (conv(e1 * (1 + clip_size) + 2 * clip_size, 64, 1)
           + 4 * conv(64, 64, 3)
           + conv(64, clip_size * deformable_groups * k * 2, 1)
           + 3 * 2.0 * e1 * 2 * e1 + gda_flops_per_pixel(2 * e1, clip_size * k)
           + 2.0 * 2 * e1 * e1 + 2 * 2.0 * e1 * 2 * e1)
    for i in range(4):
        total += px * rstb_conv(e0 + (i + 1) * e1, e1, g[i + 1], depths[1],
                                num_blocks[1], 128)
        total += aligned * feat_px * gda
    total += px * rstb_conv(e0 + 4 * e1, e2, g[5], depths[2], num_blocks[2], 64)
    total += px * conv(e2, num_feat, 1)
    total += px * conv(num_feat, 4 * num_feat, 3)               # upsampler 0
    total += 4 * px * conv(num_feat, 4 * num_feat, 3)           # upsampler 1
    total += 16 * px * (conv(num_feat, num_feat, 3) + conv(num_feat, 3, 3))
    return total


# ---------------------------------------------------------------------------
# Model summary: parameters, FLOP, bytes, activations (counterpart of
# kair_tpu/utils/summary.py:36-82; reference utils/utils_modelsummary.py:
# 27-48 and main_challenge_sr.py:99-171)
# ---------------------------------------------------------------------------

def count_params(params) -> int:
    """Elements of a module's parameters, or of every tensor in a state
    dict."""
    import torch
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(v.numel() for v in params.values() if torch.is_tensor(v))


def describe_model(model) -> str:
    n = count_params(model)
    return f"{type(model).__name__}: {n:,} params ({n * 4 / 1e6:.2f} MB fp32)"


def _aten_mode(on_op):
    """A TorchDispatchMode that calls ``on_op(args, kwargs, out)`` after
    each aten op it runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            on_op(args, kwargs, out)
            return out
    return Mode()


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """``{"flops": ..., "bytes accessed": ...}`` of one call ``fn(*args)``
    under inference mode, the counterpart of XLA's cost analysis: "flops"
    from ``torch.utils.flop_counter.FlopCounterMode`` (a multiply-add is
    2; the matmuls, convolutions and attention it knows), "bytes accessed"
    the sum over the aten ops run of the bytes of their tensor inputs and
    outputs (each op reading its inputs once and writing its outputs once,
    no fusion: more than a fused program moves)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    total = [0]

    def on_op(a, kw, out):
        total[0] += sum(t.numel() * t.element_size()
                        for t in _tensors((a, kw)) + _tensors(out))
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter, _aten_mode(on_op):
        fn(*args)
    return {"flops": float(counter.get_total_flops()),
            "bytes accessed": float(total[0])}


def activation_count(fn: Callable, *args) -> int:
    """Output elements of every aten op in one call ``fn(*args)`` (the
    counterpart of the JAX package's count over a jaxpr's equations, and of
    the reference's get_model_activation, utils_modelsummary.py:48)."""
    import torch

    total = [0]

    def on_op(a, kw, out):
        total[0] += sum(t.numel() for t in _tensors(out))
    with torch.inference_mode(), _aten_mode(on_op):
        fn(*args)
    return total[0]


def summary_report(model, x, extra_args=()) -> str:
    """main_challenge_sr-style report (main_challenge_sr.py:99-171): the
    model, the input, its FLOP and bytes accessed by ``cost_analysis``."""
    ca = cost_analysis(lambda a: model(a, *extra_args), x)
    return "\n".join([
        describe_model(model),
        f"input {tuple(x.shape)}",
        f"FLOPs: {ca['flops'] / 1e9:.2f} G",
        f"bytes accessed: {ca['bytes accessed'] / 1e6:.1f} MB",
    ])
