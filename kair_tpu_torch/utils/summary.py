"""Analytic FLOP count and the card's peak rates, for MFU and roofline
bounds (counterparts of ``bench.py:83 swinir_flops_per_lr_pixel`` and the
peak table of ``kair_tpu/utils/summary.py:18-33``).

The table holds NVIDIA's published dense peaks for the H100 SXM (data
sheet and the Hopper architecture white paper). They assume the card's full
700 W power limit; a card set lower runs slower, so every measured number
is reported beside ``nvidia-smi``'s power limit. An unknown card (or the
CPU) gets None, never a guessed number.
"""

from __future__ import annotations

from typing import Dict, Optional

# dense bf16 tensor-core TFLOP/s and device-memory TB/s, by device name
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bf16_tflops": 989.0, "hbm_tbps": 3.35},
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


def swinir_flops_per_lr_pixel(embed_dim=180, depths=(6,) * 6, num_heads=6,
                              window=8, mlp_ratio=2.0, num_feat=64,
                              in_chans=3, upscale=4) -> float:
    """Analytic FLOP per LR pixel for SwinIR classical SR with the
    pixelshuffle head (as bench.py counts it, on the unpadded head dim):
    the blocks, per-RSTB conv3x3, conv_first/after_body and the head."""
    c = embed_dim
    dense = sum(depths) * swinir_block_flops_per_token(
        c, num_heads, window, mlp_ratio) / 2.0
    convs = 9 * (in_chans * c + len(depths) * c * c + c * c + c * num_feat)
    s, f, area = upscale, num_feat, 1
    while s > 1:
        r = 3 if s % 3 == 0 else 2
        # each upsample conv runs on `area` pixels per LR pixel
        convs += 9 * f * (f * r * r) * area
        area *= r * r
        s //= r
    convs += 9 * f * in_chans * upscale ** 2        # conv_last at HR size
    return 2.0 * (dense + convs)
