"""Fused Swin-transformer block on the (B, H, W, C) map — CUDA kernel 1.

Replaces ``kair_tpu/ops/pallas/swin_block.py :: swin_block_pallas_2d``
(TPU body ``_kernel_2d`` :174 + ``_block_body`` :68) at inference:

    out = Block(roll(x, (−phase, −phase)))   written in the block's own
                                              (rolled) coordinates

where Block is the windowed Swin block, ws=8: LN1 → W-MSA (rel-pos bias,
0/−100 shift mask for shifted blocks) → +x → LN2 → fc1 → exact GELU → fc2
→ +x. The kernel is ``csrc/swin_block.cu`` (its header gives the bound on
the card and what the design does about it); ``swin_block_2d_reference``
below is its plain PyTorch version.

``swin_block_2d`` launches the kernel for a CUDA tensor and uses the plain
version only for a CPU tensor. It never falls back: a tensor the kernel
does not take raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.window_msa import fold_ln_affine, window_bias
from kair_tpu_torch.ops.window_attention import (relative_position_index,
                                                  window_msa,
                                                  window_partition,
                                                  window_reverse)

WS = 8                      # the kernel's window: 8x8 = 64 tokens
HD_MAX = 32                 # head dim is zero-padded to 32 in the kernel


class SwinBlockParams(NamedTuple):
    """One block's parameters in KAIR's ``nn.Linear`` layout (out, in)."""
    qkv_weight: torch.Tensor        # (3C, C)
    qkv_bias: Optional[torch.Tensor]
    proj_weight: torch.Tensor       # (C, C)
    proj_bias: torch.Tensor
    rel_table: torch.Tensor         # ((2ws-1)², nh)
    norm1_weight: torch.Tensor
    norm1_bias: torch.Tensor
    norm2_weight: torch.Tensor
    norm2_bias: torch.Tensor
    fc1_weight: torch.Tensor        # (hidden, C)
    fc1_bias: torch.Tensor
    fc2_weight: torch.Tensor        # (C, hidden)
    fc2_bias: torch.Tensor


class SwinBlockPack(NamedTuple):
    """Kernel operands (see the layout note in csrc/swin_block.cu)."""
    wqkv: torch.Tensor      # (CP, nh*96) bf16, LN1 affine + q scale folded
    bqkv: torch.Tensor      # (nh*96,) f32
    wp: torch.Tensor        # (nh*32, CP) bf16
    bp: torch.Tensor        # (C,) f32
    w1: torch.Tensor        # (CP, HP) bf16, LN2 affine folded
    b1: torch.Tensor        # (HP,) f32
    w2: torch.Tensor        # (HP, CP) bf16
    b2: torch.Tensor        # (C,) f32
    relbias: torch.Tensor   # (nh, 64, 64) f32
    hp: int


def pack_swin_block(p: SwinBlockParams, num_heads: int,
                    dtype: torch.dtype = torch.bfloat16) -> SwinBlockPack:
    """Relayout, fold and cast one block's parameters for the kernel (once
    per set of weights; the model caches the result). The kernel takes
    bf16 matrices; ``dtype=torch.float32`` keeps them exact for checking
    the layout against the plain version."""
    c = p.qkv_weight.shape[1]
    nh = num_heads
    hd = c // nh
    cp = _build.round16(c)
    hidden = p.fc1_weight.shape[0]
    hp = _build.round16(hidden)
    dev = p.qkv_weight.device
    f32 = torch.float32

    qkv_b = (p.qkv_bias if p.qkv_bias is not None
             else torch.zeros(3 * c, device=dev))
    w, b = fold_ln_affine(p.qkv_weight, qkv_b, p.norm1_weight, p.norm1_bias)
    wt = w.t().reshape(c, 3, nh, hd).clone()        # columns [q | k | v] x heads
    b = b.reshape(3, nh, hd).clone()
    wt[:, 0] *= hd ** -0.5
    b[0] *= hd ** -0.5
    wqkv = torch.zeros(cp, nh, 3, HD_MAX, device=dev, dtype=f32)
    wqkv[:c, :, :, :hd] = wt.permute(0, 2, 1, 3)
    bqkv = torch.zeros(nh, 3, HD_MAX, device=dev, dtype=f32)
    bqkv[:, :, :hd] = b.permute(1, 0, 2)

    wp = torch.zeros(nh, HD_MAX, cp, device=dev, dtype=f32)
    wp[:, :hd, :c] = p.proj_weight.float().t().reshape(nh, hd, c)

    w1f, b1f = fold_ln_affine(p.fc1_weight, p.fc1_bias, p.norm2_weight,
                              p.norm2_bias)
    w1 = torch.zeros(cp, hp, device=dev, dtype=f32)
    w1[:c, :hidden] = w1f.t()
    b1 = torch.zeros(hp, device=dev, dtype=f32)
    b1[:hidden] = b1f
    w2 = torch.zeros(hp, cp, device=dev, dtype=f32)
    w2[:hidden, :c] = p.fc2_weight.float().t()

    return SwinBlockPack(
        wqkv=wqkv.reshape(cp, nh * 3 * HD_MAX).to(dtype).contiguous(),
        bqkv=bqkv.reshape(-1).contiguous(),
        wp=wp.reshape(nh * HD_MAX, cp).to(dtype).contiguous(),
        bp=p.proj_bias.float().contiguous(),
        w1=w1.to(dtype).contiguous(), b1=b1,
        w2=w2.to(dtype).contiguous(),
        b2=p.fc2_bias.float().contiguous(),
        relbias=window_bias(p.rel_table, nh, WS),
        hp=hp)


def swin_block_2d_reference(x: torch.Tensor, p: SwinBlockParams,
                            num_heads: int, mask: Optional[torch.Tensor] = None,
                            phase: int = 0, window: int = WS) -> torch.Tensor:
    """Plain PyTorch version of the kernel, computed in f32 from the given
    inputs (counterpart of ``_reference_2d`` :468 / ``_reference_block_tokens``
    :415): roll, window partition, LN1, W-MSA with max-subtracted softmax,
    residual, LN2, exact-GELU MLP, residual, window reverse. Returns
    ``x.dtype``. ``window`` other than 8 is the model's composed route for
    geometries the kernel does not take."""
    f = x.float()
    if phase:
        f = torch.roll(f, (-phase, -phase), (1, 2))
    b, h, w, c = f.shape
    y = F.layer_norm(f, (c,), p.norm1_weight.float(), p.norm1_bias.float(), 1e-5)
    a = window_msa(window_partition(y, window), p.qkv_weight.float(),
                   None if p.qkv_bias is None else p.qkv_bias.float(),
                   p.proj_weight.float(), p.proj_bias.float(),
                   p.rel_table.float(), relative_position_index(window, window),
                   num_heads, None if mask is None else mask.float())
    x1 = f + window_reverse(a, window, h, w)
    z = F.layer_norm(x1, (c,), p.norm2_weight.float(), p.norm2_bias.float(), 1e-5)
    z = F.gelu(F.linear(z, p.fc1_weight.float(), p.fc1_bias.float()))
    return (x1 + F.linear(z, p.fc2_weight.float(), p.fc2_bias.float())).to(x.dtype)


def _check_cuda_args(x, p, num_heads, mask):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"swin_block_2d kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("swin_block_2d expects a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    if h % WS or w % WS:
        raise ValueError(f"swin_block_2d needs H and W multiples of {WS}, "
                         f"got {h}x{w}")
    if c % 2 or c % num_heads or c // num_heads > HD_MAX:
        raise ValueError(f"swin_block_2d needs an even C divisible by the "
                         f"heads with head dim <= {HD_MAX} (C={c}, "
                         f"heads={num_heads})")
    if tuple(p.qkv_weight.shape) != (3 * c, c):
        raise ValueError(f"qkv weight {tuple(p.qkv_weight.shape)} does not "
                         f"match C={c}")
    if p.rel_table.shape != ((2 * WS - 1) ** 2, num_heads):
        raise ValueError("relative position table must be for an 8x8 window")
    if mask is not None:
        nw = (h // WS) * (w // WS)
        if (tuple(mask.shape) != (nw, WS * WS, WS * WS)
                or mask.dtype != torch.float32 or not mask.is_contiguous()
                or mask.device != x.device):
            raise ValueError(f"mask must be a contiguous f32 ({nw}, 64, 64) "
                             f"tensor on {x.device}")


def swin_block_2d(x: torch.Tensor, p: SwinBlockParams, num_heads: int,
                  mask: Optional[torch.Tensor] = None, phase: int = 0,
                  packed: Optional[SwinBlockPack] = None) -> torch.Tensor:
    """Fused inference Swin block on (B, H, W, C), window 8.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16 only),
    or an exception; ``packed`` is the cached ``pack_swin_block(p, nh)``."""
    if x.device.type == "cpu":
        return swin_block_2d_reference(x, p, num_heads, mask, phase)
    _check_cuda_args(x, p, num_heads, mask)
    pk = packed if packed is not None else pack_swin_block(p, num_heads)
    if pk.wqkv.dtype != torch.bfloat16 or pk.wqkv.device != x.device:
        raise ValueError("packed weights must be bf16 on the input's device")
    out = torch.empty_like(x)
    _launch(_build.library(), x, out, pk, num_heads, mask, phase)
    swin_block_2d.launches += 1
    return out


def _launch(lib, x: torch.Tensor, out: torch.Tensor, pk: SwinBlockPack,
            num_heads: int, mask: Optional[torch.Tensor], phase: int) -> None:
    """One launch of the kernel in ``lib`` on checked arguments; raises on a
    CUDA error (oversized shared memory included)."""
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        err = lib.kair_swin_block_2d(
            x.data_ptr(), out.data_ptr(), pk.wqkv.data_ptr(),
            pk.bqkv.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.w1.data_ptr(), pk.b1.data_ptr(), pk.w2.data_ptr(),
            pk.b2.data_ptr(), pk.relbias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            b, h, w, c, num_heads, pk.hp, int(phase),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "swin_block_2d")


swin_block_2d.launches = 0
