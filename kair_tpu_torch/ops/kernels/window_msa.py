"""Window attention on the (B, H, W, C) map — CUDA kernel B — and the
host-side helpers that the Swin-block kernels share.

``window_msa_win`` replaces ``kair_tpu/ops/pallas/window_msa.py ::
window_msa_pallas`` (:217, ``pl.pallas_call`` :271) at inference:

    out = roll(W-MSA(roll(y, (−phase, −phase))), (phase, phase))

on an LN1 output ``y``: qkv → QKᵀ·scale + rel-pos bias (+ 0/−100 shift
mask) → softmax (row max subtracted) → PV → proj, for any window ws ≤ 8
that tiles the map. The kernel is the attention-only entry of
``csrc/swin_block.cu`` (its header gives the bound on the card); it reads
each window straight from the map with the shift folded into the read and
writes it back to the pixels it came from, so the output is un-rolled.
``window_msa_win_reference`` is its plain version: the port's composed
``ops/window_attention.window_msa`` between a roll, a window partition and
their inverses. A CPU tensor takes the plain version; a CUDA tensor the
kernel, or an exception.

Helpers (counterparts of ``fold_ln_affine`` :87, ``pack_qkv_fused`` :101
and the score bias of ``make_pair_bias`` :185). The TPU packs two 64-token
windows into one 128-row tile with a block-diagonal −1e9 mask, and sets a
constant-1 "rowsum lane" in v so the PV matmul also yields the softmax
denominator. Neither pays on Hopper: the kernels give each window its own
thread block and reduce rows with warp shuffles, so the bias is the plain
per-window one, and a window of N < 64 tokens is padded to 64 rows inside
the kernel (``padded_window_bias`` writes out the score bias that results).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.window_attention import (rel_pos_bias,
                                                  relative_position_index,
                                                  shift_attn_mask, window_msa,
                                                  window_partition,
                                                  window_reverse)

HD_MAX = 32                 # head dim is zero-padded to 32 in the kernels
N_PAD = 64                  # a window is padded to 64 rows in the kernels
NEG = -1e9                  # score of a padded key (make_pair_bias's −1e9)
SMEM_LIMIT = 232448         # H100 opt-in shared memory per thread block


def fold_ln_affine(weight: torch.Tensor, bias: torch.Tensor,
                   ln_scale: torch.Tensor, ln_bias: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a LayerNorm affine into the linear layer that consumes it
    (exact f32 algebra; residuals bypass the LN):
        (y·s + b) @ Wᵀ + c  =  y @ (W·s)ᵀ + (W @ b + c)
    ``weight`` is in ``nn.Linear`` layout (out, in). Inference only."""
    w32 = weight.float()
    return w32 * ln_scale.float()[None, :], w32 @ ln_bias.float() + bias.float()


def pack_qkv_proj(qkv_weight: torch.Tensor, qkv_bias: Optional[torch.Tensor],
                  proj_weight: torch.Tensor, num_heads: int,
                  ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  scale_q: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' f32 attention operands: wqkv (CP, nh*96) with per head
    [q | k | v] 32 columns each, bqkv (nh*96,), wp (nh*32, CP); head dim
    and C zero-padded. ``ln`` = (scale, bias) is folded into wqkv, bqkv
    (the block's LN1); ``scale_q`` folds hd^-½ into the q columns."""
    c = qkv_weight.shape[1]
    nh, hd, cp = num_heads, c // num_heads, _build.round16(c)
    dev, f32 = qkv_weight.device, torch.float32
    b = (qkv_bias if qkv_bias is not None
         else torch.zeros(3 * c, device=dev))
    if ln is not None:
        w, b = fold_ln_affine(qkv_weight, b, *ln)
    else:
        w, b = qkv_weight.float(), b.float()
    wt = w.t().reshape(c, 3, nh, hd).clone()        # columns [q | k | v] x heads
    b = b.reshape(3, nh, hd).clone()
    if scale_q:
        wt[:, 0] *= hd ** -0.5
        b[0] *= hd ** -0.5
    wqkv = torch.zeros(cp, nh, 3, HD_MAX, device=dev, dtype=f32)
    wqkv[:c, :, :, :hd] = wt.permute(0, 2, 1, 3)
    bqkv = torch.zeros(nh, 3, HD_MAX, device=dev, dtype=f32)
    bqkv[:, :, :hd] = b.permute(1, 0, 2)
    wp = torch.zeros(nh, HD_MAX, cp, device=dev, dtype=f32)
    wp[:, :hd, :c] = proj_weight.float().t().reshape(nh, hd, c)
    return (wqkv.reshape(cp, nh * 3 * HD_MAX), bqkv.reshape(-1),
            wp.reshape(nh * HD_MAX, cp))


def table_window(bias_table: torch.Tensor) -> int:
    """The window side of a ((2ws−1)², nh) relative-position table."""
    return (round(bias_table.shape[0] ** 0.5) + 1) // 2


def window_bias(bias_table: torch.Tensor, num_heads: int,
                ws: int = 8) -> torch.Tensor:
    """(nh, ws², ws²) f32 relative-position score bias, contiguous."""
    return rel_pos_bias(bias_table.float(), rel_index_on(ws, bias_table.device),
                        num_heads).contiguous()


def padded_window_bias(relbias: torch.Tensor, mask: Optional[torch.Tensor],
                       n_pad: int = N_PAD) -> torch.Tensor:
    """The score bias the kernels add, written out: (nW or 1, nh, n_pad,
    n_pad) f32 with the rel-pos bias (+ the window's shift mask) on the
    real N×N block, NEG on every padded key column and 0 on the padded
    query rows' real keys — ``make_pair_bias(n_pad=...)`` per window. A
    padded key's probability is exactly 0 under it."""
    nh, n, _ = relbias.shape
    per_win = relbias.float()[None] if mask is None else \
        relbias.float()[None] + mask.float()[:, None]
    out = torch.zeros(per_win.shape[0], nh, n_pad, n_pad, device=relbias.device)
    out[..., :n, :n] = per_win
    out[..., n:] = NEG
    return out


def rel_index_on(ws: int, device: torch.device) -> torch.Tensor:
    """The flat (ws⁴,) relative-position index as a long tensor on
    ``device``, made once per (window, device): copying it from the host
    at every pack would be a pageable copy that waits for the card."""
    return _rel_index_on(ws, str(device))


@lru_cache(maxsize=16)
def _rel_index_on(ws: int, device: str) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode: the
    # gather saves its index for backward, which an inference tensor fails
    with torch.inference_mode(False):
        return torch.as_tensor(relative_position_index(ws, ws).reshape(-1),
                               dtype=torch.long, device=device)


def shift_mask_tensor(h: int, w: int, ws: int, shift: int,
                      device: torch.device) -> Optional[torch.Tensor]:
    """(nW, ws², ws²) f32 0/−100 shift mask on ``device``, or None for an
    unshifted block. Cached per geometry: it is a constant of the shape."""
    if shift == 0:
        return None
    return _mask_on(h, w, ws, shift, str(device))


@lru_cache(maxsize=32)
def _mask_on(h: int, w: int, ws: int, shift: int, device: str) -> torch.Tensor:
    return torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(device)


# ---------------------------------------------------------------------------
# Shared-memory layout of csrc/swin_block.cu (SwinSmem), for the check
# before a launch; chip_smoke.py holds it equal to the kernel's own
# kair_window_msa_shared_bytes.
# ---------------------------------------------------------------------------

def shared_bytes(c: int, nh: int) -> int:
    """Bytes of shared memory one thread block of kernel B asks."""
    r16, a128 = _build.round16, _build.align128
    pad, ls, stage = 8, 64 + 4, 16 * 256 * 4
    la, lq = max(r16(c), nh * 32) + pad, nh * 96 + pad
    s = a128(a128(64 * la * 2) + 64 * lq * 2)
    cb = a128(a128(s + 64 * ls * 4) + stage)
    return cb + (nh * 96 + c) * 4


def check_geometry(name: str, x: torch.Tensor, qkv_weight: torch.Tensor,
                   num_heads: int,
                   bias_table: torch.Tensor, mask: Optional[torch.Tensor],
                   ws: int, smem: int) -> None:
    """Raise on an input that the window kernels do not take: bf16,
    contiguous (B, H, W, C) with ws ≤ 8 tiling H and W, an even C divisible
    by the heads with head dim ≤ 32, the table and mask of that window, and
    a shared-memory layout within the card's opt-in limit."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    if not 1 <= ws <= 8 or h % ws or w % ws:
        raise ValueError(f"{name} needs a window of at most 8 tiling H and W, "
                         f"got window {ws} on {h}x{w}")
    if c % 2 or c % num_heads or c // num_heads > HD_MAX:
        raise ValueError(f"{name} needs an even C divisible by the heads "
                         f"with head dim <= {HD_MAX} (C={c}, "
                         f"heads={num_heads})")
    if tuple(qkv_weight.shape) != (3 * c, c):
        raise ValueError(f"qkv weight {tuple(qkv_weight.shape)} does not "
                         f"match C={c}")
    if tuple(bias_table.shape) != ((2 * ws - 1) ** 2, num_heads):
        raise ValueError(f"relative position table must be for a {ws}x{ws} "
                         f"window and {num_heads} heads")
    if mask is not None:
        nw, n = (h // ws) * (w // ws), ws * ws
        if (tuple(mask.shape) != (nw, n, n) or mask.dtype != torch.float32
                or not mask.is_contiguous() or mask.device != x.device):
            raise ValueError(f"mask must be a contiguous f32 ({nw}, {n}, {n}) "
                             f"tensor on {x.device}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name} at C={c}, {num_heads} heads needs {smem} "
                         f"bytes of shared memory per block, over the card's "
                         f"opt-in limit of {SMEM_LIMIT}")


# ---------------------------------------------------------------------------
# Kernel B: attention only
# ---------------------------------------------------------------------------

class WindowMsaPack(NamedTuple):
    """Kernel B's operands (the layout note in csrc/swin_block.cu)."""
    wqkv: torch.Tensor      # (CP, nh*96) bf16, q scale folded
    bqkv: torch.Tensor      # (nh*96,) f32
    wp: torch.Tensor        # (nh*32, CP) bf16
    bp: torch.Tensor        # (C,) f32
    relbias: torch.Tensor   # (nh, N, N) f32


def pack_window_msa(qkv_weight: torch.Tensor, qkv_bias: Optional[torch.Tensor],
                    proj_weight: torch.Tensor, proj_bias: torch.Tensor,
                    bias_table: torch.Tensor, num_heads: int,
                    dtype: torch.dtype = torch.bfloat16) -> WindowMsaPack:
    """Relayout and cast W-MSA's parameters for kernel B (once per set of
    weights; the model caches it). Runs with autocast off."""
    with torch.autocast(qkv_weight.device.type, enabled=False):
        wqkv, bqkv, wp = pack_qkv_proj(qkv_weight, qkv_bias, proj_weight,
                                       num_heads)
        return WindowMsaPack(
            wqkv.to(dtype).contiguous(), bqkv.contiguous(),
            wp.to(dtype).contiguous(), proj_bias.float().contiguous(),
            window_bias(bias_table, num_heads, table_window(bias_table)))


def window_msa_win_reference(y: torch.Tensor, qkv_weight, qkv_bias,
                             proj_weight, proj_bias, bias_table,
                             num_heads: int,
                             mask: Optional[torch.Tensor] = None,
                             phase: int = 0, ws: int = 8) -> torch.Tensor:
    """Plain version of kernel B: roll by −phase, window partition, the
    composed ``window_msa``, window reverse, roll back; in ``y``'s dtype."""
    b, h, w, c = y.shape
    if phase:
        y = torch.roll(y, (-phase, -phase), (1, 2))
    a = window_msa(window_partition(y, ws), qkv_weight, qkv_bias, proj_weight,
                   proj_bias, bias_table, rel_index_on(ws, y.device),
                   num_heads, mask)
    a = window_reverse(a, ws, h, w)
    return torch.roll(a, (phase, phase), (1, 2)) if phase else a


def window_msa_win(y: torch.Tensor, qkv_weight, qkv_bias, proj_weight,
                   proj_bias, bias_table, num_heads: int,
                   mask: Optional[torch.Tensor] = None, phase: int = 0,
                   ws: int = 8, packed: Optional[WindowMsaPack] = None
                   ) -> torch.Tensor:
    """W-MSA on the (B, H, W, C) LN1 output, windows of ws ≤ 8 taken at
    shift ``phase`` and written back un-rolled.

    CPU tensor → the plain version. CUDA tensor → kernel B (bf16 only), or
    an exception; ``packed`` is the cached ``pack_window_msa``."""
    if y.device.type == "cpu":
        return window_msa_win_reference(y, qkv_weight, qkv_bias, proj_weight,
                                        proj_bias, bias_table, num_heads,
                                        mask, phase, ws)
    nh = num_heads
    check_geometry("window_msa_win", y, qkv_weight, nh, bias_table,
                   mask, ws, shared_bytes(y.shape[3], nh))
    pk = packed if packed is not None else pack_window_msa(
        qkv_weight, qkv_bias, proj_weight, proj_bias, bias_table, nh)
    if pk.wqkv.dtype != torch.bfloat16 or pk.wqkv.device != y.device:
        raise ValueError("packed weights must be bf16 on the input's device")
    b, h, w, c = y.shape
    out = torch.empty_like(y)
    lib = _build.library()
    with torch.cuda.device(y.device):
        err = lib.kair_window_msa(
            y.data_ptr(), out.data_ptr(), pk.wqkv.data_ptr(),
            pk.bqkv.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.relbias.data_ptr(), None if mask is None else mask.data_ptr(),
            b, h, w, c, nh, int(phase), ws,
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "window_msa_win")
    window_msa_win.launches += 1
    return out


window_msa_win.launches = 0
