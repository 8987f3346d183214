"""Fused Swin-transformer block on the (B, H, W, C) map — CUDA kernels 1
and A.

Kernel 1 replaces ``kair_tpu/ops/pallas/swin_block.py ::
swin_block_pallas_2d`` (TPU body ``_kernel_2d`` :174 + ``_block_body`` :68)
and kernel A replaces ``swin_block_pallas`` (:774, the window-pair
``_kernel``) at inference:

    out = Block(roll(x, (−phase, −phase)))   written in the block's own
                                              (rolled) coordinates

where Block is the windowed Swin block: LN1 → W-MSA (rel-pos bias, 0/−100
shift mask for shifted blocks) → +x → LN2 → fc1 → exact GELU → fc2 → +x.
``swin_block_2d`` takes any window ws ≤ 8 that tiles the map (kernel 1 at
ws 8, kernel A below it; ws 7 is the JPEG-CAR SwinIR geometry), with the
window's N = ws² tokens padded to 64 rows inside the kernel and the padded
keys masked out. Both are one kernel, ``csrc/swin_block_wgmma.cu`` (its
header gives the bound on the card and what the design does about it): wgmma products fed by a ring of bulk-copied weight stages that two
windows share. ``pack_block_stages`` writes those stages from
``pack_swin_block``'s matrices, ``block_plan`` mirrors the kernel's layout
arithmetic and ``window_walk`` its persistent walk over the windows;
``swin_block_win_reference`` is the plain PyTorch version. The same kernel's
attention-only mode is kernel B (``ops/kernels/window_msa.py``): the plan
at hidden width 0, whose stages ``pack_attn_stages`` writes.

The wrappers launch the kernel for a CUDA tensor and use the plain version
only for a CPU tensor. They never fall back: a tensor the kernel does not
take, a shared-memory layout over the card's limit included, raises.

Training adds CUDA kernel 3, ``swin_block_2d_bwd``: the block's backward
with the forward recomputed, replacing ``_fused_2d_bwd_pallas`` (TPU body
``_kernel_2d_bwd`` :219), in ``csrc/swin_block_bwd_wgmma.cu`` (two passes:
the window chain on wgmma products fed by a bulk-copied weight ring, then
the weight grads as wgmma products over the operand tiles pass 1 writes).
``pack_bwd_stages`` writes its weight stages, ``bwd_plan`` mirrors its
layout arithmetic and ``unpack_bwd_grads`` turns its outputs into KAIR's
layout; its plain version is ``swin_block_2d_bwd_reference``.
``SwinBlockFunction`` ties kernels 1 and 3 into one autograd node with the
block's shift folded into both kernels' reads, as ``_fused_2d`` (:490) does
with its custom VJP: it saves only the block input and the parameters.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels._build import SMEM_LIMIT
from kair_tpu_torch.ops.kernels.window_msa import (HD_MAX, check_geometry,
                                                   fold_ln_affine,
                                                   pack_qkv_proj,
                                                   rel_index_on,
                                                   table_window, window_bias)
from kair_tpu_torch.ops.window_attention import (window_msa, window_partition,
                                                  window_reverse)

WS = 8                      # the 2-D kernel's window: 8x8 = 64 tokens


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
    """Kernel operands: the padded matrices, and the weight stages as
    csrc/swin_block_wgmma.cu (``stages``) and csrc/swin_block_bwd_wgmma.cu
    (``bwd_stages``) read them."""
    wqkv: torch.Tensor      # (CP, nh*96) bf16, LN1 affine + q scale folded
                            # (folded=True)
    bqkv: torch.Tensor      # (nh*96,) f32
    wp: torch.Tensor        # (nh*32, CP) bf16
    bp: torch.Tensor        # (C,) f32
    w1: torch.Tensor        # (CP, HP) bf16, LN2 affine folded (folded=True)
    b1: torch.Tensor        # (HP,) f32
    w2: torch.Tensor        # (HP, CP) bf16
    b2: torch.Tensor        # (C,) f32
    relbias: torch.Tensor   # (nh, 64, 64) f32
    hp: int
    stages: Optional[torch.Tensor] = None   # pack_block_stages, forward only
    bwd_stages: Optional[torch.Tensor] = None   # pack_bwd_stages, backward only


def pack_swin_block(p: SwinBlockParams, num_heads: int,
                    dtype: torch.dtype = torch.bfloat16,
                    folded: bool = True) -> SwinBlockPack:
    """Relayout, fold and cast one block's parameters for the kernel (once
    per set of weights; the model caches the result). The kernel takes
    bf16 matrices; ``dtype=torch.float32`` keeps them exact for checking
    the layout against the plain version. ``folded=False`` is the backward
    kernel's pack: the same layout with the q scale and the LN affines
    left out (the backward applies them itself, so the weight grads come
    out for the raw parameters), with the backward's weight stages. Runs
    with autocast off: the folds are f32 algebra."""
    with torch.autocast(p.qkv_weight.device.type, enabled=False):
        return _pack(p, num_heads, dtype, folded)


def _pack(p: SwinBlockParams, num_heads: int, dtype: torch.dtype,
          folded: bool) -> SwinBlockPack:
    c = p.qkv_weight.shape[1]
    cp = _build.round16(c)
    hidden = p.fc1_weight.shape[0]
    hp = _build.round16(hidden)
    dev = p.qkv_weight.device
    f32 = torch.float32

    wqkv, bqkv, wp = pack_qkv_proj(
        p.qkv_weight, p.qkv_bias, p.proj_weight, num_heads,
        ln=(p.norm1_weight, p.norm1_bias) if folded else None, scale_q=folded)
    if folded:
        w1f, b1f = fold_ln_affine(p.fc1_weight, p.fc1_bias, p.norm2_weight,
                                  p.norm2_bias)
    else:
        w1f, b1f = p.fc1_weight.float(), p.fc1_bias.float()
    w1 = torch.zeros(cp, hp, device=dev, dtype=f32)
    w1[:c, :hidden] = w1f.t()
    b1 = torch.zeros(hp, device=dev, dtype=f32)
    b1[:hidden] = b1f
    w2 = torch.zeros(hp, cp, device=dev, dtype=f32)
    w2[:hidden, :c] = p.fc2_weight.float().t()

    return SwinBlockPack(
        wqkv=wqkv.to(dtype).contiguous(), bqkv=bqkv.contiguous(),
        wp=wp.to(dtype).contiguous(),
        bp=p.proj_bias.float().contiguous(),
        w1=w1.to(dtype).contiguous(), b1=b1,
        w2=w2.to(dtype).contiguous(),
        b2=p.fc2_bias.float().contiguous(),
        relbias=window_bias(p.rel_table, num_heads, table_window(p.rel_table)),
        hp=hp,
        stages=(pack_block_stages(wqkv, wp, w1, w2, c, num_heads).to(dtype)
                if folded and c <= NT_MAX else None),
        bwd_stages=(pack_bwd_stages(wqkv, wp, w1, w2, c, num_heads).to(dtype)
                    if not folded and c <= NT_MAX else None))


# ---------------------------------------------------------------------------
# The forward kernel's layout (csrc/swin_block_wgmma.cu, BlockPlan) and its
# weight stages; chip_smoke.py holds block_plan equal to the kernel's own
# kair_swin_block_plan and kair_swin_block_shared_bytes.
# ---------------------------------------------------------------------------

KC = 64                     # K chunk: one 128-byte swizzle row of bf16
NT_MAX = 240                # the widest accumulator: C ≤ 240
CONSUMER_WGS = 2            # windows per weight stage
RING = 2                    # weight stages in shared memory


class BlockPlan(NamedTuple):
    nt: int         # accumulator width (proj / fc2 N): 64, 128, 184 or 240
    kc: int         # K chunks of 64 over C
    np: int         # head pairs
    hc: int         # hidden chunks of 64
    lda: int        # LN-output row stride, bf16
    slot: int       # bytes of one ring slot
    ring: int       # ring slots (RING)
    stages: int     # stages per window pair
    smem: int       # dynamic shared memory of one thread block


def block_plan(c: int, nh: int, hp: int) -> BlockPlan:
    """The kernel's tiling and shared-memory layout at C channels, nh heads
    and hidden width hp (BlockPlan in csrc/swin_block_wgmma.cu): RING
    weight stages, then each window's x tile and LN output, the biases and
    the ring's barriers. At hp = 0 it is kernel B's: no hidden chunk."""
    a128, a1024 = _build.align128, lambda v: (v + 1023) // 1024 * 1024
    nt = 64 if c <= 64 else 128 if c <= 128 else 184 if c <= 184 else 240
    kc, np_, hc = -(-c // KC), -(-nh // 2), -(-hp // 64)
    lda = kc * KC + 8
    slot = max(96, nt) * 128
    xs = a1024(max(64 * c * 2, 3 * 4096))
    ab = a1024(64 * lda * 2)
    bias = a128((nh * 96 + c + hc * 64 + c) * 4)
    smem = RING * slot + CONSUMER_WGS * (xs + ab) + bias + 2 * RING * 8 + 1024
    return BlockPlan(nt, kc, np_, hc, lda, slot, RING,
                     nh * kc + np_ + hc * (kc + 1), smem)


def block_shared_bytes(c: int, nh: int, hp: int) -> int:
    """Bytes of shared memory one thread block of the forward kernel asks."""
    return block_plan(c, nh, hp).smem


def stage_rows(c: int, nh: int, hp: int) -> List[Tuple[str, int]]:
    """(product, rows) of each weight stage, in the order the producer
    copies them for every window pair: per head pair the qkv K chunks of
    both heads (96 rows each) and then the pair's proj (NT rows); per
    hidden chunk the fc1 K chunks (64 rows) and then fc2 (NT rows). Every
    row holds 64 K values."""
    pl = block_plan(c, nh, hp)
    out: List[Tuple[str, int]] = []
    for p in range(pl.np):
        out += [("qkv", 96)] * (pl.kc * (min(2 * p + 2, nh) - 2 * p))
        out.append(("proj", pl.nt))
    for _ in range(pl.hc):           # none at hp = 0 (kernel B)
        out += [("fc1", 64)] * pl.kc + [("fc2", pl.nt)]
    return out


@lru_cache(maxsize=16)
def _swizzle_index(rows: int, device: str) -> torch.Tensor:
    """(rows, 64) column of element (n, k) in a swizzled stage row: its
    16-byte unit k // 8 XOR n % 8 (wgmma's 128-byte swizzle). A normal
    tensor even when first asked for under inference_mode."""
    with torch.inference_mode(False):
        n = torch.arange(rows, device=device)[:, None]
        k = torch.arange(KC, device=device)[None, :]
        return ((k // 8) ^ (n % 8)) * 8 + k % 8


def _swizzle(m: torch.Tensor) -> torch.Tensor:
    """(..., rows, 64) K-major stages → the 128-byte swizzle, one scatter."""
    idx = _swizzle_index(m.shape[-2], str(m.device)).expand(m.shape)
    return torch.empty_like(m).scatter_(-1, idx, m)


def unswizzle(m: torch.Tensor) -> torch.Tensor:
    """The inverse of the stage swizzle (for checking the layout)."""
    idx = _swizzle_index(m.shape[-2], str(m.device)).expand(m.shape)
    return torch.gather(m, -1, idx)


def pack_block_stages(wqkv: torch.Tensor, wp: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor, c: int, nh: int) -> torch.Tensor:
    """``pack_swin_block``'s matrices (wqkv (CP, nh·96), wp (nh·32, CP),
    w1 (CP, HP), w2 (HP, CP)) → the kernel's weight stages, one flat f32
    tensor in ``stage_rows`` order: stage row n holds B[k, n] for its 64 K
    values, zero past C, the hidden width and the heads, swizzled. One
    gather through an index cached per geometry: a training model packs
    its blocks anew after every optimizer step."""
    return _gather_stages(_stage_layout, (wqkv, wp, w1, w2), c, nh)


def pack_attn_stages(wqkv: torch.Tensor, wp: torch.Tensor, c: int,
                     nh: int) -> torch.Tensor:
    """Kernel B's weight stages: ``pack_block_stages`` up to the last proj
    stage (``stage_rows(c, nh, 0)``), from ``pack_qkv_proj``'s wqkv and
    wp; one flat f32 tensor."""
    return _gather_stages(_attn_stage_layout, (wqkv, wp), c, nh)


def _gather_stages(layout, mats, c: int, nh: int) -> torch.Tensor:
    """``layout`` of the matrices ``mats`` as one gather, flat f32."""
    idx = _stage_index(layout, c, nh, tuple(tuple(m.shape) for m in mats),
                       str(mats[0].device))
    return torch.cat([m.reshape(-1).float() for m in mats]
                     + [mats[0].new_zeros(1, dtype=torch.float32)])[idx]


@lru_cache(maxsize=32)
def _stage_index(layout, c: int, nh: int, shapes: Tuple[Tuple[int, int], ...],
                 device: str) -> torch.Tensor:
    """Where each stage element comes from in the matrices and a last zero
    (the padding's), flattened and concatenated: ``layout`` of matrices
    that hold their own flat positions (float64: exact)."""
    with torch.inference_mode(False):
        sizes = [r * k for r, k in shapes]
        total = sum(sizes)
        src = torch.arange(1, total + 1, dtype=torch.float64)
        mats = [t.view(shape) for t, shape in zip(torch.split(src, sizes), shapes)]
        idx = layout(*mats, c, nh).long() - 1
        idx[idx < 0] = total
        return idx.to(device)


def _padded(m: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """m cut or zero-padded to (rows, cols)."""
    out = m.new_zeros(rows, cols)
    r, cc = min(rows, m.shape[0]), min(cols, m.shape[1])
    out[:r, :cc] = m[:r, :cc]
    return out


def _attn_stage_layout(wqkv: torch.Tensor, wp: torch.Tensor, c: int,
                       nh: int) -> torch.Tensor:
    """The qkv and proj stages (per head pair), in whole-tensor ops and
    the matrices' dtype: all of kernel B's, the head of the block's."""
    pl = block_plan(c, nh, 0)
    kp, nt = pl.kc * KC, pl.nt
    cn = min(wqkv.shape[0], nt)               # columns of wp that exist

    # (K, N) → swizzled stages (.., N rows, 64 K)
    q = _swizzle(_padded(wqkv, kp, nh * 96).view(pl.kc, KC, nh, 96)
                 .permute(2, 0, 3, 1))                      # (nh, kc, 96, 64)
    pj = _swizzle(_padded(wp[:, :cn], pl.np * 64, nt).view(pl.np, 64, nt)
                  .transpose(1, 2))                         # (np, nt, 64)
    full = nh // 2                      # head pairs with both heads
    parts = [torch.cat([q[:2 * full].reshape(full, -1),
                        pj[:full].reshape(full, -1)], 1).reshape(-1)]
    if nh % 2:
        parts += [q[nh - 1].reshape(-1), pj[full].reshape(-1)]
    return torch.cat(parts)


def _stage_layout(wqkv: torch.Tensor, wp: torch.Tensor, w1: torch.Tensor,
                  w2: torch.Tensor, c: int, nh: int) -> torch.Tensor:
    """The stage layout itself (``pack_block_stages``), in whole-tensor
    ops and the matrices' dtype."""
    hp = w1.shape[1]
    pl = block_plan(c, nh, hp)
    kp, nt = pl.kc * KC, pl.nt
    cn = min(wqkv.shape[0], nt)               # columns of w2 that exist
    f1 = _swizzle(_padded(w1, kp, pl.hc * 64).view(pl.kc, KC, pl.hc, 64)
                  .permute(2, 0, 3, 1))                     # (hc, kc, 64, 64)
    f2 = _swizzle(_padded(w2[:, :cn], pl.hc * 64, nt).view(pl.hc, 64, nt)
                  .transpose(1, 2))                         # (hc, nt, 64)
    return torch.cat([_attn_stage_layout(wqkv, wp, c, nh),
                      torch.cat([f1.reshape(pl.hc, -1), f2.reshape(pl.hc, -1)],
                                1).reshape(-1)])


def window_walk(windows: int, blocks: int) -> List[List[Tuple[int, int]]]:
    """The persistent grid's walk (the kernel's loop over t): block i takes
    window pairs t = i, i + blocks, ...; consumer warpgroup g of a pair
    takes window 2t + g, or none (-1) past the last window, where it only
    keeps the ring's count. Returns each block's (window of warpgroup 0,
    window of warpgroup 1) in order."""
    pairs = -(-windows // 2)
    return [[(2 * t, 2 * t + 1 if 2 * t + 1 < windows else -1)
             for t in range(i, pairs, blocks)] for i in range(blocks)]


def grid_blocks(windows: int, sms: int = 132) -> int:
    """Thread blocks of a launch: one per SM, at most one per window pair."""
    return min(-(-windows // 2), sms)


def swin_block_win_reference(x: torch.Tensor, p: SwinBlockParams,
                             num_heads: int,
                             mask: Optional[torch.Tensor] = None,
                             phase: int = 0, ws: int = WS) -> torch.Tensor:
    """Plain PyTorch version of the block kernels, computed in f32 from the
    given inputs (counterpart of ``_reference_2d`` :468 /
    ``_reference_block_tokens`` :415): roll, window partition, LN1, W-MSA
    with max-subtracted softmax, residual, LN2, exact-GELU MLP, residual,
    window reverse. Returns ``x.dtype``. Any window that tiles the map;
    above 8 it is the model's composed route."""
    f = x.float()
    if phase:
        f = torch.roll(f, (-phase, -phase), (1, 2))
    b, h, w, c = f.shape
    y = F.layer_norm(f, (c,), p.norm1_weight.float(), p.norm1_bias.float(), 1e-5)
    a = window_msa(window_partition(y, ws), p.qkv_weight.float(),
                   None if p.qkv_bias is None else p.qkv_bias.float(),
                   p.proj_weight.float(), p.proj_bias.float(),
                   p.rel_table.float(), rel_index_on(ws, f.device),
                   num_heads, None if mask is None else mask.float())
    x1 = f + window_reverse(a, ws, h, w)
    z = F.layer_norm(x1, (c,), p.norm2_weight.float(), p.norm2_bias.float(), 1e-5)
    z = F.gelu(F.linear(z, p.fc1_weight.float(), p.fc1_bias.float()))
    return (x1 + F.linear(z, p.fc2_weight.float(), p.fc2_bias.float())).to(x.dtype)


def swin_block_2d_reference(x: torch.Tensor, p: SwinBlockParams,
                            num_heads: int, mask: Optional[torch.Tensor] = None,
                            phase: int = 0) -> torch.Tensor:
    """Plain version of the 2-D kernel: ``swin_block_win_reference`` at
    window 8."""
    return swin_block_win_reference(x, p, num_heads, mask, phase, WS)


def _check_cuda_args(x, p, num_heads, mask, ws=WS, backward=False):
    """Raise on what the block kernels do not take, the card's shared-
    memory limit included (the forward's layout, or the backward's)."""
    hidden = p.fc1_weight.shape[0]
    c = x.shape[-1]
    if c > NT_MAX:
        raise ValueError(f"swin_block{'_bwd' if backward else ''} takes C <= "
                         f"{NT_MAX} (the widest wgmma accumulator it holds), "
                         f"got C={c}")
    smem = (bwd_shared_bytes(c, num_heads, hidden) if backward
            else block_shared_bytes(c, num_heads, _build.round16(hidden)))
    check_geometry("swin_block_bwd" if backward else "swin_block", x,
                   p.qkv_weight, num_heads, p.rel_table, mask, ws, smem)


@lru_cache(maxsize=64)
def block_refusal(c: int, nh: int, hidden: int, ws: int = WS
                  ) -> Optional[str]:
    """Why the forward kernel refuses a block of C channels, nh heads and
    an MLP of ``hidden`` width at window ws, or None: the message of
    ``_check_cuda_args`` (the kernel's own ``check_geometry`` and
    shared-memory limit) run on shape-only tensors."""
    x = torch.empty((1, ws, ws, c), dtype=torch.bfloat16, device="meta")
    m = lambda *shape: torch.empty(shape, device="meta")
    p = SwinBlockParams(m(3 * c, c), m(3 * c), m(c, c), m(c),
                        m((2 * ws - 1) ** 2, nh), m(c), m(c), m(c), m(c),
                        m(hidden, c), m(hidden), m(c, hidden), m(c))
    try:
        _check_cuda_args(x, p, nh, None, ws)
    except ValueError as e:
        return str(e)
    return None


def block_takes(c: int, nh: int, hidden: int, ws: int = WS) -> bool:
    """Whether the forward kernel takes that block: ``block_refusal`` is
    None."""
    return block_refusal(c, nh, hidden, ws) is None


def _check_stages(x: torch.Tensor, pk: SwinBlockPack, num_heads: int) -> None:
    """The stage pack must be the forward's (``check_ring_operands``)."""
    if pk.stages is None:
        raise ValueError("swin_block_2d needs the forward pack's weight "
                         "stages (pack_swin_block with folded=True)")
    check_ring_operands("swin_block_2d", x, pk.stages,
                        stage_rows(x.shape[-1], num_heads, pk.hp),
                        (pk.bqkv, pk.bp, pk.b1, pk.b2, pk.relbias))


def check_ring_operands(name: str, x: torch.Tensor, st: torch.Tensor,
                        rows: List[Tuple[str, int]], f32s) -> None:
    """What the wgmma kernel (the block or kernel B) needs of its operands:
    the weight stages bf16, contiguous, on x's device, of the ``rows``
    list's size, and 16-byte aligned (the bulk copies' rule; a misaligned
    one faults on the card); the biases and the score table (``f32s``)
    f32 on x's device; x aligned to 8 bytes when C % 4 == 0 (else 4); and
    B·H·W < 2^31 (32-bit pixel offsets)."""
    b, h, w, c = x.shape
    want = sum(r for _, r in rows) * KC
    if (st.dtype != torch.bfloat16 or st.device != x.device
            or not st.is_contiguous() or st.numel() != want):
        raise ValueError(f"weight stages must be a contiguous bf16 tensor of "
                         f"{want} elements on {x.device}")
    if st.data_ptr() % 16:
        raise ValueError(f"{name} needs the weight stages aligned to 16 bytes")
    if any(t.dtype != torch.float32 or t.device != x.device for t in f32s):
        raise ValueError("packed biases and score table must be f32 on "
                         f"{x.device}")
    if x.data_ptr() % (8 if c % 4 == 0 else 4):
        raise ValueError(f"{name} needs its input aligned to 8 bytes "
                         "(4 when C % 4 != 0)")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{name} takes B*H*W < 2^31 pixels, got {b * h * w}")


def swin_block_2d(x: torch.Tensor, p: SwinBlockParams, num_heads: int,
                  mask: Optional[torch.Tensor] = None, phase: int = 0,
                  ws: int = WS, packed=None) -> torch.Tensor:
    """Fused inference Swin block on (B, H, W, C) for a window ws ≤ 8 that
    tiles the map: kernel 1 at ws 8, kernel A below it (windows of N = ws²
    tokens padded to 64 rows inside the kernel); one C entry,
    ``kair_swin_block``.

    CPU tensor → the plain version. CUDA tensor → the kernel of its dtype:
    bf16 → ``kair_swin_block``, ``packed`` the cached ``pack_swin_block(p,
    nh)`` (its weight stages included); f32 → ``kair_swin_block_f32``,
    ``packed`` the cached ``pack_swin_block_f32(p, nh)``; anything else, or
    a pack of the other dtype, raises. A launch adds one to ``launches``
    (bf16, ws 8), ``launches_win`` (bf16, ws < 8), ``launches_f32`` or
    ``launches_win_f32``."""
    if x.device.type == "cpu":
        return swin_block_win_reference(x, p, num_heads, mask, phase, ws)
    if x.dtype == torch.float32:
        return _swin_block_f32(x, p, num_heads, mask, phase, ws, packed)
    _check_cuda_args(x, p, num_heads, mask, ws)
    if isinstance(packed, SwinBlockF32Pack):
        raise TypeError("swin_block_2d: a bf16 input met the f32 pack")
    pk = packed if packed is not None else pack_swin_block(p, num_heads)
    _check_stages(x, pk, num_heads)
    out = torch.empty_like(x)
    _launch(_build.library(), x, out, pk, num_heads, mask, phase, ws)
    if ws == WS:
        swin_block_2d.launches += 1
    else:
        swin_block_2d.launches_win += 1
    return out


def _launch(lib, x: torch.Tensor, out: torch.Tensor, pk: SwinBlockPack,
            num_heads: int, mask: Optional[torch.Tensor], phase: int,
            ws: int = WS) -> None:
    """One launch of ``kair_swin_block`` in ``lib`` (the library or its
    profile build) on checked arguments; raises on a CUDA error."""
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        err = lib.kair_swin_block(
            x.data_ptr(), out.data_ptr(), pk.stages.data_ptr(),
            pk.bqkv.data_ptr(), pk.bp.data_ptr(), pk.b1.data_ptr(),
            pk.b2.data_ptr(), pk.relbias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            b, h, w, c, num_heads, pk.hp, int(phase), ws,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"swin_block_2d (ws {ws})")


swin_block_2d.launches = 0          # kernel 1: ws 8
swin_block_2d.launches_win = 0      # kernel A: ws < 8
swin_block_2d.launches_f32 = 0      # the f32 kernel: ws 8
swin_block_2d.launches_win_f32 = 0  # the f32 kernel: ws < 8


# ---------------------------------------------------------------------------
# The f32 kernels (csrc/swin_block_f32.cu, csrc/swin_block_bwd_f32.cu): the
# block at every window ≤ 8 and its attention-only mode, and the window-8
# backward, FFMA on the CUDA cores over the parameters as they are. One pack
# serves all of them; f32_plan and bwd_f32_plan mirror the kernels' layouts
# (chip_smoke.py holds them to kair_swin_f32_plan and kair_swin_bwd_f32_plan).
# ---------------------------------------------------------------------------

F32_KT = 16                 # K rows the f32 products stage at a time
F32_NB, F32_CONV_NB = 128, 256  # output columns a pass over K covers: the
                                # block kernels, the conv tail
F32_HC = 128                # MLP hidden chunk
F32_L = 68                  # row stride of the backward's 64-wide buffers


def stage_floats(nr: int, nnmax: int, nb: int) -> int:
    """Shared floats of the f32 products' staging (simt_f32.cuh): two
    stages of F32_KT rows of A (nr wide) and of B (up to nb wide)."""
    return 2 * F32_KT * nr + 2 * F32_KT * min(nnmax, nb)


class SwinBlockF32Pack(NamedTuple):
    """The f32 kernels' operands: qkv per head [q | k | v] of HD_MAX columns
    each (zero past the head dim), no LN affine folded, no q scale. A pack
    for the attention-only mode alone (``pack_attn_f32``) has the LN and MLP
    fields empty."""
    wqkv: torch.Tensor      # (C, nh*96)
    bqkv: torch.Tensor      # (nh*96,)
    wp: torch.Tensor        # (nh*32, C)
    bp: torch.Tensor        # (C,)
    ln: torch.Tensor        # (4, C): norm1 weight, bias, norm2 weight, bias
    w1: torch.Tensor        # (C, hidden)
    b1: torch.Tensor        # (hidden,)
    w2: torch.Tensor        # (hidden, C)
    b2: torch.Tensor        # (C,)
    relbias: torch.Tensor   # (nh, N, N)


def pack_attn_f32(qkv_weight: torch.Tensor, qkv_bias: Optional[torch.Tensor],
                  proj_weight: torch.Tensor, proj_bias: torch.Tensor,
                  bias_table: torch.Tensor, num_heads: int) -> SwinBlockF32Pack:
    """W-MSA's fields of the f32 pack, every value f32 as it is; the LN and
    MLP fields empty (the attention-only mode reads none of them). Runs with
    autocast off."""
    with torch.autocast(qkv_weight.device.type, enabled=False):
        c = qkv_weight.shape[1]
        wqkv, bqkv, wp = pack_qkv_proj(qkv_weight, qkv_bias, proj_weight,
                                       num_heads, scale_q=False)
        e = proj_bias.new_empty(0, dtype=torch.float32)
        return SwinBlockF32Pack(
            wqkv[:c].contiguous(), bqkv.contiguous(), wp[:, :c].contiguous(),
            proj_bias.float().contiguous(), e, e, e, e, e,
            window_bias(bias_table, num_heads, table_window(bias_table)))


def pack_swin_block_f32(p: SwinBlockParams, num_heads: int) -> SwinBlockF32Pack:
    """One block's parameters in the f32 kernels' layout (once per set of
    weights; the model caches it): every value f32 as it is, nothing folded
    or rounded. The forward, its attention-only mode and the backward read
    the same pack. Runs with autocast off."""
    with torch.autocast(p.qkv_weight.device.type, enabled=False):
        t = lambda a: a.float().t().contiguous()
        return pack_attn_f32(
            p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias, p.rel_table,
            num_heads)._replace(
                ln=ln_params(p), w1=t(p.fc1_weight),
                b1=p.fc1_bias.float().contiguous(), w2=t(p.fc2_weight),
                b2=p.fc2_bias.float().contiguous())


class F32Plan(NamedTuple):
    """csrc/swin_block_f32.cu's F32Plan, as kair_swin_f32_plan reports it."""
    nr: int         # rows a window is padded to: 16, 32 or 64
    ldx: int        # row stride of the x and LN buffers
    nnmax: int      # widest staged B tile
    smem: int       # dynamic shared memory of one thread block


def f32_plan(c: int, nh: int, ws: int, hdp: int = HD_MAX) -> F32Plan:
    """The f32 forward's layout: the window's x and LN rows (nr, C + 4),
    one head's q, k, v and scores (the MLP chunk in their bytes), and the
    products' staging (``stage_floats``)."""
    n = ws * ws
    nr = 16 if n <= 16 else 32 if n <= 32 else 64
    ldx = c + 4
    nnmax = max(c, 3 * hdp, F32_HC, nr)
    head = max(3 * nr * hdp + nr * (nr + 4), nr * (F32_HC + 4))
    floats = 2 * nr * ldx + head + stage_floats(nr, nnmax, F32_NB)
    return F32Plan(nr, ldx, nnmax, 4 * floats)


class BwdF32Plan(NamedTuple):
    """csrc/swin_block_bwd_f32.cu's layout, as kair_swin_bwd_f32_plan
    reports it."""
    smem: int       # pass-1 shared memory of a thread block
    op_floats: int  # operand floats a token (Y1, O, Y2, GELU out, dpre,
                    # dx1, dqkv, dy; each head's q, k, v and P)
    total: int      # floats of the four products' D, back to back
    tiles: int      # pass-2 tiles of 64 x 128
    dims: Tuple[Tuple[int, int], ...]   # (Kin + 1, Nout) of each product


def bwd_f32_plan(c: int, nh: int, hidden: int, hdp: int = HD_MAX) -> BwdF32Plan:
    ldx, nq = c + 4, nh * 3 * hdp
    nnmax = max(c, 3 * hdp, F32_HC)
    floats = (2 * 64 * ldx + 4 * 64 * hdp + 2 * 64 * F32_L + 4 * 64
              + stage_floats(64, nnmax, F32_NB))
    nhd = nh * hdp
    dims = ((c + 1, nq), (nhd + 1, c), (c + 1, hidden), (hidden + 1, c))
    return BwdF32Plan(
        4 * floats, 4 * c + nhd + 2 * hidden + nq + nh * (3 * hdp + F32_L),
        sum(m * n for m, n in dims),
        sum(-(-m // 64) * -(-n // 128) for m, n in dims), dims)


def f32_refusal(c: int, nh: int, hidden: int, ws: int = WS,
                backward: bool = False) -> Optional[str]:
    """Why the f32 kernels refuse a block of C channels, nh heads, an MLP
    of ``hidden`` width at window ws (the forward, or with ``backward`` the
    window-8 backward), or None."""
    name = "swin_block_2d_bwd (f32)" if backward else "swin_block_2d (f32)"
    if c % 4 or hidden % 4:
        return (f"{name} takes C and the MLP width in multiples of 4 (its "
                f"16-byte tiles), got C={c}, hidden={hidden}")
    if c % nh or c // nh > HD_MAX:
        return (f"{name} needs C divisible by the heads with head dim <= "
                f"{HD_MAX} (C={c}, heads={nh})")
    if backward and ws != WS:
        return f"{name} takes window {WS} only, got {ws}"
    smem = bwd_f32_plan(c, nh, hidden).smem if backward else \
        f32_plan(c, nh, ws).smem
    if smem > SMEM_LIMIT:
        return (f"{name} at C={c}, {nh} heads, window {ws} needs {smem} "
                f"bytes of shared memory per block, over the card's opt-in "
                f"limit of {SMEM_LIMIT}")
    return None


def _check_f32(name: str, x: torch.Tensor, p: SwinBlockParams, num_heads: int,
               mask, ws: int, backward: bool = False) -> None:
    """Raise on what the f32 kernels do not take: the window geometry, the
    widths (``f32_refusal``) and B·H·W < 2^31."""
    c, hidden = x.shape[-1], p.fc1_weight.shape[0]
    check_geometry(name, x, p.qkv_weight, num_heads, p.rel_table, mask, ws, 0,
                   torch.float32)
    why = f32_refusal(c, num_heads, hidden, ws, backward)
    if why:
        raise ValueError(why)
    if x.numel() // c >= 2 ** 31:
        raise ValueError(f"{name} takes B*H*W < 2^31 pixels")


def check_f32_pack(name: str, x: torch.Tensor, pk,
                   attn_only: bool = False) -> None:
    """The pack must be the f32 one, contiguous f32 on x's device, and
    hold the LN and MLP fields unless the attention-only mode reads it."""
    if not isinstance(pk, SwinBlockF32Pack):
        raise TypeError(f"{name}: an f32 input needs the f32 pack "
                        "(SwinBlockF32Pack)")
    if not attn_only and pk.w1.numel() == 0:
        raise ValueError(f"{name}: the f32 pack holds W-MSA's fields only "
                         "(pack_attn_f32); the block needs pack_swin_block_f32")
    if any(t.dtype != torch.float32 or t.device != x.device
           or not t.is_contiguous() for t in pk):
        raise ValueError(f"{name}: the f32 pack must be contiguous f32 on "
                         f"{x.device}")


def _swin_block_f32(x, p, num_heads, mask, phase, ws, packed) -> torch.Tensor:
    """The f32 forward kernel on a checked CUDA tensor (``swin_block_2d``)."""
    _check_f32("swin_block_2d", x, p, num_heads, mask, ws)
    pk = packed if packed is not None else pack_swin_block_f32(p, num_heads)
    check_f32_pack("swin_block_2d", x, pk)
    out = torch.empty_like(x)
    launch_f32(x, out, pk, num_heads, p.fc1_weight.shape[0], mask, phase, ws,
               attn_only=False)
    if ws == WS:
        swin_block_2d.launches_f32 += 1
    else:
        swin_block_2d.launches_win_f32 += 1
    return out


def launch_f32(x: torch.Tensor, out: torch.Tensor, pk, num_heads: int,
               hidden: int, mask: Optional[torch.Tensor], phase: int, ws: int,
               attn_only: bool) -> None:
    """One launch of ``kair_swin_block_f32`` on checked operands: the whole
    block (``pk`` a ``SwinBlockF32Pack``), or its attention-only mode on an
    LN1 output (its LN and MLP fields unread)."""
    b, h, w, c = x.shape
    mlp = [None] * 5 if attn_only else [
        t.data_ptr() for t in (pk.ln, pk.w1, pk.b1, pk.w2, pk.b2)]
    with torch.cuda.device(x.device):
        err = _build.library().kair_swin_block_f32(
            x.data_ptr(), out.data_ptr(), pk.wqkv.data_ptr(),
            pk.bqkv.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(), *mlp,
            pk.relbias.data_ptr(),
            None if mask is None else mask.data_ptr(), b, h, w, c, num_heads,
            HD_MAX, hidden, int(phase), ws, int(attn_only),
            float((c // num_heads) ** -0.5),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"swin_block f32 ({'attention' if attn_only else 'block'}"
                      f", ws {ws})")


# ---------------------------------------------------------------------------
# Backward (training): CUDA kernel 3 (csrc/swin_block_bwd_wgmma.cu), its
# layout mirror, weight stages and plain version
# ---------------------------------------------------------------------------

HEAD_TILE = 16384           # a head's k|v and q^T|k^T tiles in the scratch
ATTN_TILES = 28672          # region B in the attention backward
STAGE_WARP = 2048           # a warp's transposed-store staging
# (layer input, output grad) operands of the four weight products, indices
# into op_rows: LN1 out, attention out, LN2 out, GELU out, dpre, dy, dx1, dqkv
WGRAD_PRODUCTS = (("qkv", 0, 7), ("proj", 1, 6), ("fc1", 2, 4), ("fc2", 3, 5))


class BwdPlan(NamedTuple):
    """csrc/swin_block_bwd_wgmma.cu's layout (BwdPlan and WgradPlan), which
    ``kair_swin_bwd_plan`` reports and chip_smoke.py holds this mirror to."""
    smem: int           # pass-1 shared memory of a thread block (RING slots)
    nt: int             # accumulator width: 64, 128, 184 or 240
    stages: int         # weight stages per window pair
    slot: int           # bytes of a ring slot
    scratch: int        # scratch bytes per consumer warpgroup
    op_rows: Tuple[int, ...]   # rows per window of the eight stored operands
    nb: int             # pass-2 columns of B per work item
    items: int          # pass-2 work items (128 rows of A x nb columns)
    total: int          # floats of the four products' D, back to back
    wgrad_smem: int     # pass-2 shared memory
    dims: Tuple[Tuple[int, int], ...]   # (MP, NP) of each product's D


def bwd_plan(c: int, nh: int, hidden: int) -> BwdPlan:
    a128, a1024 = _build.align128, lambda v: (v + 1023) // 1024 * 1024
    nt = 64 if c <= 64 else 128 if c <= 128 else 184 if c <= 184 else 240
    kc, np_, hc = -(-c // KC), -(-nh // 2), -(-hidden // 64)
    lda = kc * KC + 8
    slot = max(96, nt) * 128
    ab = a1024(64 * lda * 2)
    rb = a1024(max(64 * lda * 2, ATTN_TILES))
    wg = ab + rb + 4 * STAGE_WARP
    params = 4 * c + nh * 96 + hc * 64 + c
    stages = nh * kc + np_ + hc * (2 * kc + 1) + np_ * kc + nh + np_
    # ring slots, two warpgroups' regions, parameters, the ring's and the
    # heads' mbarriers, the ring's release counts, the stage table
    smem = (RING * slot + CONSUMER_WGS * wg + a128(params * 4)
            + (RING + CONSUMER_WGS) * 8 + RING * 4 + 2 * stages * 4 + 1024)
    rows = (c, nh * 32, c, hidden, hidden, c, c, nh * 96)
    best = None
    for cand in (128, 192, 256):
        cols = sum(-(-rows[b] // cand) * cand for _, _, b in WGRAD_PRODUCTS)
        if best is None or cols <= best:
            best, nb = cols, cand
    dims = tuple((-(-(rows[a] + 1) // 128) * 128, -(-rows[b] // nb) * nb)
                 for _, a, b in WGRAD_PRODUCTS)
    return BwdPlan(
        smem=smem, nt=nt,
        stages=stages,
        slot=slot, scratch=nh * HEAD_TILE + 64 * nt * 4, op_rows=rows, nb=nb,
        items=sum(m // 128 * (n // nb) for m, n in dims),
        total=sum(m * n for m, n in dims),
        wgrad_smem=4 * (128 * 128 + nb * 128) + 2 * 4 * 8 + 1024, dims=dims)


def bwd_shared_bytes(c: int, nh: int, hidden: int) -> int:
    """Pass-1 shared memory of the backward kernel's thread block, for the
    check before a launch (a round16 width gives the same bytes)."""
    return bwd_plan(c, nh, hidden).smem


def bwd_splits(windows: int, items: int, sms: int = 132) -> int:
    """Window ranges of the weight-grad pass: one wave of items x splits
    thread blocks on the card's SMs."""
    return max(1, min(windows, sms // items))


def bwd_stage_rows(c: int, nh: int, hidden: int) -> List[Tuple[str, int]]:
    """(product, rows) of each backward weight stage, in the order the
    producer copies them for every window pair (the stage list in
    csrc/swin_block_bwd_wgmma.cu); every row holds 64 K values."""
    pl = block_plan(c, nh, _build.round16(hidden))
    nt, kc, np_, hc = pl.nt, pl.kc, pl.np, -(-hidden // 64)
    out: List[Tuple[str, int]] = []
    for p in range(np_):
        out += [("qkv", 96)] * (kc * (min(2 * p + 2, nh) - 2 * p))
        out.append(("proj", nt))
    for _ in range(hc):
        out += [("fc1", 64), ("w2t", 64)] * kc + [("w1t", nt)]
    for p in range(np_):
        out += [("wpt", 64)] * kc
        out += [("qkt", nt)] * (min(2 * p + 2, nh) - 2 * p) + [("vt", nt)]
    return out


def pack_bwd_stages(wqkv: torch.Tensor, wp: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor, c: int, nh: int) -> torch.Tensor:
    """The backward pack's matrices (wqkv (CP, nh·96) unscaled, wp (nh·32,
    CP), w1 (CP, HP), w2 (HP, CP), no LN affine) → the backward kernel's
    weight stages in ``bwd_stage_rows`` order, swizzled, one flat f32
    tensor; one gather through an index cached per geometry."""
    return _gather_stages(_bwd_stage_layout, (wqkv, wp, w1, w2), c, nh)


def _bwd_stage_layout(wqkv: torch.Tensor, wp: torch.Tensor, w1: torch.Tensor,
                      w2: torch.Tensor, c: int, nh: int) -> torch.Tensor:
    """The backward stage layout (``pack_bwd_stages``) in whole-tensor ops:
    qkv, proj and fc1 as the forward's; w2t(j, k) row u = W2[u, k-chunk],
    alternating with fc1(j, k); w1t(j) row c = W1[c, j-chunk]; wpt(p, k)
    row d = Wp[64p + d, k-chunk] (a pair of heads); qkt(h) row c =
    Wqkv[c, 96h .. 96h + 63] (q and k); vt(p) row c = the v columns of
    heads 2p and 2p + 1."""
    hp = w1.shape[1]
    pl = block_plan(c, nh, hp)
    kc, nt, np_ = pl.kc, pl.nt, pl.np
    hc = -(-hp // 64)
    kp = kc * KC
    sw = lambda m: _swizzle(m.contiguous())
    q = sw(_padded(wqkv, kp, nh * 96).view(kc, KC, nh, 96).permute(2, 0, 3, 1))
    pj = sw(_padded(wp[:, :nt], np_ * 64, nt).view(np_, 64, nt).transpose(1, 2))
    f1 = sw(_padded(w1, kp, hc * 64).view(kc, KC, hc, 64).permute(2, 0, 3, 1))
    w2t = sw(_padded(w2, hc * 64, kp).view(hc, 64, kc, KC).permute(0, 2, 1, 3))
    w1t = sw(_padded(w1, nt, hc * 64).view(nt, hc, 64).permute(1, 0, 2))
    wpt = sw(_padded(wp, np_ * 64, kp).view(np_, 64, kc, KC).permute(0, 2, 1, 3))
    wq = _padded(wqkv, nt, nh * 96).view(nt, nh, 96)
    qkt = sw(wq[:, :, :64].permute(1, 0, 2))
    v = wq.new_zeros(nt, 2 * np_, 32)
    v[:, :nh] = wq[:, :, 64:]
    vt = sw(v.view(nt, np_, 64).permute(1, 0, 2))
    parts = []
    for p in range(np_):
        heads = range(2 * p, min(2 * p + 2, nh))
        parts += [q[h].reshape(-1) for h in heads] + [pj[p].reshape(-1)]
    for j in range(hc):
        parts += [torch.stack([f1[j], w2t[j]], 1).reshape(-1),
                  w1t[j].reshape(-1)]
    for p in range(np_):
        parts.append(wpt[p].reshape(-1))
        parts += [qkt[h].reshape(-1) for h in range(2 * p, min(2 * p + 2, nh))]
        parts.append(vt[p].reshape(-1))
    return torch.cat(parts)


@lru_cache(maxsize=16)
def _grad_index(c: int, nh: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Columns of the qkv product's D in KAIR's output order ([q | k | v] x
    heads x head dim → head x [q | k | v] x 32), and rows of the proj
    product's D in KAIR's input order (head x head dim → head x 32)."""
    hd = c // nh
    with torch.inference_mode(False):
        j, h, d = torch.meshgrid(torch.arange(3), torch.arange(nh),
                                 torch.arange(hd), indexing="ij")
        qkv = (h * 96 + j * 32 + d).reshape(-1)
        proj = (h[0] * 32 + d[0]).reshape(-1)
        return qkv.to(device), proj.to(device)


def unpack_bwd_grads(dw: torch.Tensor, dln: torch.Tensor, dbias: torch.Tensor,
                     p: SwinBlockParams, num_heads: int) -> SwinBlockParams:
    """The kernel's outputs (the four products' D back to back, each
    (MP, NP): rows the layer input with its bias row of ones last, columns
    the output grad; the LN grads (4, C); the score-bias grad (nh, 64, 64))
    → grads in KAIR's layout."""
    c = p.qkv_weight.shape[1]
    hidden = p.fc1_weight.shape[0]
    pl = bwd_plan(c, num_heads, hidden)
    d_qkv, d_proj, d_fc1, d_fc2 = (
        t.view(shape) for t, shape in
        zip(torch.split(dw, [m * n for m, n in pl.dims]), pl.dims))
    qcol, prow = _grad_index(c, num_heads, str(dw.device))
    nin = num_heads * 32
    t = lambda a: a.t().contiguous()
    return SwinBlockParams(
        qkv_weight=t(d_qkv[:c, qcol]),
        qkv_bias=None if p.qkv_bias is None else d_qkv[c, qcol].contiguous(),
        proj_weight=t(d_proj[prow, :c]), proj_bias=d_proj[nin, :c].contiguous(),
        rel_table=rel_table_grad(dbias, p.rel_table.shape[0], num_heads),
        norm1_weight=dln[0], norm1_bias=dln[1],
        norm2_weight=dln[2], norm2_bias=dln[3],
        fc1_weight=t(d_fc1[:c, :hidden]),
        fc1_bias=d_fc1[c, :hidden].contiguous(),
        fc2_weight=t(d_fc2[:hidden, :c]),
        fc2_bias=d_fc2[hidden, :c].contiguous())


def rel_table_grad(dbias: torch.Tensor, n_rows: int, num_heads: int
                   ) -> torch.Tensor:
    """Sum the (nh, 64, 64) score-bias grad into the relative-position
    table's grad (n_rows, nh) by ``relative_position_index``: the
    transpose of the gather in ``window_bias``, as a gather of each table
    row's positions and a sum in a fixed order (an index_add_ on the card
    adds by atomics, in an order that changes from run to run)."""
    pos = _rel_positions(n_rows, str(dbias.device))
    flat = F.pad(dbias.float().reshape(num_heads, -1), (0, 1))   # a zero last
    return flat[:, pos].sum(-1).t().contiguous()


@lru_cache(maxsize=16)
def _rel_positions(n_rows: int, device: str) -> torch.Tensor:
    """(n_rows, most) flat score positions of each table row, padded with
    the position past the end (a zero)."""
    with torch.inference_mode(False):
        idx = rel_index_on(WS, torch.device("cpu"))
        order = torch.argsort(idx, stable=True)
        counts = torch.bincount(idx, minlength=n_rows)
        pos = torch.full((n_rows, int(counts.max())), idx.numel(),
                         dtype=torch.long)
        start = 0
        for r in range(n_rows):
            pos[r, :counts[r]] = order[start:start + counts[r]]
            start += int(counts[r])
        return pos.to(device)


def swin_block_2d_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                                p: SwinBlockParams, num_heads: int,
                                mask: Optional[torch.Tensor] = None,
                                phase: int = 0
                                ) -> Tuple[torch.Tensor, SwinBlockParams]:
    """Plain PyTorch version of the backward kernel (counterpart of
    ``_fused_2d_bwd_xla`` :516): roll x by −phase, autograd through
    ``swin_block_2d_reference`` at phase 0, in f32 from the given inputs,
    autocast off, and dx rolled back by +phase. dy is in the block's own
    (rolled) coordinates, as the forward writes its output. Returns dx in
    ``x.dtype`` and f32 parameter grads (``qkv_bias`` None when absent)."""
    with torch.enable_grad(), torch.autocast(x.device.type, enabled=False):
        xf = x.detach().float()
        if phase:
            xf = torch.roll(xf, (-phase, -phase), (1, 2))
        xf.requires_grad_(True)
        ps = [None if a is None else a.detach().float().requires_grad_(True)
              for a in p]
        y = swin_block_2d_reference(xf, SwinBlockParams(*ps), num_heads, mask)
        grads = torch.autograd.grad(
            y, [xf] + [a for a in ps if a is not None], dy.float())
    dx = torch.roll(grads[0], (phase, phase), (1, 2)) if phase else grads[0]
    rest = iter(grads[1:])
    return dx.to(x.dtype), SwinBlockParams(
        *[None if a is None else next(rest) for a in ps])


def _check_bwd_stages(x: torch.Tensor, pk: SwinBlockPack, num_heads: int,
                      hidden: int) -> None:
    """The backward stage pack must be bf16, contiguous, on x's device, of
    the plan's size and 16-byte aligned (the bulk copies' rule); the biases
    and the score table f32 on x's device."""
    c = x.shape[-1]
    st = pk.bwd_stages
    if st is None:
        raise ValueError("swin_block_2d_bwd needs the backward pack's weight "
                         "stages (pack_swin_block with folded=False)")
    want = sum(r for _, r in bwd_stage_rows(c, num_heads, hidden)) * KC
    if (st.dtype != torch.bfloat16 or st.device != x.device
            or not st.is_contiguous() or st.numel() != want):
        raise ValueError(f"backward weight stages must be a contiguous bf16 "
                         f"tensor of {want} elements on {x.device}")
    if st.data_ptr() % 16:
        raise ValueError("swin_block_2d_bwd needs the weight stages aligned "
                         "to 16 bytes")
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in (pk.bqkv, pk.bp, pk.b1, pk.relbias)):
        raise ValueError("packed biases and score table must be f32 on "
                         f"{x.device}")


def swin_block_2d_bwd(x: torch.Tensor, dy: torch.Tensor, p: SwinBlockParams,
                      num_heads: int, mask: Optional[torch.Tensor] = None,
                      packed: Optional[SwinBlockPack] = None, phase: int = 0
                      ) -> Tuple[torch.Tensor, SwinBlockParams]:
    """Backward of the training Swin block (window 8, the shift folded in:
    x read at +phase, dy in the block's coordinates, dx at x's): dx and the
    f32 parameter grads.

    CPU tensor → the plain version. CUDA tensor → the kernel of its dtype
    (x and dy of one dtype): bf16 → ``kair_swin_block_2d_bwd``, ``packed``
    the cached ``pack_swin_block(p, nh, folded=False)``; f32 →
    ``kair_swin_block_2d_bwd_f32``, ``packed`` the cached
    ``pack_swin_block_f32(p, nh)``; anything else raises. A launch adds one
    to ``launches`` (bf16) or ``launches_f32``."""
    if x.device.type == "cpu":
        return swin_block_2d_bwd_reference(x, dy, p, num_heads, mask, phase)
    if x.dtype == torch.float32:
        return _swin_block_2d_bwd_f32(x, dy, p, num_heads, mask, packed, phase)
    _check_cuda_args(x, p, num_heads, mask, backward=True)
    if isinstance(packed, SwinBlockF32Pack):
        raise TypeError("swin_block_2d_bwd: a bf16 input met the f32 pack")
    if (dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous()
            or dy.device != x.device):
        raise ValueError("dy must be a contiguous bf16 tensor shaped and "
                         "placed like x")
    b, h, w, c = x.shape
    hidden = p.fc1_weight.shape[0]
    if (tuple(p.fc1_weight.shape) != (hidden, c)
            or tuple(p.fc2_weight.shape) != (c, hidden)):
        raise ValueError(f"fc1/fc2 weights do not match C={c}")
    pk = packed if packed is not None else pack_swin_block(p, num_heads,
                                                           folded=False)
    _check_bwd_stages(x, pk, num_heads, hidden)
    if x.data_ptr() % 4 or dy.data_ptr() % (8 if c % 4 == 0 else 4):
        raise ValueError("swin_block_2d_bwd needs x aligned to 4 bytes and dy "
                         "to 8 (4 when C % 4 != 0)")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"swin_block_2d_bwd takes B*H*W < 2^31 pixels, got "
                         f"{b * h * w}")
    dx, dw, dln, dbias = _launch_bwd(_build.library(), x, dy, pk,
                                     ln_params(p), num_heads, hidden, mask,
                                     phase)
    swin_block_2d_bwd.launches += 1
    return dx, unpack_bwd_grads(dw, dln, dbias, p, num_heads)


def ln_params(p: SwinBlockParams) -> torch.Tensor:
    """(4, C) f32: norm1 weight, bias, norm2 weight, bias (the backward
    kernel's LayerNorm operand)."""
    return torch.stack([p.norm1_weight, p.norm1_bias, p.norm2_weight,
                        p.norm2_bias]).float().contiguous()


def _launch_bwd(lib, x: torch.Tensor, dy: torch.Tensor, pk: SwinBlockPack,
                ln: torch.Tensor, num_heads: int, hidden: int,
                mask: Optional[torch.Tensor], phase: int):
    """One launch of ``kair_swin_block_2d_bwd`` in ``lib`` (the library or
    its profile build) on checked arguments, its buffers sized by
    ``bwd_plan``; returns dx and the raw dw, dln, dbias. Raises on a CUDA
    error."""
    b, h, w, c = x.shape
    nh, pl = num_heads, bwd_plan(c, num_heads, hidden)
    windows = b * h * w // (WS * WS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(-(-windows // 2), sms)
    splits = bwd_splits(windows, pl.items, sms)
    f32 = torch.float32
    new = lambda *shape, dtype=f32: torch.empty(shape, dtype=dtype,
                                                device=x.device)
    scratch = new(2 * grid * pl.scratch, dtype=torch.uint8)
    ops = new(windows * sum(pl.op_rows) * 64, dtype=torch.bfloat16)
    part_bias = new(2 * grid, nh, 64 * 64)
    part_ln = new(8 * grid, 4, c)
    part_w = new(splits, pl.total)
    dx = torch.empty_like(x)
    dw, dln, dbias = new(pl.total), new(4, c), new(nh, 64, 64)
    with torch.cuda.device(x.device):
        err = lib.kair_swin_block_2d_bwd(
            x.data_ptr(), dy.data_ptr(), pk.bwd_stages.data_ptr(),
            pk.bqkv.data_ptr(), pk.bp.data_ptr(), pk.b1.data_ptr(),
            ln.data_ptr(), pk.relbias.data_ptr(),
            None if mask is None else mask.data_ptr(), scratch.data_ptr(),
            ops.data_ptr(), part_bias.data_ptr(), part_ln.data_ptr(),
            part_w.data_ptr(), dx.data_ptr(), dw.data_ptr(), dln.data_ptr(),
            dbias.data_ptr(), b, h, w, c, nh, hidden, int(phase), sms, splits,
            float((c // nh) ** -0.5),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "swin_block_2d_bwd")
    return dx, dw, dln, dbias


swin_block_2d_bwd.launches = 0
swin_block_2d_bwd.launches_f32 = 0


def wgrad_f32_splits(tokens: int, tiles: int, sms: int = 132) -> int:
    """Token ranges of the f32 weight-grad pass: about two blocks an SM,
    each range at least 256 tokens."""
    return max(1, min(-(-tokens // 256), -(-2 * sms // tiles)))


def _swin_block_2d_bwd_f32(x, dy, p, num_heads, mask, packed, phase):
    """The f32 backward kernel on checked CUDA tensors (``swin_block_2d_bwd``):
    pass 1 over the windows, the weight grads, the partial sums; then the
    grads in KAIR's layout."""
    _check_f32("swin_block_2d_bwd", x, p, num_heads, mask, WS, backward=True)
    pk = packed if packed is not None else pack_swin_block_f32(p, num_heads)
    check_f32_pack("swin_block_2d_bwd", x, pk)
    if (dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous()
            or dy.device != x.device):
        raise ValueError("dy must be a contiguous f32 tensor shaped and "
                         "placed like x")
    b, h, w, c = x.shape
    hidden = p.fc1_weight.shape[0]
    pl = bwd_f32_plan(c, num_heads, hidden)
    windows = b * h * w // (WS * WS)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(windows, sms)
    splits = wgrad_f32_splits(b * h * w, pl.tiles, sms)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                     device=x.device)
    ops = new(b * h * w * pl.op_floats)
    part_bias = torch.zeros(grid, num_heads, 64, 64, device=x.device)
    part_ln = torch.zeros(grid, 4, c, device=x.device)
    part_w = new(splits, pl.total)
    dx = torch.empty_like(x)
    dw, dln, dbias = new(pl.total), new(4, c), new(num_heads, 64, 64)
    with torch.cuda.device(x.device):
        err = _build.library().kair_swin_block_2d_bwd_f32(
            x.data_ptr(), dy.data_ptr(), pk.wqkv.data_ptr(),
            pk.bqkv.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.ln.data_ptr(), pk.w1.data_ptr(), pk.b1.data_ptr(),
            pk.w2.data_ptr(), pk.b2.data_ptr(), pk.relbias.data_ptr(),
            None if mask is None else mask.data_ptr(), ops.data_ptr(),
            part_bias.data_ptr(), part_ln.data_ptr(), part_w.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), dln.data_ptr(), dbias.data_ptr(),
            b, h, w, c, num_heads, HD_MAX, hidden, int(phase), grid, splits,
            float((c // num_heads) ** -0.5),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "swin_block_2d_bwd (f32)")
    swin_block_2d_bwd.launches_f32 += 1
    return dx, unpack_bwd_f32_grads(dw, dln, dbias, p, num_heads)


def unpack_bwd_f32_grads(dw: torch.Tensor, dln: torch.Tensor,
                         dbias: torch.Tensor, p: SwinBlockParams,
                         num_heads: int) -> SwinBlockParams:
    """The f32 backward's outputs (the four products' D back to back, each
    (Kin + 1, Nout): rows the layer input with its bias row of ones last;
    the LN grads (4, C); the score-bias grad (nh, 64, 64)) → grads in
    KAIR's layout."""
    c = p.qkv_weight.shape[1]
    hidden = p.fc1_weight.shape[0]
    pl = bwd_f32_plan(c, num_heads, hidden)
    d_qkv, d_proj, d_fc1, d_fc2 = (
        t.view(shape) for t, shape in
        zip(torch.split(dw, [m * n for m, n in pl.dims]), pl.dims))
    qcol, prow = _grad_index(c, num_heads, str(dw.device))
    nin = num_heads * HD_MAX
    t = lambda a: a.t().contiguous()
    return SwinBlockParams(
        qkv_weight=t(d_qkv[:c, qcol]),
        qkv_bias=None if p.qkv_bias is None else d_qkv[c, qcol].contiguous(),
        proj_weight=t(d_proj[prow, :]), proj_bias=d_proj[nin].contiguous(),
        rel_table=rel_table_grad(dbias, p.rel_table.shape[0], num_heads),
        norm1_weight=dln[0], norm1_bias=dln[1],
        norm2_weight=dln[2], norm2_bias=dln[3],
        fc1_weight=t(d_fc1[:c]), fc1_bias=d_fc1[c].contiguous(),
        fc2_weight=t(d_fc2[:hidden]), fc2_bias=d_fc2[hidden].contiguous())


def autocast_bf16(device: torch.device) -> bool:
    """Whether a bf16 autocast is on for ``device``'s type."""
    t = device.type
    return torch.is_autocast_enabled(t) and \
        torch.get_autocast_dtype(t) == torch.bfloat16


def kernel_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the training block runs x in: bf16 under a bf16 autocast on
    x's device, else x's own (an f32 model gets the f32 kernels)."""
    return torch.bfloat16 if autocast_bf16(x.device) else x.dtype


class SwinBlockFunction(torch.autograd.Function):
    """The training block as one autograd node: forward through
    ``swin_block_2d`` (kernel 1), backward through ``swin_block_2d_bwd``
    (kernel 3), both reading x at the block's phase. Only x and the
    parameters are saved (the remat profile of ``_fused_2d`` :490). On the
    card x runs in ``kernel_dtype(x)``: the bf16 kernels under a bf16
    autocast (f32 parameters stay the master copy and get f32 grads), else
    the kernels of x's own dtype (f32: the f32 kernels); dx goes back in
    x's dtype."""

    @staticmethod
    def forward(ctx, x, mask, num_heads, packed, packed_bwd, phase, *params):
        ctx.num_heads, ctx.mask, ctx.x_dtype = num_heads, mask, x.dtype
        ctx.packed_bwd, ctx.phase = packed_bwd, phase
        xin = x.to(kernel_dtype(x)).contiguous() if x.is_cuda else x
        ctx.save_for_backward(xin, *params)
        return swin_block_2d(xin, SwinBlockParams(*params), num_heads, mask,
                             phase, packed=packed)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        dx, grads = swin_block_2d_bwd(x, dy.to(x.dtype).contiguous(),
                                      SwinBlockParams(*params),
                                      ctx.num_heads, ctx.mask, ctx.packed_bwd,
                                      ctx.phase)
        return (dx.to(ctx.x_dtype), None, None, None, None, None,
                *[None if g is None else g.to(a.dtype)
                  for g, a in zip(grads, params)])


def swin_block_train(x: torch.Tensor, p: SwinBlockParams, num_heads: int,
                     mask: Optional[torch.Tensor] = None,
                     packed: Optional[SwinBlockPack] = None,
                     packed_bwd: Optional[SwinBlockPack] = None,
                     phase: int = 0) -> torch.Tensor:
    """Differentiable Swin block on (B, H, W, C), window 8: Block(roll(x,
    −phase)) in the block's own coordinates (the caller rolls the output
    back), ``SwinBlockFunction``. ``packed`` and ``packed_bwd`` are the
    cached forward and backward packs of ``kernel_dtype(x)`` for a CUDA
    tensor (made per call when None; in f32 both are the f32 pack)."""
    return SwinBlockFunction.apply(x, mask, num_heads, packed, packed_bwd,
                                   phase, *p)
