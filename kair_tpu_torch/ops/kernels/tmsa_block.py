"""VRT's TMSA mutual block on (2, 8, 8) windows — CUDA kernel
``kair_tmsa_block``.

``tmsa_block`` replaces ``kair_tpu/ops/pallas/tmsa_block.py ::
tmsa_block_pallas`` (:395, ``pl.pallas_call`` :253) at inference:

    out = roll(Block(roll(x, −shift)), +shift)

on (B, D, H, W, C), where Block is LN1 → self-MSA over the window's 128
tokens (3-D rel-pos bias, shift mask) and mutual MSA on LN1(x) + sine
position (frame 2's queries on frame 1's keys and values and the reverse,
under the frame-1 block of the mask) → proj of ``[mutual | self]`` → +x →
LN2 → GEGLU → +x. The kernel is the mutual instance of the three passes
in ``csrc/window3d_block.cu``, with both branches (its header gives the
bound on the card; ``win3d.py`` the host side);
``tmsa_block_reference`` is its plain version, the composed block of
``ops/window3d.py`` in f32. The TPU kernel's rowsum lane, max-free softmax
and −1e9 block-diagonal bias are TPU layout tricks: the kernel subtracts
the running row max and gives each branch its own key tiles.

A CPU tensor takes the plain version; a CUDA tensor the kernel, or an
exception. ``tmsa_block_train`` is the training route (JAX
``tmsa_block.py:365-392``): the kernel forward, whose online softmax
subtracts the row max as the JAX training forward's ``safe=True`` does, and
autograd through the composed block recomputed from the saved input and
parameters (the JAX remat profile: only x is saved).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.recompute import composed_vjp
from kair_tpu_torch.ops.kernels.win3d import (Win3dPack, check_geometry,
                                              labels_on, pack_win3d)
from kair_tpu_torch.ops.window3d import Tmsa3dParams

WS = (2, 8, 8)


def tmsa_block_reference(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                         shift: Sequence[int] = (0, 0, 0)) -> torch.Tensor:
    """Plain version of the kernel, in f32 from the given inputs: the
    composed mutual block at window (2, 8, 8) and shift ``shift``; returns
    ``x.dtype``."""
    return window3d.tmsa_composed(x.float(), p.float(), num_heads, WS,
                                  shift).to(x.dtype)


def tmsa_block(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
               shift: Sequence[int] = (0, 0, 0),
               packed: Optional[Win3dPack] = None) -> torch.Tensor:
    """TMSA mutual block on (B, D, H, W, C), windows (2, 8, 8), shift folded
    into the kernel's indices.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16), or an
    exception; ``packed`` is the cached ``pack_win3d(p, nh)``. A launch adds
    one to ``launches``."""
    if x.device.type == "cpu":
        return tmsa_block_reference(x, p, num_heads, shift)
    check_geometry("tmsa_block", x, p, num_heads, 2, mutual=True)
    if window3d.table_depth(p.rel_table) != 2:
        raise ValueError("tmsa_block needs the (2, 8, 8) window's table")
    pk = packed if packed is not None else pack_win3d(p, num_heads)
    b, d, h, w, c = x.shape
    t = b * d * h * w
    qkv = torch.empty(t, 2 * num_heads * 96, dtype=x.dtype, device=x.device)
    att = torch.empty(t, 2 * num_heads * 32, dtype=x.dtype, device=x.device)
    lab = labels_on((d, h, w), WS, shift, x.device)
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.kair_tmsa_block(
            x.data_ptr(), out.data_ptr(), qkv.data_ptr(), att.data_ptr(),
            pk.wqkv_s.data_ptr(), pk.bqkv_s.data_ptr(), pk.wqkv_m.data_ptr(),
            pk.bqkv_m.data_ptr(), pk.pos.data_ptr(), pk.ln1.data_ptr(),
            pk.ln2.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.w11.data_ptr(), pk.b11.data_ptr(), pk.w12.data_ptr(),
            pk.b12.data_ptr(), pk.w2.data_ptr(), pk.b2.data_ptr(),
            pk.rel_table.data_ptr(), None if lab is None else lab.data_ptr(),
            b, d, h, w, c, num_heads, pk.hp, *map(int, shift),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "tmsa_block")
    tmsa_block.launches += 1
    return out


tmsa_block.launches = 0


class TmsaBlockFunction(torch.autograd.Function):
    """``tmsa_block`` forward; backward by autograd through
    ``window3d.tmsa_composed`` recomputed from the saved x and parameters
    under the forward's autocast state. On the card x runs in bf16 whatever
    it arrives in (the kernel takes bf16; the f32 parameters get f32
    grads) and dx goes back in x's type."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, num_heads, shift, packed, *params):
        ctx.num_heads, ctx.shift, ctx.x_dtype = num_heads, tuple(shift), x.dtype
        xin = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
        ctx.save_for_backward(xin, *params)
        return tmsa_block(xin, Tmsa3dParams(*params), num_heads, shift,
                          packed=packed)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:1] + ctx.needs_input_grad[4:]
        dx, *grads = composed_vjp(
            lambda x, *p: window3d.tmsa_composed(x, Tmsa3dParams(*p),
                                                 ctx.num_heads, WS, ctx.shift),
            ctx.saved_tensors, needs, dy)
        return (None if dx is None else dx.to(ctx.x_dtype), None, None, None,
                *grads)


def tmsa_block_train(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                     shift: Sequence[int] = (0, 0, 0),
                     packed: Optional[Win3dPack] = None) -> torch.Tensor:
    """Differentiable ``tmsa_block``: ``TmsaBlockFunction``."""
    return TmsaBlockFunction.apply(x, num_heads, tuple(shift), packed, *p)
