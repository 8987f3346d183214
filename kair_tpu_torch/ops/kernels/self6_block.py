"""VRT's self-attention + GEGLU block on (wd, 8, 8) windows — CUDA kernel
``kair_self6_block``.

``self6_block`` replaces ``kair_tpu/ops/pallas/self6_block.py ::
self6_block_pallas`` (:328, ``pl.pallas_call`` :203) at inference:

    out = roll(Block(roll(x, −shift)), +shift)

on (B, D, H, W, C), where Block is LN1 → W-MSA over (wd, 8, 8) windows
(3-D rel-pos bias, 0/−100 shift mask) → +x → LN2 → GEGLU → +x, for wd in
{6, 2, 1} (any wd that divides D). The kernel is the self-only instance of
the three passes in ``csrc/window3d_block.cu`` (its header gives the bound
on the card and the design; ``win3d.py`` the host side it shares with the
TMSA block); ``self6_block_reference`` is its plain version, the composed
block of ``ops/window3d.py`` in f32.

A CPU tensor takes the plain version; a CUDA tensor the kernel, or an
exception. Nothing falls back. ``self6_block_train`` is the training route
(JAX ``self6_block.py:301-325``): the kernel forward and autograd through
the composed block recomputed from the saved input and parameters.
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


def self6_block_reference(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                          wd: int, shift: Sequence[int] = (0, 0, 0)
                          ) -> torch.Tensor:
    """Plain version of the kernel, in f32 from the given inputs: the
    composed block at window (wd, 8, 8) and shift ``shift``; returns
    ``x.dtype``."""
    return window3d.tmsa_composed(x.float(), p.float(), num_heads,
                                  (wd, 8, 8), shift).to(x.dtype)


def self6_block(x: torch.Tensor, p: Tmsa3dParams, num_heads: int, wd: int,
                shift: Sequence[int] = (0, 0, 0),
                packed: Optional[Win3dPack] = None) -> torch.Tensor:
    """Self-attention + GEGLU block on (B, D, H, W, C), windows (wd, 8, 8),
    shift folded into the kernel's indices.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16), or an
    exception; ``packed`` is the cached ``pack_win3d(p, nh)``. A launch adds
    one to ``launches``."""
    if x.device.type == "cpu":
        return self6_block_reference(x, p, num_heads, wd, shift)
    twd = check_geometry("self6_block", x, p, num_heads, wd, mutual=False)
    pk = packed if packed is not None else pack_win3d(p, num_heads)
    b, d, h, w, c = x.shape
    t = b * d * h * w
    qkv = torch.empty(t, num_heads * 96, dtype=x.dtype, device=x.device)
    att = torch.empty(t, num_heads * 32, dtype=x.dtype, device=x.device)
    lab = labels_on((d, h, w), (wd, 8, 8), shift, x.device)
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.kair_self6_block(
            x.data_ptr(), out.data_ptr(), qkv.data_ptr(), att.data_ptr(),
            pk.wqkv_s.data_ptr(), pk.bqkv_s.data_ptr(), pk.ln1.data_ptr(),
            pk.ln2.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.w11.data_ptr(), pk.b11.data_ptr(), pk.w12.data_ptr(),
            pk.b12.data_ptr(), pk.w2.data_ptr(), pk.b2.data_ptr(),
            pk.rel_table.data_ptr(), None if lab is None else lab.data_ptr(),
            b, d, h, w, c, num_heads, pk.hp, wd, twd, *map(int, shift),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"self6_block (wd {wd})")
    self6_block.launches += 1
    return out


self6_block.launches = 0


class Self6BlockFunction(torch.autograd.Function):
    """``self6_block`` forward; backward by autograd through
    ``window3d.tmsa_composed`` at window (wd, 8, 8), recomputed from the
    saved x and parameters under the forward's autocast state (as
    ``TmsaBlockFunction``)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, num_heads, wd, shift, packed, *params):
        ctx.num_heads, ctx.wd, ctx.shift = num_heads, wd, tuple(shift)
        ctx.x_dtype = x.dtype
        xin = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
        ctx.save_for_backward(xin, *params)
        return self6_block(xin, Tmsa3dParams(*params), num_heads, wd, shift,
                           packed=packed)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:1] + ctx.needs_input_grad[5:]
        dx, *grads = composed_vjp(
            lambda x, *p: window3d.tmsa_composed(
                x, Tmsa3dParams(*p), ctx.num_heads, (ctx.wd, 8, 8), ctx.shift),
            ctx.saved_tensors, needs, dy)
        return (None if dx is None else dx.to(ctx.x_dtype), None, None, None,
                None, *grads)


def self6_block_train(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                      wd: int, shift: Sequence[int] = (0, 0, 0),
                      packed: Optional[Win3dPack] = None) -> torch.Tensor:
    """Differentiable ``self6_block``: ``Self6BlockFunction``."""
    return Self6BlockFunction.apply(x, num_heads, wd, tuple(shift), packed, *p)
