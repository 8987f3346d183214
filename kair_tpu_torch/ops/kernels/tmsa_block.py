"""VRT's TMSA mutual block on (2, 8, 8) windows — CUDA kernel
``kair_win3d_block`` (the mutual block).

``tmsa_block`` replaces ``kair_tpu/ops/pallas/tmsa_block.py ::
tmsa_block_pallas`` (:395, ``pl.pallas_call`` :253) at inference:

    out = roll(Block(roll(x, −shift)), +shift)

on (B, D, H, W, C), where Block is LN1 → self-MSA over the window's 128
tokens (3-D rel-pos bias, shift mask) and mutual MSA on LN1(x) + sine
position (frame 2's queries on frame 1's keys and values and the reverse,
under the frame-1 block of the mask) → proj of ``[mutual | self]`` → +x →
LN2 → GEGLU → +x. The kernel is the mutual instance of the three wgmma
passes in ``csrc/window3d_wgmma.cu``, with both branches (its header gives
the bound on the card and the design; ``win3d.py`` the host side);
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
from kair_tpu_torch.ops.kernels.recompute import win3d_train
from kair_tpu_torch.ops.kernels.win3d import (Win3dStages, check_geometry,
                                              launch_win3d, pack_win3d_stages)
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
               packed: Optional[Win3dStages] = None) -> torch.Tensor:
    """TMSA mutual block on (B, D, H, W, C), windows (2, 8, 8), shift folded
    into the kernel's indices.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16), or an
    exception; ``packed`` is the cached ``pack_win3d_stages(p, nh)``. A
    launch adds one to ``launches``."""
    if x.device.type == "cpu":
        return tmsa_block_reference(x, p, num_heads, shift)
    check_geometry("tmsa_block", x, p, num_heads, 2, mutual=True)
    if window3d.table_depth(p.rel_table) != 2:
        raise ValueError("tmsa_block needs the (2, 8, 8) window's table")
    pk = packed if packed is not None else pack_win3d_stages(p, num_heads)
    out = launch_win3d("tmsa_block", x, pk, num_heads, 2, 2, shift, True)
    tmsa_block.launches += 1
    return out


tmsa_block.launches = 0


def tmsa_block_train(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                     shift: Sequence[int] = (0, 0, 0),
                     packed: Optional[Win3dStages] = None) -> torch.Tensor:
    """Differentiable ``tmsa_block``: the kernel forward, the composed
    block's autograd as its backward (``recompute.win3d_train``)."""
    return win3d_train(lambda xin, pp: tmsa_block(xin, pp, num_heads, shift,
                                                  packed=packed),
                       x, p, num_heads, WS, shift)
