"""VRT's self-attention + GEGLU block on (wd, 8, 8) windows — CUDA kernel
``kair_win3d_block`` (the self block).

``self6_block`` replaces ``kair_tpu/ops/pallas/self6_block.py ::
self6_block_pallas`` (:328, ``pl.pallas_call`` :203) at inference:

    out = roll(Block(roll(x, −shift)), +shift)

on (B, D, H, W, C), where Block is LN1 → W-MSA over (wd, 8, 8) windows
(3-D rel-pos bias, 0/−100 shift mask) → +x → LN2 → GEGLU → +x, for wd in
{8, 6, 4, 2, 1} (any wd that divides D). The kernel is the self-only
instance of the three wgmma passes in ``csrc/window3d_wgmma.cu`` (its
header gives the bound on the card and the design; ``win3d.py`` the host
side it shares with the TMSA block); ``self6_block_reference`` is its
plain version, the composed block of ``ops/window3d.py`` in f32.

A CPU tensor takes the plain version; a CUDA tensor the kernel, or an
exception. Nothing falls back. ``self6_block_train`` is the training route
(JAX ``self6_block.py:301-325``): the kernel forward and autograd through
the composed block recomputed from the saved input and parameters.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels.recompute import win3d_train
from kair_tpu_torch.ops.kernels.win3d import (Win3dStages, check_geometry,
                                              launch_win3d, pack_win3d_stages)
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
                packed: Optional[Win3dStages] = None) -> torch.Tensor:
    """Self-attention + GEGLU block on (B, D, H, W, C), windows (wd, 8, 8),
    shift folded into the kernel's indices.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16), or an
    exception; ``packed`` is the cached ``pack_win3d_stages(p, nh)``. A
    launch adds one to ``launches``."""
    if x.device.type == "cpu":
        return self6_block_reference(x, p, num_heads, wd, shift)
    twd = check_geometry("self6_block", x, p, num_heads, wd, mutual=False)
    pk = packed if packed is not None else pack_win3d_stages(p, num_heads)
    out = launch_win3d("self6_block", x, pk, num_heads, wd, twd, shift, False)
    self6_block.launches += 1
    return out


self6_block.launches = 0


def self6_block_train(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                      wd: int, shift: Sequence[int] = (0, 0, 0),
                      packed: Optional[Win3dStages] = None) -> torch.Tensor:
    """Differentiable ``self6_block``: the kernel forward, the composed
    block's autograd at window (wd, 8, 8) as its backward
    (``recompute.win3d_train``)."""
    return win3d_train(lambda xin, pp: self6_block(xin, pp, num_heads, wd,
                                                   shift, packed=packed),
                       x, p, num_heads, (wd, 8, 8), shift)
