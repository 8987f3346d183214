"""RVRT's self-only STL block on (2, 8, 8) windows — CUDA kernel
``kair_win3d_block``, the STL kind.

``stl2_block`` replaces ``kair_tpu/ops/pallas/stl_block.py ::
stl2_block_pallas`` (:207, ``pl.pallas_call`` :110) at inference:

    out = roll(Block(roll(x, −shift)), +shift)

on (B, D, H, W, C), where Block is LN1 → W-MSA over (2, 8, 8) windows (3-D
rel-pos bias, 0/−100 shift mask) → +x → LN2 → fc1 → exact GELU → fc2 → +x:
the STL blocks of RVRT's propagation backbones (KAIR
``network_rvrt.py:337-358``). The kernel is the plain-MLP kind of VRT's
self block's three wgmma passes in ``csrc/window3d_wgmma.cu`` (passes 1
and 2 the self block's at C = 144 and 192, RVRT's widths; pass 3 one fc1
product of N = 64 a hidden chunk and the exact-erf GELU; its header gives
the bound on the card and the design; ``win3d.py`` the host side it shares
with VRT's blocks); ``stl2_block_reference`` is its plain version, the
composed block of ``ops/window3d.py`` in f32. The TPU kernel's max-free
inference softmax is not copied: the kernel keeps a running row max.

A CPU tensor takes the plain version; a CUDA tensor the kernel, or an
exception. Nothing falls back. ``stl2_block_train`` is the training route
(JAX ``_fused_stl2_fwd/_bwd``, ``stl_block.py:187-201``): the kernel
forward and autograd through the composed block recomputed from the saved
input and parameters, as ``tmsa_block_train`` does for VRT's mutual block.
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


def stl2_block_reference(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                         shift: Sequence[int] = (0, 0, 0)) -> torch.Tensor:
    """Plain version of the kernel, in f32 from the given inputs: the
    composed self-only block with the plain MLP at window (2, 8, 8) and
    shift ``shift``; returns ``x.dtype``."""
    return window3d.tmsa_composed(x.float(), p.float(), num_heads, WS,
                                  shift).to(x.dtype)


def stl2_block(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
               shift: Sequence[int] = (0, 0, 0),
               packed: Optional[Win3dStages] = None) -> torch.Tensor:
    """RVRT STL block on (B, D, H, W, C), windows (2, 8, 8), shift folded
    into the kernel's indices.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16), or an
    exception; ``packed`` is the cached ``pack_win3d_stages(p, nh)``. A
    launch adds one to ``launches``."""
    if x.device.type == "cpu":
        return stl2_block_reference(x, p, num_heads, shift)
    twd = check_geometry("stl2_block", x, p, num_heads, 2, mutual=False,
                         gated=False)
    pk = packed if packed is not None else pack_win3d_stages(p, num_heads)
    out = launch_win3d("stl2_block", x, pk, num_heads, 2, twd, shift,
                       mutual=False, plain=True)
    stl2_block.launches += 1
    return out


stl2_block.launches = 0


def stl2_block_train(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                     shift: Sequence[int] = (0, 0, 0),
                     packed: Optional[Win3dStages] = None) -> torch.Tensor:
    """Differentiable ``stl2_block``: the kernel forward, the composed
    block's autograd as its backward (``recompute.win3d_train``)."""
    return win3d_train(lambda xin, pp: stl2_block(xin, pp, num_heads, shift,
                                                  packed=packed),
                       x, p, num_heads, WS, shift)
