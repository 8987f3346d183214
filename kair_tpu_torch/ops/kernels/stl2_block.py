"""RVRT's self-only STL block on (2, 8, 8) windows — CUDA kernel
``kair_stl2_block``.

``stl2_block`` replaces ``kair_tpu/ops/pallas/stl_block.py ::
stl2_block_pallas`` (:207, ``pl.pallas_call`` :110) at inference:

    out = roll(Block(roll(x, −shift)), +shift)

on (B, D, H, W, C), where Block is LN1 → W-MSA over (2, 8, 8) windows (3-D
rel-pos bias, 0/−100 shift mask) → +x → LN2 → fc1 → exact GELU → fc2 → +x:
the STL blocks of RVRT's propagation backbones (KAIR
``network_rvrt.py:337-358``). The kernel is the plain-MLP instance of the
three passes in ``csrc/window3d_block.cu`` (its header gives the bound on
the card and the design; ``win3d.py`` the host side it shares with VRT's
blocks); ``stl2_block_reference`` is its plain version, the composed block
of ``ops/window3d.py`` in f32. The TPU kernel's max-free inference softmax
is not copied: the kernel keeps a running row max.

A CPU tensor takes the plain version; a CUDA tensor the kernel, or an
exception. Nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.win3d import (Win3dPack, check_geometry,
                                              labels_on, pack_win3d)
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
               packed: Optional[Win3dPack] = None) -> torch.Tensor:
    """RVRT STL block on (B, D, H, W, C), windows (2, 8, 8), shift folded
    into the kernel's indices.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16), or an
    exception; ``packed`` is the cached ``pack_win3d(p, nh)``. A launch adds
    one to ``launches``."""
    if x.device.type == "cpu":
        return stl2_block_reference(x, p, num_heads, shift)
    twd = check_geometry("stl2_block", x, p, num_heads, 2, mutual=False,
                         gated=False)
    pk = packed if packed is not None else pack_win3d(p, num_heads)
    b, d, h, w, c = x.shape
    t = b * d * h * w
    qkv = torch.empty(t, num_heads * 96, dtype=x.dtype, device=x.device)
    att = torch.empty(t, num_heads * 32, dtype=x.dtype, device=x.device)
    lab = labels_on((d, h, w), WS, shift, x.device)
    out = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.kair_stl2_block(
            x.data_ptr(), out.data_ptr(), qkv.data_ptr(), att.data_ptr(),
            pk.wqkv_s.data_ptr(), pk.bqkv_s.data_ptr(), pk.ln1.data_ptr(),
            pk.ln2.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.w11.data_ptr(), pk.b11.data_ptr(), pk.w2.data_ptr(),
            pk.b2.data_ptr(), pk.rel_table.data_ptr(),
            None if lab is None else lab.data_ptr(),
            b, d, h, w, c, num_heads, pk.hp, twd, *map(int, shift),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stl2_block")
    stl2_block.launches += 1
    return out


stl2_block.launches = 0
