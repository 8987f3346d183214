"""Host side of the three window-block kernels (``csrc/window3d_block.cu``):
VRT's TMSA mutual block (``tmsa_block.py``) and self-attention (wd, 8, 8)
block (``self6_block.py``), and RVRT's self-only (2, 8, 8) STL block with a
plain GELU MLP (``stl2_block.py``).

``pack_win3d`` relays a block's parameters into the kernels' operands,
``labels_on`` gives the shift mask as region labels, ``check_geometry``
refuses what the kernels do not take, and ``shared_bytes`` mirrors the
passes' shared-memory layouts (``chip_smoke.py`` phase 1 holds it equal to
the kernels' own count).

The relative-position table keeps the window depth ``twd`` it was made
for (KAIR's module window, 6 in VRT): a block on a shallower window reads
it with the (twd, 8, 8) index sliced to its N tokens, as KAIR does. The
shift mask goes to the kernel as region labels, (8, N) int32: one row per
boundary pattern, a key and a query in different regions score −100.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Sequence

import torch

from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.window_msa import (HD_MAX, SMEM_LIMIT,
                                                   pack_qkv_proj)
from kair_tpu_torch.ops.window3d import Tmsa3dParams

WARPS = 8
STAGE = 256                 # f32 staging floats per warp and tile


def shared_bytes(c: int, nh: int, hp: int, p: int) -> int:
    """Bytes of shared memory the largest of the three passes asks (the
    QkvSmem / AttnSmem / MlpSmem layouts of csrc/window3d_block.cu); ``p`` = 2
    for the mutual block, 1 for self-only (the GEGLU and the plain MLP use
    one layout)."""
    r16, a128 = _build.round16, _build.align128
    la = r16(c) + 8
    qkv = a128(64 * la * 2) + WARPS * STAGE * 4
    off = 0
    for nbytes in (64 * 40 * 2,) * 3 + (64 * 68 * 4, 64 * 72 * 2):
        off = a128(off + nbytes)
    attn = a128(off + 64 * 36 * 4)
    lat, lh = p * nh * 32 + 8, hp + 8
    x1 = a128(64 * lat * 2)
    hbuf = a128(x1 + 64 * c * 4)
    hid = a128(hbuf + 64 * la * 2)
    stage = a128(hid + 64 * lh * 2)
    mlp = stage + WARPS * 2 * STAGE * 4
    return max(qkv, attn, mlp)


class Win3dPack(NamedTuple):
    """The kernels' operands (the layout note in csrc/window3d_block.cu)."""
    wqkv_s: torch.Tensor    # (CP, nh*96) bf16, q scale folded
    bqkv_s: torch.Tensor    # (nh*96,) f32
    wqkv_m: Optional[torch.Tensor]
    bqkv_m: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]     # (64, C) f32
    ln1: torch.Tensor       # (2, C) f32 scale, bias
    ln2: torch.Tensor
    wp: torch.Tensor        # (P*nh*32, CP) bf16, mutual heads first
    bp: torch.Tensor        # (C,) f32
    w11: torch.Tensor       # (CP, HP) bf16; fc1 of a plain MLP
    b11: torch.Tensor       # (HP,) f32
    w12: Optional[torch.Tensor]     # None for a plain MLP
    b12: Optional[torch.Tensor]
    w2: torch.Tensor        # (HP, CP) bf16
    b2: torch.Tensor        # (C,) f32
    rel_table: torch.Tensor     # f32, contiguous
    hp: int


def pack_win3d(p: Tmsa3dParams, num_heads: int,
               dtype: torch.dtype = torch.bfloat16) -> Win3dPack:
    """Relayout and cast one block's parameters for the kernels (once per
    set of weights; the model caches it). ``dtype=torch.float32`` keeps the
    matrices exact for checking the layout against the plain version. No
    LayerNorm affine is folded: the mutual branch adds the position after
    LN1's affine, so the kernels apply both affines themselves."""
    with torch.autocast(p.qkv_self_weight.device.type, enabled=False):
        return _pack(p, num_heads, dtype)


def _pack(p: Tmsa3dParams, nh: int, dtype: torch.dtype) -> Win3dPack:
    c = p.qkv_self_weight.shape[1]
    cp = _build.round16(c)
    hidden = p.fc11_weight.shape[0]
    hp = _build.round16(hidden)
    dev, f32 = p.qkv_self_weight.device, torch.float32
    mutual = p.qkv_mut_weight is not None
    gated = p.fc12_weight is not None
    proj_self = p.proj_weight[:, c:] if mutual else p.proj_weight
    wqkv_s, bqkv_s, wp = pack_qkv_proj(p.qkv_self_weight, p.qkv_self_bias,
                                       proj_self, nh)
    wqkv_m = bqkv_m = pos = None
    if mutual:
        wqkv_m, bqkv_m, wp_m = pack_qkv_proj(p.qkv_mut_weight, p.qkv_mut_bias,
                                             p.proj_weight[:, :c], nh)
        wp = torch.cat([wp_m, wp], 0)
        wqkv_m = wqkv_m.to(dtype).contiguous()
        pos = p.position_bias.reshape(64, c).float().contiguous()

    def mat(w, rows, cols):                 # (out, in) weight → padded (in, out)
        m = torch.zeros(rows, cols, device=dev, dtype=f32)
        m[:w.shape[1], :w.shape[0]] = w.float().t()
        return m.to(dtype).contiguous()

    def vec(b, n):
        v = torch.zeros(n, device=dev, dtype=f32)
        v[:b.shape[0]] = b.float()
        return v

    return Win3dPack(
        wqkv_s=wqkv_s.to(dtype).contiguous(), bqkv_s=bqkv_s.contiguous(),
        wqkv_m=wqkv_m, bqkv_m=None if bqkv_m is None else bqkv_m.contiguous(),
        pos=pos,
        ln1=torch.stack([p.norm1_weight, p.norm1_bias]).float().contiguous(),
        ln2=torch.stack([p.norm2_weight, p.norm2_bias]).float().contiguous(),
        wp=wp.to(dtype).contiguous(), bp=p.proj_bias.float().contiguous(),
        w11=mat(p.fc11_weight, cp, hp), b11=vec(p.fc11_bias, hp),
        w12=mat(p.fc12_weight, cp, hp) if gated else None,
        b12=vec(p.fc12_bias, hp) if gated else None,
        w2=mat(p.fc2_weight, hp, cp), b2=p.fc2_bias.float().contiguous(),
        rel_table=p.rel_table.float().contiguous(), hp=hp)


def labels_on(dhw: Sequence[int], ws: Sequence[int], ss: Sequence[int],
              device: torch.device) -> Optional[torch.Tensor]:
    """(8, N) int32 region labels of a shifted geometry on ``device`` (None
    when unshifted); cached per geometry: a constant of the shape."""
    if not any(ss):
        return None
    return _labels_on(tuple(dhw), tuple(ws), tuple(ss), str(device))


@lru_cache(maxsize=64)
def _labels_on(dhw, ws, ss, device: str) -> torch.Tensor:
    labels, _ = window3d.compute_mask_labels_3d(*dhw, ws, ss)
    with torch.inference_mode(False):
        return torch.from_numpy(labels).to(device)


def check_geometry(name: str, x: torch.Tensor, p: Tmsa3dParams,
                   num_heads: int, wd: int, mutual: bool,
                   gated: bool = True) -> int:
    """Raise on what the window kernels do not take; returns the table's
    window depth. bf16, contiguous (B, D, H, W, C) with (wd, 8, 8) windows
    tiling it, head dim ≤ 32, a table for 8x8 windows at least wd deep, the
    parameters of the kernel's kind of block (mutual or not, GEGLU
    (``gated``) or plain MLP), and a layout within the card's opt-in
    limit."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous (B, D, H, W, C) tensor")
    b, d, h, w, c = x.shape
    if d % wd or h % 8 or w % 8:
        raise ValueError(f"{name} needs ({wd}, 8, 8) windows tiling the map, "
                         f"got {d}x{h}x{w}")
    if c % num_heads or c // num_heads > HD_MAX:
        raise ValueError(f"{name} needs C divisible by the heads with head "
                         f"dim <= {HD_MAX} (C={c}, heads={num_heads})")
    if tuple(p.qkv_self_weight.shape) != (3 * c, c):
        raise ValueError(f"qkv weight {tuple(p.qkv_self_weight.shape)} does "
                         f"not match C={c}")
    twd = window3d.table_depth(p.rel_table)
    if (p.rel_table.shape[0] != (2 * twd - 1) * 225 or twd < wd
            or p.rel_table.shape[1] != num_heads):
        raise ValueError(f"{name} needs a relative position table for 8x8 "
                         f"windows at least {wd} deep and {num_heads} heads, "
                         f"got {tuple(p.rel_table.shape)}")
    if (mutual != (p.qkv_mut_weight is not None)
            or gated != (p.fc12_weight is not None)
            or (mutual and tuple(p.proj_weight.shape) != (c, 2 * c))):
        raise ValueError(f"{name}: parameters of the wrong kind of block")
    hp = _build.round16(p.fc11_weight.shape[0])
    smem = shared_bytes(c, num_heads, hp, 2 if mutual else 1)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{name} at C={c}, {num_heads} heads needs {smem} "
                         f"bytes of shared memory per block, over the card's "
                         f"opt-in limit of {SMEM_LIMIT}")
    return twd
