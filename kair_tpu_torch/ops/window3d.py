"""VRT's 3-D window geometry and its composed transformer block, in PyTorch.

Counterpart of ``kair_tpu/models/vrt.py:48-393``: the numpy geometry
(``get_window_size``, ``compute_mask_3d``, ``compute_mask_labels_3d``,
``rel_position_index_3d``, ``sine_position_encoding``), window partition and
reverse on (B, D, H, W, C), and the composed TMSA block (LN1 → joint self +
mutual window attention → residual → LN2 → MLP → residual) as KAIR
computes it (``network_vrt.py:588-850``). The MLP is VRT's GEGLU, or for
RVRT's self-only STL blocks (``network_rvrt.py:337-358``) the plain
fc1 → exact GELU → fc2 (``Tmsa3dParams.fc12_weight`` None).
``models/vrt.py`` runs the composed block for a geometry that no kernel
takes; the kernels' plain versions (``ops/kernels/tmsa_block.py``,
``self6_block.py``, ``stl2_block.py``) are this block in f32.

Two quirks of KAIR are kept: the mutual branch's mask is the window mask's
top-left ``[:N/2, :N/2]`` block, and the projection's input is
``[mutual | self]`` (width 2C).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def get_window_size(x_size, window_size, shift_size=None):
    """Clamp window and shift to the input extent (KAIR :479-494)."""
    ws = list(window_size)
    ss = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            ws[i] = x_size[i]
            if ss is not None:
                ss[i] = 0
    return (tuple(ws), tuple(ss)) if shift_size is not None else tuple(ws)


def _region_map(D, H, W, window_size, shift_size) -> np.ndarray:
    img_mask = np.zeros((D, H, W), np.int32)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0] or None),
              slice(-shift_size[0] or None, None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1] or None),
                  slice(-shift_size[1] or None, None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2] or None),
                      slice(-shift_size[2] or None, None)):
                img_mask[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(D // wd, wd, H // wh, wh, W // ww, ww)
    return m.transpose(0, 2, 4, 1, 3, 5).reshape(
        D // wd, H // wh, W // ww, wd * wh * ww)


@functools.lru_cache(maxsize=64)
def compute_mask_3d(D, H, W, window_size, shift_size) -> np.ndarray:
    """(nW, N, N) 0/−100 mask for shifted 3-D windows (KAIR :497-514)."""
    m = _region_map(D, H, W, tuple(window_size), tuple(shift_size))
    m = m.reshape(-1, m.shape[-1])
    attn = m[:, None, :] - m[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def compute_mask_labels_3d(D, H, W, window_size, shift_size):
    """(labels (8, N) int32, window pattern index (nW,)): the mask of
    ``compute_mask_3d`` factored into per-token region labels of the 8
    boundary patterns (4·is_last_d + 2·is_last_h + is_last_w); the (N, N)
    mask of a window is ``where(label_i != label_j, −100, 0)``."""
    m = _region_map(D, H, W, tuple(window_size), tuple(shift_size))
    nd, nh, nw = m.shape[:3]
    labels = np.zeros((8, m.shape[-1]), np.int32)
    for ild in (0, 1):
        for ilh in (0, 1):
            for ilw in (0, 1):
                labels[4 * ild + 2 * ilh + ilw] = m[
                    (nd - 1) if ild else 0, (nh - 1) if ilh else 0,
                    (nw - 1) if ilw else 0]
    di = (np.arange(nd) == nd - 1).astype(np.int32) * 4
    hi = (np.arange(nh) == nh - 1).astype(np.int32) * 2
    wi = (np.arange(nw) == nw - 1).astype(np.int32)
    idx = (di[:, None, None] + hi[None, :, None] + wi[None, None, :]).reshape(-1)
    assert np.array_equal(labels[idx], m.reshape(-1, m.shape[-1])), \
        "mask label factorization mismatch"
    return labels, idx


@functools.lru_cache(maxsize=64)
def rel_position_index_3d(wd, wh, ww) -> np.ndarray:
    """(N, N) index into the (2wd−1)(2wh−1)(2ww−1) bias table (KAIR
    get_position_index, :688-706)."""
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= (2 * ww - 1)
    return rel.sum(-1)


@functools.lru_cache(maxsize=16)
def sine_position_encoding(h, w, num_pos_feats, temperature=10000,
                           normalize=True) -> np.ndarray:
    """(h·w, 2·num_pos_feats) DETR-style sine encoding (KAIR
    get_sine_position_encoding, :708-727)."""
    scale = 2 * math.pi
    y_embed = np.cumsum(np.ones((h, w)), axis=0)
    x_embed = np.cumsum(np.ones((h, w)), axis=1)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[-1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, -1:] + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = np.stack([np.sin(pos_x[:, :, 0::2]), np.cos(pos_x[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[:, :, 0::2]), np.cos(pos_y[:, :, 1::2])],
                     axis=3).reshape(h, w, -1)
    pos = np.concatenate([pos_y, pos_x], axis=2)
    return pos.reshape(h * w, -1).astype(np.float32)


def window_partition_3d(x: torch.Tensor, ws) -> torch.Tensor:
    """(B, D, H, W, C) → (B, nW, N, C) in KAIR's window order (:443-457)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b, -1, ws[0] * ws[1] * ws[2], c)


def window_reverse_3d(xw: torch.Tensor, ws, d, h, w) -> torch.Tensor:
    b = xw.shape[0]
    x = xw.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, -1)


class Tmsa3dParams(NamedTuple):
    """One TMSA block's parameters in KAIR's layout (``nn.Linear`` weights
    (out, in)); the mutual fields are None for a self-only block. A plain
    MLP (RVRT's ``mlp.fc1``/``mlp.fc2``) keeps fc1 in the fc11 fields and
    None in the fc12 fields."""
    qkv_self_weight: torch.Tensor       # (3C, C)
    qkv_self_bias: Optional[torch.Tensor]
    qkv_mut_weight: Optional[torch.Tensor]
    qkv_mut_bias: Optional[torch.Tensor]
    proj_weight: torch.Tensor           # (C, 2C) mutual, (C, C) self-only
    proj_bias: torch.Tensor
    rel_table: torch.Tensor             # ((2twd−1)·15·15, nh)
    position_bias: Optional[torch.Tensor]   # (64, C) sine position, mutual
    norm1_weight: torch.Tensor
    norm1_bias: torch.Tensor
    norm2_weight: torch.Tensor
    norm2_bias: torch.Tensor
    fc11_weight: torch.Tensor           # (hidden, C); fc1 of a plain MLP
    fc11_bias: torch.Tensor
    fc12_weight: Optional[torch.Tensor]     # None: the plain MLP
    fc12_bias: Optional[torch.Tensor]
    fc2_weight: torch.Tensor            # (C, hidden)
    fc2_bias: torch.Tensor

    def float(self) -> "Tmsa3dParams":
        return Tmsa3dParams(*[None if t is None else t.float() for t in self])


def table_depth(rel_table: torch.Tensor) -> int:
    """The window depth twd of a ((2twd−1)·15·15, nh) table (8x8 windows)."""
    return (rel_table.shape[0] // 225 + 1) // 2


@functools.lru_cache(maxsize=64)
def _index_on(twd: int, n: int, device: str) -> torch.Tensor:
    with torch.inference_mode(False):
        idx = rel_position_index_3d(twd, 8, 8)[:n, :n].reshape(-1)
        return torch.as_tensor(idx, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=64)
def _mask_on(dhw, ws, ss, device: str) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(compute_mask_3d(*dhw, ws, ss)).to(device)


def _mha(q, k, v, bias, mask):
    """q, k, v (B, nW, nh, n, hd), q pre-scaled; bias (nh, n, m); mask
    (nW, n, m); softmax with the row max subtracted."""
    s = q @ k.transpose(-1, -2)
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = s + mask[None, :, None]
    return torch.softmax(s, -1) @ v


def window_attention_3d(xw: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
    """KAIR WindowAttention (:588-686) on (B, nW, N, C) windows: self
    attention with the 3-D rel-pos bias (index of the table's window,
    sliced to N), and for a mutual block the two frames' cross attention
    on x + sine position; proj of ``[mutual | self]``."""
    b, nw, n, c = xw.shape
    nh, hd = num_heads, c // num_heads
    scale = hd ** -0.5

    def qkv(inp, w, bias):
        y = F.linear(inp, w, bias).reshape(b, nw, n, 3, nh, hd)
        y = y.permute(3, 0, 1, 4, 2, 5)
        return y[0] * scale, y[1], y[2]

    idx = _index_on(table_depth(p.rel_table), n, str(xw.device))
    rel = p.rel_table[idx].reshape(n, n, nh).permute(2, 0, 1).to(xw.dtype)
    q, k, v = qkv(xw, p.qkv_self_weight, p.qkv_self_bias)
    out = _mha(q, k, v, rel, None if mask is None else mask[:, :n, :n])
    out = out.transpose(2, 3).reshape(b, nw, n, c)
    if p.qkv_mut_weight is not None:
        pos = p.position_bias.reshape(-1, c).to(xw.dtype)
        q, k, v = qkv(xw + torch.cat([pos, pos], 0), p.qkv_mut_weight,
                      p.qkv_mut_bias)
        half = n // 2
        hm = None if mask is None else mask[:, :half, :half]
        x1 = _mha(q[..., half:, :], k[..., :half, :], v[..., :half, :], None, hm)
        x2 = _mha(q[..., :half, :], k[..., half:, :], v[..., half:, :], None, hm)
        mut = torch.cat([x1, x2], 3).transpose(2, 3).reshape(b, nw, n, c)
        out = torch.cat([mut, out], -1)
    return F.linear(out, p.proj_weight, p.proj_bias)


def geglu(x: torch.Tensor, w11, b11, w12, b12, w2, b2) -> torch.Tensor:
    """KAIR Mlp_GEGLU (:560-586): fc2(GELU(fc11(x)) · fc12(x)), exact GELU;
    with ``w12`` None the plain MLP fc2(GELU(fc1(x))) (KAIR Mlp,
    ``network_rvrt.py:443-463``), fc1 in ``w11``."""
    h = F.gelu(F.linear(x, w11, b11))
    if w12 is not None:
        h = h * F.linear(x, w12, b12)
    return F.linear(h, w2, b2)


def tmsa_composed(x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                  ws: Sequence[int], ss: Sequence[int]) -> torch.Tensor:
    """One TMSA block on (B, D, H, W, C) with the (already clamped) window
    ws and shift ss, composed of PyTorch ops (KAIR TMSA.forward, :778-850;
    RVRT's STL, ``network_rvrt.py:337-358``, with a plain MLP; the JAX
    package's XLA route): pads to the window, rolls, masks, and crops back,
    so any geometry runs."""
    b, d, h, w, c = x.shape
    ws, ss = tuple(ws), tuple(ss)
    y = F.layer_norm(x, (c,), p.norm1_weight, p.norm1_bias, 1e-5)
    pad = [(ws[i] - s % ws[i]) % ws[i] for i, s in enumerate((d, h, w))]
    if any(pad):
        y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    dp, hp, wp = y.shape[1:4]
    mask = None
    if any(s > 0 for s in ss):
        y = torch.roll(y, (-ss[0], -ss[1], -ss[2]), (1, 2, 3))
        mask = _mask_on((dp, hp, wp), ws, ss, str(x.device)).to(y.dtype)
    yw = window_attention_3d(window_partition_3d(y, ws), p, num_heads, mask)
    y = window_reverse_3d(yw, ws, dp, hp, wp)
    if any(s > 0 for s in ss):
        y = torch.roll(y, ss, (1, 2, 3))
    x = x + y[:, :d, :h, :w]
    z = F.layer_norm(x, (c,), p.norm2_weight, p.norm2_bias, 1e-5)
    return x + geglu(z, p.fc11_weight, p.fc11_bias, p.fc12_weight,
                     p.fc12_bias, p.fc2_weight, p.fc2_bias)
