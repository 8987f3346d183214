"""Windowed multi-head self-attention, composed in PyTorch.

Counterpart of ``kair_tpu/ops/window_attention.py`` (reference semantics:
KAIR ``models/network_swinir.py:65-151``). Feature maps are (B, H, W, C) and
windows (B, nW, ws*ws, C), as in the JAX package. Linear weights keep
KAIR's ``nn.Linear`` layout ``(out, in)``, because the port's modules carry
KAIR's parameters natively.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B, nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // ws) * (w // ws), ws * ws, c)


def window_reverse(xw: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B, nW, ws*ws, C) → (B, H, W, C)."""
    b, _, _, c = xw.shape
    x = xw.reshape(b, h // ws, w // ws, ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


@lru_cache(maxsize=64)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Static (Wh*Ww, Wh*Ww) index into the (2Wh-1)(2Ww-1) bias table
    (reference network_swinir.py:92-103)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


@lru_cache(maxsize=64)
def shift_window_labels(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, N) int32 per-token region labels for shifted windows
    (reference calculate_mask regions, network_swinir.py:216-239)."""
    img_mask = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, h - ws), slice(h - ws, h - shift), slice(h - shift, h)):
        for wsl in (slice(0, w - ws), slice(w - ws, w - shift),
                    slice(w - shift, w)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    mw = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(mw.reshape(-1, ws * ws))


@lru_cache(maxsize=64)
def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Static (nW, N, N) 0/-100 mask for shifted windows
    (reference calculate_mask, network_swinir.py:216-239)."""
    mw = shift_window_labels(h, w, ws, shift)
    attn_mask = mw[:, None, :] - mw[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def rel_pos_bias(bias_table: torch.Tensor, rel_index, num_heads: int
                 ) -> torch.Tensor:
    """(nh, N, N) relative-position bias gathered from the table.
    ``rel_index`` is the (N, N) index, or a long tensor of it already on
    the table's device (used as it is, no copy)."""
    idx = torch.as_tensor(rel_index, dtype=torch.long,
                          device=bias_table.device).reshape(-1)
    n = math.isqrt(idx.numel())
    return bias_table[idx].reshape(n, n, num_heads).permute(2, 0, 1)


def window_msa(xw: torch.Tensor,
               qkv_weight: torch.Tensor, qkv_bias: Optional[torch.Tensor],
               proj_weight: torch.Tensor, proj_bias: torch.Tensor,
               bias_table: torch.Tensor, rel_index, num_heads: int,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """W-MSA on windows.

    xw          (B, nW, N, C)
    qkv_weight  (3C, C)  qkv_bias (3C,) or None   (nn.Linear layout)
    proj_weight (C, C)   proj_bias (C,)
    bias_table  ((2Wh-1)(2Ww-1), nH); rel_index (N, N) int
    mask        (nW, N, N) or None
    → (B, nW, N, C)
    """
    b, nw, n, c = xw.shape
    hd = c // num_heads
    scale = hd ** -0.5
    qkv = F.linear(xw, qkv_weight.to(xw.dtype),
                   None if qkv_bias is None else qkv_bias.to(xw.dtype))
    qkv = qkv.reshape(b, nw, n, 3, num_heads, hd)
    q = qkv[:, :, :, 0].permute(0, 1, 3, 2, 4) * scale    # (b,nw,nh,n,hd)
    k = qkv[:, :, :, 1].permute(0, 1, 3, 2, 4)
    v = qkv[:, :, :, 2].permute(0, 1, 3, 2, 4)

    attn = torch.matmul(q, k.transpose(-1, -2)).float()
    attn = attn + rel_pos_bias(bias_table, rel_index, num_heads)[None, None].float()
    if mask is not None:
        attn = attn + mask[None, :, None].float()
    attn = torch.softmax(attn, dim=-1).to(xw.dtype)

    out = torch.matmul(attn, v)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, nw, n, c)
    return F.linear(out, proj_weight.to(xw.dtype), proj_bias.to(xw.dtype))
