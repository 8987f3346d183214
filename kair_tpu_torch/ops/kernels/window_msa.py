"""Host-side helpers for the fused Swin-block kernel.

Counterpart of the helpers in ``kair_tpu/ops/pallas/window_msa.py``
(``fold_ln_affine`` :87, the score-bias construction of ``make_pair_bias``
:185). The TPU packs two 64-token windows into one 128-row tile with a
block-diagonal −1e9 mask, and sets a constant-1 "rowsum lane" in v so the
PV matmul also yields the softmax denominator. Neither pays on Hopper: the
CUDA kernel gives each 8×8 window its own thread block and reduces rows
with warp shuffles, so the bias here is the plain per-window one.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch

from kair_tpu_torch.ops.window_attention import (rel_pos_bias,
                                                  relative_position_index,
                                                  shift_attn_mask)


def fold_ln_affine(weight: torch.Tensor, bias: torch.Tensor,
                   ln_scale: torch.Tensor, ln_bias: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a LayerNorm affine into the linear layer that consumes it
    (exact f32 algebra; residuals bypass the LN):
        (y·s + b) @ Wᵀ + c  =  y @ (W·s)ᵀ + (W @ b + c)
    ``weight`` is in ``nn.Linear`` layout (out, in). Inference only."""
    w32 = weight.float()
    return w32 * ln_scale.float()[None, :], w32 @ ln_bias.float() + bias.float()


def window_bias(bias_table: torch.Tensor, num_heads: int,
                ws: int = 8) -> torch.Tensor:
    """(nh, ws², ws²) f32 relative-position score bias, contiguous."""
    return rel_pos_bias(bias_table.float(), rel_index_on(ws, bias_table.device),
                        num_heads).contiguous()


def rel_index_on(ws: int, device: torch.device) -> torch.Tensor:
    """The flat (ws⁴,) relative-position index as a long tensor on
    ``device``, made once per (window, device): copying it from the host
    at every pack would be a pageable copy that waits for the card."""
    return _rel_index_on(ws, str(device))


@lru_cache(maxsize=16)
def _rel_index_on(ws: int, device: str) -> torch.Tensor:
    return torch.as_tensor(relative_position_index(ws, ws).reshape(-1),
                           dtype=torch.long, device=device)


def shift_mask_tensor(h: int, w: int, ws: int, shift: int,
                      device: torch.device) -> Optional[torch.Tensor]:
    """(nW, ws², ws²) f32 0/−100 shift mask on ``device``, or None for an
    unshifted block. Cached per geometry: it is a constant of the shape."""
    if shift == 0:
        return None
    return _mask_on(h, w, ws, shift, str(device))


@lru_cache(maxsize=32)
def _mask_on(h: int, w: int, ws: int, shift: int, device: str) -> torch.Tensor:
    return torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(device)
