"""Guided deformable attention — CUDA kernel ``kair_gda``.

``gda_fused`` replaces ``kair_tpu/ops/pallas/gda_block.py :: gda_fused``
(:206, ``pl.pallas_call`` :178) at inference: for each query pixel and head
(a head is a deformable group), bilinear samples with zeros padding of the
key and value maps at S = clip·kh·kw offset taps, the softmax over S of
q·k·scale, and the weighted sum of the values — without the (…, S, C)
sampled keys and values in device memory. The kernel is
``csrc/gda_block.cu`` (its header gives the bound on the card and the
design); ``gda_reference`` is its plain version, the composed gather route
of ``ops/deform_attn.py`` in f32.

Layouts are ``deform_attention``'s: q (B·T, H, W, C), k and v (B, clip, H,
W, C) un-rotated (query frame j pairs KV slot n with frame (n + j) % clip;
T = 1: already rotated, the JAX contract), offsets (B·T, clip, H, W,
dg·K·2) f32. A CPU tensor takes the plain version; a CUDA tensor the
kernel, or an exception.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kair_tpu_torch.ops import deform_attn
from kair_tpu_torch.ops.kernels import _build

MAX_GROUP = 32              # channels of a group: one lane each
MAX_TAPS = 32               # clip·kh·kw: one tap's coordinates per lane


def gda_supported(c: int, heads: int, dg: int, kernel: Tuple[int, int],
                  clip: int) -> bool:
    """What the kernel takes: heads == groups dividing C, at most 32
    channels per group and at most 32 taps."""
    return (heads == dg and dg >= 1 and c % dg == 0 and c // dg <= MAX_GROUP
            and clip * kernel[0] * kernel[1] <= MAX_TAPS)


def gda_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  offset: torch.Tensor, kernel: Tuple[int, int], heads: int,
                  dg: int) -> torch.Tensor:
    """Plain version of the kernel: the composed gather route in f32 from
    the given inputs; returns ``q.dtype``."""
    return deform_attn.deform_attention_gather(
        q.float(), k.float(), v.float(), offset.float(), kernel, heads,
        dg).to(q.dtype)


def _check(q, k, v, offset, kernel, heads, dg) -> None:
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gda kernel takes bfloat16 q, k, v, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 5:
        raise ValueError("gda expects q (B·T, H, W, C) and k, v "
                         "(B, clip, H, W, C)")
    bq, h, w, c = q.shape
    b, clip = k.shape[:2]
    if not gda_supported(c, heads, dg, kernel, clip):
        raise ValueError(f"gda kernel does not take C={c}, {heads} heads, "
                         f"{dg} groups, kernel {tuple(kernel)}, clip {clip}")
    if bq % b or tuple(k.shape) != (b, clip, h, w, c) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not "
                         "pair: q's batch must be a multiple of the clips'")
    want = (bq, clip, h, w, dg * kernel[0] * kernel[1] * 2)
    if (tuple(offset.shape) != want or offset.dtype != torch.float32
            or offset.device != q.device):
        raise ValueError(f"offset must be an f32 {want} tensor on {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, offset)):
        raise ValueError("gda kernel takes contiguous tensors")


def gda_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              offset: torch.Tensor, kernel: Tuple[int, int] = (3, 3),
              heads: int = 12, dg: int = 12) -> torch.Tensor:
    """Fused GDA → (B·T, H, W, C).

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16 q, k, v,
    f32 offsets), or an exception. A launch adds one to ``launches``."""
    if q.device.type == "cpu":
        return gda_reference(q, k, v, offset, kernel, heads, dg)
    _check(q, k, v, offset, kernel, heads, dg)
    bq, h, w, c = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.kair_gda(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           offset.data_ptr(), out.data_ptr(), bq,
                           bq // k.shape[0], k.shape[1], h, w, c, dg,
                           kernel[0], kernel[1],
                           torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "gda_fused")
    gda_fused.launches += 1
    return out


gda_fused.launches = 0
