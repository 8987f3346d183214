"""Guided deformable attention — CUDA kernel ``kair_gda``.

``gda_fused`` replaces ``kair_tpu/ops/pallas/gda_block.py :: gda_fused``
(:206, ``pl.pallas_call`` :178) at inference: for each query pixel and head
(a head is a deformable group), bilinear samples with zeros padding of the
key and value maps at S = clip·kh·kw offset taps, the softmax over S of
q·k·scale, and the weighted sum of the values — without the (…, S, C)
sampled keys and values in device memory. The kernel is
``csrc/gda_block.cu`` (its header gives the bound on the card and the
design); ``gda_reference`` is its plain version, the composed gather route
of ``ops/deform_attn.py`` in f32, and ``gda_plan`` mirrors the kernel's
plan (``chip_smoke.py`` phase 1 holds it equal to ``kair_gda_plan``): the
channels a thread holds, the threads of an item and the tile of query
pixels a block walks.

Layouts are ``deform_attention``'s: q (B·T, H, W, C), k and v (B, clip, H,
W, C) un-rotated (query frame j pairs KV slot n with frame (n + j) % clip;
T = 1: already rotated, the JAX contract), offsets (B·T, clip, H, W,
dg·K·2) f32. A CPU tensor takes the plain version; a CUDA tensor the
kernel, or an exception. ``gda_train`` is the training route (JAX
``_gda_vjp_fwd/_bwd``, ``gda_block.py:210-224``): the kernel forward and
autograd through the composed gather route recomputed from the saved q, k,
v and offsets.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from kair_tpu_torch.ops import deform_attn
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.recompute import composed_vjp

MAX_GROUP = 32              # channels of a group: at most 32 threads an item
MAX_TAPS = 32               # clip·kh·kw
WARPS = 8                   # warps a block
TILE_W = 8                  # query pixels a tile row


class GdaPlan(NamedTuple):
    """csrc/gda_block.cu's GdaPlan, as ``kair_gda_plan`` reports it."""
    vec: int        # channels a thread: one load of 2·vec bytes a corner
    tpi: int        # threads that hold an item's channels: cg / vec
    ipw: int        # items a warp: 32 // tpi
    th: int         # a block's tile of th x tw query pixels
    tw: int
    tiles_y: int
    tiles_x: int


@lru_cache(maxsize=64)
def gda_plan(c: int, dg: int, h: int, w: int, align: int = 16) -> GdaPlan:
    """The kernel's plan at C channels, dg groups, an h x w map and bf16
    pointers aligned to ``align`` bytes: vec the widest of 8, 4, 2, 1
    channels dividing the group and the alignment, a block's WARPS·ipw
    items a tile of TILE_W columns."""
    cg = c // dg
    vec = 8
    while vec > 1 and (cg % vec or align % (2 * vec)):
        vec //= 2
    tpi = cg // vec
    ipw = 32 // tpi
    th = WARPS * ipw // TILE_W
    return GdaPlan(vec, tpi, ipw, th, TILE_W, -(-h // th), -(-w // TILE_W))


def gda_walk(pl: GdaPlan, bq: int, dg: int) -> torch.Tensor:
    """(blocks·WARPS·ipw, 4) int64 (query frame, group, y, x) of each item,
    block by block, as the kernel decodes its block and thread indices;
    y ≥ H or x ≥ W: an item past the map's edge, which stores nothing."""
    tiles = pl.tiles_y * pl.tiles_x
    blk = torch.arange(bq * dg * tiles)[:, None]
    i = torch.arange(WARPS * pl.ipw)[None, :]
    tile, bg = blk % tiles, blk // tiles
    y = tile // pl.tiles_x * pl.th + i // pl.tw
    x = tile % pl.tiles_x * pl.tw + i % pl.tw
    return torch.stack(torch.broadcast_tensors(bg // dg, bg % dg, y, x),
                       -1).reshape(-1, 4)


def gda_supported(c: int, heads: int, dg: int, kernel: Tuple[int, int],
                  clip: int) -> bool:
    """What the kernel takes: heads == groups dividing C, at most 32
    channels per group (an item's threads fit a warp) and at most 32
    taps."""
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


class GdaFunction(torch.autograd.Function):
    """``gda_fused`` forward; backward by autograd through
    ``deform_attention_gather`` recomputed from the saved q, k, v and
    offsets under the forward's autocast state. On the card q, k and v run
    in bf16 and the offsets in f32 whatever they arrive in, as at
    inference; each gradient goes back in its input's type. Nothing but
    ``ctx`` holds state, so a checkpoint's recompute may run it again."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, offset, kernel, heads, dg):
        ctx.kernel, ctx.heads, ctx.dg = tuple(kernel), heads, dg
        ctx.dtypes = (q.dtype, k.dtype, v.dtype, offset.dtype)
        if q.is_cuda:
            q, k, v = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
            offset = offset.float().contiguous()
        ctx.save_for_backward(q, k, v, offset)
        return gda_fused(q, k, v, offset, kernel, heads, dg)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        grads = composed_vjp(
            lambda q, k, v, o: deform_attn.deform_attention_gather(
                q, k, v, o, ctx.kernel, ctx.heads, ctx.dg),
            ctx.saved_tensors, ctx.needs_input_grad[:4], dy)
        return (*[None if g is None else g.to(t)
                  for g, t in zip(grads, ctx.dtypes)], None, None, None)


def gda_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              offset: torch.Tensor, kernel: Tuple[int, int] = (3, 3),
              heads: int = 12, dg: int = 12) -> torch.Tensor:
    """Differentiable ``gda_fused``: ``GdaFunction``."""
    return GdaFunction.apply(q, k, v, offset, tuple(kernel), heads, dg)
