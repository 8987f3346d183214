"""Bilinear sampling with zeros padding — CUDA kernels ``kair_bilin_fwd`` and
``kair_bilin_bwd``.

``bilinear_sample`` replaces ``kair_tpu/ops/pallas/bilin_mm.py ::
bilinear_sample_mm`` (``pl.pallas_call`` :197) and its custom-VJP backward
(``_bwd_kernel``, ``pl.pallas_call`` :312): feat (G, H, W, Cs) sampled at
f32 pixel coordinates fy, fx (G, R) → (G, R, Cs) in feat's type, a corner
outside the frame reading 0. It is the ``deform_impl`` "mxu" sampler of
``ops/warp.modulated_deform_conv`` and ``ops/deform_attn.deform_attention``.
The kernels are ``csrc/bilin_sample.cu`` (its header gives the bound on the
card and the design): a direct gather, for frames of any size, in vectors
of ``vector_bytes`` with 32-bit pixel indices (G·H·W < 2^31,
``MAX_PIXELS``). The backward gathers dfeat: a row pass (dfy, dfx, and
each row counted in the windows of dfeat its corners touch,
``bwd_tiles``), a scan of the counts into list offsets and a fill pass
(each row's index appended to its windows' lists), then a window pass (a
thread block per window links its rows' corners into per-pixel lists in
shared memory, sums each pixel's list into its tile and writes its window
once, in feat's type); no float atomic, no zero-fill, no cast. A row enters
at most four lists, so its scratch (``bwd_scratch_bytes``) is 16 bytes a
row and 12 a window: 57 MB at VRT-001's stage-1 call at batch 8, linear in
the frame. The TPU kernel's 2-hot
matmuls, lane padding and ``MXU_MAX_HW`` gate are TPU workarounds and have
no counterpart here.

The backward follows the Pallas kernel's rule (``bilin_mm.py:217-281``):
the derivative of the hat weight max(1 − |i − c|, 0) is sign(i − c) on its
open support, so at an exactly integer coordinate dfy (dfx) is 0, where
autograd of the floor form would give feat[y0 + 1] − feat[y0].
``bilinear_reference`` and ``bilinear_bwd_reference`` are the plain
versions (f32 arithmetic, that rule written out, not autograd). A CPU
tensor takes them; a CUDA tensor the kernels, or an exception.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels._build import SMEM_LIMIT


def _corners(feat: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor):
    """The four corners of every row in f32: their values (G, R, Cs) each,
    with 0 outside the frame, their flat pixel indices and validity (G, R),
    and the fractions ty, tx."""
    g, h, w, cs = feat.shape
    flat = feat.float().reshape(g, h * w, cs)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    ty, tx = fy - y0, fx - x0
    # clamp before the conversion, as the kernel does
    y0 = y0.clamp(-2, h).long()
    x0 = x0.clamp(-2, w).long()
    out = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yc, xc = y0 + dy, x0 + dx
        valid = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        idx = torch.where(valid, yc * w + xc, torch.zeros_like(yc))
        v = torch.gather(flat, 1, idx[..., None].expand(-1, -1, cs))
        out.append((v * valid[..., None], idx, valid))
    return out, ty, tx


def bilinear_reference(feat: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor
                       ) -> torch.Tensor:
    """Plain version of the forward kernel, in f32; returns feat's type."""
    with torch.autocast(feat.device.type, enabled=False):
        (c00, c01, c10, c11), ty, tx = _corners(feat, fy.float(), fx.float())
        ty, tx = ty[..., None], tx[..., None]
        out = ((1 - ty) * ((1 - tx) * c00[0] + tx * c01[0])
               + ty * ((1 - tx) * c10[0] + tx * c11[0]))
        return out.to(feat.dtype)


def bilinear_bwd_reference(feat: torch.Tensor, fy: torch.Tensor,
                           fx: torch.Tensor, dout: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel, in f32: (dfeat in feat's type,
    dfy, dfx in f32), the hat's derivative 0 at an exact integer."""
    with torch.autocast(feat.device.type, enabled=False):
        g, h, w, cs = feat.shape
        fy, fx = fy.float(), fx.float()
        (c00, c01, c10, c11), ty, tx = _corners(feat, fy, fx)
        go = dout.float()
        wy, wx = (1 - ty, ty), (1 - tx, tx)
        dfeat = torch.zeros(g, h * w, cs, device=feat.device)
        for (v, idx, valid), i, j in ((c00, 0, 0), (c01, 0, 1), (c10, 1, 0),
                                      (c11, 1, 1)):
            wt = (wy[i] * wx[j] * valid)[..., None]
            dfeat.scatter_add_(1, idx[..., None].expand(-1, -1, cs), wt * go)
        sy = (ty > 0).float()[..., None]
        sx = (tx > 0).float()[..., None]
        wy0, wy1 = wy[0][..., None], wy[1][..., None]
        wx0, wx1 = wx[0][..., None], wx[1][..., None]
        dfy = (go * sy * (wx0 * (c10[0] - c00[0]) + wx1 * (c11[0] - c01[0]))).sum(-1)
        dfx = (go * sx * (wy0 * (c01[0] - c00[0]) + wy1 * (c11[0] - c10[0]))).sum(-1)
        return dfeat.reshape(g, h, w, cs).to(feat.dtype), dfy, dfx


def _check(feat, fy, fx, dout=None) -> None:
    if feat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bilinear kernels take f32 or bf16 feat, got "
                        f"{feat.dtype}")
    if feat.dim() != 4:
        raise ValueError("bilinear kernels take feat (G, H, W, Cs)")
    g = feat.shape[0]
    for name, t in (("fy", fy), ("fx", fx)):
        if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != g
                or t.shape != fy.shape or t.device != feat.device):
            raise ValueError(f"{name} must be an f32 (G, R) tensor on "
                             f"{feat.device} with G = {g}")
    if dout is not None and (dout.dtype != feat.dtype or tuple(dout.shape) != (
            g, fy.shape[1], feat.shape[3]) or dout.device != feat.device):
        raise ValueError(f"dout must be a {feat.dtype} (G, R, Cs) tensor")
    if not all(t.is_contiguous() for t in (feat, fy, fx)
               + (() if dout is None else (dout,))):
        raise ValueError("bilinear kernels take contiguous tensors")


# the forward's corner pixel index, slab folded in, is a 32-bit int; the
# backward keeps the same limit
MAX_PIXELS = 2 ** 31
BWD_TILE_BYTES = 32 * 1024   # a backward window's f32 tile and list heads
BWD_STAGE_BYTES = 24 * 1024  # its chunk's dout stage
BWD_BLOCKS = 528             # backward windows enough for four on each of 132 SMs
BWD_CHUNK = 512              # rows the backward links per pass (kChunk)
BWD_MAX_WINDOWS = 24576      # windows a slab (kMaxWindows: the fill pass's histogram)


def vector_bytes(cs: int, elem_bytes: int, *ptrs: int) -> int:
    """Bytes the kernels move per load and store: the widest power
    of two up to 16 that divides a pixel's bytes (Cs · elem_bytes) and the
    pointers, at least one element (16 at Cs=48 bf16, 4 at Cs=10 bf16, 2 at
    Cs=3 bf16)."""
    vb = 16
    while vb > elem_bytes and ((cs * elem_bytes) % vb
                               or any(p % vb for p in ptrs)):
        vb //= 2
    return vb


def bilinear_fwd(feat: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor
                 ) -> torch.Tensor:
    """Samples (G, R, Cs) in feat's type. CPU tensor → the plain version;
    CUDA tensor → the forward kernel (f32 or bf16 feat, f32 coordinates,
    G·H·W < ``MAX_PIXELS``), or an exception. A launch adds one to
    ``launches``."""
    if feat.device.type == "cpu":
        return bilinear_reference(feat, fy, fx)
    _check(feat, fy, fx)
    _check_pixels(feat, "forward")
    g, h, w, cs = feat.shape
    r = fy.shape[1]
    out = torch.empty(g, r, cs, dtype=feat.dtype, device=feat.device)
    vec = vector_bytes(cs, feat.element_size(), feat.data_ptr(),
                       out.data_ptr())
    lib = _build.library()
    with torch.cuda.device(feat.device):
        err = lib.kair_bilin_fwd(
            feat.data_ptr(), fy.data_ptr(), fx.data_ptr(), out.data_ptr(),
            g, h, w, cs, r, int(feat.dtype == torch.bfloat16), vec,
            torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(err, "bilinear_fwd")
    bilinear_fwd.launches += 1
    return out


def _check_pixels(feat: torch.Tensor, what: str) -> None:
    g, h, w, _ = feat.shape
    if g * h * w >= MAX_PIXELS:
        raise ValueError(f"bilinear {what} kernel takes G*H*W < 2^31 pixels, "
                         f"got {g * h * w}")


def bwd_tiles(g: int, h: int, w: int, cs: int, n: int, es: int
              ) -> Tuple[int, int, int]:
    """(th, tw, tc): the backward block's window of a slab's dfeat, pixel
    rows x columns x channels. A pixel takes 4·(tc | 1) bytes of f32 tile
    and 8 of list heads, within ``BWD_TILE_BYTES`` for the window; a chunk's
    dout stage, ``BWD_CHUNK`` rows of tc channels of ``es`` bytes, within
    ``BWD_STAGE_BYTES``; tc a multiple of ``n``, the channels of a vector.
    Whole pixels and whole pixel rows first; then, while the G slabs'
    windows are fewer than ``BWD_BLOCKS``, more windows of fewer rows."""
    tc = cs
    if 4 * (cs | 1) + 8 > BWD_TILE_BYTES or BWD_CHUNK * cs * es > BWD_STAGE_BYTES:
        tc = min((BWD_TILE_BYTES - 12) // 4,
                 BWD_STAGE_BYTES // (BWD_CHUNK * es)) // n * n
    bpp = 4 * (tc | 1) + 8
    tw = w if w * bpp <= BWD_TILE_BYTES else BWD_TILE_BYTES // bpp
    tw = max(tw, -(-w // BWD_MAX_WINDOWS))
    th = min(h, max(1, BWD_TILE_BYTES // (tw * bpp)))
    nwx = -(-w // tw)
    nwy = -(-h // th)
    if g > 0:
        nwy = min(h, max(nwy, -(-BWD_BLOCKS // (g * nwx * -(-cs // tc)))))
    # at most BWD_MAX_WINDOWS windows a slab: a huge frame takes larger tiles
    nwy = min(nwy, max(1, BWD_MAX_WINDOWS // nwx))
    return -(-h // nwy), tw, tc


def bwd_shared_bytes(th: int, tw: int, tc: int, es: int) -> int:
    """Shared memory of a block of the backward's second pass
    (BwdTiles::smem_bytes in csrc/bilin_sample.cu): the chunk's dout stage,
    a weight and a link for each of its corners, two list heads a pixel, the
    f32 tile."""
    return (BWD_CHUNK * tc * es + 8 * 4 * BWD_CHUNK + 8 * th * tw
            + 4 * th * tw * (tc | 1))


def bwd_scratch_bytes(g: int, h: int, w: int, r: int, th: int, tw: int) -> int:
    """The backward's scratch (kair_bilin_bwd_scratch_bytes): each window's
    row count (int), then, 16-byte aligned, its list's start (64-bit), then
    a slab's lists, 4 R int entries: a row enters at most four windows."""
    windows = g * -(-h // th) * -(-w // tw)
    return -(-4 * windows // 16) * 16 + 8 * windows + 16 * g * r


def bilinear_bwd(feat: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                 dout: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dfeat in feat's type, dfy, dfx in f32). CPU tensor → the plain
    version; CUDA tensor → the backward kernel (G·H·W < ``MAX_PIXELS``), or
    an exception. The kernel gathers dfeat in f32 in shared memory and
    writes every element of it, in feat's type. A launch adds one to
    ``launches``."""
    if feat.device.type == "cpu":
        return bilinear_bwd_reference(feat, fy, fx, dout)
    _check(feat, fy, fx, dout)
    _check_pixels(feat, "backward")
    g, h, w, cs = feat.shape
    r = fy.shape[1]
    dfeat = torch.empty_like(feat)
    dfy = torch.empty(g, r, device=feat.device)
    dfx = torch.empty(g, r, device=feat.device)
    es = feat.element_size()
    vec = vector_bytes(cs, es, feat.data_ptr(), dout.data_ptr(),
                       dfeat.data_ptr())
    th, tw, tc = bwd_tiles(g, h, w, cs, vec // es, es)
    if bwd_shared_bytes(th, tw, tc, es) > SMEM_LIMIT:
        raise ValueError(f"bilinear backward: a {h}x{w} frame of {cs} channels "
                         f"needs more than {SMEM_LIMIT} bytes of shared memory "
                         "a window")
    scratch = torch.empty(bwd_scratch_bytes(g, h, w, r, th, tw),
                          dtype=torch.uint8, device=feat.device)
    lib = _build.library()
    with torch.cuda.device(feat.device):
        err = lib.kair_bilin_bwd(
            feat.data_ptr(), fy.data_ptr(), fx.data_ptr(), dout.data_ptr(),
            dfeat.data_ptr(), dfy.data_ptr(), dfx.data_ptr(),
            scratch.data_ptr(), g, h, w, cs, r,
            int(feat.dtype == torch.bfloat16), vec, th, tw, tc,
            torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(err, "bilinear_bwd")
    bilinear_bwd.launches += 1
    return dfeat, dfy, dfx


bilinear_fwd.launches = 0
bilinear_bwd.launches = 0


class BilinearSampleFunction(torch.autograd.Function):
    """``bilinear_fwd`` forward, ``bilinear_bwd`` backward; feat, fy and fx
    are saved. On a CUDA tensor both are the kernels."""

    @staticmethod
    def forward(ctx, feat, fy, fx):
        feat, fy, fx = feat.contiguous(), fy.contiguous(), fx.contiguous()
        ctx.save_for_backward(feat, fy, fx)
        return bilinear_fwd(feat, fy, fx)

    @staticmethod
    def backward(ctx, dout):
        feat, fy, fx = ctx.saved_tensors
        dfeat, dfy, dfx = bilinear_bwd(feat, fy, fx,
                                       dout.to(feat.dtype).contiguous())
        return dfeat, dfy.to(fy.dtype), dfx.to(fx.dtype)


def bilinear_sample(feat: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor
                    ) -> torch.Tensor:
    """Differentiable bilinear sampling of feat (G, H, W, Cs) at f32 pixel
    coordinates fy, fx (G, R) → (G, R, Cs), zeros padding."""
    return BilinearSampleFunction.apply(feat, fy.float(), fx.float())
