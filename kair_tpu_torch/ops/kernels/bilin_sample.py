"""Bilinear sampling with zeros padding — CUDA kernels ``kair_bilin_fwd`` and
``kair_bilin_bwd``.

``bilinear_sample`` replaces ``kair_tpu/ops/pallas/bilin_mm.py ::
bilinear_sample_mm`` (``pl.pallas_call`` :197) and its custom-VJP backward
(``_bwd_kernel``, ``pl.pallas_call`` :312): feat (G, H, W, Cs) sampled at
f32 pixel coordinates fy, fx (G, R) → (G, R, Cs) in feat's type, a corner
outside the frame reading 0. It is the ``deform_impl`` "mxu" sampler of
``ops/warp.modulated_deform_conv`` and ``ops/deform_attn.deform_attention``.
The kernels are ``csrc/bilin_sample.cu`` (its header gives the bound on the
card and the design): a direct gather, for frames of any size; the TPU
kernel's 2-hot matmuls, lane padding and ``MXU_MAX_HW`` gate are TPU
workarounds and have no counterpart here.

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


def bilinear_fwd(feat: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor
                 ) -> torch.Tensor:
    """Samples (G, R, Cs) in feat's type. CPU tensor → the plain version;
    CUDA tensor → the forward kernel (f32 or bf16 feat, f32 coordinates),
    or an exception. A launch adds one to ``launches``."""
    if feat.device.type == "cpu":
        return bilinear_reference(feat, fy, fx)
    _check(feat, fy, fx)
    g, h, w, cs = feat.shape
    r = fy.shape[1]
    out = torch.empty(g, r, cs, dtype=feat.dtype, device=feat.device)
    lib = _build.library()
    with torch.cuda.device(feat.device):
        err = lib.kair_bilin_fwd(
            feat.data_ptr(), fy.data_ptr(), fx.data_ptr(), out.data_ptr(),
            g, h, w, cs, r, int(feat.dtype == torch.bfloat16),
            torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(err, "bilinear_fwd")
    bilinear_fwd.launches += 1
    return out


def bilinear_bwd(feat: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                 dout: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dfeat in feat's type, dfy, dfx in f32). CPU tensor → the plain
    version; CUDA tensor → the backward kernel, or an exception. dfeat is
    summed in f32 with atomics, then cast. A launch adds one to
    ``launches``."""
    if feat.device.type == "cpu":
        return bilinear_bwd_reference(feat, fy, fx, dout)
    _check(feat, fy, fx, dout)
    g, h, w, cs = feat.shape
    r = fy.shape[1]
    dfeat = torch.zeros(g, h, w, cs, device=feat.device)
    dfy = torch.empty(g, r, device=feat.device)
    dfx = torch.empty(g, r, device=feat.device)
    lib = _build.library()
    with torch.cuda.device(feat.device):
        err = lib.kair_bilin_bwd(
            feat.data_ptr(), fy.data_ptr(), fx.data_ptr(), dout.data_ptr(),
            dfeat.data_ptr(), dfy.data_ptr(), dfx.data_ptr(), g, h, w, cs, r,
            int(feat.dtype == torch.bfloat16),
            torch.cuda.current_stream(feat.device).cuda_stream)
    _build.check(err, "bilinear_bwd")
    bilinear_bwd.launches += 1
    return dfeat.to(feat.dtype), dfy, dfx


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
