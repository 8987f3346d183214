"""Spatial sampling: flow warping and the modulated deformable convolution.

Counterpart of ``kair_tpu/ops/warp.py`` on NHWC tensors (KAIR
``network_vrt.py:20-89, 208-264``): ``flow_warp`` (bilinear, nearest,
``nearest4``; zeros or border padding) on ``F.grid_sample`` as KAIR
computes it, ``grid_sample`` (the JAX package's NHWC ``F.grid_sample``;
no model's path calls it), and the DCNv2 ``modulated_deform_conv`` with
torchvision's semantics.

``modulated_deform_conv``'s ``impl``:
  ``"fused"``   the port's CUDA kernel (``ops/kernels/dcn_block.py``), which
                replaces the JAX package's fused Pallas kernel; on a CPU
                tensor the kernel's plain version. On a CUDA tensor a
                geometry the kernel does not take raises; the kernel has no
                counterpart of the Pallas kernel's ``MXU_MAX_HW`` limit, a
                TPU workaround, so it takes maps of any size;
  ``"gather"``  the composed route: bilinear gathers per group and tap into
                an im2col tensor, then one product with the weight (the JAX
                package's XLA gather path); it is the kernel's plain version;
  ``"auto"``    ``"fused"`` on a CUDA tensor, ``"gather"`` on a CPU one;
  ``"mxu"``     the JAX package's ``bilinear_sample_mm`` route: the samples
                come from the bilinear kernels (``ops/kernels/
                bilin_sample.py``; forward and backward, the plain versions
                on a CPU tensor), rows tap-major per (image, group), then the
                mask and one product with the weight (``torch.matmul``, as
                the JAX package leaves it to XLA).
Each run of the composed route on a CUDA tensor adds one to
``modulated_deform_conv.composed_calls``. In training (grad enabled) the
``"fused"`` route runs ``dcn_block.dcn_train``: the kernel forward and the
composed route's backward, as the JAX package's custom VJP does.

The weight is KAIR's (Cout, Cin, kh, kw); the offsets are (N, Ho, Wo,
dg·K·2) with each tap's (Δy, Δx) pair, and the mask (N, Ho, Wo, dg·K),
already passed through the sigmoid: the JAX package's layouts.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def resolve_deform_impl(impl: str, device: torch.device) -> str:
    """'auto' → 'fused' on the card (the port's kernel), 'gather' on the
    CPU; 'fused', 'gather' and 'mxu' as they are."""
    if impl == "auto":
        return "fused" if torch.device(device).type == "cuda" else "gather"
    if impl not in ("fused", "gather", "mxu"):
        raise ValueError(f"unknown deform impl {impl!r}")
    return impl


def _sample_bilinear(x: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor
                     ) -> torch.Tensor:
    """Bilinear samples of x (N, H, W, C) at float pixel coordinates fy, fx
    (N, ...) → (N, ..., C), a corner outside the map reading 0: one gather
    per corner."""
    n, h, w, c = x.shape
    shape = fy.shape
    fy, fx = fy.reshape(n, -1), fx.reshape(n, -1)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy = (fy - y0)[..., None].to(x.dtype)
    wx = (fx - x0)[..., None].to(x.dtype)
    flat = x.reshape(n, h * w, c)

    def corner(yc, xc):
        yi = yc.clamp(0, h - 1).long()
        xi = xc.clamp(0, w - 1).long()
        valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
        idx = (yi * w + xi)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx) * valid[..., None].to(x.dtype)

    out = (corner(y0, x0) * (1 - wy) * (1 - wx)
           + corner(y0, x0 + 1) * (1 - wy) * wx
           + corner(y0 + 1, x0) * wy * (1 - wx)
           + corner(y0 + 1, x0 + 1) * wy * wx)
    return out.reshape(*shape, c)


def grid_sample(x: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros",
                align_corners: bool = True) -> torch.Tensor:
    """``F.grid_sample`` on NHWC x (counterpart of the JAX package's
    ``grid_sample``, ``warp.py:128``): grid (N, Ho, Wo, 2) in [−1, 1], (x,
    y) order; mode "bilinear" or "nearest", padding "zeros" or "border"."""
    if mode not in ("bilinear", "nearest"):
        raise NotImplementedError(mode)
    y = F.grid_sample(x.permute(0, 3, 1, 2), grid.to(x.dtype), mode=mode,
                      padding_mode=padding_mode, align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def _grid_sample(x: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                 mode: str, padding_mode: str) -> torch.Tensor:
    """F.grid_sample of NHWC x at pixel coordinates (align_corners=True, as
    KAIR), computed in f32: a bf16 grid would put a 64-pixel map's samples
    up to a tenth of a pixel off."""
    h, w = x.shape[1:3]
    grid = torch.stack([2.0 * fx / max(w - 1, 1) - 1.0,
                        2.0 * fy / max(h - 1, 1) - 1.0], -1)
    y = F.grid_sample(x.float().permute(0, 3, 1, 2), grid, mode=mode,
                      padding_mode=padding_mode, align_corners=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interp_mode: str = "bilinear",
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp NHWC x by flow (N, H, W, 2) in pixels, (x, y) order, with
    F.grid_sample as KAIR does (:208-264). 'nearest4' stacks the four
    nearest corners on channels in KAIR's order (floor x, floor y),
    (floor x, ceil y), (ceil x, floor y), (ceil x, ceil y)."""
    n, h, w, _ = x.shape
    f = flow.float()
    gy, gx = torch.meshgrid(torch.arange(h, dtype=f.dtype, device=f.device),
                            torch.arange(w, dtype=f.dtype, device=f.device),
                            indexing="ij")
    vx = gx[None] + f[..., 0]
    vy = gy[None] + f[..., 1]
    if interp_mode == "nearest4":
        fl, ce = torch.floor, torch.ceil
        return torch.cat([_grid_sample(x, fy, fx, "nearest", padding_mode)
                          for fy, fx in ((fl(vy), fl(vx)), (ce(vy), fl(vx)),
                                         (fl(vy), ce(vx)), (ce(vy), ce(vx)))],
                         -1)
    if interp_mode in ("bilinear", "nearest"):
        return _grid_sample(x, vy, vx, interp_mode, padding_mode)
    raise NotImplementedError(interp_mode)


def deform_columns(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                   kh: int, kw: int, stride: int, padding: int, dilation: int,
                   dg: int) -> torch.Tensor:
    """The im2col tensor of DCNv2, (N, Ho, Wo, dg·K·cg) with columns in
    (group, tap, channel) order: each tap's bilinear sample (zeros
    padding) times its mask."""
    n, h, w, cin = x.shape
    k = kh * kw
    cg = cin // dg
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev, f = x.device, offset.dtype
    base_y = torch.arange(ho, device=dev, dtype=f) * stride - padding
    base_x = torch.arange(wo, device=dev, dtype=f) * stride - padding
    ky = (torch.arange(k, device=dev) // kw).to(f) * dilation
    kx = (torch.arange(k, device=dev) % kw).to(f) * dilation
    off = offset.reshape(n, ho, wo, dg, k, 2)
    m = mask.reshape(n, ho, wo, dg, k).to(x.dtype)
    cols = []
    for g in range(dg):
        fy = base_y[:, None, None] + ky + off[:, :, :, g, :, 0]   # (N,Ho,Wo,K)
        fx = base_x[None, :, None] + kx + off[:, :, :, g, :, 1]
        s = _sample_bilinear(x[..., g * cg:(g + 1) * cg], fy, fx)
        cols.append((s * m[:, :, :, g, :, None]).reshape(n, ho, wo, k * cg))
    return torch.cat(cols, -1)


def deform_columns_mxu(x: torch.Tensor, offset: torch.Tensor,
                       mask: torch.Tensor, kh: int, kw: int, stride: int,
                       padding: int, dilation: int, dg: int) -> torch.Tensor:
    """``deform_columns`` through the bilinear kernels (the JAX package's
    "mxu" route, ``kair_tpu/ops/warp.py:234-253``): one (N·dg, H, W, cg)
    slab per image and group, sampled at K·Ho·Wo rows ordered tap-major,
    times the mask."""
    from kair_tpu_torch.ops.kernels.bilin_sample import bilinear_sample
    n, h, w, cin = x.shape
    k = kh * kw
    cg = cin // dg
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    dev, f = x.device, torch.float32
    base_y = (torch.arange(ho, device=dev, dtype=f) * stride - padding)[:, None]
    base_x = torch.arange(wo, device=dev, dtype=f) * stride - padding
    ky = ((torch.arange(k, device=dev) // kw).to(f) * dilation)[:, None, None]
    kx = ((torch.arange(k, device=dev) % kw).to(f) * dilation)[:, None, None]
    off = offset.float().reshape(n, ho, wo, dg, k, 2).permute(0, 3, 4, 1, 2, 5)
    fy = (base_y + ky + off[..., 0]).reshape(n * dg, k * ho * wo)
    fx = (base_x + kx + off[..., 1]).reshape(n * dg, k * ho * wo)
    slabs = x.reshape(n, h, w, dg, cg).permute(0, 3, 1, 2, 4).reshape(
        n * dg, h, w, cg)
    s = bilinear_sample(slabs, fy, fx).reshape(n, dg, k, ho, wo, cg)
    m = mask.reshape(n, ho, wo, dg, k).permute(0, 3, 4, 1, 2)[..., None]
    s = s * m.to(s.dtype)
    return s.permute(0, 3, 4, 1, 2, 5).reshape(n, ho, wo, dg * k * cg)


def deform_weight_matrix(weight: torch.Tensor, dg: int) -> torch.Tensor:
    """KAIR's (Cout, Cin, kh, kw) weight as the (dg·K·cg, Cout) matrix that
    the columns of ``deform_columns`` multiply."""
    cout, cin, kh, kw = weight.shape
    w = weight.permute(2, 3, 1, 0).reshape(kh * kw, dg, cin // dg, cout)
    return w.permute(1, 0, 2, 3).reshape(-1, cout)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, stride: int = 1,
                          padding: int = 1, dilation: int = 1,
                          deformable_groups: int = 1, impl: str = "auto",
                          packed: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """DCNv2 (torchvision deform_conv2d semantics) on NHWC x (N, H, W, Cin)
    → (N, Ho, Wo, Cout). ``packed`` is the kernel's cached weight."""
    from kair_tpu_torch.ops.kernels import dcn_block
    impl = resolve_deform_impl(impl, x.device)
    dg = deformable_groups
    kh, kw = weight.shape[2:]
    if impl == "mxu":
        cols = deform_columns_mxu(x, offset, mask, kh, kw, stride, padding,
                                  dilation, dg)
        out = cols @ deform_weight_matrix(weight, dg).to(cols.dtype)
        return out if bias is None else out + bias.to(out.dtype)
    if impl == "fused":
        if dcn_block.dcn_supported(x.shape[-1], weight.shape, stride, padding,
                                   dilation, dg):
            fn = (dcn_block.dcn_train if torch.is_grad_enabled()
                  else dcn_block.dcn_fused)
            return fn(x, offset, mask, weight, bias, dg, packed)
        if x.is_cuda:
            raise ValueError(
                f"the DCN kernel does not take weight {tuple(weight.shape)} "
                f"on Cin={x.shape[-1]}, stride {stride}, padding {padding}, "
                f"dilation {dilation}, {dg} groups (it takes 3x3, stride 1, "
                f"padding 1, dilation 1, Cout <= {dcn_block.MAX_COUT}); use "
                f"impl='gather' for the composed route")
    if x.is_cuda:
        modulated_deform_conv.composed_calls += 1
    cols = deform_columns(x, offset, mask, kh, kw, stride, padding, dilation, dg)
    out = cols @ deform_weight_matrix(weight, dg).to(cols.dtype)
    return out if bias is None else out + bias.to(out.dtype)


modulated_deform_conv.composed_calls = 0
