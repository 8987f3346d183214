"""Modulated deformable 3x3 convolution (DCNv2) — CUDA kernel ``kair_dcn``.

``dcn_fused`` replaces ``kair_tpu/ops/pallas/dcn_block.py :: dcn_fused``
(:167, ``pl.pallas_call`` :140, wrapper ``_dcn_fused_fwd`` :91) at
inference: bilinear sampling with zeros padding at per-group, per-tap
offsets, times the modulation mask, then the product with the conv weight,
plus the bias — without an im2col tensor in device memory. The kernel is
``csrc/dcn_block.cu`` (its header gives the bound on the card and the
design); ``dcn_reference`` is its plain version, the composed gather route
of ``ops/warp.py`` in f32.

Layouts are the JAX package's: x (N, H, W, Cin), offsets (N, H, W,
dg·9·2) with (Δy, Δx) per tap, mask (N, H, W, dg·9) after the sigmoid;
the weight is KAIR's (Cout, Cin, 3, 3). A CPU tensor takes the plain
version; a CUDA tensor the kernel, or an exception.

``dcn_train`` is the training route (JAX ``dcn_block.py:166-190``): the
kernel forward, and a backward that is autograd through the composed gather
route recomputed from the saved x, offsets, mask, weight and bias. The JAX
package has no backward kernel for this block: its backward is XLA code,
whose counterpart here is that autograd.
"""

from __future__ import annotations

from typing import Optional

import torch

from kair_tpu_torch.ops import warp
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.recompute import composed_vjp

ROWS = 32                   # output pixels per thread block
MAX_COUT = 256              # 8 warps x 2 column tiles of 16


def dcn_supported(cin: int, weight_shape, stride: int, padding: int,
                  dilation: int, dg: int) -> bool:
    """What the kernel takes: a 3x3 conv with stride 1, padding 1,
    dilation 1, Cin divisible by the groups and Cout ≤ 256."""
    cout, wcin, kh, kw = weight_shape
    return ((kh, kw, stride, padding, dilation) == (3, 3, 1, 1, 1)
            and wcin == cin and cin % dg == 0 and 1 <= cout <= MAX_COUT)


def pack_dcn_weight(weight: torch.Tensor, dg: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(Cout, Cin, 3, 3) → the kernel's [KP][CP] matrix: row (g·9 + k)·cg + c
    (group, tap, channel), column o, zero-padded to multiples of 16."""
    with torch.autocast(weight.device.type, enabled=False):
        wm = warp.deform_weight_matrix(weight.float(), dg)
        kc, cout = wm.shape
        out = torch.zeros(_build.round16(kc), _build.round16(cout),
                          device=weight.device)
        out[:kc, :cout] = wm
        return out.to(dtype).contiguous()


def dcn_reference(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor],
                  dg: int) -> torch.Tensor:
    """Plain version of the kernel: the composed gather route in f32 from
    the given inputs; returns ``x.dtype``."""
    cols = warp.deform_columns(x.float(), offset.float(), mask.float(), 3, 3,
                               1, 1, 1, dg)
    out = cols @ warp.deform_weight_matrix(weight.float(), dg)
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def _check(x, offset, mask, weight, bias, dg) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dcn kernel takes a bfloat16 input, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("dcn expects a contiguous (N, H, W, Cin) input")
    n, h, w, cin = x.shape
    if not dcn_supported(cin, tuple(weight.shape), 1, 1, 1, dg):
        raise ValueError(f"dcn kernel does not take weight "
                         f"{tuple(weight.shape)} with Cin={cin}, {dg} groups")
    for name, t, ch in (("offset", offset, dg * 18), ("mask", mask, dg * 9)):
        if (tuple(t.shape) != (n, h, w, ch) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous f32 ({n}, {h}, {w}, "
                             f"{ch}) tensor on {x.device}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (weight.shape[0],)):
        raise ValueError("bias must be f32 of shape (Cout,)")


def dcn_fused(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
              weight: torch.Tensor, bias: Optional[torch.Tensor], dg: int,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DCNv2 3x3 (stride 1, padding 1) on NHWC x → (N, H, W, Cout).

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16 x, f32
    offsets, mask and bias), or an exception; ``packed`` is the cached
    ``pack_dcn_weight(weight, dg)``. A launch adds one to ``launches``."""
    if x.device.type == "cpu":
        return dcn_reference(x, offset, mask, weight, bias, dg)
    cout = weight.shape[0]
    b = (torch.zeros(cout, device=x.device) if bias is None
         else bias.float().contiguous())
    _check(x, offset, mask, weight, b, dg)
    pk = packed if packed is not None else pack_dcn_weight(weight, dg)
    if pk.dtype != torch.bfloat16 or pk.device != x.device:
        raise ValueError("packed weight must be bf16 on the input's device")
    n, h, w, cin = x.shape
    out = torch.empty(n, h, w, cout, dtype=x.dtype, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.kair_dcn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                           pk.data_ptr(), b.data_ptr(), out.data_ptr(),
                           n, h, w, cin, cout, dg,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dcn_fused")
    dcn_fused.launches += 1
    return out


dcn_fused.launches = 0


class DcnFunction(torch.autograd.Function):
    """``dcn_fused`` forward; backward by autograd through the composed
    route (``warp.deform_columns`` and the weight product) recomputed
    from the saved inputs, under the forward's autocast state. On the card
    x runs in bf16 whatever it arrives in, and dx goes back in x's type."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, offset, mask, weight, bias, dg, packed):
        ctx.dg, ctx.x_dtype = dg, x.dtype
        xin = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
        ctx.save_for_backward(xin, offset, mask, weight, bias)
        return dcn_fused(xin, offset, mask, weight, bias, dg, packed)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        def composed(x, offset, mask, weight, bias):
            cols = warp.deform_columns(x, offset, mask, 3, 3, 1, 1, 1, ctx.dg)
            out = cols @ warp.deform_weight_matrix(weight, ctx.dg).to(cols.dtype)
            return out if bias is None else out + bias.to(out.dtype)

        dx, *rest = composed_vjp(composed, ctx.saved_tensors,
                                 ctx.needs_input_grad[:5], dy)
        return (None if dx is None else dx.to(ctx.x_dtype), *rest, None, None)


def dcn_train(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
              weight: torch.Tensor, bias: Optional[torch.Tensor], dg: int,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable ``dcn_fused``: ``DcnFunction``."""
    return DcnFunction.apply(x, offset, mask, weight, bias, dg, packed)
