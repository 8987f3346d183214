"""Fused 3x3 conv + bias + residual with the cyclic un-roll — CUDA kernel 2.

Replaces ``kair_tpu/ops/pallas/conv_block.py :: conv3x3_residual`` (TPU
body ``_kernel`` :49): the SwinIR RSTB tail and ``conv_after_body``,

    out = conv3x3_SAME(roll(y, (phase, phase))) + bias + res     (NHWC)

The kernel is ``csrc/conv_block.cu`` (its header gives the bound on the
card and what the design does about it); ``conv3x3_residual_reference`` is
its plain PyTorch version. The weight keeps KAIR's ``nn.Conv2d`` layout
(C_out, C_in, 3, 3).

``conv3x3_residual`` launches the kernel for a CUDA tensor and uses the
plain version only for a CPU tensor; a tensor the kernel does not take
raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from kair_tpu_torch.ops.kernels import _build


def pack_conv3x3(weight: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(C, C, 3, 3) OIHW → (9, CP, CP) [tap][c_in][c_out], zero-padded; the
    kernel takes bf16 (f32 keeps it exact for checking the layout)."""
    c = weight.shape[0]
    cp = _build.round16(c)
    w = torch.zeros(9, cp, cp, device=weight.device, dtype=torch.float32)
    w[:, :c, :c] = weight.float().permute(2, 3, 1, 0).reshape(9, c, c)
    return w.to(dtype).contiguous()


def conv3x3_residual_reference(y: torch.Tensor, res: torch.Tensor,
                               weight: torch.Tensor, bias: torch.Tensor,
                               phase: int = 0) -> torch.Tensor:
    """Plain version in f32: torch.roll → F.conv2d (SAME) → +bias → +res.
    Returns ``y.dtype``."""
    x = y.float()
    if phase:
        x = torch.roll(x, (phase, phase), (1, 2))
    out = F.conv2d(x.permute(0, 3, 1, 2), weight.float(), bias.float(),
                   padding=1).permute(0, 2, 3, 1)
    return (out + res.float()).to(y.dtype)


def _check_cuda_args(y, res, weight, bias):
    if y.dtype != torch.bfloat16 or res.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_residual kernel takes bfloat16, got "
                        f"{y.dtype}/{res.dtype}")
    if y.dim() != 4 or y.shape != res.shape:
        raise ValueError("conv3x3_residual expects y and res of one "
                         "(B, H, W, C) shape")
    if not (y.is_contiguous() and res.is_contiguous()):
        raise ValueError("conv3x3_residual expects contiguous tensors")
    if res.device != y.device:
        raise ValueError("y and res must be on one device")
    c = y.shape[-1]
    if c % 2:
        raise ValueError(f"conv3x3_residual needs an even C, got {c}")
    if tuple(weight.shape) != (c, c, 3, 3) or tuple(bias.shape) != (c,):
        raise ValueError(f"conv3x3_residual needs a ({c}, {c}, 3, 3) weight "
                         f"and ({c},) bias, got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")


def conv3x3_residual(y: torch.Tensor, res: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, phase: int = 0,
                     packed_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """out = conv3x3_SAME(roll(y, (phase, phase))) + bias + res, NHWC.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16 only),
    or an exception; ``packed_weight`` is the cached ``pack_conv3x3``."""
    if y.device.type == "cpu":
        return conv3x3_residual_reference(y, res, weight, bias, phase)
    _check_cuda_args(y, res, weight, bias)
    b, h, w, c = y.shape
    wpk = packed_weight if packed_weight is not None else pack_conv3x3(weight)
    cp = _build.round16(c)
    if (wpk.dtype != torch.bfloat16 or tuple(wpk.shape) != (9, cp, cp)
            or wpk.device != y.device or not wpk.is_contiguous()):
        raise ValueError(f"packed weight must be a contiguous bf16 (9, {cp}, "
                         f"{cp}) tensor on {y.device}")
    bias32 = bias.float().contiguous()
    lib = _build.library()
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        err = lib.kair_conv3x3_residual(
            y.data_ptr(), res.data_ptr(), wpk.data_ptr(), bias32.data_ptr(),
            out.data_ptr(), b, h, w, c, int(phase),
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "conv3x3_residual")
    conv3x3_residual.launches += 1
    return out


conv3x3_residual.launches = 0
