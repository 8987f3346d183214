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

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from kair_tpu_torch.ops.kernels import _build


# The kernel's tiling (csrc/conv_block.cu, ConvPlan): output channels in
# chunks of NT in {64, 128, 184}, input channels in chunks of 64 (one
# 128-byte swizzle row), a ring of RING weight stages, two halo buffers of
# 8 x 34 pixels x HALO_LD bf16 and, with one N chunk, three warpgroups'
# staging buffers of 64 pixels x C bf16.
KC = 64
RING = 3
HALO_PIX, HALO_LD = 8 * 34, KC + 8
SMEM_LIMIT = 232448


def conv_plan(c: int) -> Tuple[int, int, int]:
    """(NT, N chunks, K chunks) at C channels: C > 184 takes several N chunks
    of the narrowest NT that holds an equal share."""
    n_chunks = -(-c // 184)
    per = -(-c // n_chunks)
    nt = 64 if per <= 64 else 128 if per <= 128 else 184
    return nt, n_chunks, -(-c // KC)


def stage_bytes(c: int) -> int:
    """Bytes of one weight stage: NT rows of 64 bf16."""
    return conv_plan(c)[0] * KC * 2


def shared_bytes(c: int) -> int:
    """Dynamic shared memory of one thread block: the weight ring, two halo
    buffers, the epilogue's staging (one N chunk only), 2 * RING + 4
    mbarriers, the halo source rows and columns, and 1024 B of slack to
    align the swizzled stages."""
    staging = 3 * 64 * c * 2 if conv_plan(c)[1] == 1 else 0
    return (RING * stage_bytes(c) + 2 * HALO_PIX * HALO_LD * 2 + staging
            + (2 * RING + 4) * 8 + (8 + 34) * 4 + 1024)


def _swizzle_cols(nt: int) -> torch.Tensor:
    """(nt, 64) column of element (n, k) in a stage row: its 16-byte unit
    k // 8 XOR n % 8 (wgmma's 128-byte swizzle)."""
    n = torch.arange(nt)[:, None]
    k = torch.arange(KC)[None, :]
    return ((k // 8) ^ (n % 8)) * 8 + k % 8


def pack_conv3x3(weight: torch.Tensor,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(C, C, 3, 3) OIHW → the kernel's weight stages, (N chunks · K chunks
    · 9, NT, 64): stage (nc, kc, tap) holds W[nc·NT + n, kc·64 + k, tap] in
    row n (K-major), each row's 16-byte units swizzled, zero past C. The
    kernel takes bf16 (f32 keeps it exact for checking the layout)."""
    c = weight.shape[0]
    nt, ncs, kcs = conv_plan(c)
    w = torch.zeros(ncs * nt, kcs * KC, 9, device=weight.device,
                    dtype=torch.float32)
    w[:c, :c] = weight.float().reshape(c, c, 9)
    w = w.reshape(ncs, nt, kcs, KC, 9).permute(0, 2, 4, 1, 3)
    idx = _swizzle_cols(nt).to(weight.device).expand(w.shape)
    packed = torch.zeros_like(w).scatter_(-1, idx, w)
    return packed.reshape(ncs * kcs * 9, nt, KC).to(dtype).contiguous()


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


def _check_alignment(y, res, wpk, bias32) -> None:
    """The kernel's copies need aligned operands (a misaligned one faults on
    the card): the packed weight's bulk copies 16 bytes, y's halo copies 8
    when C % 4 == 0 (else 4), res's bf16 pairs 4, the f32 bias pairs 8. Its
    pixel offsets are 32-bit: B·H·W < 2^31."""
    b, h, w, c = y.shape
    for name, t, align in (("packed weight", wpk, 16),
                           ("y", y, 8 if c % 4 == 0 else 4), ("res", res, 4),
                           ("bias", bias32, 8)):
        if t.data_ptr() % align:
            raise ValueError(f"conv3x3_residual needs {name} aligned to "
                             f"{align} bytes")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"conv3x3_residual takes B*H*W < 2^31 pixels, got "
                         f"{b * h * w}")


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
    c = y.shape[-1]
    wpk = packed_weight if packed_weight is not None else pack_conv3x3(weight)
    nt, ncs, kcs = conv_plan(c)
    if (wpk.dtype != torch.bfloat16 or tuple(wpk.shape) != (ncs * kcs * 9, nt, KC)
            or wpk.device != y.device or not wpk.is_contiguous()):
        raise ValueError(f"packed weight must be a contiguous bf16 "
                         f"({ncs * kcs * 9}, {nt}, {KC}) tensor on {y.device}")
    bias32 = bias.float().contiguous()
    _check_alignment(y, res, wpk, bias32)
    out = torch.empty_like(y)
    _launch(_build.library(), y, res, wpk, bias32, out, phase)
    conv3x3_residual.launches += 1
    return out


def _launch(lib, y, res, wpk, bias32, out, phase: int) -> None:
    """One launch of ``kair_conv3x3_residual`` from ``lib`` (the library or
    its profile build) on checked operands."""
    b, h, w, c = y.shape
    with torch.cuda.device(y.device):
        err = lib.kair_conv3x3_residual(
            y.data_ptr(), res.data_ptr(), wpk.data_ptr(), bias32.data_ptr(),
            out.data_ptr(), b, h, w, c, int(phase),
            torch.cuda.current_stream(y.device).cuda_stream)
    _build.check(err, "conv3x3_residual")


conv3x3_residual.launches = 0
