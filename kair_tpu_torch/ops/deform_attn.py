"""Guided deformable attention, RVRT's alignment (counterpart of
``kair_tpu/ops/deform_attn.py``; KAIR ``deform_attn_cuda_pt110.cpp:64-120``).

For each query pixel and head, S = clip·kh·kw deformable samples of the key
and value maps — per deformable group, bilinear samples (zeros padding) of
the KV frames at the pixel + kernel tap − pad + offset — then softmax
attention of the one query over its S keys.

``deform_attention``'s ``impl``:
  ``"fused"``   the port's CUDA kernel (``ops/kernels/gda_block.py``), which
                replaces the JAX package's fused Pallas kernel; it needs
                heads == deformable groups (every released RVRT). On a CPU
                tensor the kernel's plain version; on a CUDA tensor a
                geometry the kernel does not take raises;
  ``"gather"``  the composed route: the samples gathered into (…, S, C)
                keys and values, then the attention (the JAX package's XLA
                gather path); it is the kernel's plain version;
  ``"auto"``    on a CUDA tensor the kernel where heads == groups, else the
                gather route, as the JAX package routes it (:73-82); the
                gather route on a CPU tensor;
  ``"mxu"``     the JAX package's ``bilinear_sample_mm`` route (:83-99):
                per (batch, clip frame, group) one slab holding that group's
                k and v channels side by side, sampled at K·H·W rows by the
                bilinear kernels (``ops/kernels/bilin_sample.py``; the plain
                versions on a CPU tensor), then the attention.
Each run of the composed route on a CUDA tensor adds one to
``deform_attention.composed_calls``.

Layouts are the JAX package's, with one addition: q may hold several
query frames for one KV clip. q is (B·T, H, W, C), k and v (B, clip, H, W,
C), offsets (B·T, clip, H, W, dg·K·2) with (Δy, Δx) per (group, tap); query
frame j of batch b pairs KV slot n with frame (n + j) % clip of batch b
(KAIR's order). T = 1 is the JAX contract: k and v already rotated for
each query.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kair_tpu_torch.ops.warp import _sample_bilinear


def rotate_kv(kv: torch.Tensor, frames: int) -> torch.Tensor:
    """(B, clip, H, W, C) → (B·frames, clip, H, W, C): for query frame j,
    slot n holds frame (n + j) % clip."""
    b, clip = kv.shape[:2]
    idx = torch.tensor([[(n + j) % clip for n in range(clip)]
                        for j in range(frames)], device=kv.device)
    return kv[:, idx].reshape(b * frames, clip, *kv.shape[2:])


def _attend(q: torch.Tensor, k_s: torch.Tensor, v_s: torch.Tensor,
            heads: int) -> torch.Tensor:
    """Per-pixel attention of q (B, H, W, C) over its S samples k_s, v_s
    (B, H, W, S, C): softmax in f32, in the inputs' type otherwise."""
    b, h, w, c = q.shape
    s, hd = k_s.shape[3], c // heads
    qh = q.reshape(b, h, w, heads, 1, hd) * hd ** -0.5
    kh_ = k_s.reshape(b, h, w, s, heads, hd).transpose(3, 4)  # (B,H,W,nh,S,hd)
    vh_ = v_s.reshape(b, h, w, s, heads, hd).transpose(3, 4)
    attn = torch.softmax((qh @ kh_.transpose(-1, -2)).float(), -1).to(q.dtype)
    return (attn @ vh_).reshape(b, h, w, c)


def _tap_offsets(kernel, dev):
    kh, kw = kernel
    taps = torch.arange(kh * kw, device=dev)
    return ((taps // kw - kh // 2).float(), (taps % kw - kw // 2).float())


def deform_attention_mxu(q: torch.Tensor, k_feat: torch.Tensor,
                         v_feat: torch.Tensor, offset: torch.Tensor,
                         kernel: Tuple[int, int], heads: int, dg: int
                         ) -> torch.Tensor:
    """The "mxu" route: k and v of a group sampled together by the bilinear
    kernels from one (B·clip·dg, H, W, 2·cg) slab per KV frame and group,
    rows tap-major, then the attention."""
    from kair_tpu_torch.ops.kernels.bilin_sample import bilinear_sample
    frames = q.shape[0] // k_feat.shape[0]
    if frames > 1:
        k_feat, v_feat = rotate_kv(k_feat, frames), rotate_kv(v_feat, frames)
    b, h, w, c = q.shape
    clip = k_feat.shape[1]
    K = kernel[0] * kernel[1]
    cg = c // dg
    both = torch.cat([k_feat.reshape(b, clip, h, w, dg, cg),
                      v_feat.reshape(b, clip, h, w, dg, cg)], -1)
    slabs = both.permute(0, 1, 4, 2, 3, 5).reshape(b * clip * dg, h, w, 2 * cg)
    ky, kx = _tap_offsets(kernel, q.device)
    off = offset.float().reshape(b, clip, h, w, dg, K, 2).permute(
        0, 1, 4, 5, 2, 3, 6)                                 # (B,n,g,K,H,W,2)
    gy = torch.arange(h, device=q.device, dtype=torch.float32)[:, None]
    gx = torch.arange(w, device=q.device, dtype=torch.float32)
    fy = (gy + ky[:, None, None] + off[..., 0]).reshape(b * clip * dg, -1)
    fx = (gx + kx[:, None, None] + off[..., 1]).reshape(b * clip * dg, -1)
    s = bilinear_sample(slabs, fy, fx).reshape(b, clip, dg, K, h, w, 2 * cg)
    s = s.permute(0, 4, 5, 1, 3, 2, 6)                       # (B,H,W,n,K,g,·)
    k_s = s[..., :cg].reshape(b, h, w, clip * K, c)
    v_s = s[..., cg:].reshape(b, h, w, clip * K, c)
    return _attend(q, k_s, v_s, heads)


def deform_attention_gather(q: torch.Tensor, k_feat: torch.Tensor,
                            v_feat: torch.Tensor, offset: torch.Tensor,
                            kernel: Tuple[int, int], heads: int, dg: int
                            ) -> torch.Tensor:
    """The composed route (the JAX package's gather path, :114-143), in the
    inputs' type: per clip frame and group, the K taps' bilinear samples of
    [k | v], the (B, H, W, S, C) keys and values ordered clip-major then
    tap, then the per-pixel attention."""
    frames = q.shape[0] // k_feat.shape[0]
    if frames > 1:
        k_feat, v_feat = rotate_kv(k_feat, frames), rotate_kv(v_feat, frames)
    b, h, w, c = q.shape
    clip = k_feat.shape[1]
    K = kernel[0] * kernel[1]
    cg = c // dg
    dev, f = q.device, offset.dtype
    gy = torch.arange(h, device=dev, dtype=f)[:, None, None]
    gx = torch.arange(w, device=dev, dtype=f)[None, :, None]
    ky, kx = (t.to(f) for t in _tap_offsets(kernel, dev))
    off = offset.reshape(b, clip, h, w, dg, K, 2)
    k_parts, v_parts = [], []
    for n in range(clip):
        both = torch.cat([k_feat[:, n].reshape(b, h, w, dg, cg),
                          v_feat[:, n].reshape(b, h, w, dg, cg)], -1)
        ks, vs = [], []
        for g in range(dg):
            fy = gy + ky + off[:, n, :, :, g, :, 0]          # (B, H, W, K)
            fx = gx + kx + off[:, n, :, :, g, :, 1]
            s = _sample_bilinear(both[..., g, :].contiguous(), fy, fx)
            ks.append(s[..., :cg])                           # (B, H, W, K, cg)
            vs.append(s[..., cg:])
        k_parts.append(torch.cat(ks, -1))                    # (B, H, W, K, C)
        v_parts.append(torch.cat(vs, -1))
    k_s = torch.cat(k_parts, 3)                              # (B, H, W, S, C)
    v_s = torch.cat(v_parts, 3)
    return _attend(q, k_s, v_s, heads)


def deform_attention(q: torch.Tensor, k_feat: torch.Tensor,
                     v_feat: torch.Tensor, offset: torch.Tensor,
                     kernel: Tuple[int, int] = (3, 3), heads: int = 12,
                     deformable_groups: int = 12, impl: str = "gather"
                     ) -> torch.Tensor:
    """GDA on q (B·T, H, W, C), k/v (B, clip, H, W, C), offsets (B·T, clip,
    H, W, dg·K·2) → (B·T, H, W, C); ``impl`` as the module note says."""
    from kair_tpu_torch.ops.kernels import gda_block
    dg = deformable_groups
    if impl == "mxu":
        return deform_attention_mxu(q, k_feat, v_feat, offset, kernel, heads,
                                    dg)
    if impl not in ("auto", "fused", "gather"):
        raise ValueError(f"unknown deform impl {impl!r}")
    supported = gda_block.gda_supported(q.shape[-1], heads, dg, kernel,
                                        k_feat.shape[1])
    if impl == "fused" or (impl == "auto" and q.is_cuda and supported):
        if q.is_cuda and torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k_feat, v_feat, offset)):
            raise NotImplementedError(
                "the GDA kernel has no backward (RVRT training is a later "
                "slice of the port); use deform_impl 'mxu' or 'gather' to "
                "train")
        if supported or not q.is_cuda:
            return gda_block.gda_fused(q, k_feat, v_feat, offset, kernel,
                                       heads, dg)
        raise ValueError(
            f"the GDA kernel does not take C={q.shape[-1]}, {heads} heads, "
            f"{dg} groups, kernel {tuple(kernel)}, clip {k_feat.shape[1]} (it "
            f"takes heads == groups of at most 32 channels and clip·kh·kw "
            f"<= 32 taps); use impl='gather' for the composed route")
    if q.is_cuda:
        deform_attention.composed_calls += 1
    return deform_attention_gather(q, k_feat, v_feat, offset, kernel, heads,
                                   dg)


deform_attention.composed_calls = 0
