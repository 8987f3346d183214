"""Modulated deformable 3x3 convolution (DCNv2) — CUDA kernel ``kair_dcn``.

``dcn_fused`` replaces ``kair_tpu/ops/pallas/dcn_block.py :: dcn_fused``
(:167, ``pl.pallas_call`` :140, wrapper ``_dcn_fused_fwd`` :91) at
inference: bilinear sampling with zeros padding at per-group, per-tap
offsets, times the modulation mask, then the product with the conv weight,
plus the bias — without an im2col tensor in device memory. The kernel is
``csrc/dcn_block.cu``: an implicit GEMM on wgmma over 64-pixel tiles, the
columns sampled a chunk (a group's taps and channels) at a time into
shared memory, the weight streamed as bulk-copied stages, the chunks of a
tile split over several blocks when the map is small (its header gives
the bound on the card and the design). ``dcn_plan`` mirrors its layout,
``dcn_splits`` and ``dcn_walk`` its grid, ``pack_dcn_weight`` writes its
weight stages; ``dcn_reference`` is its plain version, the composed gather
route of ``ops/warp.py`` in f32.

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

from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import torch

from kair_tpu_torch.ops import warp
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.recompute import composed_vjp

ROWS = 64                   # output pixels a tile: the M of one wgmma
KMAX = 96                   # columns of a chunk at most
LD = KMAX + 8               # the A tile's row, bf16
RING = 2                    # weight stages in shared memory
MAX_COUT = 256              # four output column tiles of 64


def dcn_supported(cin: int, weight_shape, stride: int, padding: int,
                  dilation: int, dg: int) -> bool:
    """What the kernel takes: a 3x3 conv with stride 1, padding 1,
    dilation 1, Cin divisible by the groups and Cout ≤ 256."""
    cout, wcin, kh, kw = weight_shape
    return ((kh, kw, stride, padding, dilation) == (3, 3, 1, 1, 1)
            and wcin == cin and cin % dg == 0 and 1 <= cout <= MAX_COUT)


class Chunk(NamedTuple):
    """Columns of one K chunk of a group: taps t0 .. t0 + ntap − 1 at
    channels c0 .. c0 + csz − 1 (tap-major), padded to kw."""
    c0: int
    csz: int
    t0: int
    ntap: int
    kw: int


class DcnPlan(NamedTuple):
    """csrc/dcn_block.cu's DcnPlan, as ``kair_dcn_plan`` reports it."""
    cs: int             # channels of a channel block (the whole group if ≤ 96)
    tpc: int            # taps a chunk
    cpg: int            # chunks a group
    kmax: int           # columns of the widest chunk
    np: int             # output columns, padded to tiles of 64
    group_elems: int    # elements of a group's stages
    stage_bytes: int    # bytes of a ring slot
    smem: int           # dynamic shared memory of a block


def _chunks(cg: int) -> Tuple[int, int, int]:
    """(cs, tpc, taps chunks) of a group of cg channels."""
    nb = -(-cg // KMAX)
    cs = -(-cg // nb)
    tpc = min(9, KMAX // cs)
    return cs, tpc, -(-9 // tpc)


@lru_cache(maxsize=64)
def dcn_chunks(cin: int, dg: int) -> Tuple[Chunk, ...]:
    """A group's K chunks in the kernel's order: channel blocks, then tap
    runs; all nine taps and all cg channels in one chunk when 9·cg ≤ 96."""
    cg = cin // dg
    cs, tpc, ntc = _chunks(cg)
    out = []
    for c0 in range(0, cg, cs):
        csz = min(cs, cg - c0)
        for t0 in range(0, 9, tpc):
            ntap = min(tpc, 9 - t0)
            out.append(Chunk(c0, csz, t0, ntap, _build.round16(ntap * csz)))
    assert len(out) == -(-cg // cs) * ntc
    return tuple(out)


@lru_cache(maxsize=64)
def dcn_plan(cin: int, cout: int, dg: int) -> DcnPlan:
    """The kernel's chunking and shared memory: a ring of RING stages (or
    the bf16 output tile, whichever is larger), the 64-row A tile, the tap
    table (an int4 of corners, a float4 of weights and a column an entry),
    the ring's barriers, 1024 bytes of alignment slack."""
    a1024 = lambda v: -(-v // 1024) * 1024
    cs, tpc, _ = _chunks(cin // dg)
    chunks = dcn_chunks(cin, dg)
    np_ = 64 * -(-cout // 64)
    kmax = _build.round16(tpc * cs)
    stage = kmax * np_ * 2
    smem = (a1024(max(RING * stage, ROWS * np_ * 2)) + a1024(ROWS * LD * 2)
            + ROWS * 9 * 36 + RING * 8 + 1024)
    return DcnPlan(cs, tpc, len(chunks), kmax, np_,
                   sum(c.kw for c in chunks) * np_, stage, smem)


@lru_cache(maxsize=256)
def dcn_splits(n: int, h: int, w: int, cin: int, dg: int, sms: int = 132
               ) -> Tuple[int, int]:
    """(tiles, splits) of a call: 64-pixel tiles of each image, and the
    number of blocks each tile's chunks are split over, so that a map with
    fewer tiles than the card has SMs still covers the card, each split
    taking the same number of chunks (the last may take fewer)."""
    tiles = n * -(-(h * w) // ROWS)
    q = dg * len(dcn_chunks(cin, dg))
    need = -(-sms // max(tiles, 1))
    if need >= q:
        return tiles, q
    per = -(-q // need)
    return tiles, -(-q // per)


def dcn_walk(n: int, h: int, w: int, cin: int, dg: int, sms: int = 132
             ) -> List[Tuple[int, int, range]]:
    """Each block's (tile, split, chunks over all groups), as the kernel
    decodes its block index; chunk q is group q // cpg's chunk q % cpg."""
    tiles, splits = dcn_splits(n, h, w, cin, dg, sms)
    q = dg * len(dcn_chunks(cin, dg))
    return [(b // splits, b % splits,
             range(b % splits * q // splits, (b % splits + 1) * q // splits))
            for b in range(tiles * splits)]


def pack_dcn_weight(weight: torch.Tensor, dg: int,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(Cout, Cin, 3, 3) → the kernel's weight stages, flat: per group and
    chunk, kw / 16 slices of NP rows (output channels) × 16 K values (the
    chunk's (tap, channel) rows of ``deform_weight_matrix``), each row's two
    16-byte units swapped on rows 4-7 of every 8 (wgmma's 32-byte swizzle),
    zero past Cout and past the chunk's columns. One gather through an
    index cached per geometry: a training model packs anew after every
    optimizer step. ``dtype=torch.float32`` keeps the stages exact for
    checking."""
    cout, cin = weight.shape[:2]
    with torch.autocast(weight.device.type, enabled=False):
        wm = warp.deform_weight_matrix(weight.float(), dg)
        idx = _pack_index(cin, cout, dg, str(weight.device))
        flat = torch.cat([wm.reshape(-1), wm.new_zeros(1)])
        return flat[idx].to(dtype).contiguous()


def stage_layout(rows: torch.Tensor, np_: int) -> torch.Tensor:
    """(kw, NP) B[k, n] → a stage: (kw/16, NP, 16) slices, swizzled."""
    kw = rows.shape[0]
    st = rows.t().reshape(np_, kw // 16, 16).transpose(0, 1)
    n = torch.arange(np_, device=rows.device)[:, None]
    k = torch.arange(16, device=rows.device)[None, :]
    pos = ((k // 8) ^ ((n >> 2) & 1)) * 8 + k % 8
    return torch.empty_like(st).scatter_(-1, pos.expand(st.shape), st)


def unstage(st: torch.Tensor, kw: int, np_: int) -> torch.Tensor:
    """The inverse of ``stage_layout`` on a flat stage: (kw, NP) B[k, n]."""
    st = st.reshape(kw // 16, np_, 16)
    n = torch.arange(np_, device=st.device)[:, None]
    k = torch.arange(16, device=st.device)[None, :]
    pos = ((k // 8) ^ ((n >> 2) & 1)) * 8 + k % 8
    return torch.gather(st, -1, pos.expand(st.shape)).transpose(0, 1).reshape(
        np_, kw).t()


@lru_cache(maxsize=32)
def _pack_index(cin: int, cout: int, dg: int, device: str) -> torch.Tensor:
    """Where each stage element comes from in ``deform_weight_matrix``'s
    flat (9·Cin, Cout) matrix; its size for the zero padding."""
    with torch.inference_mode(False):
        cg, np_ = cin // dg, dcn_plan(cin, cout, dg).np
        total = 9 * cin * cout
        o = torch.arange(np_)
        parts = []
        for g in range(dg):
            for ck in dcn_chunks(cin, dg):
                t = torch.arange(ck.t0, ck.t0 + ck.ntap)[:, None]
                c = torch.arange(ck.c0, ck.c0 + ck.csz)[None, :]
                row = ((g * 9 + t) * cg + c).reshape(-1)
                row = torch.cat([row, torch.full((ck.kw - row.numel(),), -1)])
                src = row[:, None] * cout + o[None, :]
                src[(row[:, None] < 0) | (o[None, :] >= cout)] = total
                parts.append(stage_layout(src, np_).reshape(-1))
        return torch.cat(parts).to(device)


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
    if n * h * w >= 2 ** 31 or h * w * cin >= 2 ** 31:
        raise ValueError("dcn kernel takes fewer than 2^31 pixels, and "
                         "fewer than 2^31 elements an image")
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


@lru_cache(maxsize=8)
def _sm_count(index: Optional[int]) -> int:
    """The card's SMs (cached: asked once per device)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_packed(pk: torch.Tensor, x: torch.Tensor, pl: DcnPlan,
                  dg: int) -> None:
    """The stages bf16, contiguous, of the plan's size and 16-byte aligned
    (the bulk copies' rule), on x's device."""
    if (pk.dtype != torch.bfloat16 or pk.device != x.device
            or not pk.is_contiguous() or pk.numel() != dg * pl.group_elems
            or pk.data_ptr() % 16):
        raise ValueError("packed weight must be pack_dcn_weight's contiguous, "
                         "16-byte aligned bf16 stages on the input's device")


def _launch(lib, x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            pk: torch.Tensor, bias: torch.Tensor, dg: int, splits: int
            ) -> torch.Tensor:
    """``kair_dcn`` from ``lib`` on checked operands (the profile build's
    library in ``cli/profile_dcn.py``); the partials are scratch of this
    call."""
    n, h, w, cin = x.shape
    cout = bias.shape[0]
    out = torch.empty(n, h, w, cout, dtype=x.dtype, device=x.device)
    part = (torch.empty(splits, n * h * w, cout, device=x.device)
            if splits > 1 else None)
    with torch.cuda.device(x.device):
        err = lib.kair_dcn(x.data_ptr(), offset.data_ptr(), mask.data_ptr(),
                           pk.data_ptr(), bias.data_ptr(), out.data_ptr(),
                           None if part is None else part.data_ptr(),
                           n, h, w, cin, cout, dg, splits,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "dcn_fused")
    return out


def dcn_fused(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
              weight: torch.Tensor, bias: Optional[torch.Tensor], dg: int,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DCNv2 3x3 (stride 1, padding 1) on NHWC x → (N, H, W, Cout).

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16 x, f32
    offsets, mask and bias), or an exception; ``packed`` is the cached
    ``pack_dcn_weight(weight, dg)``. A map with fewer tiles than the card
    has SMs splits each tile's chunks over blocks (``dcn_splits``): f32
    partials in scratch of this call, summed in split order by a second
    kernel. A call adds one to ``launches``."""
    if x.device.type == "cpu":
        return dcn_reference(x, offset, mask, weight, bias, dg)
    cout = weight.shape[0]
    b = (torch.zeros(cout, device=x.device) if bias is None
         else bias.float().contiguous())
    _check(x, offset, mask, weight, b, dg)
    n, h, w, cin = x.shape
    pl = dcn_plan(cin, cout, dg)
    pk = packed if packed is not None else pack_dcn_weight(weight, dg)
    _check_packed(pk, x, pl, dg)
    _, splits = dcn_splits(n, h, w, cin, dg, _sm_count(x.device.index))
    out = _launch(_build.library(), x, offset, mask, pk, b, dg, splits)
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
