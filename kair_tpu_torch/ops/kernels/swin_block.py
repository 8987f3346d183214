"""Fused Swin-transformer block on the (B, H, W, C) map — CUDA kernel 1.

Replaces ``kair_tpu/ops/pallas/swin_block.py :: swin_block_pallas_2d``
(TPU body ``_kernel_2d`` :174 + ``_block_body`` :68) at inference:

    out = Block(roll(x, (−phase, −phase)))   written in the block's own
                                              (rolled) coordinates

where Block is the windowed Swin block, ws=8: LN1 → W-MSA (rel-pos bias,
0/−100 shift mask for shifted blocks) → +x → LN2 → fc1 → exact GELU → fc2
→ +x. The kernel is ``csrc/swin_block.cu`` (its header gives the bound on
the card and what the design does about it); ``swin_block_2d_reference``
below is its plain PyTorch version.

``swin_block_2d`` launches the kernel for a CUDA tensor and uses the plain
version only for a CPU tensor. It never falls back: a tensor the kernel
does not take raises.

Training adds CUDA kernel 3, ``swin_block_2d_bwd``: the block's backward
with the forward recomputed, replacing ``_fused_2d_bwd_pallas`` (TPU body
``_kernel_2d_bwd`` :219), in ``csrc/swin_block_bwd.cu``; its plain version
is ``swin_block_2d_bwd_reference``. ``SwinBlockFunction`` ties the two
kernels into one autograd node at phase 0, as ``_fused_2d`` (:490) does
with its custom VJP: it saves only the block input and the parameters.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels.window_msa import (fold_ln_affine,
                                                   rel_index_on, window_bias)
from kair_tpu_torch.ops.window_attention import (relative_position_index,
                                                  window_msa,
                                                  window_partition,
                                                  window_reverse)

WS = 8                      # the kernel's window: 8x8 = 64 tokens
HD_MAX = 32                 # head dim is zero-padded to 32 in the kernel


class SwinBlockParams(NamedTuple):
    """One block's parameters in KAIR's ``nn.Linear`` layout (out, in)."""
    qkv_weight: torch.Tensor        # (3C, C)
    qkv_bias: Optional[torch.Tensor]
    proj_weight: torch.Tensor       # (C, C)
    proj_bias: torch.Tensor
    rel_table: torch.Tensor         # ((2ws-1)², nh)
    norm1_weight: torch.Tensor
    norm1_bias: torch.Tensor
    norm2_weight: torch.Tensor
    norm2_bias: torch.Tensor
    fc1_weight: torch.Tensor        # (hidden, C)
    fc1_bias: torch.Tensor
    fc2_weight: torch.Tensor        # (C, hidden)
    fc2_bias: torch.Tensor


class SwinBlockPack(NamedTuple):
    """Kernel operands (see the layout note in csrc/swin_block.cu)."""
    wqkv: torch.Tensor      # (CP, nh*96) bf16, LN1 affine + q scale folded
                            # (folded=True)
    bqkv: torch.Tensor      # (nh*96,) f32
    wp: torch.Tensor        # (nh*32, CP) bf16
    bp: torch.Tensor        # (C,) f32
    w1: torch.Tensor        # (CP, HP) bf16, LN2 affine folded (folded=True)
    b1: torch.Tensor        # (HP,) f32
    w2: torch.Tensor        # (HP, CP) bf16
    b2: torch.Tensor        # (C,) f32
    relbias: torch.Tensor   # (nh, 64, 64) f32
    hp: int


def pack_swin_block(p: SwinBlockParams, num_heads: int,
                    dtype: torch.dtype = torch.bfloat16,
                    folded: bool = True) -> SwinBlockPack:
    """Relayout, fold and cast one block's parameters for the kernel (once
    per set of weights; the model caches the result). The kernel takes
    bf16 matrices; ``dtype=torch.float32`` keeps them exact for checking
    the layout against the plain version. ``folded=False`` is the backward
    kernel's pack: the same layout with the q scale and the LN affines
    left out (the backward applies them itself, so the weight grads come
    out for the raw parameters). Runs with autocast off: the folds are f32
    algebra."""
    with torch.autocast(p.qkv_weight.device.type, enabled=False):
        return _pack(p, num_heads, dtype, folded)


def _pack(p: SwinBlockParams, num_heads: int, dtype: torch.dtype,
          folded: bool) -> SwinBlockPack:
    c = p.qkv_weight.shape[1]
    nh = num_heads
    hd = c // nh
    cp = _build.round16(c)
    hidden = p.fc1_weight.shape[0]
    hp = _build.round16(hidden)
    dev = p.qkv_weight.device
    f32 = torch.float32

    qkv_b = (p.qkv_bias if p.qkv_bias is not None
             else torch.zeros(3 * c, device=dev))
    if folded:
        w, b = fold_ln_affine(p.qkv_weight, qkv_b, p.norm1_weight,
                              p.norm1_bias)
    else:
        w, b = p.qkv_weight.float(), qkv_b.float()
    wt = w.t().reshape(c, 3, nh, hd).clone()        # columns [q | k | v] x heads
    b = b.reshape(3, nh, hd).clone()
    if folded:
        wt[:, 0] *= hd ** -0.5
        b[0] *= hd ** -0.5
    wqkv = torch.zeros(cp, nh, 3, HD_MAX, device=dev, dtype=f32)
    wqkv[:c, :, :, :hd] = wt.permute(0, 2, 1, 3)
    bqkv = torch.zeros(nh, 3, HD_MAX, device=dev, dtype=f32)
    bqkv[:, :, :hd] = b.permute(1, 0, 2)

    wp = torch.zeros(nh, HD_MAX, cp, device=dev, dtype=f32)
    wp[:, :hd, :c] = p.proj_weight.float().t().reshape(nh, hd, c)

    if folded:
        w1f, b1f = fold_ln_affine(p.fc1_weight, p.fc1_bias, p.norm2_weight,
                                  p.norm2_bias)
    else:
        w1f, b1f = p.fc1_weight.float(), p.fc1_bias.float()
    w1 = torch.zeros(cp, hp, device=dev, dtype=f32)
    w1[:c, :hidden] = w1f.t()
    b1 = torch.zeros(hp, device=dev, dtype=f32)
    b1[:hidden] = b1f
    w2 = torch.zeros(hp, cp, device=dev, dtype=f32)
    w2[:hidden, :c] = p.fc2_weight.float().t()

    return SwinBlockPack(
        wqkv=wqkv.reshape(cp, nh * 3 * HD_MAX).to(dtype).contiguous(),
        bqkv=bqkv.reshape(-1).contiguous(),
        wp=wp.reshape(nh * HD_MAX, cp).to(dtype).contiguous(),
        bp=p.proj_bias.float().contiguous(),
        w1=w1.to(dtype).contiguous(), b1=b1,
        w2=w2.to(dtype).contiguous(),
        b2=p.fc2_bias.float().contiguous(),
        relbias=window_bias(p.rel_table, nh, WS),
        hp=hp)


def swin_block_2d_reference(x: torch.Tensor, p: SwinBlockParams,
                            num_heads: int, mask: Optional[torch.Tensor] = None,
                            phase: int = 0, window: int = WS) -> torch.Tensor:
    """Plain PyTorch version of the kernel, computed in f32 from the given
    inputs (counterpart of ``_reference_2d`` :468 / ``_reference_block_tokens``
    :415): roll, window partition, LN1, W-MSA with max-subtracted softmax,
    residual, LN2, exact-GELU MLP, residual, window reverse. Returns
    ``x.dtype``. ``window`` other than 8 is the model's composed route for
    geometries the kernel does not take."""
    f = x.float()
    if phase:
        f = torch.roll(f, (-phase, -phase), (1, 2))
    b, h, w, c = f.shape
    y = F.layer_norm(f, (c,), p.norm1_weight.float(), p.norm1_bias.float(), 1e-5)
    a = window_msa(window_partition(y, window), p.qkv_weight.float(),
                   None if p.qkv_bias is None else p.qkv_bias.float(),
                   p.proj_weight.float(), p.proj_bias.float(),
                   p.rel_table.float(), relative_position_index(window, window),
                   num_heads, None if mask is None else mask.float())
    x1 = f + window_reverse(a, window, h, w)
    z = F.layer_norm(x1, (c,), p.norm2_weight.float(), p.norm2_bias.float(), 1e-5)
    z = F.gelu(F.linear(z, p.fc1_weight.float(), p.fc1_bias.float()))
    return (x1 + F.linear(z, p.fc2_weight.float(), p.fc2_bias.float())).to(x.dtype)


def _check_cuda_args(x, p, num_heads, mask):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"swin_block_2d kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("swin_block_2d expects a contiguous (B, H, W, C) tensor")
    b, h, w, c = x.shape
    if h % WS or w % WS:
        raise ValueError(f"swin_block_2d needs H and W multiples of {WS}, "
                         f"got {h}x{w}")
    if c % 2 or c % num_heads or c // num_heads > HD_MAX:
        raise ValueError(f"swin_block_2d needs an even C divisible by the "
                         f"heads with head dim <= {HD_MAX} (C={c}, "
                         f"heads={num_heads})")
    if tuple(p.qkv_weight.shape) != (3 * c, c):
        raise ValueError(f"qkv weight {tuple(p.qkv_weight.shape)} does not "
                         f"match C={c}")
    if p.rel_table.shape != ((2 * WS - 1) ** 2, num_heads):
        raise ValueError("relative position table must be for an 8x8 window")
    if mask is not None:
        nw = (h // WS) * (w // WS)
        if (tuple(mask.shape) != (nw, WS * WS, WS * WS)
                or mask.dtype != torch.float32 or not mask.is_contiguous()
                or mask.device != x.device):
            raise ValueError(f"mask must be a contiguous f32 ({nw}, 64, 64) "
                             f"tensor on {x.device}")


def swin_block_2d(x: torch.Tensor, p: SwinBlockParams, num_heads: int,
                  mask: Optional[torch.Tensor] = None, phase: int = 0,
                  packed: Optional[SwinBlockPack] = None) -> torch.Tensor:
    """Fused inference Swin block on (B, H, W, C), window 8.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16 only),
    or an exception; ``packed`` is the cached ``pack_swin_block(p, nh)``."""
    if x.device.type == "cpu":
        return swin_block_2d_reference(x, p, num_heads, mask, phase)
    _check_cuda_args(x, p, num_heads, mask)
    pk = packed if packed is not None else pack_swin_block(p, num_heads)
    if pk.wqkv.dtype != torch.bfloat16 or pk.wqkv.device != x.device:
        raise ValueError("packed weights must be bf16 on the input's device")
    out = torch.empty_like(x)
    _launch(_build.library(), x, out, pk, num_heads, mask, phase)
    swin_block_2d.launches += 1
    return out


def _launch(lib, x: torch.Tensor, out: torch.Tensor, pk: SwinBlockPack,
            num_heads: int, mask: Optional[torch.Tensor], phase: int) -> None:
    """One launch of the kernel in ``lib`` on checked arguments; raises on a
    CUDA error (oversized shared memory included)."""
    b, h, w, c = x.shape
    with torch.cuda.device(x.device):
        err = lib.kair_swin_block_2d(
            x.data_ptr(), out.data_ptr(), pk.wqkv.data_ptr(),
            pk.bqkv.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.w1.data_ptr(), pk.b1.data_ptr(), pk.w2.data_ptr(),
            pk.b2.data_ptr(), pk.relbias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            b, h, w, c, num_heads, pk.hp, int(phase),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "swin_block_2d")


swin_block_2d.launches = 0


# ---------------------------------------------------------------------------
# Backward (training): CUDA kernel 3 and its plain version
# ---------------------------------------------------------------------------

class BwdLayout(NamedTuple):
    """Row widths of the backward kernel's stored operands (the layout note
    in csrc/swin_block_bwd.cu). A 1 in column C of the LN1-out, attention-
    out and LN2-out rows and in column ``hidden`` of the GELU-out rows makes
    each weight product also give its bias grad."""
    cp: int     # round16(C): dx1 and dy rows
    hp: int     # round16(hidden): dpre rows
    k1: int     # round16(C + 1): LN1 out, attention out, LN2 out
    kg: int     # round16(hidden + 1): GELU out
    n3: int     # round16(3C): dqkv, KAIR order [q | k | v] x heads

    def products(self) -> List[Tuple[int, int]]:
        """(rows, cols) of the four weight products, in the kernel's order:
        qkv, proj, fc1, fc2 (each the (in [+1], out) transpose of KAIR's
        weight, the bias grad in row ``in``)."""
        return [(self.k1, self.n3), (self.k1, self.cp), (self.k1, self.hp),
                (self.kg, self.cp)]


def bwd_layout(c: int, hidden: int) -> BwdLayout:
    r = _build.round16
    return BwdLayout(cp=r(c), hp=r(hidden), k1=r(c + 1), kg=r(hidden + 1),
                     n3=r(3 * c))


def bwd_splits(tokens: int) -> int:
    """Token chunks of the weight-grad pass: about 2048 tokens each, at most
    32 partial sums (72 tiles x 32 chunks fill the card at SwinIR-M width)."""
    return max(1, min(32, tokens // 2048))


def rel_table_grad(dbias: torch.Tensor, n_rows: int, num_heads: int
                   ) -> torch.Tensor:
    """Scatter the (nh, 64, 64) score-bias grad into the relative-position
    table's grad (n_rows, nh) by ``relative_position_index``: the
    transpose of the gather in ``window_bias``."""
    idx = rel_index_on(WS, dbias.device)
    g = torch.zeros(n_rows, num_heads, device=dbias.device, dtype=torch.float32)
    return g.index_add_(0, idx, dbias.float().reshape(num_heads, -1).t())


def unpack_bwd_grads(dw: torch.Tensor, dln: torch.Tensor, dbias: torch.Tensor,
                     p: SwinBlockParams, num_heads: int) -> SwinBlockParams:
    """The kernel's outputs (the four products back to back, the LN grads
    (4, C), the score-bias grad (nh, 64, 64)) → grads in KAIR's layout."""
    c = p.qkv_weight.shape[1]
    hidden = p.fc1_weight.shape[0]
    lay = bwd_layout(c, hidden)
    shapes = lay.products()
    d_qkv, d_proj, d_fc1, d_fc2 = (
        t.view(shape) for t, shape in
        zip(torch.split(dw, [r * k for r, k in shapes]), shapes))
    t = lambda a: a.t().contiguous()
    return SwinBlockParams(
        qkv_weight=t(d_qkv[:c, :3 * c]),
        qkv_bias=None if p.qkv_bias is None else d_qkv[c, :3 * c].contiguous(),
        proj_weight=t(d_proj[:c, :c]), proj_bias=d_proj[c, :c].contiguous(),
        rel_table=rel_table_grad(dbias, p.rel_table.shape[0], num_heads),
        norm1_weight=dln[0], norm1_bias=dln[1],
        norm2_weight=dln[2], norm2_bias=dln[3],
        fc1_weight=t(d_fc1[:c, :hidden]),
        fc1_bias=d_fc1[c, :hidden].contiguous(),
        fc2_weight=t(d_fc2[:hidden, :c]),
        fc2_bias=d_fc2[hidden, :c].contiguous())


def swin_block_2d_bwd_reference(x: torch.Tensor, dy: torch.Tensor,
                                p: SwinBlockParams, num_heads: int,
                                mask: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, SwinBlockParams]:
    """Plain PyTorch version of the backward kernel (counterpart of
    ``_fused_2d_bwd_xla`` :516): autograd through ``swin_block_2d_reference``
    at phase 0, in f32 from the given inputs, autocast off. Returns dx in
    ``x.dtype`` and f32 parameter grads (``qkv_bias`` None when absent)."""
    with torch.enable_grad(), torch.autocast(x.device.type, enabled=False):
        xf = x.detach().float().requires_grad_(True)
        ps = [None if a is None else a.detach().float().requires_grad_(True)
              for a in p]
        y = swin_block_2d_reference(xf, SwinBlockParams(*ps), num_heads, mask)
        grads = torch.autograd.grad(
            y, [xf] + [a for a in ps if a is not None], dy.float())
    rest = iter(grads[1:])
    return grads[0].to(x.dtype), SwinBlockParams(
        *[None if a is None else next(rest) for a in ps])


def swin_block_2d_bwd(x: torch.Tensor, dy: torch.Tensor, p: SwinBlockParams,
                      num_heads: int, mask: Optional[torch.Tensor] = None,
                      packed: Optional[SwinBlockPack] = None
                      ) -> Tuple[torch.Tensor, SwinBlockParams]:
    """Backward of the training Swin block (phase 0, window 8): dx and the
    f32 parameter grads.

    CPU tensor → the plain version. CUDA tensor → the kernel (bf16 x and
    dy), or an exception; ``packed`` is the cached
    ``pack_swin_block(p, nh, folded=False)``."""
    if x.device.type == "cpu":
        return swin_block_2d_bwd_reference(x, dy, p, num_heads, mask)
    _check_cuda_args(x, p, num_heads, mask)
    if (dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous()
            or dy.device != x.device):
        raise ValueError("dy must be a contiguous bf16 tensor shaped and "
                         "placed like x")
    b, h, w, c = x.shape
    hidden = p.fc1_weight.shape[0]
    if (tuple(p.fc1_weight.shape) != (hidden, c)
            or tuple(p.fc2_weight.shape) != (c, hidden)):
        raise ValueError(f"fc1/fc2 weights do not match C={c}")
    lay = bwd_layout(c, hidden)
    pk = packed if packed is not None else pack_swin_block(p, num_heads,
                                                           folded=False)
    if pk.wqkv.dtype != torch.bfloat16 or pk.wqkv.device != x.device:
        raise ValueError("packed weights must be bf16 on the input's device")
    nh, tokens = num_heads, b * h * w
    n_win, splits = tokens // (WS * WS), bwd_splits(tokens)
    bf, f32 = torch.bfloat16, torch.float32
    new = lambda *shape, dtype=bf: torch.empty(shape, dtype=dtype,
                                               device=x.device)
    with torch.autocast("cuda", enabled=False):
        ln = torch.stack([p.norm1_weight, p.norm1_bias, p.norm2_weight,
                          p.norm2_bias]).float().contiguous()
    ops = dict(qkv_s=new(tokens, nh * 96), h1=new(tokens, lay.k1),
               ao=new(tokens, lay.k1), h2=new(tokens, lay.k1),
               g=new(tokens, lay.kg), dyp=new(tokens, lay.cp),
               dp=new(tokens, lay.hp), dx1=new(tokens, lay.cp),
               dqkv=new(tokens, lay.n3))
    n_dw = sum(r * k for r, k in lay.products())
    part_ln = new(n_win, 4, c, dtype=f32)
    part_bias = new(n_win, nh, 64, 64, dtype=f32)
    part_w = new(splits, n_dw, dtype=f32)
    dx = torch.empty_like(x)
    dw, dln = new(n_dw, dtype=f32), new(4, c, dtype=f32)
    dbias = new(nh, 64, 64, dtype=f32)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.kair_swin_block_2d_bwd(
            x.data_ptr(), dy.data_ptr(), pk.wqkv.data_ptr(),
            pk.bqkv.data_ptr(), pk.wp.data_ptr(), pk.bp.data_ptr(),
            pk.w1.data_ptr(), pk.b1.data_ptr(), pk.w2.data_ptr(),
            pk.b2.data_ptr(), ln.data_ptr(), pk.relbias.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *(ops[k].data_ptr() for k in ("qkv_s", "h1", "ao", "h2", "g",
                                          "dyp", "dp", "dx1", "dqkv")),
            part_ln.data_ptr(), part_bias.data_ptr(), part_w.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), dln.data_ptr(), dbias.data_ptr(),
            b, h, w, c, nh, hidden, lay.hp, lay.k1, lay.kg, lay.n3, splits,
            float((c // nh) ** -0.5),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "swin_block_2d_bwd")
    swin_block_2d_bwd.launches += 1
    return dx, unpack_bwd_grads(dw, dln, dbias, p, nh)


swin_block_2d_bwd.launches = 0


class SwinBlockFunction(torch.autograd.Function):
    """The training block at phase 0 as one autograd node: forward through
    ``swin_block_2d`` (kernel 1), backward through ``swin_block_2d_bwd``
    (kernel 3). Only x and the parameters are saved (the remat profile of
    ``_fused_2d`` :490). On the card x runs in bf16 whatever it arrives in
    (the kernels take bf16; f32 parameters stay the master copy and get f32
    grads) and dx goes back in x's dtype."""

    @staticmethod
    def forward(ctx, x, mask, num_heads, packed, packed_bwd, *params):
        ctx.num_heads, ctx.mask, ctx.x_dtype = num_heads, mask, x.dtype
        ctx.packed_bwd = packed_bwd
        xin = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
        ctx.save_for_backward(xin, *params)
        return swin_block_2d(xin, SwinBlockParams(*params), num_heads, mask,
                             0, packed=packed)

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        dx, grads = swin_block_2d_bwd(x, dy.to(x.dtype).contiguous(),
                                      SwinBlockParams(*params),
                                      ctx.num_heads, ctx.mask, ctx.packed_bwd)
        return (dx.to(ctx.x_dtype), None, None, None, None,
                *[None if g is None else g.to(a.dtype)
                  for g, a in zip(grads, params)])


def swin_block_train(x: torch.Tensor, p: SwinBlockParams, num_heads: int,
                     mask: Optional[torch.Tensor] = None,
                     packed: Optional[SwinBlockPack] = None,
                     packed_bwd: Optional[SwinBlockPack] = None
                     ) -> torch.Tensor:
    """Differentiable Swin block on (B, H, W, C), window 8, phase 0 (the
    caller rolls): ``SwinBlockFunction``. ``packed`` and ``packed_bwd`` are
    the cached forward and backward packs for a CUDA tensor (made per call
    when None)."""
    return SwinBlockFunction.apply(x, mask, num_heads, packed, packed_bwd, *p)
