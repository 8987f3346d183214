"""Host side of the 3-D window-block kernels (``csrc/window3d_wgmma.cu``):
VRT's TMSA mutual block (``tmsa_block.py``) and self-attention (wd, 8, 8)
block (``self6_block.py``), and RVRT's self-only (2, 8, 8) STL block with
a plain GELU MLP (``stl2_block.py``), three kinds of one kernel's passes.

``pack_win3d_stages`` builds a block's weight stages on the device,
already in wgmma's swizzled layout, ``win3d_plan`` mirrors the kernels'
tiling and shared-memory layout (``chip_smoke.py`` phase 1 holds it equal
to the kernels' own ``kair_win3d_plan``), ``item_walk`` and
``attn_blocks`` mirror their walks over the map, and ``launch_win3d`` runs
the three passes. ``labels_on`` gives the shift mask as region labels,
``check_geometry`` refuses what the kernels do not take, and ``refusal``
says without raising why they refuse a block's widths (the model's routes
ask it; ``takes`` is its bool).

The relative-position table keeps the window depth ``twd`` it was made
for (KAIR's module window, 6 in VRT): a block on a shallower window reads
it with the (twd, 8, 8) index sliced to its N tokens, as KAIR does. The
shift mask goes to the kernel as region labels, (8, N) int32: one row per
boundary pattern, a key and a query in different regions score −100.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels._build import SMEM_LIMIT
from kair_tpu_torch.ops.kernels.swin_block import _swizzle
from kair_tpu_torch.ops.kernels.window_msa import HD_MAX
from kair_tpu_torch.ops.window3d import Tmsa3dParams


def labels_on(dhw: Sequence[int], ws: Sequence[int], ss: Sequence[int],
              device: torch.device) -> Optional[torch.Tensor]:
    """(8, N) int32 region labels of a shifted geometry on ``device`` (None
    when unshifted); cached per geometry: a constant of the shape."""
    if not any(ss):
        return None
    return _labels_on(tuple(dhw), tuple(ws), tuple(ss), str(device))


@lru_cache(maxsize=64)
def _labels_on(dhw, ws, ss, device: str) -> torch.Tensor:
    labels, _ = window3d.compute_mask_labels_3d(*dhw, ws, ss)
    with torch.inference_mode(False):
        return torch.from_numpy(labels).to(device)


def check_geometry(name: str, x: torch.Tensor, p: Tmsa3dParams,
                   num_heads: int, wd: int, mutual: bool,
                   gated: bool = True) -> int:
    """Raise on what the window kernels do not take; returns the table's
    window depth. bf16, contiguous (B, D, H, W, C) with (wd, 8, 8) windows
    tiling it, head dim ≤ 32, a table for 8x8 windows at least wd deep, the
    parameters of the kernel's kind of block (mutual or not, GEGLU
    (``gated``) or plain MLP), and what ``_check_plan`` names."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"{name} expects a contiguous (B, D, H, W, C) tensor")
    b, d, h, w, c = x.shape
    if d % wd or h % 8 or w % 8:
        raise ValueError(f"{name} needs ({wd}, 8, 8) windows tiling the map, "
                         f"got {d}x{h}x{w}")
    if c % num_heads or c // num_heads > HD_MAX:
        raise ValueError(f"{name} needs C divisible by the heads with head "
                         f"dim <= {HD_MAX} (C={c}, heads={num_heads})")
    if tuple(p.qkv_self_weight.shape) != (3 * c, c):
        raise ValueError(f"qkv weight {tuple(p.qkv_self_weight.shape)} does "
                         f"not match C={c}")
    twd = window3d.table_depth(p.rel_table)
    if (p.rel_table.shape[0] != (2 * twd - 1) * 225 or twd < wd
            or p.rel_table.shape[1] != num_heads):
        raise ValueError(f"{name} needs a relative position table for 8x8 "
                         f"windows at least {wd} deep and {num_heads} heads, "
                         f"got {tuple(p.rel_table.shape)}")
    if (mutual != (p.qkv_mut_weight is not None)
            or gated != (p.fc12_weight is not None)
            or (mutual and tuple(p.proj_weight.shape) != (c, 2 * c))):
        raise ValueError(f"{name}: parameters of the wrong kind of block")
    _check_plan(name, win3d_plan(mutual, c, num_heads, p.fc11_weight.shape[0],
                                 wd, twd, not gated),
                c, num_heads, mutual, not gated)
    return twd


# ---------------------------------------------------------------------------
# VRT's TMSA and self blocks on wgmma (csrc/window3d_wgmma.cu): the plan, the
# weight stages, the walks and the launch
# ---------------------------------------------------------------------------

KC = 64                     # K chunk: one 128-byte swizzle row of bf16
RING = 4                    # weight stages in shared memory
MAX_STAGES = 64             # weight stages per 64-token item
STATIC_SMEM = MAX_STAGES * 8    # the stage table
# width classes (NT, HD, VD): the accumulator width that holds C, the q/k
# head width (the depth of QK^T) and the v head width (the N of PV); VRT's
# GEGLU blocks take the first three, RVRT's STL block (plain MLP) the last
# two, its widths C = 144 and 192
WIDTHS = ((96, 16, 16), (120, 32, 24), (184, 32, 32))
PLAIN_WIDTHS = ((144, 32, 24), (192, 32, 32))


class Win3dPlan(NamedTuple):
    """csrc/window3d_wgmma.cu's Plan, as ``kair_win3d_plan`` reports it."""
    nt: int         # accumulator width of pass 3 (proj, fc2)
    hdp: int        # q/k head width
    vdp: int        # v head width
    qkvw: int       # columns of the q/k/v map
    aw: int         # columns of the attention map (P·C)
    kc: int         # K chunks of 64 over C
    kcp: int        # K chunks of 64 over P·C (proj)
    hc: int         # hidden chunks of 64
    ring: int       # ring slots
    stages1: int    # pass 1's weight stages per item
    stages3: int    # pass 3's weight stages per item
    slot1: int      # bytes of a pass-1 ring slot
    slot3: int      # bytes of a pass-3 ring slot
    smem1: int      # dynamic shared memory of passes 1, 2 and 3
    smem2: int
    smem3: int
    fits: bool      # the kernels take this geometry


def width_class(c: int, plain: bool = False) -> Tuple[int, int, int]:
    """(NT, HD, VD) of the narrowest width class that holds C, among the
    GEGLU blocks' classes or (``plain``) the STL block's."""
    widths = PLAIN_WIDTHS if plain else WIDTHS
    return next((w for w in widths if c <= w[0]), widths[-1])


def kind(mutual: bool, plain: bool) -> int:
    """The C entries' kind: 0 the self block, 1 the TMSA block, 2 the STL
    block (plain MLP)."""
    return 2 if plain else int(mutual)


@lru_cache(maxsize=64)
def win3d_plan(mutual: bool, c: int, nh: int, hidden: int, wd: int,
               twd: int, plain: bool = False) -> Win3dPlan:
    """The kernels' tiling and shared-memory layout (Plan in
    csrc/window3d_wgmma.cu): passes 1 and 3 a ring of RING weight stages,
    two LN outputs, (pass 1) two q/k/v staging tiles, their f32 vectors and
    the ring's barriers; pass 2 per
    branch the head's K rows (2·HD bytes each) and vᵀ chunks, the table's
    column and the window's labels. ``plain``: the STL block (the self
    block with a plain MLP), never mutual."""
    a128, a1024 = _build.align128, lambda v: -(-v // 1024) * 1024
    nt, hdp, vdp = width_class(c, plain)
    hd = c // nh if nh else 0
    p = 2 if mutual else 1
    hw = 2 * hdp + vdp
    qkvw, aw = p * nh * hw, p * c
    kc, kcp, hc = -(-c // KC), -(-aw // KC), -(-hidden // KC)
    ab = a1024(64 * (kc * KC + 8) * 2)
    stg = a1024(64 * (2 * hw + 8) * 2)
    slot1, slot3 = 2 * hw * 128, max(nt, 128) * 128
    stages1, stages3 = p * (nh // 2) * kc, kcp + hc * (kc + 1)
    tail = 2 * RING * 8 + 1024
    smem1 = RING * slot1 + 2 * ab + 2 * stg + a128((qkvw + 2 * c) * 4) + tail
    smem3 = RING * slot3 + 2 * ab + a128((4 * c + 2 * hc * 64) * 4) + tail
    smem2 = (p * (wd * 64 * 2 * hdp + wd * vdp * 128)
             + a128((2 * twd - 1) * 225 * 4) + a128(wd * 64 * 4) + 1024)
    cmax = (PLAIN_WIDTHS if plain else WIDTHS)[-1][0]
    fits = (2 <= c <= cmax and c % 2 == 0 and nh >= 2
            and nh % 2 == 0 and c % nh == 0 and hd % 2 == 0 and hd <= vdp
            and not (mutual and (nt == WIDTHS[-1][0] or wd != 2 or twd != 2))
            and hidden >= 1 and wd >= 1 and twd >= wd
            and max(stages1, stages3) <= MAX_STAGES
            and max(smem1, smem2, smem3) + STATIC_SMEM <= SMEM_LIMIT)
    return Win3dPlan(nt, hdp, vdp, qkvw, aw, kc, kcp, hc, RING, stages1,
                     stages3, slot1, slot3, smem1, smem2, smem3, fits)


def plan_refusal(pl: Win3dPlan, c: int, nh: int, mutual: bool,
                 plain: bool = False) -> Optional[str]:
    """Why the wgmma kernels refuse a geometry that the WMMA kernels before
    them took, or None: C above 184 (192 for the STL block), an odd head
    count, an odd head dim or one wider than its width class's v width (16
    up to C=96, 24 up to 120, and up to 144 for the STL block), a TMSA
    block above C=120, or a layout that does not fit (``pl.fits``)."""
    cmax = (PLAIN_WIDTHS if plain else WIDTHS)[-1][0]
    if c > cmax:
        return f"takes C <= {cmax} (the widest accumulator class), got C={c}"
    if nh < 2 or nh % 2:
        return (f"needs an even number of heads (one qkv product per head "
                f"pair), got {nh}")
    hd = c // nh
    if hd % 2 or hd > pl.vdp:
        return (f"at C={c} takes an even head dim of at most {pl.vdp}, got "
                f"{hd}")
    if mutual and pl.nt == WIDTHS[-1][0]:
        return f"takes C <= {WIDTHS[1][0]} for the mutual block, got C={c}"
    if not pl.fits:
        return f"at C={c}, {nh} heads: the layout does not fit the card ({pl})"
    return None


@lru_cache(maxsize=64)
def refusal(mutual: bool, c: int, nh: int, hidden: int, wd: int, twd: int,
            plain: bool = False) -> Optional[str]:
    """Why the kernels refuse a block of C channels, nh heads, an MLP of
    ``hidden`` width on (wd, 8, 8) windows with a table twd deep, or None:
    the reason ``_check_plan`` raises with."""
    return plan_refusal(win3d_plan(mutual, c, nh, hidden, wd, twd, plain), c,
                        nh, mutual, plain)


def takes(mutual: bool, c: int, nh: int, hidden: int, wd: int, twd: int,
          plain: bool = False) -> bool:
    """Whether the kernels take that block: ``refusal`` is None."""
    return refusal(mutual, c, nh, hidden, wd, twd, plain) is None


def _check_plan(name: str, pl: Win3dPlan, c: int, nh: int,
                mutual: bool, plain: bool = False) -> None:
    """Raise with ``plan_refusal``'s reason."""
    why = plan_refusal(pl, c, nh, mutual, plain)
    if why is not None:
        raise ValueError(f"{name} {why}")


@lru_cache(maxsize=64)
def stage_rows(pl: Win3dPlan, nh: int, plain: bool = False
               ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Rows of each weight stage of an item, in the order the ring streams
    them (every row holds 64 K values): pass 1 per branch, head pair and K
    chunk the pair's q, k, v columns; pass 3 proj per K chunk, then per
    hidden chunk its fc11 | fc12 K chunks (``plain``: its fc1 K chunks) and
    its fc2."""
    nq = 2 * (2 * pl.hdp + pl.vdp)
    return ((nq,) * pl.stages1,
            (pl.nt,) * pl.kcp
            + ((64 if plain else 128,) * pl.kc + (pl.nt,)) * pl.hc)


class Win3dStages(NamedTuple):
    """The wgmma kernels' operands (layouts in csrc/window3d_wgmma.cu)."""
    st1: torch.Tensor       # pass 1's weight stages, flat
    bq: torch.Tensor        # (qkvw,) f32 qkv biases in the map's order
    st3: torch.Tensor       # pass 3's weight stages, flat
    pos: Optional[torch.Tensor]     # (64, C) f32 sine position, TMSA only
    ln1: torch.Tensor       # (2, C) f32 scale, bias
    ln2: torch.Tensor
    bp: torch.Tensor        # (C,) f32
    b11: torch.Tensor       # (hc·64,) f32
    b12: Optional[torch.Tensor]     # None for a plain MLP
    b2: torch.Tensor        # (C,) f32
    rel_table: torch.Tensor     # (nh, (2twd−1)·225) f32, a head a row
    hidden: int


def pack_win3d_stages(p: Tmsa3dParams, num_heads: int,
                      dtype: torch.dtype = torch.bfloat16) -> Win3dStages:
    """One block's parameters (GEGLU, or a plain MLP: no fc12) → the wgmma
    kernels' operands, on the parameters' device (once per set of weights; the model caches it): the
    q scale folded into q's rows, then each pass's stages in one gather
    through an index cached per geometry, so a training model, which packs
    its blocks anew after every optimizer step, runs a few ops per block.
    ``dtype=torch.float32`` keeps the stages exact for checking."""
    with torch.autocast(p.qkv_self_weight.device.type, enabled=False):
        return _pack_stages(p, num_heads, dtype)


def _pack_stages(p: Tmsa3dParams, nh: int, dtype: torch.dtype) -> Win3dStages:
    c = p.qkv_self_weight.shape[1]
    hidden = p.fc11_weight.shape[0]
    dev, f32 = p.qkv_self_weight.device, torch.float32
    mutual = p.qkv_mut_weight is not None
    plain = p.fc12_weight is None
    ws = [p.qkv_self_weight] + ([p.qkv_mut_weight] if mutual else [])
    bs = [p.qkv_self_bias, p.qkv_mut_bias][:len(ws)]
    w = torch.cat([t.float() for t in ws])                # (P·3C, C), a copy
    b = torch.cat([torch.zeros(3 * c, device=dev) if t is None else t.float()
                   for t in bs])
    scale = (c // nh) ** -0.5
    w.view(len(ws), 3, c, c)[:, 0] *= scale
    b.view(len(ws), 3, c)[:, 0] *= scale
    hc = -(-hidden // KC)

    def vec(t, n):
        v = torch.zeros(n, device=dev, dtype=f32)
        v[:t.shape[0]] = t.float()
        return v

    mlp = ((_plain_stage_layout, (p.proj_weight, p.fc11_weight,
                                   p.fc2_weight)) if plain
           else (_mlp_stage_layout, (p.proj_weight, p.fc11_weight,
                                     p.fc12_weight, p.fc2_weight)))
    return Win3dStages(
        st1=_gather(_qkv_stage_layout, (w,), c, nh, plain).to(dtype),
        bq=_gather(_qkv_bias_layout, (b,), c, nh, plain),
        st3=_gather(*mlp, c, nh, plain).to(dtype),
        pos=(p.position_bias.reshape(64, c).float().contiguous() if mutual
             else None),
        ln1=torch.stack([p.norm1_weight, p.norm1_bias]).float().contiguous(),
        ln2=torch.stack([p.norm2_weight, p.norm2_bias]).float().contiguous(),
        bp=p.proj_bias.float().contiguous(), b11=vec(p.fc11_bias, hc * KC),
        b12=None if plain else vec(p.fc12_bias, hc * KC),
        b2=p.fc2_bias.float().contiguous(),
        rel_table=p.rel_table.float().t().contiguous(), hidden=hidden)


def _gather(layout, mats: Tuple[torch.Tensor, ...], c: int, nh: int,
            plain: bool) -> torch.Tensor:
    """``layout(*mats, c, nh, plain)`` as one gather, flat f32."""
    idx = _layout_index(layout, tuple(tuple(m.shape) for m in mats), c, nh,
                        plain, str(mats[0].device))
    return torch.cat([m.reshape(-1).float() for m in mats]
                     + [mats[0].new_zeros(1, dtype=torch.float32)])[idx]


@lru_cache(maxsize=64)
def _layout_index(layout, shapes: Tuple[Tuple[int, ...], ...], c: int,
                  nh: int, plain: bool, device: str) -> torch.Tensor:
    """Where each element of ``layout`` comes from in the matrices'
    concatenation, flattened, with one zero after it for the padding:
    ``layout`` of matrices that hold their own flat positions (float64:
    exact)."""
    with torch.inference_mode(False):
        sizes = [math.prod(s) for s in shapes]
        total = sum(sizes)
        src = torch.arange(1, total + 1, dtype=torch.float64)
        mats = [t.view(s) for t, s in zip(torch.split(src, sizes), shapes)]
        idx = layout(*mats, c, nh, plain).long() - 1
        idx[idx < 0] = total
        return idx.to(device)


def _pad(m: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """m zero-padded to (rows, cols)."""
    return F.pad(m, (0, cols - m.shape[1], 0, rows - m.shape[0]))


def _heads(t: torch.Tensor, c: int, nh: int, plain: bool) -> torch.Tensor:
    """(P·3C, ...) qkv rows → (P, nh, 2HD + VD, ...): each head's q, k and v
    rows at the widths of C's class, zero rows between."""
    _, hdp, vdp = width_class(c, plain)
    hd, p = c // nh, t.shape[0] // (3 * c)
    tv = t.reshape(p, 3, nh, hd, *t.shape[1:])
    out = t.new_zeros(p, nh, 2 * hdp + vdp, *t.shape[1:])
    for i, off in enumerate((0, hdp, 2 * hdp)):
        out[:, :, off:off + hd] = tv[:, i]
    return out


def _qkv_stage_layout(w: torch.Tensor, c: int, nh: int, plain: bool
                      ) -> torch.Tensor:
    """Pass 1's stages from the scaled qkv rows (P·3C, C): per branch, head
    pair and K chunk, the pair's 2(2HD + VD) rows of 64 K values."""
    _, hdp, vdp = width_class(c, plain)
    kc, hw = -(-c // KC), 2 * hdp + vdp
    st = _heads(_pad(w, w.shape[0], kc * KC), c, nh, plain)
    st = st.reshape(st.shape[0], nh // 2, 2 * hw, kc, KC).transpose(2, 3)
    return _swizzle(st.contiguous()).reshape(-1)


def _qkv_bias_layout(b: torch.Tensor, c: int, nh: int, plain: bool
                     ) -> torch.Tensor:
    """The scaled qkv biases (P·3C,) in the q/k/v map's column order."""
    return _heads(b, c, nh, plain).reshape(-1)


def _mlp_stage_layout(wp: torch.Tensor, w11: torch.Tensor, w12: torch.Tensor,
                      w2: torch.Tensor, c: int, nh: int, plain: bool = False
                      ) -> torch.Tensor:
    """Pass 3's stages from KAIR's (out, in) weights: proj per K chunk of
    P·C (NT rows), then per hidden chunk its fc11 | fc12 K chunks (128
    rows) and its fc2 (NT rows)."""
    nt = width_class(c, plain)[0]
    kc, kcp, hc = -(-c // KC), -(-wp.shape[1] // KC), -(-w11.shape[0] // KC)
    sw = lambda m: _swizzle(m.contiguous())
    pj = _pad(wp, nt, kcp * KC).reshape(nt, kcp, KC).transpose(0, 1)
    f1 = torch.cat([_pad(m, hc * KC, kc * KC).reshape(hc, KC, kc, KC)
                    for m in (w11, w12)], 1).transpose(1, 2)
    f2 = _pad(w2, nt, hc * KC).reshape(nt, hc, KC).transpose(0, 1)
    per_chunk = torch.cat([sw(f1).reshape(hc, -1), sw(f2).reshape(hc, -1)], 1)
    return torch.cat([sw(pj).reshape(-1), per_chunk.reshape(-1)])


def _plain_stage_layout(wp: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                        c: int, nh: int, plain: bool = True) -> torch.Tensor:
    """The STL block's pass-3 stages: proj per K chunk of C (NT rows), then
    per hidden chunk its fc1 K chunks (64 rows) and its fc2 (NT rows)."""
    nt = width_class(c, True)[0]
    kc, kcp, hc = -(-c // KC), -(-wp.shape[1] // KC), -(-w1.shape[0] // KC)
    sw = lambda m: _swizzle(m.contiguous())
    pj = _pad(wp, nt, kcp * KC).reshape(nt, kcp, KC).transpose(0, 1)
    f1 = _pad(w1, hc * KC, kc * KC).reshape(hc, KC, kc, KC).transpose(1, 2)
    f2 = _pad(w2, nt, hc * KC).reshape(nt, hc, KC).transpose(0, 1)
    per_chunk = torch.cat([sw(f1).reshape(hc, -1), sw(f2).reshape(hc, -1)], 1)
    return torch.cat([sw(pj).reshape(-1), per_chunk.reshape(-1)])


def item_walk(items: int, sms: int = 132) -> List[List[Tuple[int, int]]]:
    """The persistent walk of passes 1 and 3 over 64-token items: two items
    an iteration (warpgroup g takes item 2t + g) when there are more items
    than SMs, else one (warpgroup 0 takes item t). Returns each block's
    (item of warpgroup 0, item of warpgroup 1 or -1) in order."""
    pair = 2 if items > sms else 1
    iters = -(-items // pair)
    grid = min(iters, sms)
    return [[(pair * t, pair * t + 1 if pair == 2 and pair * t + 1 < items
              else -1) for t in range(i, iters, grid)] for i in range(grid)]


def attn_blocks(b: int, d: int, h: int, w: int, wd: int, nh: int
                ) -> List[Tuple[int, int, int, int, int]]:
    """(batch, window along D, H and W, head) of each pass-2 block, as the
    kernel decodes its block index."""
    nwd, nwh, nww = d // wd, h // 8, w // 8
    out = []
    for blk in range(b * nwd * nwh * nww * nh):
        r, head = divmod(blk, nh)
        r, wk = divmod(r, nww)
        r, wj = divmod(r, nwh)
        bi, wi = divmod(r, nwd)
        out.append((bi, wi, wj, wk, head))
    return out


def _check_pack(name: str, x: torch.Tensor, pk: Win3dStages, pl: Win3dPlan,
                nh: int, mutual: bool, plain: bool = False) -> None:
    """The stages bf16, contiguous, of the plan's size, 16-byte aligned (the
    bulk copies' rule), on x's device; the vectors f32 there (no fc12 bias
    for the plain MLP); the TMSA block's position; fewer than 2^31
    tokens."""
    rows1, rows3 = stage_rows(pl, nh, plain)
    for st, rows in ((pk.st1, rows1), (pk.st3, rows3)):
        if (st.dtype != torch.bfloat16 or st.device != x.device
                or not st.is_contiguous() or st.numel() != sum(rows) * KC
                or st.data_ptr() % 16):
            raise ValueError(f"{name} needs contiguous, 16-byte aligned bf16 "
                             f"weight stages of the plan's size on {x.device}")
    vecs = (pk.bq, pk.ln1, pk.ln2, pk.bp, pk.b11, pk.b2, pk.rel_table) + (
        () if plain else (pk.b12,))
    if any(t is None or t.dtype != torch.float32 or t.device != x.device
           or not t.is_contiguous() for t in vecs) or (plain != (pk.b12 is None)):
        raise ValueError(f"{name} needs its packed vectors f32 on {x.device}, "
                         f"{'without' if plain else 'with'} an fc12 bias")
    if mutual and (pk.pos is None or pk.pos.device != x.device):
        raise ValueError(f"{name} needs the sine position on {x.device}")
    if x.numel() // x.shape[-1] >= 2 ** 31:
        raise ValueError(f"{name} takes fewer than 2^31 tokens")


def launch_win3d(name: str, x: torch.Tensor, pk: Win3dStages, nh: int,
                 wd: int, twd: int, shift: Sequence[int],
                 mutual: bool, plain: bool = False) -> torch.Tensor:
    """The three passes of ``kair_win3d_block`` on a checked x, the block of
    kind (``mutual``, ``plain``); the q/k/v and attention maps are scratch
    of this call."""
    b, d, h, w, c = x.shape
    pl = win3d_plan(mutual, c, nh, pk.hidden, wd, twd, plain)
    _check_pack(name, x, pk, pl, nh, mutual, plain)
    t = b * d * h * w
    qkv = torch.empty(t, pl.qkvw, dtype=x.dtype, device=x.device)
    att = torch.empty(t, pl.aw, dtype=x.dtype, device=x.device)
    lab = labels_on((d, h, w), (wd, 8, 8), shift, x.device)
    out = torch.empty_like(x)
    ptr = lambda v: None if v is None else v.data_ptr()
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.kair_win3d_block(
            kind(mutual, plain), x.data_ptr(), out.data_ptr(), qkv.data_ptr(),
            att.data_ptr(), pk.st1.data_ptr(), pk.bq.data_ptr(),
            pk.st3.data_ptr(), ptr(pk.pos), pk.ln1.data_ptr(),
            pk.ln2.data_ptr(), pk.bp.data_ptr(), pk.b11.data_ptr(),
            ptr(pk.b12), pk.b2.data_ptr(), pk.rel_table.data_ptr(),
            ptr(lab), b, d, h, w, c, nh, pk.hidden, wd, twd, *map(int, shift),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"{name} (wd {wd})")
    return out
