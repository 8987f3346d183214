"""VRT's window blocks on wgmma (csrc/window3d_wgmma.cu), their host side on
the CPU: the device-built weight stages against the block's matrices, a
replay of the three passes' arithmetic from those stages (64-token items in
the persistent walk's order, one (window, head) at a time over all its query
tiles with an online softmax over 64-key tiles, the narrowed head widths)
against the plain versions and JAX's Pallas kernels in interpret mode, the
layout at every preset geometry, the walks, and the wrappers' refusals.
The kernels themselves run only on the card (chip_smoke.py phases 13-14)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.self6_block as js6
from kair_tpu.models.vrt import rel_position_index_3d as j_rel_index
from kair_tpu.ops.pallas.tmsa_block import (make_tmsa_biases,
                                            tmsa_block_pallas,
                                            tmsa_mask_patterns)
from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels import self6_block, tmsa_block, win3d
from kair_tpu_torch.ops.kernels.swin_block import unswizzle
from kair_tpu_torch.ops.kernels.win3d import (labels_on, pack_win3d_stages,
                                              stage_rows, win3d_plan)
from kair_tpu_torch.ops.kernels.window_msa import SMEM_LIMIT
from tests.test_torch_vrt_kernels import (_jroll, _x, block_weights,
                                          torch_params)

F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (the suite runs several
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stages(flat: torch.Tensor, rows) -> list:
    """A flat stage tensor → its (rows, 64) stages, unswizzled: stage row n
    holds B[k, n] for its 64 K values."""
    out, off = [], 0
    for r in rows:
        out.append(unswizzle(flat[off:off + r * 64].view(r, 64)))
        off += r * 64
    return out


def emulate_win3d_wgmma(x, pk, nh, wd, twd, shift, labels, mutual,
                        plain=False):
    """csrc/window3d_wgmma.cu's three passes in PyTorch, f32, from the
    packed stages: passes 1 and 3 per 64-token item in the persistent walk's
    order, a product per head pair (pass 1) and per K chunk (both), the
    GEGLU (``plain``: fc1 → GELU) per hidden chunk of 64 feeding fc2; pass 2
    per (window, head) over all its query tiles with the shift folded into
    the indices, q and k at the padded width HD, v at VD, an online softmax
    over 64-key tiles, the output stored at the real head dim."""
    b, d, h, w, c = x.shape
    pl = win3d_plan(mutual, c, nh, pk.hidden, wd, twd, plain)
    assert pl.fits
    rows1, rows3 = stage_rows(pl, nh, plain)
    st1, st3 = _stages(pk.st1.float(), rows1), _stages(pk.st3.float(), rows3)
    p = 2 if mutual else 1
    hd, hdp, vdp = c // nh, pl.hdp, pl.vdp
    hw, qw = 2 * hdp + vdp, pl.qkvw // p
    t_all = b * d * h * w
    xf = x.reshape(t_all, c).float()
    qkv = torch.zeros(t_all, pl.qkvw)
    att = torch.zeros(t_all, pl.aw)
    out = torch.zeros(t_all, c)
    tok = torch.arange(t_all)
    loc = ((tok // w % h - shift[1]) % h % 8) * 8 + (tok % w - shift[2]) % w % 8
    walk = [i for blk in win3d.item_walk(t_all // 64) for pair in blk
            for i in pair if i >= 0]
    kp = pl.kc * 64
    for it in walk:                                     # pass 1
        rows = slice(it * 64, it * 64 + 64)
        ln = F.layer_norm(xf[rows], (c,), pk.ln1[0], pk.ln1[1], 1e-5)
        s = 0
        for m in range(p):
            a = F.pad(ln if m == 0 else ln + pk.pos[loc[rows]], (0, kp - c))
            for pr in range(nh // 2):
                acc = torch.zeros(64, 2 * hw)
                for k in range(pl.kc):
                    acc += a[:, k * 64:(k + 1) * 64] @ st1[s].t()
                    s += 1
                cb = m * qw + pr * 2 * hw
                qkv[rows, cb:cb + 2 * hw] = acc + pk.bq[cb:cb + 2 * hw]
    n = wd * 64
    t = torch.arange(n)
    td, ty, tx = t // 64, t // 8 % 8, t % 8
    rel_idx = ((td[:, None] - td[None] + twd - 1) * 225
               + (ty[:, None] - ty[None] + 7) * 15
               + (tx[:, None] - tx[None] + 7))
    nwd, nwh, nww = d // wd, h // 8, w // 8
    r64 = torch.arange(64)
    # pass 2
    for bi, wi, wj, wk, head in win3d.attn_blocks(b, d, h, w, wd, nh):
        pix = (((bi * d + (wi * wd + td + shift[0]) % d) * h
                + (wj * 8 + ty + shift[1]) % h) * w
               + (wk * 8 + tx + shift[2]) % w)
        lab = None if labels is None else labels[
            4 * (wi == nwd - 1) + 2 * (wj == nwh - 1) + (wk == nww - 1)]
        for qt in range(4 if mutual else wd):
            mut = mutual and qt >= 2
            otile = qt - 2 if mut else qt
            qtile = 1 - otile if mut else otile
            col = (qw if mut else 0) + head * hw
            qi = qtile * 64 + r64
            q = qkv[pix[qi], col:col + hdp]
            m_run, l_run = torch.full((64,), -1e30), torch.zeros(64)
            o = torch.zeros(64, vdp)
            for kt in ([otile] if mut else range(wd)):
                kj = kt * 64 + r64
                k = qkv[pix[kj], col + hdp:col + 2 * hdp]
                v = qkv[pix[kj], col + 2 * hdp:col + hw]
                sc = q @ k.t()
                if not mut:
                    sc = sc + pk.rel_table[head, rel_idx[qi][:, kj]]
                if lab is not None:
                    lq, lk = ((lab[r64], lab[r64]) if mut
                              else (lab[qi], lab[kj]))
                    sc = sc - 100.0 * (lq[:, None] != lk[None])
                mx = torch.maximum(m_run, sc.max(1).values)
                corr = torch.exp(m_run - mx)
                e = torch.exp(sc - mx[:, None])
                l_run = l_run * corr + e.sum(1)
                o = o * corr[:, None] + e @ v
                m_run = mx
            acol = (c if mutual and not mut else 0) + head * hd
            att[pix[otile * 64 + r64], acol:acol + hd] = \
                (o / l_run[:, None])[:, :hd]
    for it in walk:                                     # pass 3
        rows = slice(it * 64, it * 64 + 64)
        acc = xf[rows] + pk.bp
        a = F.pad(att[rows], (0, pl.kcp * 64 - pl.aw))
        s = 0
        for k in range(pl.kcp):
            acc = acc + (a[:, k * 64:(k + 1) * 64] @ st3[s].t())[:, :c]
            s += 1
        z = F.pad(F.layer_norm(acc, (c,), pk.ln2[0], pk.ln2[1], 1e-5),
                  (0, kp - c))
        acc = acc + pk.b2
        for j in range(pl.hc):
            hq = torch.zeros(64, 64 if plain else 128)
            for k in range(pl.kc):
                hq += z[:, k * 64:(k + 1) * 64] @ st3[s].t()
                s += 1
            hid = F.gelu(hq[:, :64] + pk.b11[j * 64:(j + 1) * 64])
            if not plain:
                hid = hid * (hq[:, 64:] + pk.b12[j * 64:(j + 1) * 64])
            acc = acc + (hid @ st3[s].t())[:, :c]
            s += 1
        assert s == len(rows3)
        out[rows] = acc
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# the device-built stages against the block's matrices
# ---------------------------------------------------------------------------

def qkv_matrices(p, nh):
    """Per branch, the (C, 3C) qkv product matrix with the q scale folded
    into q's columns, and its bias: [q | k | v], head h's at h·hd."""
    c = p.qkv_self_weight.shape[1]
    scale = (c // nh) ** -0.5
    out = []
    for w, b in ((p.qkv_self_weight, p.qkv_self_bias),
                 (p.qkv_mut_weight, p.qkv_mut_bias)):
        if w is None:
            continue
        w, b = w.float().t().clone(), b.float().clone()
        w[:, :c] *= scale
        b[:c] *= scale
        out.append((w, b))
    return out

@pytest.mark.parametrize("c,nh,mutual", [(24, 2, True), (96, 6, True),
                                         (120, 6, True), (120, 6, False),
                                         (180, 6, False)])
def test_stage_pack_gives_back_the_matrices(c, nh, mutual):
    """Unswizzled, every stage holds the block's matrices (q scale folded,
    heads at their real width), zero elsewhere."""
    p = torch_params(block_weights(c, nh, 2, mutual, 11), c)
    pk = pack_win3d_stages(p, nh, F32)
    pl = win3d_plan(mutual, c, nh, pk.hidden, 2, 2)
    rows1, rows3 = stage_rows(pl, nh)
    st1, st3 = _stages(pk.st1, rows1), _stages(pk.st3, rows3)
    hd, hw, kp = c // nh, 2 * pl.hdp + pl.vdp, pl.kc * 64
    br = 2 if mutual else 1
    # pass 1: per branch the (K, qkvw / P) product of the map's columns
    for m, (wmat, bmat) in enumerate(qkv_matrices(p, nh)):
        got = torch.cat([torch.cat([st1[(m * (nh // 2) + pr) * pl.kc + k].t()
                                    for k in range(pl.kc)], 0)
                         for pr in range(nh // 2)], 1)      # (kp, qkvw / P)
        want = torch.zeros_like(got)
        bwant = torch.zeros(got.shape[1])
        for head, part in itertools.product(range(nh), range(3)):
            dst = head * hw + part * pl.hdp
            src = part * c + head * hd
            want[:c, dst:dst + hd] = wmat[:, src:src + hd]
            bwant[dst:dst + hd] = bmat[src:src + hd]
        torch.testing.assert_close(got, want, atol=0, rtol=0)
        cb = m * (pl.qkvw // br)
        torch.testing.assert_close(pk.bq[cb:cb + got.shape[1]], bwant,
                                   atol=0, rtol=0)
    # pass 3: proj (K = the attention map's columns, N = C), fc11, fc12, fc2
    wp = torch.cat([st3[k].t() for k in range(pl.kcp)], 0)[:pl.aw, :c]
    torch.testing.assert_close(wp, p.proj_weight.float().t(), atol=0, rtol=0)
    s = pl.kcp
    for j in range(pl.hc):
        f1 = torch.cat([st3[s + k].t() for k in range(pl.kc)], 0)   # (kp, 128)
        f2 = st3[s + pl.kc].t()                                     # (64, NT)
        s += pl.kc + 1
        cols = slice(j * 64, (j + 1) * 64)
        exact = dict(atol=0, rtol=0)
        w11, w12 = (F.pad(m.float().t(), (0, 64)) for m in (p.fc11_weight,
                                                             p.fc12_weight))
        w2 = F.pad(p.fc2_weight.float().t(), (0, 0, 0, 64))
        torch.testing.assert_close(f1[:c, :64], w11[:, cols], **exact)
        torch.testing.assert_close(f1[:c, 64:], w12[:, cols], **exact)
        torch.testing.assert_close(f2[:, :c], w2[cols], **exact)
        assert not f1[c:].any() and not f2[:, c:].any()
    assert s == len(rows3)
    hid = p.fc11_weight.shape[0]
    torch.testing.assert_close(pk.b11[:hid], p.fc11_bias.float(), atol=0,
                               rtol=0)
    torch.testing.assert_close(pk.b12[:hid], p.fc12_bias.float(), atol=0,
                               rtol=0)
    assert not pk.b11[hid:].any() and not pk.b12[hid:].any()


# ---------------------------------------------------------------------------
# the replay against the plain versions and the Pallas kernels
# ---------------------------------------------------------------------------

REPLAY_CASES = [  # (mutual, wd, C, nh, (d, h, w), shift)
    (True, 2, 24, 2, (4, 16, 16), (1, 4, 4)),
    (True, 2, 24, 2, (2, 16, 16), (0, 0, 0)),
    (True, 2, 120, 6, (2, 8, 16), (1, 4, 4)),
    (False, 1, 24, 2, (2, 16, 16), (0, 4, 4)),
    (False, 2, 24, 2, (4, 16, 16), (1, 4, 4)),
    (False, 6, 24, 2, (6, 16, 16), (3, 4, 4)),
    (False, 8, 180, 6, (8, 8, 8), (4, 4, 4)),
]


def _pallas(x, wt, c, nh, wd, shift, mutual):
    """JAX's Pallas kernel in interpret mode on the same inputs, as
    tests/test_torch_vrt_kernels.py runs it."""
    _, d, h, w, _ = x.shape
    shifted = any(shift)
    pats = tmsa_mask_patterns(d, h, w, (wd, 8, 8), shift) if shifted else None
    xin = _jroll(jnp.asarray(x), tuple(-s for s in shift))
    if mutual:
        flat = tuple(jnp.asarray(wt[k]) for k in (
            "qkv_s_k", "qkv_s_b", "qkv_m_k", "qkv_m_b", "proj_k", "proj_b",
            "ln1s", "ln1b", "ln2s", "ln2b", "fc11k", "fc11b", "fc12k", "fc12b",
            "fc2k", "fc2b"))
        pos = window3d.sine_position_encoding(8, 8, c // 2)
        bs, bm = make_tmsa_biases(jnp.asarray(wt["table"]),
                                  j_rel_index(2, 8, 8)[:128, :128], nh, pats)
        pos2 = jnp.asarray(np.concatenate([pos, pos]))
        want = tmsa_block_pallas(xin, flat, pos2, nh, bs, bm, shifted,
                                 interpret=True)
    else:
        flat = tuple(jnp.asarray(wt[k]) for k in (
            "qkv_s_k", "qkv_s_b", "proj_k", "proj_b", "ln1s", "ln1b", "ln2s",
            "ln2b", "fc11k", "fc11b", "fc12k", "fc12b", "fc2k", "fc2b"))
        rel = js6.make_self6_rel(jnp.asarray(wt["table"]), nh, wd)
        want = js6.self6_block_pallas(xin, flat, nh, rel, pats, shifted,
                                      interpret=True, wd=wd)
    return np.asarray(_jroll(want, shift))


@pytest.mark.parametrize("mutual,wd,c,nh,dhw,shift", REPLAY_CASES)
def test_replay_matches_plain_and_pallas(mutual, wd, c, nh, dhw, shift):
    """The kernels' arithmetic, f32, against the plain version (the
    composed block; the limit, 1e-5 of max|ref|, covers f32 sums in another
    order and the online softmax's rescaling, at C=180 on scores of order
    100) and against the Pallas kernel (1e-4 of max|ref|: its softmax and
    sums run in another order, in f32)."""
    x = _x((1, *dhw, c), 21)
    wt = block_weights(c, nh, wd, mutual, 22)
    p = torch_params(wt, c)
    pk = pack_win3d_stages(p, nh, F32)
    labels = labels_on(dhw, (wd, 8, 8), shift, "cpu")
    got = emulate_win3d_wgmma(torch.from_numpy(x), pk, nh, wd, wd, shift,
                              labels, mutual)
    want = (tmsa_block.tmsa_block_reference(torch.from_numpy(x), p, nh, shift)
            if mutual else self6_block.self6_block_reference(
                torch.from_numpy(x), p, nh, wd, shift))
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    jax_out = torch.from_numpy(_pallas(x, wt, c, nh, wd, shift, mutual))
    torch.testing.assert_close(got, jax_out, atol=1e-4 * scale, rtol=0)


# ---------------------------------------------------------------------------
# the layout at the presets' geometries, the walks, the refusals
# ---------------------------------------------------------------------------

# VRT's presets (cli/test_video.py): TMSA blocks at C 96 and 120 on (2,8,8);
# self blocks at C 96, 120 and 180, windows 1, 2, 4, 6 and 8 deep, with
# the module's table depth 4, 6 or 8 (1 for stage 8's per-frame blocks)
PRESET_GEOMETRIES = (
    [(True, c, 2, 2) for c in (96, 120)]
    + [(False, c, wd, twd) for c in (96, 120, 180) for twd in (4, 6, 8)
       for wd in (1, 2, 4, 6, 8) if wd <= twd]
    + [(False, c, 1, 1) for c in (96, 120, 180)])


@pytest.mark.parametrize("mutual,c,wd,twd", PRESET_GEOMETRIES)
def test_layout_fits_every_preset_geometry(mutual, c, wd, twd):
    pl = win3d_plan(mutual, c, 6, 2 * c, wd, twd)
    assert pl.fits
    assert max(pl.smem1, pl.smem2, pl.smem3) + win3d.STATIC_SMEM <= SMEM_LIMIT
    # every stage fits its ring slot; the slots are whole 1024-byte atoms
    rows1, rows3 = stage_rows(pl, 6)
    assert max(rows1) * 128 <= pl.slot1 and max(rows3) * 128 <= pl.slot3
    assert pl.slot1 % 1024 == 0 and pl.slot3 % 1024 == 0


def test_layout_pinned_at_vrt001():
    """VRT-001's two blocks: the TMSA block at C=120 (NT 120, q/k at 32, v at
    24) and stage 8's self block at C=180, wd 6 (NT 184, 32, 32)."""
    assert win3d_plan(True, 120, 6, 240, 2, 2) == (
        120, 32, 24, 1056, 240, 2, 4, 4, 4, 12, 16, 22528, 16384, 178368,
        33024, 105408, True)
    assert win3d_plan(False, 180, 6, 360, 6, 6) == (
        184, 32, 32, 576, 180, 3, 3, 6, 4, 9, 27, 24576, 23552, 205632,
        61696, 152512, True)


@pytest.mark.parametrize("items", [1, 6, 131, 132, 133, 263, 264, 265, 3072])
def test_item_walk_covers_every_item_once(items):
    walk = win3d.item_walk(items, 132)
    got = sorted(i for blk in walk for pair in blk for i in pair if i >= 0)
    assert got == list(range(items))
    assert len(walk) <= 132
    if items <= 132:                    # a small map: one item a block
        assert all(len(blk) == 1 and blk[0][1] == -1 for blk in walk)


@pytest.mark.parametrize("b,d,h,w,wd", [(1, 6, 64, 64, 6), (2, 2, 8, 24, 2),
                                        (1, 8, 16, 8, 8), (3, 3, 8, 8, 1)])
def test_attn_blocks_cover_every_window_head_once(b, d, h, w, wd):
    blocks = win3d.attn_blocks(b, d, h, w, wd, 6)
    want = set(itertools.product(range(b), range(d // wd), range(h // 8),
                                 range(w // 8), range(6)))
    assert len(blocks) == len(want) and set(blocks) == want


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """What the WMMA kernels took and these do not: C above 184, an odd
    head count, a head dim past its class's v width, a TMSA block above
    C=120; and a pack that is not the plan's."""
    def geom(c, nh, mutual=False, wd=2):
        x = torch.zeros(1, 2, 8, 8, c, dtype=torch.bfloat16)
        p = torch_params(block_weights(c, nh, 2, mutual, 0), c)
        win3d.check_geometry("win3d", x, p, nh, wd, mutual=mutual)

    geom(120, 6)
    with pytest.raises(ValueError, match="C <= 184"):
        geom(192, 6)
    with pytest.raises(ValueError, match="even number of heads"):
        geom(120, 5)
    with pytest.raises(ValueError, match="head dim of at most 16"):
        geom(96, 4)
    with pytest.raises(ValueError, match="mutual block"):
        geom(180, 6, mutual=True)
    x = torch.zeros(1, 2, 8, 8, 24, dtype=torch.bfloat16)
    p = torch_params(block_weights(24, 2, 2, True, 0), 24)
    pk = pack_win3d_stages(p, 2, F32)
    pl = win3d_plan(True, 24, 2, pk.hidden, 2, 2)
    with pytest.raises(ValueError, match="weight stages"):
        win3d._check_pack("tmsa_block", x, pk, pl, 2, True)
    pk = pack_win3d_stages(p, 2)
    win3d._check_pack("tmsa_block", x, pk, pl, 2, True)
    with pytest.raises(ValueError, match="sine position"):
        win3d._check_pack("tmsa_block", x, pk._replace(pos=None), pl, 2, True)
