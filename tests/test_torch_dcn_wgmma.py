"""VRT's DCNv2 kernel on wgmma (csrc/dcn_block.cu), its host side on the
CPU: the weight stages against ``deform_weight_matrix``, a replay of the
kernel's algorithm from those stages against the plain version and JAX's
``dcn_fused`` in interpret mode, the tile × split plan at VRT-001's map
sizes, and the wrapper's refusals. The kernel itself runs only on the card
(chip_smoke.py phases 15-16).

The replay, in f32: per (pixel, tap) the tap table (the in-frame test,
four corner indices, −1 outside the frame, and the bilinear weights times
the mask), per chunk the column tile (each sample the corners' weighted
sum, optionally rounded to bf16 as the kernel rounds its operand), its product
with the unpacked stage, per block of the walk the sum over its split's
chunks, and the splits summed in order plus the bias. Without the rounding
it is held to the plain version at 1e-5 of max|ref| (f32 sums in another
order) and to JAX's kernel at 1e-4 of max|ref| (its sample matmul sums in
another order); with it, to the plain version at 1e-2 of max|ref|, the
card's limit (chip_smoke.py phase 15), which bf16 columns meet with room.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kair_tpu.ops.pallas.dcn_block import dcn_fused as j_dcn_fused
from kair_tpu_torch.ops import warp
from kair_tpu_torch.ops.kernels import dcn_block
from kair_tpu_torch.ops.kernels._build import SMEM_LIMIT
from kair_tpu_torch.ops.kernels.dcn_block import (dcn_chunks, dcn_plan,
                                                  dcn_splits, dcn_walk,
                                                  pack_dcn_weight, unstage)

F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (the suite runs several
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def stages(pk: torch.Tensor, cin: int, cout: int, dg: int) -> list:
    """The flat stages → per (group, chunk) the (kw, NP) matrix B[k, n]."""
    pl = dcn_plan(cin, cout, dg)
    out, off = [], 0
    for _ in range(dg):
        for ck in dcn_chunks(cin, dg):
            n = ck.kw * pl.np
            out.append(unstage(pk[off:off + n], ck.kw, pl.np))
            off += n
    assert off == pk.numel() == dg * pl.group_elems
    return out


# ---------------------------------------------------------------------------
# the weight stages
# ---------------------------------------------------------------------------

# VRT's presets (cli/test_video.py; Cin = dim·pa_frames/2): 001 cg 10, 002
# cg 15 at 24 groups, 003-004 cg 15, 005-008 cg 6; a small odd one; a group
# wider than a chunk (channel blocks); nine taps over two chunks
PACK_GEOMETRIES = [(120, 120, 12), (360, 120, 24), (240, 120, 16),
                   (96, 96, 16), (21, 70, 3), (300, 200, 1), (40, 250, 2)]


@pytest.mark.parametrize("cin,cout,dg", PACK_GEOMETRIES)
def test_stage_pack_gives_back_the_matrix(cin, cout, dg):
    """Unswizzled, each chunk's stage holds its (tap, channel) rows of
    ``deform_weight_matrix``, tap-major, zero past them and past Cout;
    together the stages hold every row once."""
    weight = torch.from_numpy(np.random.RandomState(cin + dg).randn(
        cout, cin, 3, 3).astype(np.float32))
    wm = warp.deform_weight_matrix(weight, dg)
    pk = pack_dcn_weight(weight, dg, F32)
    cg, seen = cin // dg, []
    it = iter(stages(pk, cin, cout, dg))
    for g in range(dg):
        for ck in dcn_chunks(cin, dg):
            b = next(it)
            rows = [(g * 9 + t) * cg + c for t in range(ck.t0, ck.t0 + ck.ntap)
                    for c in range(ck.c0, ck.c0 + ck.csz)]
            torch.testing.assert_close(b[:len(rows), :cout], wm[rows],
                                       atol=0, rtol=0)
            assert not b[len(rows):].any() and not b[:, cout:].any()
            assert ck.kw % 16 == 0 and len(rows) <= ck.kw <= dcn_block.KMAX
            seen += rows
    assert sorted(seen) == list(range(9 * cin))
    # bf16, the kernel's operand, packs the same values rounded
    torch.testing.assert_close(pack_dcn_weight(weight, dg).float(),
                               pk.to(torch.bfloat16).float(), atol=0, rtol=0)


def test_chunks_at_the_presets():
    """One chunk a group, all nine taps, at cg 10 and 6 (96 and 64 columns:
    90 and 54 padded to 16); two at cg 15, six taps (90 → 96) and three
    (45 → 48); so every preset's ring slot is 96 columns at most."""
    for cin, dg, kw in ((120, 12, 96), (96, 16, 64)):
        assert dcn_chunks(cin, dg) == (dcn_block.Chunk(0, cin // dg, 0, 9, kw),)
    for cin, dg in ((360, 24), (240, 16)):
        assert dcn_chunks(cin, dg) == (dcn_block.Chunk(0, 15, 0, 6, 96),
                                       dcn_block.Chunk(0, 15, 6, 3, 48))
    assert dcn_plan(120, 120, 12) == (10, 9, 1, 96, 128, 12288, 24576, 84240)
    # a group of 20 channels: 4, 4 and 1 taps (80, 80 and 20 → 32 columns)
    assert [tuple(c) for c in dcn_chunks(40, 2)] == [
        (0, 20, 0, 4, 80), (0, 20, 4, 4, 80), (0, 20, 8, 1, 32)]


# ---------------------------------------------------------------------------
# the replay
# ---------------------------------------------------------------------------

def tap_table(off, mask, h, w, dg):
    """Per (image, pixel, group, tap): the four corners' pixel indices (−1
    outside the frame; all −1 for a tap outside (−1, H) x (−1, W)) and their
    bilinear weights times the mask, as the kernel decodes a tap once."""
    n = off.shape[0]
    o = off.reshape(n, h * w, dg, 9, 2)
    pix = torch.arange(h * w)
    py, px = (pix // w).view(1, -1, 1, 1), (pix % w).view(1, -1, 1, 1)
    tap = torch.arange(9).view(1, 1, 1, 9)
    fy = (py - 1 + tap // 3).float() + o[..., 0]
    fx = (px - 1 + tap % 3).float() + o[..., 1]
    inside = (fy > -1) & (fy < h) & (fx > -1) & (fx < w)
    m = mask.reshape(n, h * w, dg, 9)
    y0, x0 = torch.floor(fy), torch.floor(fx)
    ly, lx = fy - y0, fx - x0
    y0, x0 = y0.long(), x0.long()
    idx, wts = [], []
    for dy, dx, wt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                       (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        yc, xc = y0 + dy, x0 + dx
        ok = inside & (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        idx.append(torch.where(ok, yc * w + xc, torch.full_like(yc, -1)))
        wts.append(wt * m)
    return idx, wts


def emulate_dcn(x, off, mask, pk, bias, dg, cout, sms, round_bf16):
    """csrc/dcn_block.cu's algorithm in PyTorch, f32, from its stages."""
    n, h, w, cin = x.shape
    cg, hw = cin // dg, h * w
    pl = dcn_plan(cin, cout, dg)
    chunks = dcn_chunks(cin, dg)
    st = stages(pk, cin, cout, dg)
    idx, wts = tap_table(off, mask, h, w, dg)
    xf = x.reshape(n, hw, cin)
    bi = torch.arange(n).view(n, 1, 1)

    def columns(g, ck):
        """(N, HW, kw): the chunk's columns, (tap, channel) tap-major."""
        cols = torch.zeros(n, hw, ck.ntap, ck.csz)
        for t in range(ck.ntap):
            ch = g * cg + ck.c0 + torch.arange(ck.csz)
            v = torch.zeros(n, hw, ck.csz)
            for i, wt in zip(idx, wts):
                it = i[:, :, g, ck.t0 + t]
                corner = xf[bi, it.clamp(min=0)[..., None], ch]
                v = v + torch.where((it >= 0)[..., None],
                                    wt[:, :, g, ck.t0 + t, None] * corner, 0.0)
            cols[:, :, t] = v
        cols = cols.reshape(n, hw, -1)
        if round_bf16:
            cols = cols.to(torch.bfloat16).float()
        return F.pad(cols, (0, ck.kw - cols.shape[-1]))

    q_all = dg * len(chunks)
    contrib = []                       # per chunk over all groups: (N·HW, NP)
    for q in range(q_all):
        g, ck = divmod(q, len(chunks))
        contrib.append((columns(g, chunks[ck]) @ st[q]).reshape(n * hw, -1))
    tiles, splits = dcn_splits(n, h, w, cin, dg, sms)
    tpi = -(-hw // dcn_block.ROWS)
    part = torch.full((splits, n * hw, pl.np), float("nan"))
    for tile, split, qs in dcn_walk(n, h, w, cin, dg, sms):
        img, t = divmod(tile, tpi)
        rows = slice(img * hw + t * dcn_block.ROWS,
                     img * hw + min(hw, (t + 1) * dcn_block.ROWS))
        acc = torch.zeros(rows.stop - rows.start, pl.np)
        for q in qs:
            acc = acc + contrib[q][rows]
        part[split, rows] = acc
    out = part[0]
    for s in range(1, splits):
        out = out + part[s]
    return (out[:, :cout] + bias).reshape(n, h, w, cout)


def dcn_case(n, h, w, cin, cout, dg, seed):
    rng = np.random.RandomState(seed)
    # bf16-representable x: the kernel's input type
    x = torch.from_numpy(rng.rand(n, h, w, cin).astype(np.float32)).to(
        torch.bfloat16).float()
    # offsets up to ±3 px: taps land outside the frame and between pixels
    off = torch.from_numpy((rng.rand(n, h, w, dg * 18) * 6 - 3).astype(np.float32))
    mask = torch.sigmoid(torch.from_numpy(rng.randn(n, h, w, dg * 9).astype(
        np.float32)))
    weight = torch.from_numpy((rng.randn(cout, cin, 3, 3) * 0.2).astype(
        np.float32))
    bias = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32))
    return x, off, mask, weight, bias


# (N, H, W, Cin, Cout, dg, SMs): ragged last tiles, splits of one and of two
# chunks, two images, odd cg, two chunks a group, two column tiles with a
# ragged second, Cout past 128 (a warpgroup's second tile)
REPLAY_CASES = [(2, 12, 20, 24, 72, 3, 16), (1, 8, 10, 12, 8, 3, 132),
                (1, 9, 15, 15, 64, 1, 4), (1, 10, 12, 40, 150, 2, 132),
                (2, 8, 8, 30, 20, 6, 8)]


@pytest.mark.parametrize("n,h,w,cin,cout,dg,sms", REPLAY_CASES)
def test_replay_matches_plain_and_pallas(n, h, w, cin, cout, dg, sms):
    x, off, mask, weight, bias = dcn_case(n, h, w, cin, cout, dg, n + cin)
    pk = pack_dcn_weight(weight, dg, F32)
    want = dcn_block.dcn_reference(x, off, mask, weight, bias, dg)
    scale = float(want.abs().max())
    got = emulate_dcn(x, off, mask, pk, bias, dg, cout, sms, False)
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    hwio = jnp.asarray(weight.numpy().transpose(2, 3, 1, 0))
    jax_out = torch.from_numpy(np.asarray(j_dcn_fused(
        jnp.asarray(x.numpy()), jnp.asarray(off.numpy()),
        jnp.asarray(mask.numpy()), hwio, 1, 1, 1, dg, 256, True))) + bias
    torch.testing.assert_close(got, jax_out, atol=1e-4 * scale, rtol=0)
    # the kernel's bf16 operand, within the card's limit of the plain version
    rounded = emulate_dcn(x, off, mask, pk, bias, dg, cout, sms, True)
    err = float((rounded - want).abs().max())
    assert 0 < err <= 1e-2 * scale
    # taps outside the frame happened, and the offsets move the result
    fy = torch.arange(h)[None, :, None, None] - 1 + off[..., 0::2]
    assert (fy <= -1).any() and (fy >= h).any()
    still = dcn_block.dcn_reference(x, torch.zeros_like(off), mask, weight,
                                    bias, dg)
    assert float((still - want).abs().max()) > 0.1 * scale


# ---------------------------------------------------------------------------
# the tile × split plan, the refusals
# ---------------------------------------------------------------------------

# VRT-001 (Cin 120, dg 12) at its four map sizes: (tiles, splits) at N = 1
# and N = 8 on an H100's 132 SMs
VRT001_SPLITS = {(64, 1): (64, 3), (32, 1): (16, 6), (16, 1): (4, 12),
                 (8, 1): (1, 12), (64, 8): (512, 1), (32, 8): (128, 2),
                 (16, 8): (32, 4), (8, 8): (8, 12)}


@pytest.mark.parametrize("size,n", list(VRT001_SPLITS))
def test_plan_covers_every_tile_and_group_once(size, n):
    """Every (tile, group) of VRT-001's call once, over the walk's blocks;
    the splits as even as they go, and no more of them than needed for the
    tiles to cover the card with each block's chunks fewest."""
    cin, dg, sms = 120, 12, 132
    tiles, splits = dcn_splits(n, size, size, cin, dg, sms)
    assert (tiles, splits) == VRT001_SPLITS[(size, n)]
    walk = dcn_walk(n, size, size, cin, dg, sms)
    assert len(walk) == tiles * splits
    cpg = len(dcn_chunks(cin, dg))
    got = sorted((t, q // cpg, q % cpg) for t, _, qs in walk for q in qs)
    assert got == [(t, g, 0) for t in range(tiles) for g in range(dg)]
    per = [len(qs) for _, _, qs in walk]
    assert min(per) >= 1 and max(per) - min(per) <= 1
    # fewest chunks a block that at least min(SMs, tiles x groups) blocks allow
    least = -(-dg // min(dg, -(-sms // tiles)))
    assert max(per) == least


SUPPORTED = [(1, 1, 1), (120, 120, 12), (360, 120, 24), (1024, 256, 1),
             (145, 256, 1), (256, 1, 256), (63, 255, 7)]


@pytest.mark.parametrize("cin,cout,dg", SUPPORTED)
def test_plan_fits_every_supported_shape(cin, cout, dg):
    """Every shape ``dcn_supported`` takes has a plan within the card's
    shared memory, chunks of at most KMAX columns covering 9·Cin once."""
    assert dcn_block.dcn_supported(cin, (cout, cin, 3, 3), 1, 1, 1, dg)
    pl = dcn_plan(cin, cout, dg)
    assert pl.smem <= SMEM_LIMIT
    chunks = dcn_chunks(cin, dg)
    assert max(c.kw for c in chunks) == pl.kmax <= dcn_block.KMAX
    assert dg * sum(c.ntap * c.csz for c in chunks) == 9 * cin
    assert pl.group_elems == sum(c.kw for c in chunks) * pl.np


def test_wrapper_refuses_what_the_kernel_does_not_take():
    assert not dcn_block.dcn_supported(12, (8, 12, 3, 3), 2, 1, 1, 3)
    assert not dcn_block.dcn_supported(12, (300, 12, 3, 3), 1, 1, 1, 3)
    assert not dcn_block.dcn_supported(12, (8, 12, 3, 3), 1, 1, 1, 5)
    assert not dcn_block.dcn_supported(12, (8, 12, 5, 5), 1, 2, 1, 3)
    assert dcn_block.dcn_supported(120, (120, 120, 3, 3), 1, 1, 1, 12)
    x, off, mask, weight, bias = dcn_case(1, 8, 8, 12, 8, 3, 0)
    xb = x.to(torch.bfloat16)
    dcn_block._check(xb, off, mask, weight, bias, 3)
    with pytest.raises(TypeError):
        dcn_block._check(x, off, mask, weight, bias, 3)
    with pytest.raises(ValueError, match="offset"):
        dcn_block._check(xb, off.double(), mask, weight, bias, 3)
    with pytest.raises(ValueError, match="mask"):
        dcn_block._check(xb, off, mask[..., :9], weight, bias, 3)
    with pytest.raises(ValueError, match="does not take"):
        dcn_block._check(xb, off, mask, weight[:, :6], bias, 3)
    pk = pack_dcn_weight(weight, 3)
    pl = dcn_plan(12, 8, 3)
    dcn_block._check_packed(pk, xb, pl, 3)
    for bad in (pk.float(), pk[:-8], pk[8:]):
        with pytest.raises(ValueError, match="packed"):
            dcn_block._check_packed(bad, xb, pl, 3)
