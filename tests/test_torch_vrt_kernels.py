"""The port's three VRT kernels on the CPU, f32: their plain versions
against the JAX Pallas kernels in interpret mode, replays of the CUDA
kernels' packed layouts, and the shared-memory arithmetic.

* ``tmsa_block`` (plain version) against ``tmsa_block_pallas`` at
  1x4x16x16, C=24, 2 heads, shifted (1, 4, 4) and not; ``self6_block``
  against ``self6_block_pallas`` at wd 6, 2 and 1, shifted and not, and on
  the w-chunked grid (``_token_budget`` patched as tests/test_pallas_self6.py
  does); ``dcn_fused`` against JAX's ``dcn_fused`` and its composed gather
  route, with taps outside the frame. atol 1e-4. The Pallas bodies use the
  A&S GELU (~1.5e-7), a max-free softmax, folded LN affines, and keep the
  score bias in bf16, so the tables here hold bf16-representable values.
* Replays in PyTorch of the CUDA kernels' passes on their packed operands
  (the shift folded into the window indices, the bias gathered from the
  table, the mask from region labels, 64-key tiles with an online softmax;
  the DCN's (group, tap, channel) columns) against the plain versions,
  atol 1e-4. The kernels themselves run only on the card (chip_smoke.py
  phases 13-15).
"""

import contextlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.self6_block as js6
from kair_tpu.models.vrt import rel_position_index_3d as j_rel_index
from kair_tpu.ops.pallas.dcn_block import dcn_fused as j_dcn_fused
from kair_tpu.ops.pallas.tmsa_block import (make_tmsa_biases,
                                            tmsa_block_pallas,
                                            tmsa_mask_patterns)
from kair_tpu.ops.warp import modulated_deform_conv as j_mdc
from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels import dcn_block, self6_block, tmsa_block, win3d
from kair_tpu_torch.ops.kernels.win3d import labels_on, pack_win3d, shared_bytes
from kair_tpu_torch.ops.kernels.window_msa import SMEM_LIMIT
from kair_tpu_torch.ops.window3d import Tmsa3dParams

ATOL = 1e-4
C, NH = 24, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the suite runs six workers on
    the machine's cores, and eight threads each made these tests several
    times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bf16_exact(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def block_weights(c, nh, twd, mutual, seed):
    """Seeded weights in the JAX layout (kernels (in, out)), scaled so the
    softmax is far from uniform and every term moves the output."""
    rng = np.random.RandomState(seed)
    n = lambda *s, k=1.0: (rng.randn(*s) * k).astype(np.float32)
    hid = 2 * c
    w = dict(qkv_s_k=n(c, 3 * c, k=0.3), qkv_s_b=n(3 * c, k=0.1),
             proj_k=n((2 if mutual else 1) * c, c, k=0.2), proj_b=n(c, k=0.1),
             ln1s=1 + n(c, k=0.1), ln1b=n(c, k=0.1), ln2s=1 + n(c, k=0.1),
             ln2b=n(c, k=0.1), fc11k=n(c, hid, k=0.2), fc11b=n(hid, k=0.1),
             fc12k=n(c, hid, k=0.2), fc12b=n(hid, k=0.1), fc2k=n(hid, c, k=0.2),
             fc2b=n(c, k=0.1),
             table=_bf16_exact(n((2 * twd - 1) * 225, nh)))
    if mutual:
        w.update(qkv_m_k=n(c, 3 * c, k=0.3), qkv_m_b=n(3 * c, k=0.1))
    return w


def torch_params(w, c) -> Tmsa3dParams:
    t = lambda k: torch.from_numpy(np.ascontiguousarray(w[k]))
    tt = lambda k: torch.from_numpy(np.ascontiguousarray(w[k].T))
    mutual = "qkv_m_k" in w
    return Tmsa3dParams(
        tt("qkv_s_k"), t("qkv_s_b"), tt("qkv_m_k") if mutual else None,
        t("qkv_m_b") if mutual else None, tt("proj_k"), t("proj_b"),
        t("table"),
        torch.from_numpy(window3d.sine_position_encoding(8, 8, c // 2))
        if mutual else None,
        t("ln1s"), t("ln1b"), t("ln2s"), t("ln2b"), tt("fc11k"), t("fc11b"),
        tt("fc12k"), t("fc12b"), tt("fc2k"), t("fc2b"))


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jroll(a, s):
    return jnp.roll(a, s, axis=(1, 2, 3))


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 4, 4)])
def test_tmsa_plain_matches_pallas(shift):
    d, h, w = 4, 16, 16
    x = _x((1, d, h, w, C), 1)
    wt = block_weights(C, NH, 2, True, 2)
    flat = tuple(jnp.asarray(wt[k]) for k in (
        "qkv_s_k", "qkv_s_b", "qkv_m_k", "qkv_m_b", "proj_k", "proj_b",
        "ln1s", "ln1b", "ln2s", "ln2b", "fc11k", "fc11b", "fc12k", "fc12b",
        "fc2k", "fc2b"))
    pos = window3d.sine_position_encoding(8, 8, C // 2)
    pos2 = jnp.asarray(np.concatenate([pos, pos]))
    shifted = any(shift)
    pats = tmsa_mask_patterns(d, h, w, (2, 8, 8), shift) if shifted else None
    bs, bm = make_tmsa_biases(jnp.asarray(wt["table"]),
                              j_rel_index(2, 8, 8)[:128, :128], NH, pats)
    xin = _jroll(jnp.asarray(x), tuple(-s for s in shift))
    want = tmsa_block_pallas(xin, flat, pos2, NH, bs, bm, shifted,
                             interpret=True)
    want = np.asarray(_jroll(want, shift))
    got = tmsa_block.tmsa_block(torch.from_numpy(x), torch_params(wt, C), NH,
                                shift).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


SELF_CASES = [  # (wd, (d, h, w), shift, token budget or None)
    (6, (6, 16, 16), (0, 0, 0), None), (6, (6, 16, 16), (0, 4, 4), None),
    (6, (12, 16, 16), (3, 4, 4), None),
    (2, (2, 16, 16), (0, 4, 4), None), (2, (4, 16, 16), (1, 0, 0), None),
    (1, (3, 16, 24), (0, 4, 4), None), (1, (2, 16, 16), (0, 0, 0), None),
    (6, (6, 16, 32), (0, 4, 4), 384), (6, (6, 16, 32), (0, 0, 0), 384),
]


@pytest.mark.parametrize("wd,dhw,shift,budget", SELF_CASES)
def test_self6_plain_matches_pallas(wd, dhw, shift, budget):
    d, h, w = dhw
    x = _x((1, d, h, w, C), 3)
    wt = block_weights(C, NH, wd, False, 4)
    flat = tuple(jnp.asarray(wt[k]) for k in (
        "qkv_s_k", "qkv_s_b", "proj_k", "proj_b", "ln1s", "ln1b", "ln2s",
        "ln2b", "fc11k", "fc11b", "fc12k", "fc12b", "fc2k", "fc2b"))
    shifted = any(shift)
    pats = tmsa_mask_patterns(d, h, w, (wd, 8, 8), shift) if shifted else None
    rel = js6.make_self6_rel(jnp.asarray(wt["table"]), NH, wd)
    xin = _jroll(jnp.asarray(x), tuple(-s for s in shift))
    patch = (mock.patch.object(js6, "_token_budget", lambda c: budget)
             if budget else contextlib.nullcontext())
    with patch:
        want = js6.self6_block_pallas(xin, flat, NH, rel, pats, shifted,
                                      interpret=True, wd=wd)
    want = np.asarray(_jroll(want, shift))
    got = self6_block.self6_block(torch.from_numpy(x), torch_params(wt, C),
                                  NH, wd, shift).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def dcn_inputs(n=1, h=8, w=10, cin=12, cout=8, dg=3, seed=5):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, h, w, cin).astype(np.float32)
    # offsets up to ±3 px: taps land outside the frame and between pixels
    off = (rng.rand(n, h, w, dg * 18) * 6 - 3).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(n, h, w, dg * 9)))).astype(np.float32)
    weight = (rng.randn(cout, cin, 3, 3) * 0.2).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, off, mask, weight, bias


def test_dcn_plain_matches_pallas_and_gather():
    x, off, mask, weight, bias, dg = *dcn_inputs(), 3
    hwio = jnp.asarray(weight.transpose(2, 3, 1, 0))
    fused = np.asarray(j_dcn_fused(jnp.asarray(x), jnp.asarray(off),
                                   jnp.asarray(mask), hwio, 1, 1, 1, dg, 256,
                                   True)) + bias
    gather = np.asarray(j_mdc(jnp.asarray(x), jnp.asarray(off),
                              jnp.asarray(mask), hwio, jnp.asarray(bias),
                              deformable_groups=dg, impl="gather"))
    got = dcn_block.dcn_fused(*map(torch.from_numpy, (x, off, mask, weight,
                                                      bias)), dg).numpy()
    np.testing.assert_allclose(got, fused, atol=ATOL)
    np.testing.assert_allclose(got, gather, atol=ATOL)
    # taps outside the frame did happen, and the offsets move the result
    fy = np.arange(8)[None, :, None, None] - 1 + off[..., 0::2]
    assert (fy < -1).any() and (fy > 8).any()
    plain = dcn_block.dcn_fused(*map(torch.from_numpy, (
        x, np.zeros_like(off), mask, weight, bias)), dg).numpy()
    assert np.abs(plain - got).max() > 0.1


# ---------------------------------------------------------------------------
# replays of the CUDA kernels' passes on their packed operands
# ---------------------------------------------------------------------------

def emulate_win3d(x, pk, nh, wd, twd, shift, labels, mutual):
    """csrc/window3d_block.cu's three passes in PyTorch, f32: per-pixel passes 1
    and 3, pass 2 per (window, head, 64-query tile) with the shift folded
    into the indices and an online softmax over 64-key tiles; pass 3's MLP
    is the GEGLU, or the plain fc1 → GELU of a pack without fc12."""
    b, d, h, w, c = x.shape
    xf = x.reshape(-1, c)
    qw, p = nh * 96, 2 if mutual else 1
    hn = F.layer_norm(xf, (c,), pk.ln1[0], pk.ln1[1], 1e-5)
    hpad = F.pad(hn, (0, pk.wqkv_s.shape[0] - c))
    qkv = [hpad @ pk.wqkv_s + pk.bqkv_s]
    if mutual:
        yy = torch.arange(h)[None, :, None].expand(d, h, w).reshape(-1)
        xx = torch.arange(w)[None, None, :].expand(d, h, w).reshape(-1)
        loc = (((yy - shift[1]) % h) % 8) * 8 + ((xx - shift[2]) % w) % 8
        hm = F.pad(hn + pk.pos[loc.repeat(b)], (0, pk.wqkv_m.shape[0] - c))
        qkv.append(hm @ pk.wqkv_m + pk.bqkv_m)
    qkv = torch.cat(qkv, 1)
    att = torch.zeros(xf.shape[0], p * nh * 32)
    n = wd * 64
    t = torch.arange(n)
    td, ty, tx = t // 64, t // 8 % 8, t % 8
    rel_idx = ((td[:, None] - td[None] + twd - 1) * 225
               + (ty[:, None] - ty[None] + 7) * 15 + (tx[:, None] - tx[None] + 7))
    nwd, nwh, nww = d // wd, h // 8, w // 8
    for bi in range(b):
        for wi in range(nwd):
            for wj in range(nwh):
                for wk in range(nww):
                    pix = ((bi * d + (wi * wd + td + shift[0]) % d) * h
                           + (wj * 8 + ty + shift[1]) % h) * w \
                        + (wk * 8 + tx + shift[2]) % w
                    lab = None
                    if labels is not None:
                        lab = labels[4 * (wi == nwd - 1) + 2 * (wj == nwh - 1)
                                     + (wk == nww - 1)]
                    for head in range(nh):
                        tiles = [(False, qt, qt, range(wd)) for qt in range(wd)]
                        if mutual:
                            tiles += [(True, f, 1 - f, [f]) for f in range(2)]
                        for mut, out_t, q_t, key_tiles in tiles:
                            col = (qw if mut else 0) + head * 96
                            qi = q_t * 64 + torch.arange(64)
                            q = qkv[pix[qi], col:col + 32]
                            m_run = torch.full((64,), -1e30)
                            l_run = torch.zeros(64)
                            o = torch.zeros(64, 32)
                            for kt in key_tiles:
                                kj = kt * 64 + torch.arange(64)
                                k = qkv[pix[kj], col + 32:col + 64]
                                v = qkv[pix[kj], col + 64:col + 96]
                                s = q @ k.t()
                                if mut:
                                    if lab is not None:
                                        l64 = lab[:64]
                                        s = s - 100.0 * (l64[:, None] != l64[None])
                                else:
                                    s = s + pk.rel_table[rel_idx[qi][:, kj], head]
                                    if lab is not None:
                                        s = s - 100.0 * (lab[qi][:, None]
                                                         != lab[kj][None])
                                mx = torch.maximum(m_run, s.max(1).values)
                                corr = torch.exp(m_run - mx)
                                e = torch.exp(s - mx[:, None])
                                l_run = l_run * corr + e.sum(1)
                                o = o * corr[:, None] + e @ v
                                m_run = mx
                            acol = (nh * 32 if mutual and not mut else 0) \
                                + head * 32
                            oi = out_t * 64 + torch.arange(64)
                            att[pix[oi], acol:acol + 32] = o / l_run[:, None]
    x1 = xf + (att @ pk.wp)[:, :c] + pk.bp
    z = F.pad(F.layer_norm(x1, (c,), pk.ln2[0], pk.ln2[1], 1e-5),
              (0, pk.w11.shape[0] - c))
    u = z @ pk.w11 + pk.b11
    hid = F.gelu(u) if pk.w12 is None else F.gelu(u) * (z @ pk.w12 + pk.b12)
    return (x1 + (hid @ pk.w2)[:, :c] + pk.b2).reshape(x.shape)


REPLAY_CASES = [  # (mutual, wd, twd, (d, h, w), shift)
    (True, 2, 2, (4, 16, 16), (0, 0, 0)), (True, 2, 2, (4, 16, 24), (1, 4, 4)),
    (False, 6, 6, (6, 16, 16), (0, 4, 4)), (False, 2, 6, (2, 16, 16), (0, 4, 4)),
    (False, 1, 1, (2, 16, 16), (0, 4, 4)),
]


@pytest.mark.parametrize("mutual,wd,twd,dhw,shift", REPLAY_CASES)
def test_win3d_kernel_layout_matches_plain(mutual, wd, twd, dhw, shift):
    x = torch.from_numpy(_x((1, *dhw, C), 6))
    p = torch_params(block_weights(C, NH, twd, mutual, 7), C)
    pk = pack_win3d(p, NH, torch.float32)
    labels = labels_on(dhw, (wd, 8, 8), shift, "cpu")
    got = emulate_win3d(x, pk, NH, wd, twd, shift, labels, mutual)
    want = (tmsa_block.tmsa_block_reference(x, p, NH, shift) if mutual
            else self6_block.self6_block_reference(x, p, NH, wd, shift))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_dcn_kernel_layout_matches_plain():
    """Columns decoded from the flat column index as the kernel does, times
    the packed [KP][CP] weight."""
    x, off, mask, weight, bias = map(torch.from_numpy, dcn_inputs())
    dg = 3
    n, h, w, cin = x.shape
    cg, kc = cin // dg, 9 * cin
    pk = dcn_block.pack_dcn_weight(weight, dg, torch.float32)
    col = torch.arange(kc)
    g, k, c = col // (9 * cg), col % (9 * cg) // cg, col % cg
    py = torch.arange(h)[:, None, None]
    px = torch.arange(w)[None, :, None]
    o = off.reshape(n, h, w, dg, 9, 2)[:, :, :, g, k]
    fy = (py - 1 + k // 3) + o[..., 0]
    fx = (px - 1 + k % 3) + o[..., 1]
    m = mask.reshape(n, h, w, dg, 9)[:, :, :, g, k]
    y0, x0 = torch.floor(fy), torch.floor(fx)
    ly, lx = fy - y0, fx - x0
    ch = (g * cg + c).expand_as(fy)

    def tap(yc, xc):
        ok = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
        v = x[0][yc.clamp(0, h - 1).long(), xc.clamp(0, w - 1).long(), ch]
        return v * ok
    cols = ((1 - ly) * (1 - lx) * tap(y0, x0) + (1 - ly) * lx * tap(y0, x0 + 1)
            + ly * (1 - lx) * tap(y0 + 1, x0) + ly * lx * tap(y0 + 1, x0 + 1))
    inside = (fy > -1) & (fy < h) & (fx > -1) & (fx < w)
    cols = cols * inside * m
    got = (F.pad(cols, (0, pk.shape[0] - kc)) @ pk)[..., :weight.shape[0]] + bias
    want = dcn_block.dcn_reference(x, off, mask, weight, bias, dg)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# shared memory and the checks before a launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,nh,p,want", [
    (24, 2, 2, 52224), (120, 6, 2, 146432), (180, 6, 1, 161792),
    (120, 6, 1, 121856)])
def test_shared_memory_arithmetic(c, nh, p, want):
    """The largest pass's layout at C = 24, 120 and 180 (hidden 2C): pass 2
    is a fixed 51,200 B; pass 3 grows with C, the heads and the hidden
    width, and stays within the card's opt-in limit at VRT-001's widths."""
    hp = (2 * c + 15) // 16 * 16
    assert shared_bytes(c, nh, hp, p) == want
    assert want <= SMEM_LIMIT


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 6, 16, 16, C, dtype=torch.bfloat16)
    p = torch_params(block_weights(C, NH, 2, False, 0), C)
    with pytest.raises(ValueError, match="at least 6 deep"):
        win3d.check_geometry("self6_block", x, p, NH, 6, mutual=False)
    with pytest.raises(ValueError, match="wrong kind"):
        win3d.check_geometry("tmsa_block", x, p, NH, 2, mutual=True)
    with pytest.raises(ValueError, match="tiling"):
        win3d.check_geometry("self6_block", x[:, :, :12].contiguous(), p, NH, 2,
                             mutual=False)
    with pytest.raises(TypeError):
        win3d.check_geometry("self6_block", x.float(), p, NH, 2,
                             mutual=False)
    assert not dcn_block.dcn_supported(12, (8, 12, 3, 3), 2, 1, 1, 3)
    assert not dcn_block.dcn_supported(12, (300, 12, 3, 3), 1, 1, 1, 3)
    assert dcn_block.dcn_supported(120, (120, 120, 3, 3), 1, 1, 1, 12)
