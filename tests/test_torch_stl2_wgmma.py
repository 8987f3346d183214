"""RVRT's STL2 block on VRT's wgmma passes (csrc/window3d_wgmma.cu, the
plain-MLP kind), its host side on the CPU: the device-built weight stages
against the block's matrices (pass 3 with fc1's 64-row stages), a replay of
the three passes from them (``emulate_win3d_wgmma`` with the plain MLP)
against the plain version and JAX's ``stl2_block_pallas`` in interpret
mode, shifted and not, and the layout at RVRT's widths. The kernel itself
runs only on the card (chip_smoke.py phases 17 and 19)."""

import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.stl_block as jstl
from kair_tpu.models.vrt import rel_position_index_3d as j_rel_index
from kair_tpu.ops.pallas.tmsa_block import tmsa_mask_patterns
from kair_tpu_torch.ops.kernels import stl2_block, win3d
from kair_tpu_torch.ops.kernels.win3d import (labels_on, pack_win3d_stages,
                                              stage_rows, win3d_plan)
from kair_tpu_torch.ops.kernels.window_msa import SMEM_LIMIT
from tests.test_torch_rvrt_kernels import _flat, stl_params
from tests.test_torch_vrt_kernels import _jroll, _x, block_weights
from tests.test_torch_win3d_wgmma import (_stages, emulate_win3d_wgmma,
                                          qkv_matrices)

F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (the suite runs several
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("c,nh", [(24, 2), (144, 6), (192, 6), (96, 4)])
def test_plain_stage_pack_gives_back_the_matrices(c, nh):
    """Unswizzled, pass 1's stages hold the qkv matrix at the plain kind's
    widths (q scale folded, heads at their real width), pass 3's the proj,
    each hidden chunk's fc1 (64 rows a K chunk) and fc2, zero elsewhere; no
    fc12 bias."""
    p = stl_params(block_weights(c, nh, 2, False, 31), c)
    pk = pack_win3d_stages(p, nh, F32)
    assert pk.b12 is None
    pl = win3d_plan(False, c, nh, pk.hidden, 2, 2, True)
    assert pl.nt == (144 if c <= 144 else 192)
    rows1, rows3 = stage_rows(pl, nh, True)
    assert rows3 == (pl.nt,) * pl.kcp + ((64,) * pl.kc + (pl.nt,)) * pl.hc
    st1, st3 = _stages(pk.st1, rows1), _stages(pk.st3, rows3)
    hd, hw = c // nh, 2 * pl.hdp + pl.vdp
    (wmat, bmat), = qkv_matrices(p, nh)
    got = torch.cat([torch.cat([st1[pr * pl.kc + k].t() for k in range(pl.kc)], 0)
                     for pr in range(nh // 2)], 1)
    want = torch.zeros_like(got)
    bwant = torch.zeros(got.shape[1])
    for head in range(nh):
        for part in range(3):
            dst, src = head * hw + part * pl.hdp, part * c + head * hd
            want[:c, dst:dst + hd] = wmat[:, src:src + hd]
            bwant[dst:dst + hd] = bmat[src:src + hd]
    exact = dict(atol=0, rtol=0)
    torch.testing.assert_close(got, want, **exact)
    torch.testing.assert_close(pk.bq, bwant, **exact)
    wp = torch.cat([st3[k].t() for k in range(pl.kcp)], 0)[:c, :c]
    torch.testing.assert_close(wp, p.proj_weight.float().t(), **exact)
    w1 = F.pad(p.fc11_weight.float().t(), (0, pl.hc * 64 - pk.hidden))
    w2 = F.pad(p.fc2_weight.float().t(), (0, 0, 0, pl.hc * 64 - pk.hidden))
    s = pl.kcp
    for j in range(pl.hc):
        f1 = torch.cat([st3[s + k].t() for k in range(pl.kc)], 0)   # (kp, 64)
        f2 = st3[s + pl.kc].t()                                     # (64, NT)
        s += pl.kc + 1
        cols = slice(j * 64, (j + 1) * 64)
        torch.testing.assert_close(f1[:c], w1[:, cols], **exact)
        torch.testing.assert_close(f2[:, :c], w2[cols], **exact)
        assert not f1[c:].any() and not f2[:, c:].any()
    assert s == len(rows3)
    torch.testing.assert_close(pk.b11[:pk.hidden], p.fc11_bias.float(), **exact)
    assert not pk.b11[pk.hidden:].any()


REPLAY_CASES = [  # (C, nh, (d, h, w), shift)
    (24, 2, (2, 16, 16), (0, 4, 4)),
    (24, 2, (4, 16, 16), (0, 0, 0)),
    (24, 2, (4, 16, 24), (1, 4, 4)),
    (144, 6, (2, 8, 16), (0, 4, 4)),
    (192, 6, (2, 16, 8), (1, 4, 4)),
]


@pytest.mark.parametrize("c,nh,dhw,shift", REPLAY_CASES)
def test_replay_matches_plain_and_pallas(c, nh, dhw, shift):
    """The plain kind's arithmetic, f32, against the plain version (the
    composed block; 1e-5 of max|ref|: f32 sums in another order and the
    online softmax's rescaling) and against JAX's Pallas kernel (1e-4 of
    max|ref|: its max-free softmax, A&S GELU and folded LN affines)."""
    x = _x((1, *dhw, c), 41)
    wt = block_weights(c, nh, 2, False, 42)
    p = stl_params(wt, c)
    pk = pack_win3d_stages(p, nh, F32)
    labels = labels_on(dhw, (2, 8, 8), shift, "cpu")
    got = emulate_win3d_wgmma(torch.from_numpy(x), pk, nh, 2, 2, shift, labels,
                              False, plain=True)
    want = stl2_block.stl2_block_reference(torch.from_numpy(x), p, nh, shift)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0)
    shifted = any(shift)
    pats = tmsa_mask_patterns(*dhw, (2, 8, 8), shift) if shifted else None
    bias = jstl.make_stl2_bias(jnp.asarray(wt["table"]), j_rel_index(2, 8, 8),
                               nh, pats)
    xin = _jroll(jnp.asarray(x), tuple(-s for s in shift))
    jax_out = jstl.stl2_block_pallas(xin, _flat(wt), nh, bias, shifted,
                                     interpret=True)
    jax_out = torch.from_numpy(__import__("numpy").asarray(
        _jroll(jax_out, shift)))
    torch.testing.assert_close(got, jax_out, atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("c", [144, 192])
def test_layout_fits_rvrt_widths(c):
    """RVRT's STL2 blocks (6 heads, hidden 2C, (2,8,8) windows, a table two
    frames deep) fit, each stage in its slot; the GEGLU kinds keep their
    limits: a self block at C=192 and a TMSA block at C=144 are refused."""
    pl = win3d_plan(False, c, 6, 2 * c, 2, 2, True)
    assert pl.fits
    assert max(pl.smem1, pl.smem2, pl.smem3) + win3d.STATIC_SMEM <= SMEM_LIMIT
    rows1, rows3 = stage_rows(pl, 6, True)
    assert max(rows1) * 128 <= pl.slot1 and max(rows3) * 128 <= pl.slot3
    assert pl.slot1 % 1024 == 0 and pl.slot3 % 1024 == 0
    assert not win3d_plan(False, 192, 6, 384, 2, 2).fits
    assert not win3d_plan(True, 144, 6, 288, 2, 2).fits


def test_layout_pinned_at_rvrt001():
    """RVRT-001's STL2 block: C=144, 6 heads of 24, hidden 288 (NT 144, q/k
    at 32, v at 24), and presets 004-006's C=192, 6 heads of 32 (NT 192)."""
    assert win3d_plan(False, 144, 6, 288, 2, 2, True) == (
        144, 32, 24, 528, 144, 3, 3, 5, 4, 9, 23, 22528, 18432, 192832,
        18688, 130880, True)
    assert win3d_plan(False, 192, 6, 384, 2, 2, True) == (
        192, 32, 32, 576, 192, 3, 3, 6, 4, 9, 27, 24576, 24576, 205632,
        20736, 156736, True)


def test_stl2_refuses_what_the_kernel_does_not_take():
    """Beyond the window kernels' common checks: C above 192, an odd head
    count, a head dim past the class's v width (24 up to C=144)."""
    def geom(c, nh):
        x = torch.zeros(1, 2, 8, 8, c, dtype=torch.bfloat16)
        p = stl_params(block_weights(c, nh, 2, False, 0), c)
        win3d.check_geometry("stl2_block", x, p, nh, 2, mutual=False,
                             gated=False)

    geom(144, 6)
    geom(192, 6)
    with pytest.raises(ValueError, match="C <= 192"):
        geom(200, 8)
    with pytest.raises(ValueError, match="even number of heads"):
        geom(120, 5)
    with pytest.raises(ValueError, match="head dim of at most 24"):
        geom(128, 4)
    p = stl_params(block_weights(24, 2, 2, False, 0), 24)
    x = torch.zeros(1, 2, 8, 8, 24, dtype=torch.bfloat16)
    pl = win3d_plan(False, 24, 2, 48, 2, 2, True)
    pk = pack_win3d_stages(p, 2)
    win3d._check_pack("stl2_block", x, pk, pl, 2, False, True)
    with pytest.raises(ValueError, match="fc12 bias"):
        win3d._check_pack("stl2_block", x, pk._replace(b12=pk.b11), pl, 2,
                          False, True)
    with pytest.raises(ValueError, match="weight stages"):
        win3d._check_pack("stl2_block", x, pk, win3d_plan(False, 24, 2, 48, 2,
                                                          2), 2, False, True)
