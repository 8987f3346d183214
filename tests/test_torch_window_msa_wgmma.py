"""Kernel B, window attention on the unfused route, as the attention-only
mode of the wgmma Swin-block kernel (``kair_window_msa`` in
``csrc/swin_block_wgmma.cu``; it runs only on the card, chip_smoke.py phase
9), on the CPU.

* Its stage list and shared-memory plan are the block's at hidden width 0:
  the qkv and proj stages and nothing after the last proj stage, against
  the block's own list and an independent mirror of the C layout, at
  SwinIR-light (C=60), SwinIR-M (180) and SwinIR-L (240) widths.
* ``pack_attn_stages`` is the head of ``pack_block_stages`` on the same
  matrices, and unswizzles back to ``pack_qkv_proj``'s wqkv and wp (no LN
  affine folded: y is already the LN1 output).
* The replay of its data flow (``emulate_msa_win``, tests/
  test_torch_window_block.py: the stages unswizzled, y as the qkv
  product's A, proj from bp, the un-rolled store) against the plain version
  ``window_msa_win_reference`` and the JAX ``window_msa_pallas`` in
  interpret mode (at window 7 the JAX function's own composed fallback), at
  windows 7 and 8, with and without the shift mask; f32, atol 1e-4.
* The refusals the wrapper makes before a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.ops.pallas.window_msa import window_msa_pallas
from kair_tpu.ops.window_attention import (relative_position_index,
                                           shift_attn_mask)
from kair_tpu.ops.window_attention import window_partition as jpartition
from kair_tpu.ops.window_attention import window_reverse as jreverse
from kair_tpu_torch.ops.kernels.swin_block import (KC, block_plan,
                                                   check_ring_operands,
                                                   pack_attn_stages,
                                                   pack_block_stages,
                                                   stage_rows)
from kair_tpu_torch.ops.kernels.window_msa import (SMEM_LIMIT,
                                                   pack_qkv_proj,
                                                   pack_window_msa,
                                                   shared_bytes,
                                                   window_msa_win,
                                                   window_msa_win_reference)
from tests.test_torch_swin_wgmma import seeded_params
from tests.test_torch_window_block import attn_stages, emulate_msa_win

ATOL = 1e-4
WIDTHS = [(60, 6, 120), (180, 6, 360), (240, 8, 480)]   # light, M, L


def c_layout(c, nh):
    """csrc/swin_block_wgmma.cu's BlockPlan at HP = 0, written out: NT,
    stages a window pair, shared bytes (two ring slots; per consumer
    warpgroup the x tile, which kernel B leaves to k and vᵀ, and the LN-
    output tile that holds y; the biases bqkv | bp | b2 (unused); the
    ring's mbarriers; the alignment slack)."""
    up = lambda v, a: -(-v // a) * a
    nt = min(t for t in (64, 128, 184, 240) if c <= t)
    kc, np_ = -(-c // 64), -(-nh // 2)
    slot = max(96, nt) * 128
    xs = up(max(64 * c * 2, 3 * 4096), 1024)
    ab = up(64 * (kc * 64 + 8) * 2, 1024)
    smem = 2 * slot + 2 * (xs + ab) + up((nh * 96 + 2 * c) * 4, 128) + 32 + 1024
    return nt, nh * kc + np_, smem


@pytest.mark.parametrize("c,nh,hidden", WIDTHS)
def test_stage_list_and_plan_are_the_blocks_up_to_proj(c, nh, hidden):
    hp = -(-hidden // 16) * 16
    rows = stage_rows(c, nh, 0)
    block = stage_rows(c, nh, hp)
    assert rows == block[:len(rows)]
    assert {name for name, _ in rows} == {"qkv", "proj"}
    assert rows[-1][0] == "proj" and block[len(rows)][0] == "fc1"
    pl = block_plan(c, nh, 0)
    assert pl.hc == 0 and pl.stages == len(rows)
    assert (pl.nt, pl.stages, pl.smem) == c_layout(c, nh)
    assert pl.smem == shared_bytes(c, nh) <= SMEM_LIMIT
    bp = block_plan(c, nh, hp)
    assert (pl.nt, pl.kc, pl.np, pl.slot, pl.lda) == \
        (bp.nt, bp.kc, bp.np, bp.slot, bp.lda)


def test_plan_numbers_at_swinir_m_and_l():
    """PERF.md's numbers: SwinIR-M's kernel B asks 150,304 B with 21 stages
    a window pair (18 qkv + 3 proj), SwinIR-L's 196,512 B with 36."""
    m, l = block_plan(180, 6, 0), block_plan(240, 8, 0)
    assert (m.nt, m.stages, m.smem) == (184, 21, 150304)
    assert (l.nt, l.stages, l.smem) == (240, 36, 196512)


@pytest.mark.parametrize("c,nh,hidden", WIDTHS + [(30, 3, 60)])
def test_attention_stages_are_the_block_stages_head(c, nh, hidden):
    p = seeded_params(c, nh, hidden)
    wqkv, bqkv, wp = pack_qkv_proj(p.qkv_weight, p.qkv_bias, p.proj_weight,
                                   nh)
    att = pack_attn_stages(wqkv, wp, c, nh)
    hp = -(-hidden // 16) * 16
    w1 = torch.randn(wqkv.shape[0], hp)
    w2 = torch.randn(hp, wqkv.shape[0])
    full = pack_block_stages(wqkv, wp, w1, w2, c, nh)
    assert att.numel() == sum(r for _, r in stage_rows(c, nh, 0)) * KC
    assert torch.equal(att, full[:att.numel()])
    # unswizzled, the stages give back wqkv and wp
    pl = block_plan(c, nh, 0)
    pk = pack_window_msa(p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias,
                         p.rel_table, nh, dtype=torch.float32)
    assert torch.equal(pk.stages, att) and torch.equal(pk.bqkv, bqkv)
    wq = torch.zeros(pl.kc * KC, nh * 96)
    wpr = torch.zeros(pl.np * 64, pl.nt)
    it = iter(attn_stages(pk, c, nh))
    for pp in range(pl.np):
        for h in range(2 * pp, min(2 * pp + 2, nh)):
            for k in range(pl.kc):
                name, m = next(it)
                assert name == "qkv"
                wq[k * KC:(k + 1) * KC, h * 96:(h + 1) * 96] = m.t()
        name, m = next(it)
        assert name == "proj"
        wpr[pp * 64:(pp + 1) * 64] = m.t()
    cp = wqkv.shape[0]
    cn = min(cp, pl.nt)
    assert torch.equal(wq[:cp], wqkv) and not wq[cp:].any()
    assert torch.equal(wpr[:nh * 32, :cn], wp[:, :cn])
    assert not wpr[nh * 32:].any() and not wpr[:, c:].any()


CASES = [  # (c, nh, b, h, w, ws, phase, masked)
    (24, 4, 1, 16, 16, 8, 4, True),
    (24, 4, 2, 16, 24, 8, 0, False),
    (30, 3, 1, 16, 16, 8, -4, True),
    (24, 4, 1, 14, 21, 7, 3, True),
    (24, 4, 2, 14, 14, 7, 0, False),
    (60, 6, 1, 16, 16, 8, 4, True),
]


@pytest.mark.parametrize("c,nh,b,h,w,ws,phase,masked", CASES)
def test_replay_matches_plain_version_and_pallas(c, nh, b, h, w, ws, phase,
                                                 masked):
    p = seeded_params(c, nh, 2 * c, ws, seed=5)
    y = np.random.RandomState(6).randn(b, h, w, c).astype(np.float32)
    mask = shift_attn_mask(h, w, ws, abs(phase)) if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    pk = pack_window_msa(p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias,
                         p.rel_table, nh, dtype=torch.float32)
    got = emulate_msa_win(torch.from_numpy(y), pk, nh, tm, phase, ws)
    args = (p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias, p.rel_table,
            nh, tm, phase, ws)
    want = window_msa_win_reference(torch.from_numpy(y), *args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    # the TPU kernel it replaces, on the rolled, partitioned windows
    n = lambda t: None if t is None else jnp.asarray(t.numpy())
    xw = jpartition(jnp.roll(jnp.asarray(y), (-phase, -phase), (1, 2)), ws)
    yw = window_msa_pallas(xw, n(p.qkv_weight.t()), n(p.qkv_bias),
                           n(p.proj_weight.t()), n(p.proj_bias),
                           n(p.rel_table), relative_position_index(ws, ws),
                           nh, None if mask is None else jnp.asarray(mask),
                           interpret=True)
    jax_out = np.asarray(jnp.roll(jreverse(yw, ws, h, w), (phase, phase),
                                  (1, 2)))
    np.testing.assert_allclose(got.numpy(), jax_out, atol=ATOL)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["c_over_240", "head_dim", "f32", "ws9",
                                  "not_tiled", "mask_shape"])
def test_wrapper_refuses_before_a_launch(case):
    """On a tensor off the CPU (the meta device: no data, no build) the
    wrapper refuses what the kernel does not take."""
    c, nh, ws, h, w = 24, 4, 8, 16, 16
    err, match, mask = ValueError, None, None
    if case == "c_over_240":
        c, nh, match = 248, 8, "C <= 240"
    elif case == "head_dim":
        c, nh, match = 132, 2, "head dim"
    elif case == "f32":     # the f32 kernel's own refusal, before packing
        c, nh, match = 22, 2, "multiples of 4"
    elif case == "ws9":
        ws, h, w, match = 9, 18, 18, "window of at most 8"
    elif case == "not_tiled":
        h, match = 12, "tiling"
    else:
        mask, match = _meta(3, 64, 64, dtype=torch.float32), "mask"
    y = _meta(1, h, w, c, dtype=torch.float32 if case == "f32" else
              torch.bfloat16)
    p = seeded_params(c, nh, 2 * c, min(ws, 8))
    table = torch.zeros((2 * ws - 1) ** 2, nh)
    with pytest.raises(err, match=match):
        window_msa_win(y, p.qkv_weight, p.qkv_bias, p.proj_weight,
                       p.proj_bias, table, nh, mask, 0, ws)


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    k = nbytes // t.element_size()
    return torch.zeros(t.numel() + k, dtype=t.dtype)[k:].view(t.shape)


@pytest.mark.parametrize("case", ["aligned", "block_pack", "f32", "offset_8",
                                  "f64_bias", "pixels"])
def test_stage_pack_checks(case):
    """Kernel B takes its own stages (not the block's), bf16, 16-byte
    aligned, f32 biases, and B·H·W < 2^31."""
    c, nh = 24, 4
    p = seeded_params(c, nh, 48)
    pk = pack_window_msa(p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias,
                         p.rel_table, nh)
    y = torch.zeros(1, 8, 8, c, dtype=torch.bfloat16)
    st, f32s, match = pk.stages, (pk.bqkv, pk.bp, pk.relbias), "elements"
    if case == "block_pack":
        from kair_tpu_torch.ops.kernels.swin_block import pack_swin_block
        st = pack_swin_block(p, nh).stages
    elif case == "f32":
        st = st.float()
    elif case == "offset_8":
        st, match = _offset(st, 8), "aligned to 16"
    elif case == "f64_bias":
        f32s, match = (pk.bqkv.double(), pk.bp, pk.relbias), "f32"
    elif case == "pixels":
        y, match = _meta(2 ** 15, 256, 256, c), "2\\^31"
        st = st.to("meta")
        f32s = tuple(t.to("meta") for t in f32s)
    rows = stage_rows(c, nh, 0)
    if case == "aligned":
        check_ring_operands("window_msa_win", y, st, rows, f32s)
    else:
        with pytest.raises(ValueError, match=match):
            check_ring_operands("window_msa_win", y, st, rows, f32s)
