"""The wgmma Swin-block kernel's host side on the CPU
(``csrc/swin_block_wgmma.cu`` runs only on the card, ``chip_smoke.py``).

* ``pack_block_stages``: unswizzled, the stages give back
  ``pack_swin_block``'s matrices (SwinIR-M, SwinIR-L and narrow widths).
* A replay of the kernel's arithmetic from the stages, in the kernel's
  order (qkv per head, proj per pair of heads from one 64-deep stage, LN2
  from the residual stream, fc1/GELU/fc2 in hidden chunks of 64, windows
  padded to 64 rows with -inf keys), against the plain version and, at
  window 8, JAX's ``swin_block_pallas_2d`` in interpret mode; f32, atol
  1e-4 (the Pallas body's A&S GELU and folded LN affines).
* ``block_plan`` (the shared-memory arithmetic) fits the card at every
  model geometry and window 7, the wrapper refuses what does not fit, and
  the persistent window walk covers every window once.
* The wrapper refuses a stage pack it cannot bulk-copy (misaligned, wrong
  size, missing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu.ops.window_attention import (relative_position_index,
                                           shift_attn_mask)
from kair_tpu_torch.ops.kernels.swin_block import (KC, SwinBlockParams,
                                                   _check_cuda_args,
                                                   _check_stages, block_plan,
                                                   grid_blocks,
                                                   pack_swin_block,
                                                   stage_rows,
                                                   swin_block_win_reference,
                                                   unswizzle, window_walk)
from kair_tpu_torch.ops.kernels.window_msa import SMEM_LIMIT
from kair_tpu_torch.ops.window_attention import (window_partition,
                                                  window_reverse)

ATOL = 1e-4

# (C, heads, hidden): SwinIR-M, SwinIR-L, RVRT's (1,8,8) blocks, a narrow
# width, and an odd head count (the last head pair has one head)
GEOMETRIES = [(180, 6, 360), (240, 8, 480), (144, 6, 288), (24, 4, 48),
              (30, 3, 60)]


def seeded_params(c: int, nh: int, hidden: int, ws: int = 8,
                  seed: int = 0) -> SwinBlockParams:
    rng = np.random.RandomState(seed)

    def f(*shape, std=1.0, mean=0.0):
        a = (rng.randn(*shape) * std + mean).astype(np.float32)
        return torch.from_numpy(a)

    # the table holds bf16-representable values: the Pallas kernel stores a
    # shifted block's score bias in bf16
    table = f((2 * ws - 1) ** 2, nh, std=0.5).to(torch.bfloat16).float()
    return SwinBlockParams(
        f(3 * c, c, std=0.1), f(3 * c, std=0.1), f(c, c, std=0.05),
        f(c, std=0.1), table, f(c, std=0.1, mean=1.0), f(c, std=0.1),
        f(c, std=0.1, mean=1.0), f(c, std=0.1), f(hidden, c, std=0.05),
        f(hidden, std=0.1), f(c, hidden, std=0.05), f(c, std=0.1))


def split_stages(pk, c: int, nh: int):
    """The flat stage pack → [(product, (rows, 64) unswizzled matrix)]."""
    out, off = [], 0
    for name, rows in stage_rows(c, nh, pk.hp):
        m = pk.stages[off:off + rows * KC].view(rows, KC)
        out.append((name, unswizzle(m)))
        off += rows * KC
    assert off == pk.stages.numel()
    return out


@pytest.mark.parametrize("c,nh,hidden", GEOMETRIES)
def test_stages_unswizzle_to_the_pack_matrices(c, nh, hidden):
    pk = pack_swin_block(seeded_params(c, nh, hidden), nh,
                         dtype=torch.float32)
    pl = block_plan(c, nh, pk.hp)
    st = split_stages(pk, c, nh)
    assert len(st) == pl.stages
    kp = pl.kc * KC
    wq = torch.zeros(kp, nh * 96)
    wp = torch.zeros(pl.np * 64, pl.nt)
    w1 = torch.zeros(kp, pl.hc * 64)
    w2 = torch.zeros(pl.hc * 64, pl.nt)
    it = iter(st)
    for p in range(pl.np):
        for h in range(2 * p, min(2 * p + 2, nh)):
            for k in range(pl.kc):
                name, m = next(it)
                assert name == "qkv" and m.shape == (96, KC)
                wq[k * KC:(k + 1) * KC, h * 96:(h + 1) * 96] = m.t()
        name, m = next(it)
        assert name == "proj" and m.shape == (pl.nt, KC)
        wp[p * 64:(p + 1) * 64] = m.t()
    for j in range(pl.hc):
        for k in range(pl.kc):
            name, m = next(it)
            assert name == "fc1" and m.shape == (64, KC)
            w1[k * KC:(k + 1) * KC, j * 64:(j + 1) * 64] = m.t()
        name, m = next(it)
        assert name == "fc2" and m.shape == (pl.nt, KC)
        w2[j * 64:(j + 1) * 64] = m.t()
    cp, hp, cn = pk.wqkv.shape[0], pk.hp, min(pk.wqkv.shape[0], pl.nt)
    assert torch.equal(wq[:cp], pk.wqkv) and not wq[cp:].any()
    assert torch.equal(wp[:nh * 32, :cn], pk.wp[:, :cn])
    assert not wp[nh * 32:].any() and not wp[:, c:].any()
    assert torch.equal(w1[:cp, :hp], pk.w1) and not w1[cp:].any()
    assert not w1[:, hp:].any()
    assert torch.equal(w2[:hp, :cn], pk.w2[:, :cn]) and not w2[hp:].any()
    assert not w2[:, c:].any()


def emulate_wgmma_kernel(x, pk, c, nh, mask, phase, ws):
    """csrc/swin_block_wgmma.cu step by step from its weight stages."""
    b, h, w, _ = x.shape
    n = ws * ws
    pl = block_plan(c, nh, pk.hp)
    st = iter(m for _, m in split_stages(pk, c, nh))
    rows = (torch.arange(h) + phase) % h
    cols = (torch.arange(w) + phase) % w
    xw = F.pad(window_partition(x[:, rows][:, :, cols], ws),
               (0, 0, 0, 64 - n))                      # (B, nW, 64, C)
    kpad = pl.kc * KC - c
    a = F.pad(F.layer_norm(xw, (c,)), (0, kpad))
    a[..., n:, :] = 0                                  # padded rows stay 0
    acc = F.pad(xw + pk.bp, (0, pl.nt - c))
    acc[..., n:, :] = F.pad(pk.bp, (0, pl.nt - c))     # as the kernel: bp only
    bias = torch.zeros(nh, 64, 64)
    bias[:, :, n:] = float("-inf")
    bias[:, :n, :n] = pk.relbias
    if mask is not None:
        mpad = torch.zeros(mask.shape[0], 64, 64)
        mpad[:, :n, :n] = mask
    chunk = lambda t, k: t[..., k * KC:(k + 1) * KC]

    def product(t, k_chunks):
        return sum(chunk(t, k) @ next(st).t() for k in range(k_chunks))

    for p in range(pl.np):
        heads = []
        for hh in range(2 * p, min(2 * p + 2, nh)):
            qkv = product(a, pl.kc) + pk.bqkv[hh * 96:(hh + 1) * 96]
            q, k, v = qkv[..., :32], qkv[..., 32:64], qkv[..., 64:]
            s = q @ k.transpose(-1, -2) + bias[hh]
            if mask is not None:
                s = s + mpad[None]
            heads.append(torch.softmax(s, -1) @ v)
        wstage = next(st)
        acc = acc + sum(o @ wstage[:, 32 * i:32 * (i + 1)].t()
                        for i, o in enumerate(heads))
    z = F.pad(F.layer_norm(acc[..., :c], (c,)), (0, kpad))
    acc = acc + F.pad(pk.b2, (0, pl.nt - c))
    b1 = F.pad(pk.b1, (0, pl.hc * 64 - pk.b1.shape[0]))
    for j in range(pl.hc):
        hid = F.gelu(product(z, pl.kc) + b1[j * 64:(j + 1) * 64])
        acc = acc + hid @ next(st).t()
    return window_reverse(acc[..., :n, :c].contiguous(), ws, h, w)


REPLAY_CASES = [  # (c, nh, hidden, b, h, w, ws, phase)
    (24, 4, 48, 1, 16, 16, 8, 0),
    (24, 4, 48, 1, 16, 16, 8, 4),
    (30, 3, 60, 1, 16, 8, 8, -4),
    (24, 4, 48, 1, 14, 21, 7, 3),
    (180, 6, 360, 1, 8, 16, 8, 4),
    (240, 8, 480, 1, 8, 8, 8, 0),
]


@pytest.mark.parametrize("c,nh,hidden,b,h,w,ws,phase", REPLAY_CASES)
def test_kernel_replay_matches_plain_version(c, nh, hidden, b, h, w, ws,
                                            phase):
    p = seeded_params(c, nh, hidden, ws)
    x = torch.from_numpy(np.random.RandomState(1).randn(b, h, w, c)
                         .astype(np.float32))
    mask = (torch.from_numpy(shift_attn_mask(h, w, ws, abs(phase)))
            if phase else None)
    pk = pack_swin_block(p, nh, dtype=torch.float32)
    got = emulate_wgmma_kernel(x, pk, c, nh, mask, phase, ws)
    want = swin_block_win_reference(x, p, nh, mask, phase, ws)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_kernel_replay_matches_pallas_kernel():
    """At window 8, the replay against the TPU kernel it replaces."""
    c, nh, hidden, phase = 24, 4, 48, 4
    p = seeded_params(c, nh, hidden)
    x = np.random.RandomState(2).randn(1, 16, 16, c).astype(np.float32)
    mask = shift_attn_mask(16, 16, 8, 4)
    n = lambda t: jnp.asarray(t.numpy())
    want = jsb.swin_block_pallas_2d(
        jnp.asarray(x), n(p.qkv_weight.t()), n(p.qkv_bias),
        n(p.proj_weight.t()), n(p.proj_bias), n(p.rel_table),
        relative_position_index(8, 8), nh, n(p.norm1_weight),
        n(p.norm1_bias), n(p.norm2_weight), n(p.norm2_bias),
        n(p.fc1_weight.t()), n(p.fc1_bias), n(p.fc2_weight.t()),
        n(p.fc2_bias), jnp.asarray(mask), interpret=True, phase=phase)
    pk = pack_swin_block(p, nh, dtype=torch.float32)
    got = emulate_wgmma_kernel(torch.from_numpy(x), pk, c, nh,
                               torch.from_numpy(mask), phase, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("c,nh,hidden", GEOMETRIES)
def test_layout_fits_the_card(c, nh, hidden):
    hp = -(-hidden // 16) * 16
    pl = block_plan(c, nh, hp)
    assert pl.ring == 2 and pl.smem <= SMEM_LIMIT
    for ws in (8, 7):
        x = torch.zeros(1, 2 * ws, 2 * ws, c, dtype=torch.bfloat16)
        p = seeded_params(c, nh, hidden, ws)
        _check_cuda_args(x, p, nh, None, ws)           # does not raise


def test_layout_numbers_at_swinir_m_and_l():
    """The numbers PERF.md gives: SwinIR-M asks 151,840 B with two
    23,552-byte weight stages, 45 stages a window pair; SwinIR-L 198,560 B
    with two 30,720-byte stages, 76 a pair."""
    m, l = block_plan(180, 6, 368), block_plan(240, 8, 480)
    assert (m.nt, m.kc, m.ring, m.stages, m.slot, m.smem) == \
        (184, 3, 2, 45, 23552, 151840)
    assert (l.nt, l.kc, l.ring, l.stages, l.slot, l.smem) == \
        (240, 4, 2, 76, 30720, 198560)


@pytest.mark.parametrize("case", ["c_over_240", "shared_memory"])
def test_wrapper_refuses_what_does_not_fit(case):
    if case == "c_over_240":
        c, nh, match = 256, 8, "C <= 240"
    else:                  # 120 heads of 2: the qkv biases take 46 KB
        c, nh, match = 240, 120, "shared memory"
    x = torch.zeros(1, 8, 8, c, dtype=torch.bfloat16)
    p = seeded_params(c, nh, 2 * c)
    with pytest.raises(ValueError, match=match):
        _check_cuda_args(x, p, nh, None)


@pytest.mark.parametrize("windows", [4096, 63, 1])
def test_window_walk_covers_every_window_once(windows):
    blocks = grid_blocks(windows)
    walk = window_walk(windows, blocks)
    assert len(walk) == blocks and all(walk)       # no block without work
    seen = [w for steps in walk for pair in steps for w in pair if w >= 0]
    assert sorted(seen) == list(range(windows))
    idle = sum(w < 0 for steps in walk for pair in steps for w in pair)
    assert idle == windows % 2


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of t whose data starts nbytes past an aligned one."""
    k = nbytes // t.element_size()
    return torch.zeros(t.numel() + k, dtype=t.dtype)[k:].view(t.shape)


@pytest.mark.parametrize("case", ["aligned", "offset_8", "offset_2", "size",
                                  "f32", "missing", "f64_bias"])
def test_wrapper_refuses_a_stage_pack_it_cannot_copy(case):
    c, nh = 24, 4
    pk = pack_swin_block(seeded_params(c, nh, 48), nh)
    x = torch.zeros(1, 8, 8, c, dtype=torch.bfloat16)
    st = pk.stages
    if case == "offset_8":
        st = _offset(st, 8)
    elif case == "offset_2":
        st = _offset(st, 2)
    elif case == "size":
        st = st[:-KC]
    elif case == "f32":
        st = st.float()
    elif case == "missing":
        st = None
    elif case == "f64_bias":
        pk = pk._replace(bqkv=pk.bqkv.double())
    pk = pk._replace(stages=st)
    if case == "aligned":
        _check_stages(x, pk, nh)
    else:
        with pytest.raises(ValueError,
                           match="aligned|elements|weight stages|f32"):
            _check_stages(x, pk, nh)


def test_backward_pack_has_no_stages():
    p = seeded_params(24, 4, 48)
    assert pack_swin_block(p, 4, folded=False).stages is None
    assert pack_swin_block(p, 4).stages.dtype == torch.bfloat16
