"""The wgmma Swin-block backward's host side on the CPU
(``csrc/swin_block_bwd_wgmma.cu`` runs only on the card, ``chip_smoke.py``
phase 6).

* ``pack_bwd_stages``: unswizzled, the stages give back the backward pack's
  matrices and their transposes (SwinIR-M, SwinIR-L and narrow widths).
* The replay of the kernel's arithmetic (``emulate_bwd_kernel``: its
  stages, its swizzled feature-major operand tiles, the weight-grad pass by
  work items) with the block's phase folded in, against the plain version
  (f32, atol 1e-4) and against ``jax.vjp`` of ``swin_block_pallas_2d(...,
  safe=True)`` in interpret mode (atol 5e-5, rtol 1e-3, the tolerance of
  test_torch_swin_bwd.py).
* The plain version at a phase is roll, backward, roll back.
* ``bwd_plan`` fits the card at SwinIR-M's and SwinIR-L's widths (numbers
  pinned), C above 240 is refused, and the persistent walk covers every
  window once.
* The wrapper refuses a stage pack it cannot bulk-copy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu.ops.window_attention import (relative_position_index,
                                           shift_attn_mask)
from kair_tpu_torch.ops.kernels.swin_block import (KC, SwinBlockParams,
                                                   _check_bwd_stages,
                                                   _check_cuda_args, block_plan,
                                                   bwd_plan, bwd_stage_rows,
                                                   grid_blocks,
                                                   pack_swin_block,
                                                   swin_block_2d_bwd_reference,
                                                   swin_block_2d_reference,
                                                   window_walk)
from kair_tpu_torch.ops.kernels.window_msa import SMEM_LIMIT
from tests.test_torch_swin_bwd import (JAX_ARGS, emulate_bwd_kernel,
                                       split_bwd_stages)
from tests.test_torch_swin_wgmma import seeded_params

# (C, heads, hidden): SwinIR-M, SwinIR-L, RVRT's width, a narrow width and
# an odd head count (the last pair has one head)
GEOMETRIES = [(180, 6, 360), (240, 8, 480), (144, 6, 288), (24, 4, 48),
              (30, 3, 60)]


def _inputs(b, h, w, c, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    dy = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    return x, dy


@pytest.mark.parametrize("c,nh,hidden", GEOMETRIES)
def test_bwd_stages_unswizzle_to_the_pack_matrices(c, nh, hidden):
    pk = pack_swin_block(seeded_params(c, nh, hidden), nh,
                         dtype=torch.float32, folded=False)
    pl = block_plan(c, nh, pk.hp)
    kp, nt, np_, hc = pl.kc * KC, pl.nt, pl.np, -(-hidden // 64)
    st = split_bwd_stages(pk, c, nh, hidden)
    assert len(st) == bwd_plan(c, nh, hidden).stages
    wq = torch.zeros(kp, nh * 96)                  # forward products
    wp = torch.zeros(np_ * 64, nt)
    w1 = torch.zeros(kp, hc * 64)
    w2t = torch.zeros(hc * 64, kp)                 # backward products
    w1t = torch.zeros(nt, hc * 64)
    wpt = torch.zeros(np_ * 64, kp)
    qkt = torch.zeros(nt, nh * 96)
    it = iter(st)

    def take(name, rows):
        got, m = next(it)
        assert got == name and m.shape == (rows, KC), (got, m.shape)
        return m

    for p in range(np_):
        for h in range(2 * p, min(2 * p + 2, nh)):
            for k in range(pl.kc):
                wq[k * KC:(k + 1) * KC, h * 96:(h + 1) * 96] = take("qkv", 96).t()
        wp[p * 64:(p + 1) * 64] = take("proj", nt).t()
    for j in range(hc):
        for k in range(pl.kc):
            w1[k * KC:(k + 1) * KC, j * 64:(j + 1) * 64] = take("fc1", 64).t()
            w2t[j * 64:(j + 1) * 64, k * KC:(k + 1) * KC] = take("w2t", 64)
        w1t[:, j * 64:(j + 1) * 64] = take("w1t", nt)
    for p in range(np_):
        for k in range(pl.kc):
            wpt[p * 64:(p + 1) * 64, k * KC:(k + 1) * KC] = take("wpt", 64)
        for h in range(2 * p, min(2 * p + 2, nh)):
            qkt[:, h * 96:h * 96 + 64] = take("qkt", nt)
        v = take("vt", nt)
        for i, h in enumerate(range(2 * p, min(2 * p + 2, nh))):
            qkt[:, h * 96 + 64:(h + 1) * 96] = v[:, 32 * i:32 * (i + 1)]
        if 2 * p + 1 >= nh:
            assert not v[:, 32:].any()
    assert next(it, None) is None
    cp, hp = pk.wqkv.shape[0], pk.hp
    cn = min(cp, nt)
    assert torch.equal(wq[:cp], pk.wqkv) and not wq[cp:].any()
    assert torch.equal(wp[:nh * 32, :cn], pk.wp[:, :cn])
    assert torch.equal(w1[:cp, :hp], pk.w1) and not w1[:, hp:].any()
    assert torch.equal(w2t[:hp, :cp], pk.w2) and not w2t[hp:].any()
    assert torch.equal(w1t[:cn, :hp], pk.w1[:cn]) and not w1t[c:].any()
    assert torch.equal(wpt[:nh * 32, :cp], pk.wp) and not wpt[:, cp:].any()
    assert not wpt[nh * 32:].any()
    assert torch.equal(qkt[:cn], pk.wqkv[:cn]) and not qkt[c:].any()


REPLAY_CASES = [  # (b, h, w, c, nh, hidden, phase, masked)
    (1, 16, 16, 24, 4, 48, 4, True),
    (1, 16, 24, 30, 3, 60, -4, True),
    (2, 8, 16, 24, 4, 48, 3, False),
    (1, 8, 8, 240, 8, 480, 4, False),
]


@pytest.mark.parametrize("b,h,w,c,nh,hidden,phase,masked", REPLAY_CASES)
def test_replay_with_phase_matches_plain_version(b, h, w, c, nh, hidden, phase,
                                                 masked):
    p = seeded_params(c, nh, hidden)
    x, dy = _inputs(b, h, w, c, seed=5)
    mask = (torch.from_numpy(shift_attn_mask(h, w, 8, 4)) if masked
            else None)
    dx, grads = emulate_bwd_kernel(x, dy, p, nh, mask, phase)
    rdx, rgrads = swin_block_2d_bwd_reference(x, dy, p, nh, mask, phase)
    np.testing.assert_allclose(dx.numpy(), rdx.numpy(), atol=1e-4)
    for name, got, want in zip(SwinBlockParams._fields, grads, rgrads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_replay_matches_pallas_vjp():
    """The replay at phase 0 against the TPU kernel it replaces."""
    b, h, w, c, nh = 1, 16, 16, 24, 4
    p = seeded_params(c, nh, 2 * c, seed=3)
    x, dy = _inputs(b, h, w, c, seed=6)
    mask = shift_attn_mask(h, w, 8, 4)
    n = lambda t: jnp.asarray(t.numpy())
    jp = dict(zip([a for a, _ in JAX_ARGS],
                  [n(getattr(p, f).t() if f.endswith("_weight")
                     and getattr(p, f).dim() == 2 else getattr(p, f))
                   for _, f in JAX_ARGS]))

    def block(x_, *ws):
        kw = dict(zip([a for a, _ in JAX_ARGS], ws))
        return jsb.swin_block_pallas_2d(
            x_, kw["qkv_kernel"], kw["qkv_bias"], kw["proj_kernel"],
            kw["proj_bias"], kw["bias_table"], relative_position_index(8, 8),
            nh, kw["ln1_scale"], kw["ln1_bias"], kw["ln2_scale"],
            kw["ln2_bias"], kw["fc1_kernel"], kw["fc1_bias"],
            kw["fc2_kernel"], kw["fc2_bias"], jnp.asarray(mask),
            interpret=True, safe=True)

    _, vjp = jax.vjp(block, n(x), *[jp[a] for a, _ in JAX_ARGS])
    want = [np.asarray(g) for g in vjp(n(dy))]
    dx, grads = emulate_bwd_kernel(x, dy, p, nh, torch.from_numpy(mask))
    tol = dict(atol=5e-5, rtol=1e-3)
    np.testing.assert_allclose(dx.numpy(), want[0], err_msg="dx", **tol)
    for (_, tname), w_ in zip(JAX_ARGS, want[1:]):
        got = getattr(grads, tname).numpy()
        if tname.endswith("_weight") and got.ndim == 2:
            got = got.T
        np.testing.assert_allclose(got, w_, err_msg=tname, **tol)


@pytest.mark.parametrize("phase", [0, 4])
def test_plain_version_at_a_phase_is_roll_backward_roll(phase):
    c, nh = 24, 4
    p = seeded_params(c, nh, 48)
    x, dy = _inputs(1, 16, 16, c, seed=7)
    mask = torch.from_numpy(shift_attn_mask(16, 16, 8, 4))
    dx, grads = swin_block_2d_bwd_reference(x, dy, p, nh, mask, phase)
    xr = torch.roll(x, (-phase, -phase), (1, 2)).requires_grad_(True)
    ps = [t.clone().requires_grad_(True) for t in p]
    swin_block_2d_reference(xr, SwinBlockParams(*ps), nh, mask).backward(dy)
    assert torch.allclose(dx, torch.roll(xr.grad, (phase, phase), (1, 2)),
                          atol=1e-6)
    for a, g in zip(ps, grads):
        assert torch.allclose(a.grad, g, atol=1e-6)


def test_bwd_layout_fits_the_card_at_swinir_m_and_l():
    """Pass 1 asks 181,296 B at SwinIR-M width (two 23,552-byte ring
    slots, 81 stages a window pair) and 225,128 B at SwinIR-L's (two
    30,720-byte slots, 136 stages); pass 2 164,928 B and 197,696 B; every
    geometry fits and its plain checks pass."""
    m, l = bwd_plan(180, 6, 360), bwd_plan(240, 8, 480)
    assert (m.smem, m.nt, m.stages, m.slot, m.scratch, m.wgrad_smem) == \
        (181296, 184, 81, 23552, 145408, 164928)
    assert (l.smem, l.nt, l.stages, l.slot, l.scratch, l.wgrad_smem) == \
        (225128, 240, 136, 30720, 192512, 197696)
    for c, nh, hidden in GEOMETRIES:
        pl = bwd_plan(c, nh, hidden)
        assert pl.smem <= SMEM_LIMIT and pl.wgrad_smem <= SMEM_LIMIT
        assert pl.stages == len(bwd_stage_rows(c, nh, hidden))
        x = torch.zeros(1, 16, 16, c, dtype=torch.bfloat16)
        _check_cuda_args(x, seeded_params(c, nh, hidden), nh, None,
                         backward=True)                 # does not raise


def test_bwd_refuses_c_over_240():
    x = torch.zeros(1, 8, 8, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C <= 240"):
        _check_cuda_args(x, seeded_params(256, 8, 512), 8, None,
                         backward=True)


@pytest.mark.parametrize("windows", [1152, 63, 1])
def test_bwd_window_walk_covers_every_window_once(windows):
    """Pass 1 walks windows as the forward does: each warpgroup's partial
    rows sum its own windows, so each window is counted once."""
    blocks = grid_blocks(windows)
    walk = window_walk(windows, blocks)
    seen = [w for steps in walk for pair in steps for w in pair if w >= 0]
    assert sorted(seen) == list(range(windows))
    assert len(walk) == blocks and all(walk)


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    k = nbytes // t.element_size()
    return torch.zeros(t.numel() + k, dtype=t.dtype)[k:].view(t.shape)


@pytest.mark.parametrize("case", ["aligned", "offset_8", "offset_2", "size",
                                  "f32", "missing", "f64_bias"])
def test_bwd_wrapper_refuses_a_stage_pack_it_cannot_copy(case):
    c, nh, hidden = 24, 4, 48
    pk = pack_swin_block(seeded_params(c, nh, hidden), nh, folded=False)
    x = torch.zeros(1, 8, 8, c, dtype=torch.bfloat16)
    st = pk.bwd_stages
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
    pk = pk._replace(bwd_stages=st)
    if case == "aligned":
        _check_bwd_stages(x, pk, nh, hidden)
    else:
        with pytest.raises(ValueError,
                           match="aligned|elements|weight stages|f32"):
            _check_bwd_stages(x, pk, nh, hidden)
