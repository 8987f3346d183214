"""The port's window kernels for windows up to 8 on the CPU, f32.

* Kernel A's plain version ``swin_block_win_reference`` against the JAX
  window-pair kernel ``swin_block_pallas`` in interpret mode, after the
  roll and ``window_partition`` it expects: ws 7 on 28x28 (16 windows) and
  21x35 (15, an odd count), ws 4, with and without the shift mask. atol 2e-5
  as tests/test_pallas.py holds the JAX kernel: the Pallas body uses the A&S
  GELU (~1.5e-7), a max-free softmax and LN affines folded into the
  weights; it stores the score bias in bf16, so the tables here hold
  bf16-representable values.
* Kernel B's plain version, the composed ``window_msa``, against JAX's
  ``window_msa_pallas`` in interpret mode: no mask, the shifted mask, no
  qkv bias (tests/test_pallas.py:28-56), atol 2e-5.
* ``padded_window_bias`` against JAX's ``make_pair_bias(n_pad=64)``.
* Replays of kernels A and B in PyTorch on their packed operands: windows
  read at the folded phase, padded to 64 rows, the padded keys' score
  bias, only real rows written; against the plain versions, atol 1e-4.
  The kernels themselves run only on the card (chip_smoke.py phases 8-9).
* The shared-memory layouts of csrc/swin_block.cu at every width the port
  serves, and the checks that refuse a layout over the card's limit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu.ops.pallas.window_msa import make_pair_bias, window_msa_pallas
from kair_tpu.ops.window_attention import (relative_position_index,
                                           shift_attn_mask)
from kair_tpu.ops.window_attention import window_partition as jpartition
from kair_tpu.ops.window_attention import window_reverse as jreverse
from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams,
                                                   _check_cuda_args,
                                                   block_shared_bytes,
                                                   bwd_shared_bytes,
                                                   pack_swin_block,
                                                   swin_block_2d,
                                                   swin_block_win_reference)
from kair_tpu_torch.ops.kernels.window_msa import (N_PAD, SMEM_LIMIT,
                                                   pack_window_msa,
                                                   padded_window_bias,
                                                   shared_bytes,
                                                   window_msa_win,
                                                   window_msa_win_reference)
from kair_tpu_torch.ops.window_attention import (window_msa, window_partition,
                                                  window_reverse)

ATOL_JAX = 2e-5
ATOL_REPLAY = 1e-4
C, NH = 24, 4

WIN_CASES = [  # (b, h, w, ws, masked)
    (1, 28, 28, 7, False), (1, 28, 28, 7, True),
    (2, 21, 35, 7, False), (2, 21, 35, 7, True),
    (1, 16, 20, 4, False), (1, 16, 20, 4, True),
]


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def block_inputs(b, h, w, ws, seed=0, c=C, nh=NH):
    """numpy x (B,H,W,C) and block weights in the JAX (in, out) layout."""
    rng = np.random.RandomState(seed)
    f = lambda *s, std=1.0, mean=0.0: (rng.randn(*s) * std + mean).astype(np.float32)
    hid = 2 * c
    x = f(b, h, w, c)
    jp = dict(qkv_kernel=f(c, 3 * c, std=0.1), qkv_bias=f(3 * c, std=0.1),
              proj_kernel=f(c, c, std=0.1), proj_bias=f(c, std=0.1),
              bias_table=_bf16_exact(f((2 * ws - 1) ** 2, nh, std=0.5)),
              ln1_scale=f(c, std=0.1, mean=1.0), ln1_bias=f(c, std=0.1),
              ln2_scale=f(c, std=0.1, mean=1.0), ln2_bias=f(c, std=0.1),
              fc1_kernel=f(c, hid, std=0.1), fc1_bias=f(hid, std=0.1),
              fc2_kernel=f(hid, c, std=0.1), fc2_bias=f(c, std=0.1))
    return x, jp


def torch_params(jp) -> SwinBlockParams:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return SwinBlockParams(
        t(jp["qkv_kernel"].T), t(jp["qkv_bias"]), t(jp["proj_kernel"].T),
        t(jp["proj_bias"]), t(jp["bias_table"]), t(jp["ln1_scale"]),
        t(jp["ln1_bias"]), t(jp["ln2_scale"]), t(jp["ln2_bias"]),
        t(jp["fc1_kernel"].T), t(jp["fc1_bias"]), t(jp["fc2_kernel"].T),
        t(jp["fc2_bias"]))


def _mask(h, w, ws, masked):
    return shift_attn_mask(h, w, ws, ws // 2) if masked else None


@pytest.mark.parametrize("b,h,w,ws,masked", WIN_CASES)
def test_swin_block_win_reference_matches_pallas(b, h, w, ws, masked):
    x, jp = block_inputs(b, h, w, ws)
    mask = _mask(h, w, ws, masked)
    phase = ws // 2 if masked else 0
    j = {k: jnp.asarray(v) for k, v in jp.items()}
    xw = jpartition(jnp.roll(jnp.asarray(x), (-phase, -phase), (1, 2)), ws)
    yw = jsb.swin_block_pallas(
        xw, j["qkv_kernel"], j["qkv_bias"], j["proj_kernel"], j["proj_bias"],
        j["bias_table"], relative_position_index(ws, ws), NH,
        j["ln1_scale"], j["ln1_bias"], j["ln2_scale"], j["ln2_bias"],
        j["fc1_kernel"], j["fc1_bias"], j["fc2_kernel"], j["fc2_bias"],
        None if mask is None else jnp.asarray(mask), interpret=True)
    want = np.asarray(jreverse(yw, ws, h, w))
    got = swin_block_win_reference(
        torch.from_numpy(x), torch_params(jp), NH,
        None if mask is None else torch.from_numpy(mask), phase, ws)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_JAX)


def _msa_setup(b=1, nw=4, n=64, c=60, nh=6, seed=0):
    """tests/test_pallas.py::_setup, in numpy."""
    rng = np.random.RandomState(seed)
    xw = rng.randn(b, nw, n, c).astype(np.float32) * 0.5
    qkv_k = rng.randn(c, 3 * c).astype(np.float32) * 0.05
    qkv_b = rng.randn(3 * c).astype(np.float32) * 0.05
    pk = rng.randn(c, c).astype(np.float32) * 0.05
    pb = rng.randn(c).astype(np.float32) * 0.05
    ws = int(np.sqrt(n))
    bt = rng.randn((2 * ws - 1) ** 2, nh).astype(np.float32) * 0.05
    return xw, qkv_k, qkv_b, pk, pb, bt, nh, ws


@pytest.mark.parametrize("case", ["nomask", "shifted_mask", "no_qkv_bias"])
def test_window_msa_matches_pallas(case):
    b, nw = (2, 8) if case == "shifted_mask" else (1, 4)
    xw, qkv_k, qkv_b, pk, pb, bt, nh, ws = _msa_setup(b=b, nw=nw)
    if case == "no_qkv_bias":
        qkv_b = None
    mask = shift_attn_mask(16, 32, ws, ws // 2) if case == "shifted_mask" else None
    ri = relative_position_index(ws, ws)
    j = lambda a: None if a is None else jnp.asarray(a)
    want = window_msa_pallas(j(xw), j(qkv_k), j(qkv_b), j(pk), j(pb), j(bt),
                             jnp.asarray(ri), nh, j(mask), interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    got = window_msa(t(xw), t(qkv_k.T), t(qkv_b), t(pk.T), t(pb), t(bt), ri,
                     nh, t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_JAX,
                               rtol=1e-4)


@pytest.mark.parametrize("ws,masked", [(7, False), (7, True), (4, True)])
def test_padded_window_bias_matches_make_pair_bias(ws, masked):
    """Per window, the kernels' padded score bias is the diagonal block of
    JAX's pair bias with n_pad=64: −1e9 on padded keys, 0 on padded query
    rows' real keys."""
    h, w = 2 * ws, 4 * ws                                   # 8 windows
    table = np.random.RandomState(ws).randn((2 * ws - 1) ** 2, NH).astype(np.float32)
    mask = _mask(h, w, ws, masked)
    pair = np.asarray(make_pair_bias(
        jnp.asarray(table), relative_position_index(ws, ws), NH,
        None if mask is None else jnp.asarray(mask), 4, n_pad=N_PAD))
    from kair_tpu_torch.ops.kernels.window_msa import window_bias
    got = padded_window_bias(window_bias(torch.from_numpy(table), NH, ws),
                             None if mask is None else torch.from_numpy(mask)
                             ).numpy()
    for k in range(8):
        blk = pair[k // 2][:, :64, :64] if k % 2 == 0 else pair[k // 2][:, 64:, 64:]
        np.testing.assert_allclose(got[k if masked else 0], blk, atol=1e-6)


def _read_windows(x, ws, phase):
    """The kernels' folded read: token (r, c) of the map at shift ``phase``
    comes from x[(r + phase) % H, (c + phase) % W]; windows padded to 64
    zero rows. Returns the padded windows and the (rows, cols) it used."""
    b, h, w, c = x.shape
    rows, cols = (torch.arange(h) + phase) % h, (torch.arange(w) + phase) % w
    xw = window_partition(x[:, rows][:, :, cols], ws)
    return F.pad(xw, (0, 0, 0, N_PAD - ws * ws)), rows, cols


def _attention(a, wqkv, bqkv, wp, nh, bias):
    """qkv → scores + bias → softmax → PV → proj on 64-row windows."""
    qkv = (a @ wqkv.float() + bqkv).reshape(*a.shape[:3], nh, 3, 32)
    q, k, v = (qkv[..., i, :].permute(0, 1, 3, 2, 4) for i in range(3))
    p = torch.softmax(q @ k.transpose(-1, -2) + bias, -1)
    n = N_PAD - int((bias[0, 0, 0] <= -1e8).sum())
    assert torch.all(p[..., n:] == 0)               # padded keys: exactly 0
    o = (p @ v).permute(0, 1, 3, 2, 4).reshape(*a.shape[:3], nh * 32)
    return o @ wp.float()


def emulate_block_win(x, pk, nh, mask, phase, ws):
    """Kernel A step by step on the packed operands; real rows stored in
    the block's own coordinates."""
    b, h, w, c = x.shape
    cp, n = pk.wqkv.shape[0], ws * ws
    xw, _, _ = _read_windows(x, ws, phase)
    bias = padded_window_bias(pk.relbias, mask)
    a = F.pad(F.layer_norm(xw, (c,)), (0, cp - c))
    x1 = xw + _attention(a, pk.wqkv, pk.bqkv, pk.wp, nh, bias)[..., :c] + pk.bp
    z = F.pad(F.layer_norm(x1, (c,)), (0, cp - c))
    hid = F.gelu(z @ pk.w1.float() + pk.b1)
    y = x1 + (hid @ pk.w2.float())[..., :c] + pk.b2
    return window_reverse(y[:, :, :n], ws, h, w)


def emulate_msa_win(y, pk, nh, mask, phase, ws):
    """Kernel B step by step: real rows written back to the pixels they
    were read from (un-rolled)."""
    b, h, w, c = y.shape
    cp, n = pk.wqkv.shape[0], ws * ws
    yw, rows, cols = _read_windows(y, ws, phase)
    a = _attention(F.pad(yw, (0, cp - c)), pk.wqkv, pk.bqkv, pk.wp, nh,
                   padded_window_bias(pk.relbias, mask))[..., :c] + pk.bp
    out = torch.empty_like(y)
    out[:, rows[:, None], cols[None, :]] = window_reverse(a[:, :, :n], ws, h, w)
    return out


@pytest.mark.parametrize("b,h,w,ws,masked", WIN_CASES)
def test_kernel_a_layout_matches_reference(b, h, w, ws, masked):
    x, jp = block_inputs(b, h, w, ws, seed=1)
    p = torch_params(jp)
    mask = torch.from_numpy(_mask(h, w, ws, True)) if masked else None
    phase = ws // 2 if masked else -(ws // 2)
    pk = pack_swin_block(p, NH, dtype=torch.float32)
    assert pk.relbias.shape == (NH, ws * ws, ws * ws)
    xt = torch.from_numpy(x)
    got = emulate_block_win(xt, pk, NH, mask, phase, ws)
    want = swin_block_win_reference(xt, p, NH, mask, phase, ws)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL_REPLAY)


@pytest.mark.parametrize("b,h,w,ws,masked", WIN_CASES + [(1, 16, 24, 8, True)])
def test_kernel_b_layout_matches_reference(b, h, w, ws, masked):
    x, jp = block_inputs(b, h, w, ws, seed=2)
    p = torch_params(jp)
    mask = torch.from_numpy(_mask(h, w, ws, True)) if masked else None
    phase = ws // 2 if masked else 0
    pk = pack_window_msa(p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias,
                         p.rel_table, NH, dtype=torch.float32)
    yt = torch.from_numpy(x)
    got = emulate_msa_win(yt, pk, NH, mask, phase, ws)
    want = window_msa_win_reference(yt, p.qkv_weight, p.qkv_bias,
                                    p.proj_weight, p.proj_bias, p.rel_table,
                                    NH, mask, phase, ws)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL_REPLAY)


def test_wrappers_take_plain_versions_on_cpu():
    x, jp = block_inputs(1, 14, 21, 7)
    p, xt = torch_params(jp), torch.from_numpy(x)
    mask = torch.from_numpy(_mask(14, 21, 7, True))
    counts = lambda: (swin_block_2d.launches, swin_block_2d.launches_win,
                      window_msa_win.launches)
    before = counts()
    assert torch.equal(swin_block_2d(xt, p, NH, mask, 3, 7),
                       swin_block_win_reference(xt, p, NH, mask, 3, 7))
    args = (p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias, p.rel_table,
            NH, mask, 3, 7)
    assert torch.equal(window_msa_win(xt, *args),
                       window_msa_win_reference(xt, *args))
    assert counts() == before



def test_rel_index_cached_under_inference_mode_serves_a_backward():
    """The device index the plain versions gather through is cached on
    first use. Made first under inference_mode (an inference forward), it
    must still serve a later backward: the gather saves it."""
    from kair_tpu_torch.ops.kernels import window_msa as wm
    wm._rel_index_on.cache_clear()
    x, jp = block_inputs(1, 14, 21, 7)
    p, xt = torch_params(jp), torch.from_numpy(x)
    with torch.inference_mode():
        swin_block_win_reference(xt, p, NH, None, 0, 7)
    table = p.rel_table.clone().requires_grad_(True)
    swin_block_win_reference(xt, p._replace(rel_table=table), NH, None, 0,
                             7).sum().backward()
    assert table.grad is not None and torch.isfinite(table.grad).all()


# SwinIR-light (C=60), SwinIR-M (C=180) and SwinIR-L (C=240) widths, MLP
# ratio 2; ViT-style ratio 4 at C=96
WIDTHS = [(60, 6, 120), (180, 6, 360), (240, 8, 480), (96, 6, 384)]


@pytest.mark.parametrize("c,nh,hidden", WIDTHS)
def test_forward_layouts_fit_the_card(c, nh, hidden):
    hp = -(-hidden // 16) * 16
    assert block_shared_bytes(c, nh, hp) <= SMEM_LIMIT
    assert shared_bytes(c, nh) <= SMEM_LIMIT
    x = torch.zeros(1, 16, 16, c, dtype=torch.bfloat16)
    _, jp = block_inputs(1, 8, 8, 8, c=c, nh=nh)
    jp["fc1_kernel"] = np.zeros((c, hidden), np.float32)
    _check_cuda_args(x, torch_params(jp), nh, None)        # does not raise


def test_layout_sizes_at_swinir_m_and_l():
    """Shared memory per thread block at SwinIR-M and SwinIR-L widths: the
    block 151,840 B and 198,560 B, kernel B (attention only) 137,168 B and
    170,944 B, the backward 218,016 B and 284,160 B, over the card's
    232,448."""
    assert block_shared_bytes(180, 6, 368) == 151840
    assert block_shared_bytes(240, 8, 480) == 198560
    assert shared_bytes(180, 6) == 137168
    assert shared_bytes(240, 8) == 170944
    assert bwd_shared_bytes(180, 6, 368) == 218016
    assert bwd_shared_bytes(240, 8, 480) == 284160 > SMEM_LIMIT


def test_backward_refuses_swinir_l_width_before_launch():
    x = torch.zeros(1, 16, 16, 240, dtype=torch.bfloat16)
    _, jp = block_inputs(1, 8, 8, 8, c=240, nh=8)
    with pytest.raises(ValueError, match="shared memory"):
        _check_cuda_args(x, torch_params(jp), 8, None, backward=True)


@pytest.mark.parametrize("case", ["ws9", "h_not_ws", "table", "mask_shape",
                                  "f32"])
def test_window_wrappers_reject_what_the_kernels_do_not_take(case):
    from kair_tpu_torch.ops.kernels.window_msa import check_geometry
    ws, h, w = 7, 14, 21
    x, jp = block_inputs(1, h, w, ws)
    p = torch_params(jp)
    xt, mask, err = torch.from_numpy(x).to(torch.bfloat16), None, ValueError
    if case == "ws9":
        ws = 9
    elif case == "h_not_ws":
        xt = xt[:, :12].contiguous()
    elif case == "table":
        p = p._replace(rel_table=torch.zeros(225, NH))
    elif case == "mask_shape":
        mask = torch.zeros(6, 64, 64)
    elif case == "f32":
        xt, err = xt.float(), TypeError
    with pytest.raises(err):
        check_geometry("t", xt, p.qkv_weight, NH, p.rel_table, mask, ws, 0)
