"""The port's two kernel modules on the CPU.

* The plain versions (``swin_block_2d_reference``,
  ``conv3x3_residual_reference``) against the JAX Pallas kernels they
  replace, run in interpret mode (``swin_block_pallas_2d``,
  ``conv3x3_residual``), on the same numpy inputs in f32. atol 1e-4: the
  Pallas inference body uses the A&S GELU (~1.5e-7), the max-free softmax
  and LN affines folded into the weights, the port's plain version exact
  GELU, a max-subtracted softmax and explicit LN affines. The Pallas kernel
  stores a shifted block's score bias in bf16, so the test's bias table
  holds bf16-representable values, which that storage keeps exact.
* The CUDA kernels' operand layouts (``pack_swin_block``, ``pack_conv3x3``'s
  swizzled weight stages) and index arithmetic (shift read, window order,
  halo buffers, tile walk) replayed in PyTorch from the packed operands,
  against the plain versions (f32 packs, atol 1e-4); the conv kernel's
  shared-memory arithmetic. The kernels themselves run only on the card
  (chip_smoke.py).
* The wrappers take the plain version for CPU tensors and never count a
  launch there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.conv_block as jcb
import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu.ops.window_attention import (relative_position_index,
                                           shift_attn_mask)
from kair_tpu_torch.ops.kernels.conv_block import (HALO_LD, HALO_PIX, KC,
                                                   SMEM_LIMIT, _swizzle_cols,
                                                   conv3x3_residual,
                                                   conv3x3_residual_reference,
                                                   conv_plan, pack_conv3x3,
                                                   shared_bytes, stage_bytes)
from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams,
                                                   pack_swin_block,
                                                   swin_block_2d,
                                                   swin_block_2d_reference)
from kair_tpu_torch.ops.kernels.window_msa import window_bias
from kair_tpu_torch.ops.window_attention import (rel_pos_bias, window_partition,
                                                  window_reverse)

ATOL = 1e-4

SWIN_CASES = [  # (b, h, w, c, nh, phase, masked)
    (1, 16, 32, 180, 6, 0, False),
    (1, 16, 32, 180, 6, 4, True),
    (1, 16, 32, 180, 6, -4, False),
    (2, 32, 32, 24, 4, 0, False),
    (2, 32, 32, 24, 4, 4, True),
    (2, 32, 32, 24, 4, -4, False),
]


def _bf16_exact(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def swin_inputs(b, h, w, c, nh, seed=0):
    """numpy x (B,H,W,C) and block weights in the JAX (in, out) layout."""
    rng = np.random.RandomState(seed)
    f = lambda *s, std=1.0, mean=0.0: (rng.randn(*s) * std + mean).astype(np.float32)
    hid = 2 * c
    x = f(b, h, w, c)
    jp = dict(qkv_kernel=f(c, 3 * c, std=0.1), qkv_bias=f(3 * c, std=0.1),
              proj_kernel=f(c, c, std=0.05), proj_bias=f(c, std=0.1),
              bias_table=_bf16_exact(f(225, nh, std=0.5)),
              ln1_scale=f(c, std=0.1, mean=1.0), ln1_bias=f(c, std=0.1),
              ln2_scale=f(c, std=0.1, mean=1.0), ln2_bias=f(c, std=0.1),
              fc1_kernel=f(c, hid, std=0.05), fc1_bias=f(hid, std=0.1),
              fc2_kernel=f(hid, c, std=0.05), fc2_bias=f(c, std=0.1))
    return x, jp


def torch_params(jp) -> SwinBlockParams:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return SwinBlockParams(
        t(jp["qkv_kernel"].T), t(jp["qkv_bias"]), t(jp["proj_kernel"].T),
        t(jp["proj_bias"]), t(jp["bias_table"]), t(jp["ln1_scale"]),
        t(jp["ln1_bias"]), t(jp["ln2_scale"]), t(jp["ln2_bias"]),
        t(jp["fc1_kernel"].T), t(jp["fc1_bias"]), t(jp["fc2_kernel"].T),
        t(jp["fc2_bias"]))


@pytest.mark.parametrize("b,h,w,c,nh,phase,masked", SWIN_CASES)
def test_swin_reference_matches_pallas(b, h, w, c, nh, phase, masked):
    x, jp = swin_inputs(b, h, w, c, nh)
    mask = shift_attn_mask(h, w, 8, 4) if masked else None
    j = {k: jnp.asarray(v) for k, v in jp.items()}
    want = jsb.swin_block_pallas_2d(
        jnp.asarray(x), j["qkv_kernel"], j["qkv_bias"], j["proj_kernel"],
        j["proj_bias"], j["bias_table"], relative_position_index(8, 8), nh,
        j["ln1_scale"], j["ln1_bias"], j["ln2_scale"], j["ln2_bias"],
        j["fc1_kernel"], j["fc1_bias"], j["fc2_kernel"], j["fc2_bias"],
        None if mask is None else jnp.asarray(mask), interpret=True,
        phase=phase)
    p = torch_params(jp)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = swin_block_2d_reference(torch.from_numpy(x), p, nh, tmask, phase)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def emulate_swin_kernel(x, pk, nh, mask, phase):
    """The fused block step by step on pack_swin_block's matrices."""
    b, h, w, c = x.shape
    cp = pk.wqkv.shape[0]
    # token (r, c) of the block reads x[(r + phase) % H, (c + phase) % W]
    rows = (torch.arange(h) + phase) % h
    cols = (torch.arange(w) + phase) % w
    xw = window_partition(x[:, rows][:, :, cols], 8)          # (B, nW, 64, C)
    a = F.pad(F.layer_norm(xw, (c,)), (0, cp - c))
    qkv = (a @ pk.wqkv.float() + pk.bqkv).reshape(*xw.shape[:3], nh, 3, 32)
    q, k, v = (qkv[..., i, :].permute(0, 1, 3, 2, 4) for i in range(3))
    s = q @ k.transpose(-1, -2) + pk.relbias
    if mask is not None:
        s = s + mask[None, :, None]                          # window order
    o = (torch.softmax(s, -1) @ v).permute(0, 1, 3, 2, 4).reshape(
        *xw.shape[:3], nh * 32)
    x1 = xw + (o @ pk.wp.float())[..., :c] + pk.bp
    z = F.pad(F.layer_norm(x1, (c,)), (0, cp - c))
    hid = F.gelu(z @ pk.w1.float() + pk.b1)
    y = x1 + (hid @ pk.w2.float())[..., :c] + pk.b2
    return window_reverse(y, 8, h, w)


@pytest.mark.parametrize("b,h,w,c,nh,phase,masked", SWIN_CASES)
def test_swin_kernel_layout_matches_reference(b, h, w, c, nh, phase, masked):
    x, jp = swin_inputs(b, h, w, c, nh, seed=1)
    p = torch_params(jp)
    mask = torch.from_numpy(shift_attn_mask(h, w, 8, 4)) if masked else None
    pk = pack_swin_block(p, nh, dtype=torch.float32)
    assert pk.wqkv.shape == (-(-c // 16) * 16, nh * 96)
    xt = torch.from_numpy(x)
    got = emulate_swin_kernel(xt, pk, nh, mask, phase)
    want = swin_block_2d_reference(xt, p, nh, mask, phase)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


def test_swin_wrapper_takes_plain_version_on_cpu():
    x, jp = swin_inputs(1, 16, 16, 24, 4)
    p = torch_params(jp)
    before = swin_block_2d.launches
    got = swin_block_2d(torch.from_numpy(x), p, 4, None, 0)
    want = swin_block_2d_reference(torch.from_numpy(x), p, 4, None, 0)
    assert torch.equal(got, want)
    assert swin_block_2d.launches == before


CONV_CASES = [(1, 16, 16, 180, 0), (1, 16, 16, 180, 4),
              (2, 16, 32, 24, 0), (2, 16, 32, 24, 4)]


def conv_inputs(b, h, w, c, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randn(b, h, w, c).astype(np.float32)
    r = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)   # HWIO
    bias = (rng.randn(c) * 0.1).astype(np.float32)
    return y, r, k, bias


@pytest.mark.parametrize("ws", [4, 7, 8])
def test_window_bias_matches_jax_gather(ws):
    """The kernels' score bias (``window_bias``, gathered on the index cached
    on the table's device) and ``rel_pos_bias`` from the (N, N) index both
    equal the relative-position gather of JAX's ``window_msa``."""
    nh, n = 3, ws * ws
    table = np.random.RandomState(ws).randn((2 * ws - 1) ** 2, nh).astype(np.float32)
    idx = relative_position_index(ws, ws)
    want = np.asarray(jnp.asarray(table)[idx.reshape(-1)].reshape(
        n, n, nh).transpose(2, 0, 1))
    got = window_bias(torch.from_numpy(table), nh, ws)
    assert got.is_contiguous() and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rel_pos_bias(torch.from_numpy(table), idx, nh).numpy(), want)

@pytest.mark.parametrize("b,h,w,c,phase", CONV_CASES)
def test_conv_reference_matches_pallas(b, h, w, c, phase):
    y, r, k, bias = conv_inputs(b, h, w, c)
    want = jcb.conv3x3_residual(jnp.asarray(y), jnp.asarray(r), jnp.asarray(k),
                                jnp.asarray(bias), phase=phase, interpret=True)
    t = torch.from_numpy
    got = conv3x3_residual_reference(t(y), t(r), t(k.transpose(3, 2, 0, 1).copy()),
                                     t(bias), phase)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def unpack_conv_stages(wpk, c):
    """The packed weight's stages back in plain (n, k) order: (N chunks,
    K chunks, 9, NT, 64), undoing the 128-byte swizzle of each row."""
    nt, ncs, kcs = conv_plan(c)
    idx = _swizzle_cols(nt).expand(wpk.shape)
    return torch.gather(wpk.float(), -1, idx).reshape(ncs, kcs, 9, nt, KC)


def emulate_conv_kernel(y, res, wpk, bias, phase):
    """csrc/conv_block.cu on the packed stages, tile by tile: tiles of 6 x 32
    pixels; per tile and 64-channel K chunk a halo buffer of 8 x 34 pixels x
    HALO_LD (the un-rolled source, zeros outside the frame and past C);
    warpgroup g's A row m at the kernel's element offset ((2g + m // 32) * 34
    + m % 32 + tap row * 34 + tap column) * HALO_LD; nine taps times the
    unswizzled stage (NT x 64, K-major) per N chunk; the epilogue adds bias
    and residual where the pixel and channel exist."""
    b, h, w, c = y.shape
    nt, ncs, kcs = conv_plan(c)
    stages = unpack_conv_stages(wpk, c)
    rows = (torch.arange(h) - phase) % h
    cols = (torch.arange(w) - phase) % w
    th, tw = -(-h // 6) * 6, -(-w // 32) * 32
    src = torch.zeros(b, th + 2, tw + 2, kcs * KC)
    src[:, 1:h + 1, 1:w + 1, :c] = y[:, rows][:, :, cols]
    m = torch.arange(64)
    a_rows = [((2 * g + m // 32) * 34 + m % 32) * HALO_LD for g in range(3)]
    out = torch.zeros(b, th, tw, ncs * nt)
    for bi in range(b):
        for i0 in range(0, h, 6):
            for j0 in range(0, w, 32):
                for nc in range(ncs):
                    acc = torch.zeros(3, 64, nt)
                    for kc in range(kcs):
                        halo = torch.zeros(HALO_PIX, HALO_LD)
                        halo[:, :KC] = src[bi, i0:i0 + 8, j0:j0 + 34,
                                           kc * KC:(kc + 1) * KC].reshape(-1, KC)
                        flat = halo.reshape(-1)
                        for tap in range(9):
                            shift = (tap // 3 * 34 + tap % 3) * HALO_LD
                            for g in range(3):
                                at = (a_rows[g] + shift)[:, None] + torch.arange(KC)
                                acc[g] += flat[at] @ stages[nc, kc, tap].T
                    for g in range(3):
                        out[bi, i0 + 2 * g + m // 32, j0 + m % 32,
                            nc * nt:(nc + 1) * nt] = acc[g]
    return out[:, :h, :w, :c] + bias + res


@pytest.mark.parametrize("b,h,w,c,phase", CONV_CASES + [
    (1, 8, 72, 10, 3), (1, 8, 72, 60, 5), (2, 7, 40, 180, 3),
    (1, 6, 16, 240, 1)])
def test_conv_kernel_layout_matches_reference(b, h, w, c, phase):
    """At C = 10, 24, 60 (NT 64), 180 (NT 184) and 240 (two N chunks of
    128), tiles ragged in H and W."""
    y, r, k, bias = conv_inputs(b, h, w, c, seed=1)
    t = torch.from_numpy
    weight = t(k.transpose(3, 2, 0, 1).copy())
    wpk = pack_conv3x3(weight, dtype=torch.float32)
    got = emulate_conv_kernel(t(y), t(r), wpk, t(bias), phase)
    want = conv3x3_residual_reference(t(y), t(r), weight, t(bias), phase)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("c,plan,want", [
    (6, (64, 1, 1), 106488), (60, (64, 1, 1), 127224),
    (180, (184, 1, 3), 219384), (240, (128, 2, 4), 128760),
    (368, (184, 2, 6), 150264), (370, (128, 3, 6), 128760)])
def test_conv_shared_memory_arithmetic(c, plan, want):
    """ConvPlan's arithmetic (csrc/conv_block.cu): the N chunks, the K
    chunks and the bytes of the layout (the staging buffers only with one N
    chunk); weight stages and halo buffers are 16-byte multiples (bulk and
    cp.async copies) and stages 1024-byte multiples (swizzle atoms); every
    C fits the card's opt-in limit."""
    assert conv_plan(c) == plan
    assert shared_bytes(c) == want <= SMEM_LIMIT
    assert stage_bytes(c) % 1024 == 0 and (HALO_PIX * HALO_LD * 2) % 16 == 0
    wpk = pack_conv3x3(torch.zeros(c, c, 3, 3))
    assert tuple(wpk.shape) == (plan[1] * plan[2] * 9, plan[0], KC)
    assert wpk.shape[1] * wpk.shape[2] * 2 == stage_bytes(c)


def test_conv_wrapper_takes_plain_version_on_cpu():
    y, r, k, bias = conv_inputs(1, 8, 8, 6)
    t = torch.from_numpy
    weight = t(k.transpose(3, 2, 0, 1).copy())
    before = conv3x3_residual.launches
    got = conv3x3_residual(t(y), t(r), weight, t(bias), 4)
    assert torch.equal(got, conv3x3_residual_reference(t(y), t(r), weight,
                                                       t(bias), 4))
    assert conv3x3_residual.launches == before


def _swin_args(shape=(1, 16, 16, 24), nh=4, dtype=torch.bfloat16):
    x = torch.zeros(shape, dtype=dtype)
    _, jp = swin_inputs(1, 16, 16, shape[-1], nh)
    return x, torch_params(jp)


@pytest.mark.parametrize("case", ["f32", "h_not_8", "c_odd_heads", "qkv_shape",
                                  "mask_shape", "noncontig", "shared_memory"])
def test_swin_wrapper_rejects_what_the_kernel_does_not_take(case):
    from kair_tpu_torch.ops.kernels.swin_block import _check_cuda_args
    x, p = _swin_args()
    nh, mask = 4, None
    err = ValueError
    if case == "f32":
        x, err = x.float(), TypeError
    elif case == "h_not_8":
        x = torch.zeros(1, 12, 16, 24, dtype=torch.bfloat16)
    elif case == "c_odd_heads":
        nh = 5
    elif case == "qkv_shape":
        p = p._replace(qkv_weight=p.qkv_weight[:, :12])
    elif case == "mask_shape":
        mask = torch.zeros(3, 64, 64)
    elif case == "noncontig":
        x = x.transpose(1, 2)
    elif case == "shared_memory":      # 16 heads of 30 at C=480: 373,248 B
        x, p = _swin_args((1, 16, 16, 480), nh=16)
        nh = 16
    with pytest.raises(err):
        _check_cuda_args(x, p, nh, mask)


@pytest.mark.parametrize("case", ["f32", "shape_mismatch", "c_odd", "weight"])
def test_conv_wrapper_rejects_what_the_kernel_does_not_take(case):
    from kair_tpu_torch.ops.kernels.conv_block import _check_cuda_args
    y = torch.zeros(1, 8, 8, 6, dtype=torch.bfloat16)
    res, weight, bias, err = y.clone(), torch.zeros(6, 6, 3, 3), torch.zeros(6), ValueError
    if case == "f32":
        y, res, err = y.float(), res.float(), TypeError
    elif case == "shape_mismatch":
        res = torch.zeros(1, 8, 16, 6, dtype=torch.bfloat16)
    elif case == "c_odd":
        y = res = torch.zeros(1, 8, 8, 5, dtype=torch.bfloat16)
        weight, bias = torch.zeros(5, 5, 3, 3), torch.zeros(5)
    elif case == "weight":
        weight = torch.zeros(6, 6, 1, 1)
    with pytest.raises(err):
        _check_cuda_args(y, res, weight, bias)


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A contiguous copy of t whose data starts nbytes past an aligned one."""
    k = nbytes // t.element_size()
    return torch.zeros(t.numel() + k, dtype=t.dtype)[k:].view(t.shape)


@pytest.mark.parametrize("case", ["aligned", "y_c6_at_4", "packed_weight",
                                  "y_at_4", "res_at_2", "bias_at_4", "pixels"])
def test_conv_wrapper_refuses_misaligned_operands(case):
    from kair_tpu_torch.ops.kernels.conv_block import _check_alignment
    c = 6 if case == "y_c6_at_4" else 8
    y = res = torch.zeros(1, 8, 8, c, dtype=torch.bfloat16)
    wpk, bias32 = pack_conv3x3(torch.zeros(c, c, 3, 3)), torch.zeros(c)
    if case == "y_c6_at_4":           # C % 4 != 0: 4-byte halo copies
        y = _offset(y, 4)
    elif case == "packed_weight":
        wpk = _offset(wpk, 8)
    elif case == "y_at_4":
        y = _offset(y, 4)
    elif case == "res_at_2":
        res = _offset(res, 2)
    elif case == "bias_at_4":
        bias32 = _offset(bias32, 4)
    elif case == "pixels":            # 2^31 pixels: 32-bit offsets
        y = res = torch.empty(2 ** 15, 256, 256, c, dtype=torch.bfloat16,
                              device="meta")
    if case in ("aligned", "y_c6_at_4"):
        _check_alignment(y, res, wpk, bias32)
    else:
        with pytest.raises(ValueError, match="aligned|2\\^31"):
            _check_alignment(y, res, wpk, bias32)
