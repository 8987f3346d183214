"""The Swin-block backward (kernel 3) on the CPU.

* The plain version ``swin_block_2d_bwd_reference`` against ``jax.vjp`` of
  ``swin_block_pallas_2d(..., safe=True)`` with the Pallas forward and
  backward kernels in interpret mode, f32, the same numpy inputs: dx and all
  13 parameter grads, the relative-position table included, at atol 5e-5,
  rtol 1e-3 (the tolerance of test_pallas.py's
  ``test_fused_block_2d_gradients_match_standard``; the Pallas backward uses
  the A&S erf, ~1.5e-7, the port the exact one).
* The CUDA kernel's stored operands (ones columns, compact dqkv order,
  pixel-ordered rows), its two-pass reduction over token chunks and the
  host-side unpacking, replayed in PyTorch from the ``folded=False`` pack,
  against the plain version (f32, atol 1e-4).
* The wrapper and the autograd Function take the plain version on the CPU
  and count no launch there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu.ops.window_attention import (relative_position_index,
                                           shift_attn_mask)
from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams,
                                                   bwd_layout, bwd_splits,
                                                   pack_swin_block,
                                                   swin_block_2d_bwd,
                                                   swin_block_2d_bwd_reference,
                                                   swin_block_train,
                                                   unpack_bwd_grads)
from kair_tpu_torch.ops.window_attention import window_partition, window_reverse
from tests.test_torch_kernels import swin_inputs, torch_params

CASES = [(1, 16, 16, 24, 4, False), (1, 16, 16, 24, 4, True),
         (2, 16, 32, 24, 4, False), (2, 16, 32, 24, 4, True)]
IDS = [f"{b}x{h}x{w}x{c}-{'mask' if m else 'nomask'}"
       for b, h, w, c, _, m in CASES]
# JAX argument order of swin_block_pallas_2d → the port's field names
JAX_ARGS = [("qkv_kernel", "qkv_weight"), ("qkv_bias", "qkv_bias"),
            ("proj_kernel", "proj_weight"), ("proj_bias", "proj_bias"),
            ("bias_table", "rel_table"), ("ln1_scale", "norm1_weight"),
            ("ln1_bias", "norm1_bias"), ("ln2_scale", "norm2_weight"),
            ("ln2_bias", "norm2_bias"), ("fc1_kernel", "fc1_weight"),
            ("fc1_bias", "fc1_bias"), ("fc2_kernel", "fc2_weight"),
            ("fc2_bias", "fc2_bias")]


def _dy(shape, seed=7):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("b,h,w,c,nh,masked", CASES, ids=IDS)
def test_reference_backward_matches_pallas_vjp(b, h, w, c, nh, masked):
    x, jp = swin_inputs(b, h, w, c, nh)
    dy = _dy(x.shape)
    mask = shift_attn_mask(h, w, 8, 4) if masked else None
    rel = relative_position_index(8, 8)

    def block(x_, *ws):
        kw = dict(zip([a for a, _ in JAX_ARGS], ws))
        return jsb.swin_block_pallas_2d(
            x_, kw["qkv_kernel"], kw["qkv_bias"], kw["proj_kernel"],
            kw["proj_bias"], kw["bias_table"], rel, nh, kw["ln1_scale"],
            kw["ln1_bias"], kw["ln2_scale"], kw["ln2_bias"], kw["fc1_kernel"],
            kw["fc1_bias"], kw["fc2_kernel"], kw["fc2_bias"],
            None if mask is None else jnp.asarray(mask), interpret=True,
            safe=True)

    _, vjp = jax.vjp(block, jnp.asarray(x),
                     *[jnp.asarray(jp[a]) for a, _ in JAX_ARGS])
    want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]

    p = torch_params(jp)
    tmask = None if mask is None else torch.from_numpy(mask)
    dx, grads = swin_block_2d_bwd_reference(torch.from_numpy(x),
                                            torch.from_numpy(dy), p, nh, tmask)
    tol = dict(atol=5e-5, rtol=1e-3)
    np.testing.assert_allclose(dx.numpy(), want[0], err_msg="dx", **tol)
    for (jname, tname), w_ in zip(JAX_ARGS, want[1:]):
        got = getattr(grads, tname).numpy()
        if tname.endswith("_weight") and got.ndim == 2:
            got = got.T                          # nn.Linear (out, in) → (in, out)
        np.testing.assert_allclose(got, w_, err_msg=tname, **tol)


def _ln(v, w, b):
    mu = v.mean(-1, keepdim=True)
    inv = torch.rsqrt(((v - mu) ** 2).mean(-1, keepdim=True) + 1e-5)
    xhat = (v - mu) * inv
    return xhat, inv, xhat * w + b


def _ln_bwd(g, xhat, inv, w):
    dz = g * w
    return inv * (dz - dz.mean(-1, keepdim=True)
                  - xhat * (dz * xhat).mean(-1, keepdim=True))


def _rows(v, width, ones=None):
    """Pixel-ordered operand rows (T, width): v's columns, a 1 at `ones`."""
    t = v.reshape(-1, v.shape[-1])
    out = torch.zeros(t.shape[0], width)
    out[:, :t.shape[1]] = t
    if ones is not None:
        out[:, ones] = 1.0
    return out


def emulate_bwd_kernel(x, dy, p, nh, mask):
    """csrc/swin_block_bwd.cu step by step on the folded=False pack: pass 1
    per window, the stored operands, pass 2 over token chunks, the ordered
    sums, then the host's unpacking."""
    b, h, w, c = x.shape
    hidden = p.fc1_weight.shape[0]
    lay = bwd_layout(c, hidden)
    pk = pack_swin_block(p, nh, dtype=torch.float32, folded=False)
    hd, scale = c // nh, (c // nh) ** -0.5
    pad = lambda v, n: F.pad(v, (0, n - v.shape[-1]))
    # forward recompute (per-token ops on the map, attention on windows)
    xhat1, inv1, h1 = _ln(x, p.norm1_weight, p.norm1_bias)
    qkv = window_partition(pad(h1, lay.cp) @ pk.wqkv + pk.bqkv, 8)
    qkv = qkv.reshape(*qkv.shape[:3], nh, 3, 32).permute(0, 1, 3, 4, 2, 5)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    s = (q @ k.transpose(-1, -2)) * scale + pk.relbias
    if mask is not None:
        s = s + mask[None, :, None]
    pr = torch.softmax(s, -1)
    o = (pr @ v).permute(0, 1, 3, 2, 4)                  # (B, nW, 64, nh, 32)
    o = window_reverse(o.reshape(*o.shape[:3], nh * 32), 8, h, w)
    x1 = x + (o @ pk.wp)[..., :c] + pk.bp
    xhat2, inv2, h2 = _ln(x1, p.norm2_weight, p.norm2_bias)
    pre = pad(h2, lay.cp) @ pk.w1 + pk.b1
    gelu = pre * 0.5 * (1 + torch.erf(pre * 0.5 ** 0.5))
    gp = 0.5 * (1 + torch.erf(pre * 0.5 ** 0.5)) \
        + pre * torch.exp(-0.5 * pre * pre) / (2 * np.pi) ** 0.5
    # backward
    dpre = (pad(dy, lay.cp) @ pk.w2.t()) * gp
    dpre[..., hidden:] = 0
    dh2 = (dpre @ pk.w1.t())[..., :c]
    dx1 = dy + _ln_bwd(dh2, xhat2, inv2, p.norm2_weight)
    dacc = window_partition(pad(dx1, lay.cp) @ pk.wp.t(), 8)
    do = dacc.reshape(*dacc.shape[:3], nh, 32).permute(0, 1, 3, 2, 4)
    dp = do @ v.transpose(-1, -2)
    ds = pr * (dp - (dp * pr).sum(-1, keepdim=True))
    dq, dk = scale * ds @ k, scale * ds.transpose(-1, -2) @ q
    dv = pr.transpose(-1, -2) @ do                       # (B, nW, nh, 64, 32)
    dqkv_i = torch.stack([dq, dk, dv], 3).permute(0, 1, 4, 2, 3, 5)
    dqkv_i = window_reverse(dqkv_i.reshape(*dqkv_i.shape[:3], nh * 96), 8, h, w)
    dh = (dqkv_i @ pk.wqkv.t())[..., :c]
    dx = dx1 + _ln_bwd(dh, xhat1, inv1, p.norm1_weight)
    # stored operands, rows in pixel order
    ao = o.reshape(b, h, w, nh, 32)[..., :hd].reshape(b, h, w, c)
    dqkv = dqkv_i.reshape(b, h, w, nh, 3, 32)[..., :hd]
    dqkv = dqkv.permute(0, 1, 2, 4, 3, 5).reshape(b, h, w, 3 * c)  # KAIR order
    pairs = [(_rows(h1, lay.k1, c), _rows(dqkv, lay.n3)),
             (_rows(ao, lay.k1, c), _rows(dx1, lay.cp)),
             (_rows(h2, lay.k1, c), _rows(dpre[..., :hidden], lay.hp)),
             (_rows(gelu[..., :hidden], lay.kg, hidden), _rows(dy, lay.cp))]
    tokens = b * h * w
    splits = bwd_splits(tokens) + 1          # more than one chunk at this size
    chunk = -(-tokens // splits + 15) // 16 * 16
    parts = [torch.cat([(a_[i:i + chunk].t() @ b_[i:i + chunk]).reshape(-1)
                        for a_, b_ in pairs])
             for i in range(0, tokens, chunk)]
    dw = torch.stack(parts).sum(0)
    red = lambda t: t.reshape(-1, c).sum(0)
    dln = torch.stack([red(dh * xhat1), red(dh), red(dh2 * xhat2), red(dh2)])
    dbias = ds.sum((0, 1))
    return dx, unpack_bwd_grads(dw, dln, dbias, p, nh)


@pytest.mark.parametrize("b,h,w,c,nh,masked",
                         CASES + [(1, 8, 24, 36, 3, True), (1, 16, 16, 32, 1, False)],
                         ids=IDS + ["1x8x24x36-mask", "1x16x16x32-hd32"])
def test_kernel_layout_and_reduction_match_reference(b, h, w, c, nh, masked):
    x, jp = swin_inputs(b, h, w, c, nh, seed=2)
    x, dy = torch.from_numpy(x), torch.from_numpy(_dy(x.shape, seed=3))
    p = torch_params(jp)
    mask = torch.from_numpy(shift_attn_mask(h, w, 8, 4)) if masked else None
    dx, grads = emulate_bwd_kernel(x, dy, p, nh, mask)
    rdx, rgrads = swin_block_2d_bwd_reference(x, dy, p, nh, mask)
    np.testing.assert_allclose(dx.numpy(), rdx.numpy(), atol=1e-4)
    for name, got, want in zip(SwinBlockParams._fields, grads, rgrads):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_bwd_layout_widths_at_swinir_m():
    lay = bwd_layout(180, 360)
    assert lay == (192, 368, 192, 368, 544)
    assert sum(r * k for r, k in lay.products()) == 282_624
    assert bwd_splits(32 * 48 * 48) == 32 and bwd_splits(1000) == 1


def test_wrapper_and_function_take_plain_version_on_cpu():
    x, jp = swin_inputs(1, 16, 16, 24, 4)
    p = torch_params(jp)
    xt, dy = torch.from_numpy(x), torch.from_numpy(_dy(x.shape))
    mask = torch.from_numpy(shift_attn_mask(16, 16, 8, 4))
    before = swin_block_2d_bwd.launches
    dx, grads = swin_block_2d_bwd(xt, dy, p, 4, mask)
    rdx, rgrads = swin_block_2d_bwd_reference(xt, dy, p, 4, mask)
    assert torch.equal(dx, rdx)
    assert all(torch.equal(a, b) for a, b in zip(grads, rgrads))
    # the Function: same grads as autograd through the plain forward
    xx = xt.clone().requires_grad_(True)
    ps = [t.clone().requires_grad_(True) for t in p]
    swin_block_train(xx, SwinBlockParams(*ps), 4, mask).backward(dy)
    assert torch.allclose(xx.grad, rdx, atol=1e-6)
    for a, g in zip(ps, rgrads):
        assert torch.allclose(a.grad, g, atol=1e-6)
    assert swin_block_2d_bwd.launches == before
