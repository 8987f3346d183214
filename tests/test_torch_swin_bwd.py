"""The Swin-block backward (kernel 3) on the CPU.

* The plain version ``swin_block_2d_bwd_reference`` against ``jax.vjp`` of
  ``swin_block_pallas_2d(..., safe=True)`` with the Pallas forward and
  backward kernels in interpret mode, f32, the same numpy inputs: dx and all
  13 parameter grads, the relative-position table included, at atol 5e-5,
  rtol 1e-3 (the tolerance of test_pallas.py's
  ``test_fused_block_2d_gradients_match_standard``; the Pallas backward uses
  the A&S erf, ~1.5e-7, the port the exact one).
* The CUDA kernel (csrc/swin_block_bwd_wgmma.cu) replayed in PyTorch from
  its weight stages: pass 1 in its stage order, its eight stored operands
  as swizzled feature-major window tiles, pass 2 by work items and window
  ranges with the bias rows of ones, the partial sums in the persistent
  walk's order and the host-side unpacking, against the plain version
  (f32, atol 1e-4).
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
from kair_tpu_torch.ops.kernels.swin_block import (KC, WGRAD_PRODUCTS,
                                                   SwinBlockParams, _swizzle,
                                                   bwd_plan, bwd_splits,
                                                   bwd_stage_rows, grid_blocks,
                                                   pack_swin_block,
                                                   swin_block_2d_bwd,
                                                   swin_block_2d_bwd_reference,
                                                   swin_block_train,
                                                   unpack_bwd_grads, unswizzle,
                                                   window_walk)
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


def split_bwd_stages(pk, c, nh, hidden):
    """The flat backward stage pack → [(product, (rows, 64) unswizzled)]."""
    out, off = [], 0
    for name, rows in bwd_stage_rows(c, nh, hidden):
        m = pk.bwd_stages[off:off + rows * KC].view(rows, KC)
        out.append((name, unswizzle(m.float())))
        off += rows * KC
    assert off == pk.bwd_stages.numel()
    return out


def _tiles(v):
    """(B, nW, 64, F) window tokens → the stored operand: per window F rows
    of 64 tokens (feature-major), swizzled as a K-major wgmma operand."""
    t = v.reshape(-1, 64, v.shape[-1]).transpose(1, 2).contiguous()
    return _swizzle(t)


def _wgrad_pass(tiles, pl, splits):
    """Pass 2 from the operand tiles: per product D = A^T B with A's ones row
    at row FA, by work items of 128 rows x nb columns and window ranges,
    the split partials summed in order."""
    windows = tiles[0].shape[0]
    wps = -(-windows // splits)
    parts = []
    for (_, ia, ib), (mp, np_) in zip(WGRAD_PRODUCTS, pl.dims):
        a, b_ = unswizzle(tiles[ia]), unswizzle(tiles[ib])    # (W, F, 64)
        fa, fb = a.shape[1], b_.shape[1]
        a_full = torch.zeros(windows, mp, 64)
        a_full[:, :fa] = a
        a_full[:, fa] = 1.0
        b_full = torch.zeros(windows, np_, 64)
        b_full[:, :fb] = b_
        d = torch.zeros(splits, mp, np_)
        for m0 in range(0, mp, 128):
            for n0 in range(0, np_, pl.nb):
                for sp in range(splits):
                    w = slice(sp * wps, min(windows, (sp + 1) * wps))
                    d[sp, m0:m0 + 128, n0:n0 + pl.nb] = torch.einsum(
                        "wmt,wnt->mn", a_full[w, m0:m0 + 128],
                        b_full[w, n0:n0 + pl.nb])
        parts.append(d.reshape(splits, -1))
    part = torch.cat(parts, 1)
    out = part[0].clone()
    for sp in range(1, splits):
        out += part[sp]
    return out


def _slot_sums(v, windows):
    """Per-window values (W, ...) summed per consumer warpgroup of the
    persistent walk in its window order, then over warpgroups in order."""
    walk = window_walk(windows, grid_blocks(windows))
    slots = [[pair[g] for pair in steps if pair[g] >= 0]
             for steps in walk for g in range(2)]
    total = torch.zeros_like(v[0])
    for ws_ in slots:
        acc = torch.zeros_like(v[0])
        for i in ws_:
            acc = acc + v[i]
        total = total + acc
    return total


def emulate_bwd_kernel(x, dy, p, nh, mask, phase=0):
    """csrc/swin_block_bwd_wgmma.cu step by step from its weight stages, in
    f32: pass 1 per window in the kernel's stage order (the recompute per
    head and pair, the MLP backward per hidden chunk of 64, the attention
    backward per head with dh accumulating q|k per head and v per pair),
    the eight operands as swizzled feature-major tiles, pass 2 over them by
    work items and window ranges, the partials summed in order, then the
    host's unpacking."""
    b, h, w, c = x.shape
    hidden = p.fc1_weight.shape[0]
    pl = bwd_plan(c, nh, hidden)
    pk = pack_swin_block(p, nh, dtype=torch.float32, folded=False)
    st = iter(m for _, m in split_bwd_stages(pk, c, nh, hidden))
    kc, np_, hc, nt = -(-c // KC), -(-nh // 2), -(-hidden // 64), pl.nt
    kp, scale = kc * KC, (c // nh) ** -0.5
    pad = lambda v, n: F.pad(v, (0, n - v.shape[-1]))
    chunk = lambda t, k: t[..., k * KC:(k + 1) * KC]
    product = lambda a: sum(chunk(a, k) @ next(st).t() for k in range(kc))

    def product2(a1, a2):
        """Two products whose K-chunk stages alternate in the ring."""
        d1 = d2 = 0
        for k in range(kc):
            d1 = d1 + chunk(a1, k) @ next(st).t()
            d2 = d2 + chunk(a2, k) @ next(st).t()
        return d1, d2
    xr = torch.roll(x, (-phase, -phase), (1, 2)) if phase else x
    xw = window_partition(xr, 8)                         # (B, nW, 64, C)
    dyw = window_partition(dy, 8)
    bias = pk.relbias[None, None]
    if mask is not None:
        bias = bias + mask[None, :, None]
    lnw1, lnb1, lnw2, lnb2 = (p.norm1_weight, p.norm1_bias, p.norm2_weight,
                              p.norm2_bias)
    # recompute: LN1, attention per head, proj per pair
    xhat1, inv1, h1 = _ln(xw, lnw1, lnb1)
    h1p = pad(h1, kp)
    acc = xw + pk.bp
    ao, heads = [], []
    for pp in range(np_):
        outs = []
        for hh in range(2 * pp, min(2 * pp + 2, nh)):
            qkv = product(h1p) + pk.bqkv[hh * 96:(hh + 1) * 96]
            q, k, v = qkv[..., :32] * scale, qkv[..., 32:64], qkv[..., 64:]
            heads.append((q, k, v))
            pr = torch.softmax(q @ k.transpose(-1, -2) + bias[:, :, hh], -1)
            outs.append(pr @ v)
        ao += outs
        stage = next(st)
        acc = acc + sum(o @ stage[:, 32 * i:32 * (i + 1)].t()
                        for i, o in enumerate(outs))[..., :c]
    x1 = acc
    xhat2, inv2, h2 = _ln(x1, lnw2, lnb2)
    h2p, dyp = pad(h2, kp), pad(dyw, kp)
    # MLP backward by hidden chunks of 64
    b1 = pad(pk.b1[:hidden], hc * 64)
    dh2 = 0
    gelu_cols, dpre_cols = [], []
    for j in range(hc):
        pre, dhid = product2(h2p, dyp)
        pre = pre + b1[j * 64:(j + 1) * 64]
        cdf = 0.5 * (1 + torch.erf(pre * 0.5 ** 0.5))
        gp = cdf + pre * torch.exp(-0.5 * pre * pre) / (2 * np.pi) ** 0.5
        dpre = dhid * gp
        dpre[..., max(0, hidden - j * 64):] = 0
        gelu_cols.append(pre * cdf)
        dpre_cols.append(dpre)
        dh2 = dh2 + dpre @ next(st).t()
    dx1 = dyw + _ln_bwd(dh2[..., :c], xhat2, inv2, lnw2)
    dx1p = pad(dx1, kp)
    # attention backward per head
    dh, dqkv, dbias = 0, [], []
    for pp in range(np_):
        dvs = []
        do_pair = product(dx1p)                          # (.., 64, 64)
        for hh in range(2 * pp, min(2 * pp + 2, nh)):
            do = do_pair[..., 32 * (hh - 2 * pp):32 * (hh - 2 * pp + 1)]
            q, k, v = heads[hh]
            pr = torch.softmax(q @ k.transpose(-1, -2) + bias[:, :, hh], -1)
            dp = do @ v.transpose(-1, -2)
            ds = pr * (dp - (pr * dp).sum(-1, keepdim=True))
            dbias.append(ds)
            dq, dk = (ds @ k) * scale, ds.transpose(-1, -2) @ q
            dv = pr.transpose(-1, -2) @ do
            dqkv += [dq, dk, dv]
            dvs.append(dv)
            stage = next(st)
            dh = dh + dq @ stage[:, :32].t() + dk @ stage[:, 32:].t()
        stage = next(st)
        dh = dh + sum(d_ @ stage[:, 32 * i:32 * (i + 1)].t()
                      for i, d_ in enumerate(dvs))
    assert next(st, None) is None
    dxw = dx1 + _ln_bwd(dh[..., :c], xhat1, inv1, lnw1)
    dx = window_reverse(dxw, 8, h, w)
    if phase:
        dx = torch.roll(dx, (phase, phase), (1, 2))
    # the stored operands, as pass 1 writes them, and pass 2
    ops = [h1, torch.cat(ao, -1), h2, torch.cat(gelu_cols, -1)[..., :hidden],
           torch.cat(dpre_cols, -1)[..., :hidden], dyw, dx1, torch.cat(dqkv, -1)]
    tiles = [_tiles(o) for o in ops]
    assert [t.shape[1] for t in tiles] == list(pl.op_rows)
    windows = tiles[0].shape[0]
    splits = bwd_splits(windows, pl.items, sms=2 * pl.items)   # two ranges
    dw = _wgrad_pass(tiles, pl, splits)
    per_win = lambda t: t.reshape(windows, -1, c).sum(1)
    dln = _slot_sums(torch.stack([per_win(dh[..., :c] * xhat1),
                                  per_win(dh[..., :c]),
                                  per_win(dh2[..., :c] * xhat2),
                                  per_win(dh2[..., :c])], 1), windows)
    dbias = _slot_sums(torch.stack(dbias, 2).reshape(windows, nh, 64, 64),
                       windows)
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
    """The stored operands at SwinIR-M width: 2,208 rows of 64 tokens a
    window (4,416 bytes a token), the weight products' D 368,640 floats
    in 15 work items of 128 x 192; 8 window ranges fill 120 of 132 SMs."""
    pl = bwd_plan(180, 6, 360)
    assert pl.op_rows == (180, 192, 180, 360, 360, 180, 180, 576)
    assert 2 * sum(pl.op_rows) == 4416
    assert (pl.nb, pl.items, pl.total) == (192, 15, 368_640)
    assert pl.dims == ((256, 576), (256, 192), (256, 384), (384, 192))
    assert bwd_splits(1152, pl.items) == 8 and bwd_splits(3, pl.items) == 3


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
