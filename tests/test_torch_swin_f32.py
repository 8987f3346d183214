"""The f32 Swin kernels (csrc/swin_block_f32.cu, swin_block_bwd_f32.cu,
conv_block_f32.cu), their routing and the f32 route on the CPU.

* Plans: the f32 layouts mirrored from the C side fit the card's 227 KB at
  SwinIR-M (180/6/360), SwinIR-L (240/8/480) and window 7; a width that
  does not fit is refused with its reason.
* Replays: each f32 kernel's tile and chunk order in PyTorch, on flat
  buffers laid out as the kernels lay out shared and device memory (the
  plan's offsets, unwritten bytes NaN, so a read of the wrong bytes shows):
  the block at windows 8, 7 and 4, shifted and not, its attention-only
  mode, the backward's two passes with its window-ordered operands, the
  partial sums and the pass-2 tiles, and the conv tail on a map that 8x8
  tiles do not cover; each against its plain version within 1e-5 of
  max|ref| (1e-5 relative per tensor for the backward).
* The f32 plain versions against the JAX Pallas kernels in interpret mode,
  f32, numpy seeds: rows 1 (``swin_block_pallas_2d``), 2
  (``conv3x3_residual``), 3 (``jax.vjp`` through the Pallas backward), 4
  (``swin_block_pallas`` at ws 7) and 5 (``window_msa_pallas``), shifted and
  not. The bias tables are not bf16-representable: the JAX kernels store a
  shifted block's pair bias (row 4's always) in bf16
  (``kair_tpu/ops/pallas/swin_block.py:600, 715, 821``; row 5 its score
  bias always, ``window_msa.py:249``), so they are not f32
  everywhere. Each case states the JAX kernel's own distance from the JAX
  package's f32 composed block (``_flat_block_xla``, ``window_msa``, the jnp
  conv) and holds the port within that distance plus 2e-5 of max|ref|, and
  within 2e-5 of the composed block itself.
* Dispatch: f32 inputs reach the f32 C entries and bf16 inputs the bf16
  ones (a recording stand-in for the library, meta tensors for the card's);
  a pack of the other dtype raises; a training block on a card-looking
  tensor asks for the f32 packs in f32 and the bf16 ones under a bf16
  autocast.
* A tiny SwinIR at window 7 trains on the CPU through the composed route:
  its f32 gradient within 1e-5 (relative) of the JAX ``PlainTrainer``'s,
  whose blocks take the XLA route there.
* ``cli/test.py --dtype f32 --device cpu`` equals the JAX ``cli/test``.
"""

import contextlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kair_tpu.ops.pallas.conv_block as jcb
import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu.models.swinir import _flat_block_xla
from kair_tpu.ops.pallas.window_msa import window_msa_pallas
from kair_tpu.ops.window_attention import relative_position_index
from kair_tpu.ops.window_attention import shift_attn_mask as jshift_mask
from kair_tpu.ops.window_attention import window_msa as jwindow_msa
from kair_tpu.ops.window_attention import window_partition as jpartition
from kair_tpu.ops.window_attention import window_reverse as jreverse
from kair_tpu_torch.ops.kernels import _build
from kair_tpu_torch.ops.kernels import conv_block as cb
from kair_tpu_torch.ops.kernels import swin_block as sb
from kair_tpu_torch.ops.kernels import window_msa as wm
from kair_tpu_torch.ops.kernels._build import SMEM_LIMIT
from kair_tpu_torch.ops.kernels.swin_block import (F32_HC, F32_KT, F32_L,
                                                   F32_NB,
                                                   SwinBlockParams, bwd_f32_plan,
                                                   f32_plan, f32_refusal,
                                                   pack_swin_block_f32,
                                                   stage_floats)
from kair_tpu_torch.ops.kernels.window_msa import HD_MAX

NAN = float("nan")
TOL_REPLAY = 1e-5


def block_inputs(b, h, w, c, nh, ws, seed=0, hidden=None):
    """numpy x and block weights in the JAX (in, out) layout; the bias
    table at std 0.5, not bf16-representable."""
    rng = np.random.RandomState(seed)
    f = lambda *s, std=1.0, mean=0.0: (rng.randn(*s) * std + mean).astype(np.float32)
    hid = hidden or 2 * c
    x = f(b, h, w, c)
    jp = dict(qkv_kernel=f(c, 3 * c, std=0.1), qkv_bias=f(3 * c, std=0.1),
              proj_kernel=f(c, c, std=0.05), proj_bias=f(c, std=0.1),
              bias_table=f((2 * ws - 1) ** 2, nh, std=0.5),
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


def _mask(h, w, ws, shift):
    return torch.from_numpy(jshift_mask(h, w, ws, shift)) if shift else None


def _close(got, ref, tol):
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    assert err <= tol, err


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,nh,hidden,ws", [(180, 6, 360, 8), (240, 8, 480, 8),
                                            (180, 6, 360, 7), (60, 6, 120, 4)])
def test_f32_plans_fit_the_card(c, nh, hidden, ws):
    fwd = f32_plan(c, nh, ws)
    assert fwd.smem <= SMEM_LIMIT and fwd.nr == (64 if ws > 5 else 16)
    assert f32_refusal(c, nh, hidden, ws) is None
    if ws == 8:
        bwd = bwd_f32_plan(c, nh, hidden)
        assert bwd.smem <= SMEM_LIMIT
        assert f32_refusal(c, nh, hidden, ws, backward=True) is None
    # SwinIR-M 160,768 / 187,392 B; SwinIR-L 191,488 / 218,112 B
    if (c, ws) == (240, 8):
        assert (fwd.smem, bwd_f32_plan(c, nh, hidden).smem) == (191488, 218112)


@pytest.mark.parametrize("case", ["wide", "odd_width", "head_dim", "bwd_ws7"])
def test_f32_refusals_give_their_reason(case):
    c, nh, hidden, ws, bwd, match = {
        "wide": (480, 16, 960, 8, False, "shared memory"),
        "odd_width": (22, 2, 44, 8, False, "multiples of 4"),
        "head_dim": (132, 2, 264, 8, False, "head dim"),
        "bwd_ws7": (180, 6, 360, 7, True, "window 8 only")}[case]
    why = f32_refusal(c, nh, hidden, ws, backward=bwd)
    assert why is not None and match in why


# ---------------------------------------------------------------------------
# replays of the kernels' tile and chunk order (simt_f32.cuh block_gemm)
# ---------------------------------------------------------------------------

def strided(buf, off, sk, sr, n, K, R, ones=-1):
    """(K, R) operand of block_gemm (``Strided``): buf[off + k sk + r sr]
    for r < n, 1 at r == ones, 0 elsewhere."""
    k = torch.arange(K)[:, None]
    r = torch.arange(R)[None, :]
    valid = r < n
    v = torch.where(valid, buf[torch.where(valid, off + k * sk + r * sr, 0)],
                    torch.zeros(()))
    return torch.where(r == ones, torch.ones(()), v)


def gemm(a, b):
    """block_gemm: the sum over K of A(k, r) B(k, n), F32_KT rows of K a
    staged tile."""
    out = torch.zeros(a.shape[1], b.shape[1])
    for k0 in range(0, a.shape[0], F32_KT):
        out = out + a[k0:k0 + F32_KT].T @ b[k0:k0 + F32_KT]
    return out


def _flat(pk):
    return {k: getattr(pk, k).reshape(-1) for k in pk._fields}


def _window_pixels(b, wr, wc, ws, nr, h, w, phase):
    i = torch.arange(nr)
    read = (b * h + (wr * ws + i // ws + phase) % h) * w + (wc * ws + i % ws
                                                           + phase) % w
    own = (b * h + wr * ws + i // ws) * w + wc * ws + i % ws
    return read, own


def replay_block_f32(x, pk, nh, hidden, mask, phase, ws, attn_only=False):
    """csrc/swin_block_f32.cu, window by window, on a flat shared-memory
    image laid out by F32Plan."""
    bsz, h, w, c = x.shape
    hdp, n = HD_MAX, ws * ws
    pl = f32_plan(c, nh, ws)
    nr, ldx, lds, nq = pl.nr, pl.ldx, pl.nr + 4, nh * 3 * hdp
    o_q = 2 * nr * ldx
    o_k, o_v, o_s = o_q + nr * hdp, o_q + 2 * nr * hdp, o_q + 3 * nr * hdp
    head = max(3 * nr * hdp + nr * lds, nr * (F32_HC + 4))
    assert 4 * (o_q + head + stage_floats(nr, pl.nnmax, F32_NB)) == pl.smem
    scale = (c // nh) ** -0.5
    g = _flat(pk)
    xf = x.reshape(-1, c)
    out = torch.full_like(xf, NAN)
    nwc, nw = w // ws, (h // ws) * (w // ws)
    real = torch.arange(nr) < n
    for win in range(bsz * nw):
        b, wi = divmod(win, nw)
        read, own = _window_pixels(b, *divmod(wi, nwc), ws, nr, h, w, phase)
        sm = torch.full((o_q + head,), NAN)
        mat = lambda off, rows, ld: sm[off:off + rows * ld].view(rows, ld)
        X, Y = mat(0, nr, ldx), mat(nr * ldx, nr, ldx)
        (Y if attn_only else X)[:, :c] = torch.where(
            real[:, None], xf[torch.where(real, read, read[0])], torch.zeros(()))
        if not attn_only:
            Y[:, :c] = F.layer_norm(X[:, :c], (c,), pk.ln[0], pk.ln[1], 1e-5)
            X[:, :c] = X[:, :c] + pk.bp
        else:
            X[:, :c] = pk.bp
        for hh in range(nh):
            t = gemm(strided(sm, nr * ldx, 1, ldx, nr, c, nr),
                     strided(g["wqkv"], hh * 3 * hdp, nq, 1, 3 * hdp, c, 3 * hdp))
            t = t + pk.bqkv[hh * 3 * hdp:(hh + 1) * 3 * hdp]
            mat(o_q, nr, hdp)[:] = t[:, :hdp] * scale
            mat(o_k, nr, hdp)[:] = t[:, hdp:2 * hdp]
            mat(o_v, nr, hdp)[:] = t[:, 2 * hdp:]
            s = gemm(strided(sm, o_q, 1, hdp, nr, hdp, nr),
                     strided(sm, o_k, 1, hdp, nr, hdp, nr))
            bias = torch.zeros(nr, nr)
            bias[:n, :n] = pk.relbias[hh] + (0 if mask is None else mask[wi])
            s = s + bias
            s[:, n:] = -math.inf
            S = mat(o_s, nr, lds)
            S[:, :nr] = torch.softmax(s, -1)
            mat(o_q, nr, hdp)[:] = gemm(strided(sm, o_s, 1, lds, nr, nr, nr),
                                        strided(sm, o_v, hdp, 1, hdp, nr, hdp))
            X[:, :c] += gemm(strided(sm, o_q, 1, hdp, nr, hdp, nr),
                             strided(g["wp"], hh * hdp * c, c, 1, c, hdp, c))
        if attn_only:
            out[read[:n]] = X[:n, :c]
            continue
        Y[:, :c] = F.layer_norm(X[:, :c], (c,), pk.ln[2], pk.ln[3], 1e-5)
        X[:, :c] += pk.b2
        for j0 in range(0, hidden, F32_HC):
            nc = min(F32_HC, hidden - j0)
            hc = mat(o_q, nr, F32_HC + 4)
            hc[:, :nc] = F.gelu(gemm(strided(sm, nr * ldx, 1, ldx, nr, c, nr),
                                     strided(g["w1"], j0, hidden, 1, nc, c, nc))
                                + pk.b1[j0:j0 + nc])
            X[:, :c] += gemm(strided(sm, o_q, 1, F32_HC + 4, nr, nc, nr),
                             strided(g["w2"], j0 * c, c, 1, c, nc, c))
        out[own[:n]] = X[:n, :c]
    return out.view(x.shape)


@pytest.mark.parametrize("b,h,w,c,nh,ws,shift", [
    (1, 16, 24, 24, 4, 8, 0), (1, 16, 24, 24, 4, 8, 4), (2, 16, 16, 24, 4, 8, -4),
    (1, 14, 21, 24, 4, 7, 3), (1, 12, 16, 24, 4, 4, 2), (1, 16, 16, 60, 6, 8, 4)])
def test_block_replay_matches_plain(b, h, w, c, nh, ws, shift):
    x, jp = block_inputs(b, h, w, c, nh, ws, hidden=2 * c + 4 * (c == 60) * 23)
    p = torch_params(jp)
    hidden = p.fc1_weight.shape[0]
    mask = _mask(h, w, ws, abs(shift))
    pk = pack_swin_block_f32(p, nh)
    xt = torch.from_numpy(x)
    got = replay_block_f32(xt, pk, nh, hidden, mask, shift, ws)
    _close(got, sb.swin_block_win_reference(xt, p, nh, mask, shift, ws),
           TOL_REPLAY)
    # the attention-only mode (kernel B's f32 counterpart) on the LN1 output
    y = F.layer_norm(xt, (c,), p.norm1_weight, p.norm1_bias)
    got = replay_block_f32(y, pk, nh, 0, mask, shift, ws, attn_only=True)
    ref = wm.window_msa_win_reference(y, p.qkv_weight, p.qkv_bias,
                                      p.proj_weight, p.proj_bias, p.rel_table,
                                      nh, mask, shift, ws)
    _close(got, ref, TOL_REPLAY)


def replay_bwd_f32(x, dy, pk, nh, hidden, mask, phase, grid, splits):
    """csrc/swin_block_bwd_f32.cu: pass 1 by the persistent walk on a flat
    shared-memory image (BwdF32Plan) and a window-ordered operand buffer
    (each head's q, k, v and P kept from the forward for the backward),
    pass 2 by its 64 x 128 tiles and token ranges, then the partial sums.
    Returns dx, dw, dln, dbias as the kernel writes them."""
    bsz, h, w, c = x.shape
    hdp, L = HD_MAX, F32_L
    nq, nhd, ldx = nh * 3 * hdp, nh * hdp, c + 4
    pl = bwd_f32_plan(c, nh, hidden)
    o_r1, o_q = 64 * ldx, 128 * ldx
    o_k, o_v, o_s = o_q + 64 * hdp, o_q + 128 * hdp, o_q + 192 * hdp
    o_d, o_do = o_s + 64 * L, o_s + 128 * L
    o_st = o_do + 64 * hdp
    assert 4 * (o_st + 256 + stage_floats(64, max(c, 3 * hdp, F32_HC),
                                          F32_NB)) == pl.smem
    scale = (c // nh) ** -0.5
    g = _flat(pk)
    T = bsz * h * w
    ops = torch.full((T * pl.op_floats,), NAN)
    y1g, og = 0, T * c
    y2g, hg = og + T * nhd, og + T * nhd + T * c
    dhg = hg + T * hidden
    dag = dhg + T * hidden
    dqg, dyg = dag + T * c, dag + T * c + T * nq
    hf = 3 * 64 * hdp + 64 * L            # a head's q, k, v and P, kept
    qkvp = dyg + T * c
    part_bias = torch.zeros(grid, nh * 4096)
    part_ln = torch.zeros(grid, 4 * c)
    xf, dyf = x.reshape(-1, c), dy.reshape(-1, c)
    dx = torch.full_like(xf, NAN)
    rows = lambda base, t0, width: ops[base + t0 * width:
                                       base + (t0 + 64) * width].view(64, width)
    g1, b1n, g2, b2n = pk.ln
    nwc, nw = w // 8, (h // 8) * (w // 8)
    for blk in range(grid):
        for win in range(blk, bsz * nw, grid):
            b, wi = divmod(win, nw)
            read, own = _window_pixels(b, *divmod(wi, nwc), 8, 64, h, w, phase)
            t0 = win * 64
            sm = torch.full((o_st + 256,), NAN)
            mat = lambda off, r, ld: sm[off:off + r * ld].view(r, ld)
            R0, R1 = mat(0, 64, ldx), mat(o_r1, 64, ldx)
            Q, K, V, S, D, dO = (mat(o_q, 64, hdp), mat(o_k, 64, hdp),
                                 mat(o_v, 64, hdp), mat(o_s, 64, L),
                                 mat(o_d, 64, L), mat(o_do, 64, hdp))
            R0[:, :c] = xf[read]
            rows(dyg, t0, c)[:] = dyf[own]
            mu1 = R0[:, :c].mean(-1, keepdim=True)
            rs1 = torch.rsqrt(((R0[:, :c] - mu1) ** 2).mean(-1, keepdim=True)
                              + 1e-5)
            R1[:, :c] = (R0[:, :c] - mu1) * rs1 * g1 + b1n
            rows(y1g, t0, c)[:] = R1[:, :c]
            R0[:, :c] += pk.bp

            def head_forward(hh, y1):
                t = gemm(y1, strided(g["wqkv"], hh * 3 * hdp, nq, 1, 3 * hdp,
                                     c, 3 * hdp))
                t = t + pk.bqkv[hh * 3 * hdp:(hh + 1) * 3 * hdp]
                Q[:], K[:], V[:] = t[:, :hdp] * scale, t[:, hdp:2 * hdp], \
                    t[:, 2 * hdp:]
                s = gemm(strided(sm, o_q, 1, hdp, 64, hdp, 64),
                         strided(sm, o_k, 1, hdp, 64, hdp, 64))
                s = s + pk.relbias[hh] + (0 if mask is None else mask[wi])
                S[:, :64] = torch.softmax(s, -1)

            for hh in range(nh):
                head_forward(hh, strided(sm, o_r1, 1, ldx, 64, c, 64))
                o = gemm(strided(sm, o_s, 1, L, 64, 64, 64),
                         strided(sm, o_v, hdp, 1, hdp, 64, hdp))
                dO[:] = o
                rows(og, t0, nhd)[:, hh * hdp:(hh + 1) * hdp] = o
                at = qkvp + (win * nh + hh) * hf
                ops[at:at + hf] = sm[o_q:o_q + hf]
                R0[:, :c] += gemm(strided(sm, o_do, 1, hdp, 64, hdp, 64),
                                  strided(g["wp"], hh * hdp * c, c, 1, c, hdp, c))
            mu2 = R0[:, :c].mean(-1, keepdim=True)
            rs2 = torch.rsqrt(((R0[:, :c] - mu2) ** 2).mean(-1, keepdim=True)
                              + 1e-5)
            rows(y2g, t0, c)[:] = (R0[:, :c] - mu2) * rs2 * g2 + b2n
            R1[:, :c] = 0
            for j0 in range(0, hidden, F32_HC):
                nc = min(F32_HC, hidden - j0)
                hc = mat(o_q, 64, F32_HC + 4)
                pre = gemm(strided(ops, y2g + t0 * c, 1, c, 64, c, 64),
                           strided(g["w1"], j0, hidden, 1, nc, c, nc)) \
                    + pk.b1[j0:j0 + nc]
                hc[:, :nc] = pre
                rows(hg, t0, hidden)[:, j0:j0 + nc] = F.gelu(pre)
                dh = gemm(strided(ops, dyg + t0 * c, 1, c, 64, c, 64),
                          strided(g["w2"], j0 * c, 1, c, nc, c, nc))
                x_ = hc[:, :nc].clone().requires_grad_(True)
                with torch.enable_grad():
                    gg, = torch.autograd.grad(F.gelu(x_), x_, dh)
                hc[:, :nc] = gg
                rows(dhg, t0, hidden)[:, j0:j0 + nc] = gg
                R1[:, :c] += gemm(strided(sm, o_q, 1, F32_HC + 4, 64, nc, 64),
                                  strided(g["w1"], j0, 1, hidden, c, nc, c))
            xh2 = (R0[:, :c] - mu2) * rs2
            part_ln[blk, 2 * c:3 * c] += (R1[:, :c] * xh2).sum(0)
            part_ln[blk, 3 * c:] += R1[:, :c].sum(0)
            a = R1[:, :c] * g2
            d = rows(dyg, t0, c) + rs2 * (a - a.mean(-1, keepdim=True)
                                          - xh2 * (a * xh2).mean(-1, keepdim=True))
            R1[:, :c] = d
            rows(dag, t0, c)[:] = d
            R0[:, :c] = 0
            for hh in range(nh):
                at = qkvp + (win * nh + hh) * hf
                sm[o_q:o_q + hf] = ops[at:at + hf]
                dO[:] = gemm(strided(sm, o_r1, 1, ldx, 64, c, 64),
                             strided(g["wp"], hh * hdp * c, 1, c, hdp, c, hdp))
                D[:, :64] = gemm(strided(sm, o_do, 1, hdp, 64, hdp, 64),
                                 strided(sm, o_v, 1, hdp, 64, hdp, 64))
                P = S[:, :64]
                D[:, :64] = P * (D[:, :64] - (D[:, :64] * P).sum(-1, keepdim=True))
                part_bias[blk, hh * 4096:(hh + 1) * 4096] += D[:, :64].reshape(-1)
                dq = rows(dqg, t0, nq)[:, hh * 3 * hdp:(hh + 1) * 3 * hdp]
                dq[:, 2 * hdp:] = gemm(strided(sm, o_s, L, 1, 64, 64, 64),
                                       strided(sm, o_do, hdp, 1, hdp, 64, hdp))
                dq[:, :hdp] = gemm(strided(sm, o_d, 1, L, 64, 64, 64),
                                   strided(sm, o_k, hdp, 1, hdp, 64, hdp)) * scale
                dq[:, hdp:2 * hdp] = gemm(strided(sm, o_d, L, 1, 64, 64, 64),
                                          strided(sm, o_q, hdp, 1, hdp, 64, hdp))
                R0[:, :c] += gemm(
                    strided(ops, dqg + t0 * nq + hh * 3 * hdp, 1, nq, 64,
                            3 * hdp, 64),
                    strided(g["wqkv"], hh * 3 * hdp, 1, nq, c, 3 * hdp, c))
            xh1 = (xf[read] - mu1) * rs1
            part_ln[blk, :c] += (R0[:, :c] * xh1).sum(0)
            part_ln[blk, c:2 * c] += R0[:, :c].sum(0)
            a = R0[:, :c] * g1
            dx[read] = R1[:, :c] + rs1 * (a - a.mean(-1, keepdim=True)
                                          - xh1 * (a * xh1).mean(-1, keepdim=True))
    # pass 2: the four products D = [A | 1]^T G, 64 x 128 tiles, token ranges
    prods = ((y1g, c, dqg, nq), (og, nhd, dag, c), (y2g, c, dhg, hidden),
             (hg, hidden, dyg, c))
    ts = -(-T // splits)
    part_w = torch.full((splits, pl.total), NAN)
    off = 0
    for (a_off, kin, g_off, nout), (m, nn) in zip(prods, pl.dims):
        assert (m, nn) == (kin + 1, nout)
        for r0 in range(0, kin + 1, 64):
            for c0 in range(0, nout, 128):
                for s in range(splits):
                    t0 = s * ts
                    k = max(0, min(T, t0 + ts) - t0)
                    ones = kin - r0 if kin - r0 < 64 else -1
                    tile = gemm(strided(ops, a_off + t0 * kin + r0, kin, 1,
                                        min(kin - r0, 64), k, 64, ones),
                                strided(ops, g_off + t0 * nout + c0, nout, 1,
                                        min(nout - c0, 128), k, 128))
                    rr, cc = min(64, kin + 1 - r0), min(128, nout - c0)
                    dst = part_w[s, off:off + m * nn].view(m, nn)
                    dst[r0:r0 + rr, c0:c0 + cc] = tile[:rr, :cc]
        off += m * nn
    assert off == pl.total
    sums = lambda part: sum(part[i] for i in range(part.shape[0]))
    return (dx.view(x.shape), sums(part_w), sums(part_ln).view(4, c),
            sums(part_bias).view(nh, 64, 64))


@pytest.mark.parametrize("b,h,w,c,nh,shift,grid,splits", [
    (1, 16, 16, 24, 4, 0, 2, 3), (1, 16, 24, 24, 4, 4, 4, 2),
    (2, 16, 16, 20, 2, 4, 3, 5)])
def test_backward_replay_matches_plain(b, h, w, c, nh, shift, grid, splits):
    x, jp = block_inputs(b, h, w, c, nh, 8, seed=3)
    p = torch_params(jp)
    hidden = p.fc1_weight.shape[0]
    mask = _mask(h, w, 8, shift)
    xt = torch.from_numpy(x)
    dy = torch.from_numpy(np.random.RandomState(9).randn(*x.shape)
                          .astype(np.float32))
    pk = pack_swin_block_f32(p, nh)
    dx, dw, dln, dbias = replay_bwd_f32(xt, dy, pk, nh, hidden, mask, shift,
                                        grid, splits)
    got = sb.unpack_bwd_f32_grads(dw, dln, dbias, p, nh)
    rdx, ref = sb.swin_block_2d_bwd_reference(xt, dy, p, nh, mask, shift)
    for name, a, r in [("dx", dx, rdx)] + list(zip(p._fields, got, ref)):
        err = ((a - r).norm() / r.norm()).item()
        assert err <= TOL_REPLAY, (name, err)


def replay_conv_f32(y, res, wpk, bias, phase):
    """csrc/conv_block_f32.cu: 8x8 output tiles, K = 9 C tap-major, the
    roll folded into the tap's read, SAME padding of the rolled map."""
    bsz, h, w, c = y.shape
    out = torch.full_like(y, NAN)
    k = torch.arange(9 * c)[:, None]
    r = torch.arange(64)[None, :]
    tap, ci = k // c, k % c
    wflat = wpk.reshape(-1)
    for b in range(bsz):
        for py0 in range(0, h, 8):
            for px0 in range(0, w, 8):
                py = py0 + r // 8 + tap // 3 - 1
                px = px0 + r % 8 + tap % 3 - 1
                inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
                a = torch.where(inside, y[b, (py - phase) % h, (px - phase) % w,
                                          ci], torch.zeros(()))
                acc = gemm(a, strided(wflat, 0, c, 1, c, 9 * c, c))
                oy, ox = py0 + torch.arange(64) // 8, px0 + torch.arange(64) % 8
                ok = (oy < h) & (ox < w)
                out[b, oy[ok], ox[ok]] = acc[ok] + bias + res[b, oy[ok], ox[ok]]
    return out


@pytest.mark.parametrize("shape,phase", [((1, 12, 20, 8), 0), ((2, 16, 16, 24), 4),
                                         ((1, 9, 14, 12), -4)])
def test_conv_replay_matches_plain(shape, phase):
    rng = np.random.RandomState(4)
    c = shape[-1]
    y, res = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
              for _ in range(2))
    wt = torch.from_numpy(rng.randn(c, c, 3, 3).astype(np.float32) * 0.1)
    bias = torch.from_numpy(rng.randn(c).astype(np.float32))
    got = replay_conv_f32(y, res, cb.pack_conv3x3_f32(wt), bias, phase)
    _close(got, cb.conv3x3_residual_reference(y, res, wt, bias, phase),
           TOL_REPLAY)


# ---------------------------------------------------------------------------
# the f32 plain versions against the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

JAX_NAMES = ["qkv_kernel", "qkv_bias", "proj_kernel", "proj_bias",
             "ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias", "fc1_kernel",
             "fc1_bias", "fc2_kernel", "fc2_bias"]
TOL_JAX = 2e-5


def _flat_xla(x, jp, nh, ws, shift):
    """The JAX package's f32 composed block on the rolled map, its output
    in the block's own coordinates (``_flat_block_xla``)."""
    j = {k: jnp.asarray(v) for k, v in jp.items()}
    xr = jnp.roll(jnp.asarray(x), (-shift, -shift), (1, 2))
    h, w = x.shape[1:3]
    mask = jnp.asarray(jshift_mask(h, w, ws, abs(shift))) if shift else None
    return _flat_block_xla(xr, ws, tuple(j[k] for k in JAX_NAMES),
                           j["bias_table"], relative_position_index(ws, ws),
                           nh, mask)


def _hold(port, pallas, xla, what):
    """The port within the JAX kernel's own distance from the composed f32
    block plus TOL_JAX of max|ref|, and within TOL_JAX of the composed
    block; returns the kernel's distance (stated in the failure)."""
    port, pallas, xla = (np.asarray(a, np.float64) for a in (port, pallas, xla))
    scale = np.abs(xla).max()
    own = np.abs(pallas - xla).max() / scale
    assert np.abs(port - xla).max() / scale <= TOL_JAX, (what, own)
    assert np.abs(port - pallas).max() / scale <= own + TOL_JAX, (what, own)
    return own


@pytest.mark.parametrize("shift", [0, 4])
def test_row1_plain_against_pallas_2d(shift):
    x, jp = block_inputs(1, 16, 32, 24, 4, 8, seed=1)
    j = {k: jnp.asarray(v) for k, v in jp.items()}
    mask = jshift_mask(16, 32, 8, 4) if shift else None
    pallas = jsb.swin_block_pallas_2d(
        jnp.asarray(x), j["qkv_kernel"], j["qkv_bias"], j["proj_kernel"],
        j["proj_bias"], j["bias_table"], relative_position_index(8, 8), 4,
        j["ln1_scale"], j["ln1_bias"], j["ln2_scale"], j["ln2_bias"],
        j["fc1_kernel"], j["fc1_bias"], j["fc2_kernel"], j["fc2_bias"],
        None if mask is None else jnp.asarray(mask), interpret=True,
        phase=shift)
    port = sb.swin_block_win_reference(torch.from_numpy(x), torch_params(jp),
                                       4, _mask(16, 32, 8, shift), shift, 8)
    own = _hold(port.numpy(), pallas, _flat_xla(x, jp, 4, 8, shift), "row 1")
    if shift:     # the bf16 pair bias of a shifted block shows
        assert own > 1e-5, own
    else:         # the constant bias stays f32
        assert own < 1e-5, own


@pytest.mark.parametrize("shift", [0, 3])
def test_row4_plain_against_pallas_ws7(shift):
    h, w, ws = 14, 28, 7
    x, jp = block_inputs(1, h, w, 24, 4, ws, seed=2)
    j = {k: jnp.asarray(v) for k, v in jp.items()}
    mask = jshift_mask(h, w, ws, 3) if shift else None
    xw = jpartition(jnp.roll(jnp.asarray(x), (-shift, -shift), (1, 2)), ws)
    yw = jsb.swin_block_pallas(
        xw, j["qkv_kernel"], j["qkv_bias"], j["proj_kernel"], j["proj_bias"],
        j["bias_table"], relative_position_index(ws, ws), 4, j["ln1_scale"],
        j["ln1_bias"], j["ln2_scale"], j["ln2_bias"], j["fc1_kernel"],
        j["fc1_bias"], j["fc2_kernel"], j["fc2_bias"],
        None if mask is None else jnp.asarray(mask), interpret=True)
    port = sb.swin_block_win_reference(torch.from_numpy(x), torch_params(jp),
                                       4, _mask(h, w, ws, shift), shift, ws)
    own = _hold(port.numpy(), jreverse(yw, ws, h, w),
                _flat_xla(x, jp, 4, ws, shift), "row 4")
    assert own > 1e-5, own        # row 4 keeps its pair bias in bf16 always


@pytest.mark.parametrize("shift", [0, 4])
def test_row5_plain_against_window_msa_pallas(shift):
    h, w, c, nh = 16, 16, 60, 6
    x, jp = block_inputs(1, h, w, c, nh, 8, seed=5)
    y = np.asarray(F.layer_norm(torch.from_numpy(x), (c,)).numpy())
    j = {k: jnp.asarray(v) for k, v in jp.items()}
    mask = jnp.asarray(jshift_mask(h, w, 8, 4)) if shift else None
    yw = jpartition(jnp.roll(jnp.asarray(y), (-shift, -shift), (1, 2)), 8)
    args = (j["qkv_kernel"], j["qkv_bias"], j["proj_kernel"], j["proj_bias"],
            j["bias_table"], relative_position_index(8, 8), nh, mask)
    back = lambda a: jnp.roll(jreverse(a, 8, h, w), (shift, shift), (1, 2))
    pallas = back(window_msa_pallas(yw, *args, interpret=True))
    xla = back(jwindow_msa(yw, *args))
    p = torch_params(jp)
    port = wm.window_msa_win_reference(
        torch.from_numpy(y), p.qkv_weight, p.qkv_bias, p.proj_weight,
        p.proj_bias, p.rel_table, nh, _mask(h, w, 8, shift), shift, 8)
    _hold(port.numpy(), pallas, xla, "row 5")


@pytest.mark.parametrize("phase", [0, 4])
def test_row2_plain_against_conv_pallas(phase):
    rng = np.random.RandomState(6)
    c = 16
    y, res = (rng.randn(2, 16, 16, c).astype(np.float32) for _ in range(2))
    k = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)          # HWIO
    bias = rng.randn(c).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (y, res, k, bias)]
    pallas = jcb.conv3x3_residual(*jargs, phase=phase, interpret=True)
    xla = jcb.conv3x3_residual_reference(*jargs, phase=phase)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    port = cb.conv3x3_residual_reference(t(y), t(res), t(k.transpose(3, 2, 0, 1)),
                                         t(bias), phase)
    _hold(port.numpy(), pallas, xla, "row 2")


@pytest.mark.parametrize("shift", [0, 4])
def test_row3_plain_backward_against_pallas_vjp(shift):
    b, h, w, c, nh = 1, 16, 16, 24, 4
    x, jp = block_inputs(b, h, w, c, nh, 8, seed=8)
    dy = np.random.RandomState(10).randn(b, h, w, c).astype(np.float32)
    mask = jshift_mask(h, w, 8, 4) if shift else None
    rel = relative_position_index(8, 8)
    names = JAX_NAMES[:4] + ["bias_table"] + JAX_NAMES[4:]

    def pallas(xr, *ws):
        kw = dict(zip(names, ws))
        return jsb.swin_block_pallas_2d(
            xr, kw["qkv_kernel"], kw["qkv_bias"], kw["proj_kernel"],
            kw["proj_bias"], kw["bias_table"], rel, nh, kw["ln1_scale"],
            kw["ln1_bias"], kw["ln2_scale"], kw["ln2_bias"], kw["fc1_kernel"],
            kw["fc1_bias"], kw["fc2_kernel"], kw["fc2_bias"],
            None if mask is None else jnp.asarray(mask), interpret=True,
            safe=True)

    def xla(xr, *ws):
        kw = dict(zip(names, ws))
        return _flat_block_xla(xr, 8, tuple(kw[k] for k in JAX_NAMES),
                               kw["bias_table"], rel, nh,
                               None if mask is None else jnp.asarray(mask))

    # JAX rolls before the block in training; the port folds the roll into
    # its read, so both are fed the rolled map and the port phase 0
    xr = jnp.roll(jnp.asarray(x), (-shift, -shift), (1, 2))
    leaves = [jnp.asarray(jp[k]) for k in names]
    grads = {}
    for label, fn in (("pallas", pallas), ("xla", xla)):
        _, vjp = jax.vjp(fn, xr, *leaves)
        grads[label] = [np.asarray(gr) for gr in vjp(jnp.asarray(dy))]
    p = torch_params(jp)
    dx, pg = sb.swin_block_2d_bwd_reference(
        torch.from_numpy(np.asarray(xr)), torch.from_numpy(dy), p, nh,
        _mask(h, w, 8, shift))
    tname = dict(zip(names, ["qkv_weight", "qkv_bias", "proj_weight",
                             "proj_bias", "rel_table", "norm1_weight",
                             "norm1_bias", "norm2_weight", "norm2_bias",
                             "fc1_weight", "fc1_bias", "fc2_weight",
                             "fc2_bias"]))
    owns = {}
    for i, name in enumerate(["x"] + names):
        got = dx.numpy() if name == "x" else getattr(pg, tname[name]).numpy()
        if got.ndim == 2 and name.endswith("kernel"):
            got = got.T
        pa, xl = grads["pallas"][i], grads["xla"][i]
        norm = np.linalg.norm(xl)
        owns[name] = np.linalg.norm(pa - xl) / norm
        assert np.linalg.norm(got - xl) / norm <= 1e-5, (name, owns[name])
        assert np.linalg.norm(got - pa) / norm <= owns[name] + 1e-5, \
            (name, owns[name])
    if shift:     # the Pallas backward's bf16 pair bias shows
        assert max(owns.values()) > 1e-5, owns


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

class _Recorder:
    """A stand-in for the kernel library: records each entry it is asked
    for and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("kair_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(name) or 0


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_build, "library", lambda profile=False: rec)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: types.SimpleNamespace(
                            multi_processor_count=132))
    return rec


def _meta(pack):
    """A pack (or params) made on the CPU, moved to the meta device: the
    card's stand-in (packing itself runs under a CPU or CUDA autocast)."""
    return type(pack)(*[a.to("meta") if isinstance(a, torch.Tensor) else a
                        for a in pack])


def _packs(p, nh, ws=8):
    """Every pack of a block, on the meta device."""
    pb = _meta(sb.pack_swin_block(p, nh))
    return dict(
        f32=_meta(pack_swin_block_f32(p, nh)), fwd=pb,
        bwd=_meta(sb.pack_swin_block(p, nh, folded=False)),
        msa=_meta(wm.pack_window_msa(p.qkv_weight, p.qkv_bias, p.proj_weight,
                                     p.proj_bias, p.rel_table, nh)),
        msa_f32=_meta(sb.pack_attn_f32(p.qkv_weight, p.qkv_bias,
                                             p.proj_weight, p.proj_bias,
                                             p.rel_table, nh)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_dispatch_on_dtype(recorder, dtype):
    c, nh, h = 24, 4, 16
    p = torch_params(block_inputs(1, h, h, c, nh, 8)[1])
    p7 = torch_params(block_inputs(1, 14, 14, c, nh, 7)[1])
    pk, pk7, mp = _packs(p, nh), _packs(p7, nh, 7), _meta(p)
    x = torch.empty(2, h, h, c, dtype=dtype, device="meta")
    mask = torch.empty(4, 64, 64, device="meta")
    f32 = dtype == torch.float32
    wconv = torch.zeros(c, c, 3, 3)
    sb.swin_block_2d(x, mp, nh, mask, 4, packed=pk["f32" if f32 else "fwd"])
    sb.swin_block_2d(torch.empty(1, 14, 14, c, dtype=dtype, device="meta"),
                     _meta(p7), nh, None, 0, 7,
                     packed=pk7["f32" if f32 else "fwd"])
    wm.window_msa_win(x, mp.qkv_weight, mp.qkv_bias, mp.proj_weight,
                      mp.proj_bias, mp.rel_table, nh, mask, 4,
                      packed=pk["msa_f32" if f32 else "msa"])
    cb.conv3x3_residual(x, x, wconv.to("meta"), torch.zeros(c, device="meta"),
                        4, (cb.pack_conv3x3_f32 if f32 else cb.pack_conv3x3)(
                            wconv).to("meta"))
    sb.swin_block_2d_bwd(x, torch.empty_like(x), mp, nh, mask,
                         pk["f32" if f32 else "bwd"], 4)
    want = (["kair_swin_block_f32"] * 3 + ["kair_conv3x3_residual_f32",
                                            "kair_swin_block_2d_bwd_f32"]
            if f32 else ["kair_swin_block", "kair_swin_block",
                         "kair_window_msa", "kair_conv3x3_residual",
                         "kair_swin_block_2d_bwd"])
    assert recorder.calls == want


def test_a_pack_of_the_other_dtype_raises(recorder):
    c, nh, h = 24, 4, 16
    p = torch_params(block_inputs(1, h, h, c, nh, 8)[1])
    pk, mp = _packs(p, nh), _meta(p)
    x32 = torch.empty(1, h, h, c, device="meta")
    x16 = torch.empty(1, h, h, c, dtype=torch.bfloat16, device="meta")
    with pytest.raises(TypeError, match="f32 pack"):
        sb.swin_block_2d(x32, mp, nh, packed=pk["fwd"])
    with pytest.raises(TypeError, match="f32 pack"):
        sb.swin_block_2d(x16, mp, nh, packed=pk["f32"])
    with pytest.raises(TypeError, match="f32 pack"):
        sb.swin_block_2d_bwd(x32, torch.empty_like(x32), mp, nh,
                             packed=pk["bwd"])
    with pytest.raises(TypeError, match="f32 pack"):
        sb.swin_block_2d_bwd(x16, torch.empty_like(x16), mp, nh,
                             packed=pk["f32"])
    with pytest.raises(TypeError, match="f32 pack"):
        wm.window_msa_win(x32, mp.qkv_weight, mp.qkv_bias, mp.proj_weight,
                          mp.proj_bias, mp.rel_table, nh, packed=pk["msa"])
    with pytest.raises(ValueError, match="f32 packed weight"):
        cb.conv3x3_residual(x32, x32, torch.empty(c, c, 3, 3, device="meta"),
                            torch.empty(c, device="meta"),
                            packed_weight=cb.pack_conv3x3(
                                torch.zeros(c, c, 3, 3)).to("meta"))
    with pytest.raises(TypeError, match="float16"):
        sb.swin_block_2d(x32.half(), mp, nh, packed=pk["fwd"])
    assert recorder.calls == []


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` as a card's would."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("autocast", [False, True])
def test_training_block_asks_for_its_dtypes_packs(monkeypatch, autocast):
    """On a card-looking tensor a window-8 training block hands the
    autograd node the f32 pack in f32 and the bf16 forward and backward
    packs under a bf16 autocast; the node runs the kernel of that dtype."""
    from kair_tpu_torch.models import swinir as tsw
    seen = []
    real = sb.swin_block_2d

    def spy(x, p, nh, mask=None, phase=0, ws=8, packed=None):
        seen.append((x.dtype, type(packed).__name__))
        return real(x.as_subclass(torch.Tensor), p, nh, mask, phase, ws)

    monkeypatch.setattr(sb, "swin_block_2d", spy)
    block = tsw.SwinBlock(24, (16, 16), 4, 8, 4).train()
    x = torch.randn(1, 16, 16, 24).as_subclass(_CudaLooking)
    ctx = torch.autocast("cpu", dtype=torch.bfloat16) if autocast else \
        contextlib.nullcontext()
    with ctx:
        block(x)
    kinds = sorted(k for k in block._packs)
    if autocast:
        assert seen == [(torch.bfloat16, "SwinBlockPack")]
        assert kinds == [("bwd", False), ("fwd", False)]
    else:
        assert seen == [(torch.float32, "SwinBlockF32Pack")]
        assert kinds == [("blk", True)]


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("autocast", [False, True])
def test_inference_block_follows_the_same_dtype_rule(monkeypatch, autocast,
                                                     fuse):
    """In inference, too, a card-looking f32 tensor meets the f32 kernel
    and the f32 pack, and under a bf16 autocast it is cast to bf16 and
    meets the bf16 pack: fused (``swin_block_2d``) and unfused
    (``window_msa_win`` on the LN1 output) alike."""
    from kair_tpu_torch.models import swinir as tsw
    seen = []
    name = "swin_block_2d" if fuse else "window_msa_win"
    real = getattr(tsw, name)

    def spy(x, *args, packed=None):
        seen.append((x.dtype, type(packed).__name__))
        return real(x.as_subclass(torch.Tensor), *args)

    monkeypatch.setattr(tsw, name, spy)
    block = tsw.SwinBlock(24, (16, 16), 4, 8, 4, fuse_block=fuse).eval()
    x = torch.randn(1, 16, 16, 24).as_subclass(_CudaLooking)
    ctx = torch.autocast("cpu", dtype=torch.bfloat16) if autocast else \
        contextlib.nullcontext()
    with ctx, torch.no_grad():
        block(x)
    if autocast:
        assert seen == [(torch.bfloat16,
                         "SwinBlockPack" if fuse else "WindowMsaPack")]
    else:
        assert seen == [(torch.float32, "SwinBlockF32Pack")]
        assert sorted(block._packs) == [("blk", True)]


def test_the_block_refuses_an_attention_only_pack(recorder):
    """``pack_attn_f32`` serves the attention-only mode; the whole block and
    its backward refuse it before any launch."""
    c, nh, h = 24, 4, 16
    p = torch_params(block_inputs(1, h, h, c, nh, 8)[1])
    mp, pa = _meta(p), _meta(sb.pack_attn_f32(
        p.qkv_weight, p.qkv_bias, p.proj_weight, p.proj_bias, p.rel_table, nh))
    x = torch.empty(1, h, h, c, device="meta")
    with pytest.raises(ValueError, match="W-MSA's fields only"):
        sb.swin_block_2d(x, mp, nh, packed=pa)
    with pytest.raises(ValueError, match="W-MSA's fields only"):
        sb.swin_block_2d_bwd(x, torch.empty_like(x), mp, nh, packed=pa)
    wm.window_msa_win(x, mp.qkv_weight, mp.qkv_bias, mp.proj_weight,
                      mp.proj_bias, mp.rel_table, nh, packed=pa)
    assert recorder.calls == ["kair_swin_block_f32"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_step_runs_in_the_trainers_dtype(monkeypatch, dtype):
    """On the card an f32 trainer evaluates its f32 model (the f32
    kernels), a bf16 trainer a bf16 copy: every Swin block and conv tail of
    ``eval_step`` sees the trainer's dtype."""
    from kair_tpu_torch.models import swinir as tsw
    from kair_tpu_torch.ops import blocks
    from kair_tpu_torch.train.trainer import PlainTrainer
    net = {"net_type": "swinir", "upscale": 1, "in_nc": 1, "img_size": 16,
           "window_size": 8, "depths": [2, 2], "embed_dim": 24,
           "num_heads": [4, 4], "mlp_ratio": 2, "upsampler": None,
           "img_range": 1.0, "resi_connection": "1conv"}
    opt = {"model": "plain", "netG": net,
           "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 1e-3,
                     "G_scheduler_milestones": [10 ** 9], "E_decay": 0}}
    trainer = PlainTrainer(opt, dtype=torch.float32, device="cpu")
    # the card's trainer of that dtype, its batch handed over as it is
    trainer.device, trainer.dtype = torch.device("cuda"), dtype
    x = torch.rand(1, 16, 16, 1, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(trainer, "_args", lambda batch: [x])
    seen = []
    for mod, name in ((tsw, "swin_block_2d"), (blocks, "conv3x3_residual")):
        real = getattr(mod, name)

        def spy(t, *args, _real=real, _name=name, **kw):
            seen.append((_name, t.dtype))
            return _real(t, *args, **kw)

        monkeypatch.setattr(mod, name, spy)
    out = trainer.eval_step({})
    assert out.dtype == torch.float32 and out.shape == (1, 16, 16, 1)
    assert sorted(seen) == [("conv3x3_residual", dtype)] * 3 + \
        [("swin_block_2d", dtype)] * 4
    assert next(trainer.model.parameters()).dtype == torch.float32


# ---------------------------------------------------------------------------
# SwinIR at window 7 trains on the CPU: the composed route against JAX
# ---------------------------------------------------------------------------

def test_window7_swinir_gradient_matches_the_jax_trainer():
    from kair_tpu.train import losses as jlosses
    from kair_tpu.train.trainer import PlainTrainer as JaxTrainer
    from kair_tpu_torch.ckpt.torch_convert import swinir_from_jax
    from kair_tpu_torch.models import swinir as tsw
    from kair_tpu_torch.train.trainer import PlainTrainer
    net = {"net_type": "swinir", "upscale": 1, "in_nc": 1, "img_size": 14,
           "window_size": 7, "depths": [2], "embed_dim": 24, "num_heads": [4],
           "mlp_ratio": 2, "upsampler": None, "fuse_block": True,
           "img_range": 1.0, "resi_connection": "1conv"}
    opt = {"model": "plain", "netG": net,
           "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 1e-3,
                     "G_scheduler_milestones": [10 ** 9], "E_decay": 0}}
    rng = np.random.RandomState(11)
    arrays = {"L": rng.rand(2, 14, 14, 1).astype(np.float32),
              "H": rng.rand(2, 14, 14, 1).astype(np.float32)}
    jt = JaxTrainer(opt)
    # initialised in training mode, where the blocks take the XLA route
    init = jax.jit(lambda k, a: jt.model.init(k, a, train=True)["params"])
    # weights moved off the initialisers' near-identity, every term live
    leaves, tree = jax.tree_util.tree_flatten(
        init(jax.random.PRNGKey(0), jnp.asarray(arrays["L"])))
    keys = jax.random.split(jax.random.PRNGKey(1), len(leaves))
    params = jax.tree_util.tree_unflatten(tree, [
        a + 0.1 * jax.random.normal(k, a.shape) for a, k in zip(leaves, keys)])

    def loss_of(p):
        e = jt.model.apply({"params": p}, jnp.asarray(arrays["L"]), train=True)
        return jlosses.l1_loss(e, jnp.asarray(arrays["H"]))

    jgrads = jax.jit(jax.grad(loss_of))(params)
    numpy = lambda t: jax.tree_util.tree_map(np.asarray, t)
    t = PlainTrainer(opt, device="cpu", dtype=torch.float32)
    t.model.load_state_dict(swinir_from_jax(numpy(params), img_size=14,
                                            window_size=7))
    n = tsw.SwinBlock.composed_calls
    t.compute_grads(arrays)
    assert tsw.SwinBlock.composed_calls == n + 2
    want = swinir_from_jax(numpy(jgrads), img_size=14, window_size=7)
    for name, prm in t.model.named_parameters():
        w_ = want[name].numpy()
        err = np.linalg.norm(prm.grad.numpy() - w_) / np.linalg.norm(w_)
        assert err <= 1e-5, (name, err)


# ---------------------------------------------------------------------------
# cli/test --dtype f32 against the JAX CLI
# ---------------------------------------------------------------------------

def test_cli_test_f32_matches_the_jax_cli(tmp_path):
    import cv2
    import kair_tpu.cli.test as jt
    from kair_tpu_torch.cli import test as pt
    model, _, _ = pt.preset_model("swinir_classical_x4", {})
    gen = torch.Generator().manual_seed(12)
    sd = {}
    for k, v in model.state_dict().items():
        if v.is_floating_point() and not k.endswith(("attn_mask", "index")):
            std = 0.5 if "relative_position_bias_table" in k else \
                (0.1 if v.ndim == 1 else 1 / math.sqrt(v[0].numel()))
            mean = 1.0 if k.endswith(("norm1.weight", "norm2.weight",
                                      "norm.weight")) else 0.0
            v = torch.randn(v.shape, generator=gen) * std + mean
        sd[k] = v
    torch.save({"params": sd}, tmp_path / "m.pth")
    hr = tmp_path / "hr"
    hr.mkdir()
    yy, xx = np.mgrid[0:32, 0:32] / 32.0
    img = (0.5 + 0.3 * np.sin(6 * yy)[..., None] * np.cos(5 * xx)[..., None]
           + np.random.RandomState(13).normal(0, 0.05, (32, 32, 3)))
    cv2.imwrite(str(hr / "a.png"), (np.clip(img, 0, 1) * 255).astype(np.uint8))
    args = ["--model_name", "swinir_classical_x4", "--model_path",
            str(tmp_path / "m.pth"), "--testset_dir", str(hr)]
    got = pt.main(args + ["--device", "cpu", "--dtype", "f32"])
    want = jt.main(args)
    assert np.isfinite(got[0])
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3
