"""The port's bilinear sampler (``ops/kernels/bilin_sample.py``) and the
``deform_impl`` "mxu" routes on the CPU, f32, against the JAX package.

* The plain forward against ``bilinear_sample_mm(..., interpret=True)`` at
  tests/test_pallas_bilin.py's three shapes (coordinates in the frame, in
  its zero ring, far outside and on integers), atol/rtol 1e-5, the JAX
  test's limits.
* ``bilinear_sample``'s gradients (the plain backward, written to the
  Pallas rule) against ``jax.grad`` through the interpret-mode Pallas
  backward, coordinates off the integers, atol/rtol 1e-5; at exact integer
  coordinates dfy and dfx are 0, as the Pallas kernel gives, where the
  gather route's autograd gives feat[y0 + 1] − feat[y0].
* ``modulated_deform_conv`` and ``deform_attention`` on "mxu", outputs and
  gradients, against the JAX "mxu" routes in interpret mode (atol 2e-5 on
  outputs, the JAX test's; 1e-4 on gradients, sums of a few hundred f32
  products) and against the port's "gather" route.
* A numpy replay of the CUDA kernels' thread mapping (the forward's 64-row
  warps with corners once per row and (row, vector) items at the widths
  bf16 and f32 take; the backward's 8 lanes a row, channels strided by 8,
  corner clamping, the atomic dfeat sum, the xor reduction of dfy and dfx)
  against the plain versions, atol 1e-5. The kernels themselves run only on
  the card (chip_smoke.py phase 20).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.ops.pallas.bilin_mm import bilinear_sample_mm
from kair_tpu_torch.ops import deform_attn as tda
from kair_tpu_torch.ops import warp as twarp
from kair_tpu_torch.ops.kernels import bilin_sample as bs

TOL = 1e-5


def _rand_coords(rng, g, r, h, w):
    """Mostly in the frame, some in the zero ring, some far outside, an
    eighth of the y on integers, the last row on the far corner (as
    tests/test_pallas_bilin.py draws them)."""
    fy = rng.uniform(-2.5, h + 1.5, size=(g, r)).astype(np.float32)
    fx = rng.uniform(-2.5, w + 1.5, size=(g, r)).astype(np.float32)
    fy[:, :r // 8] = np.round(fy[:, :r // 8])
    fy[:, -1] = h - 1.0
    fx[:, -1] = w - 1.0
    fy[:, r // 8:r // 4] *= 5
    return fy, fx


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("h,w,cs,r", [(16, 16, 48, 300), (8, 24, 24, 64),
                                      (12, 8, 7, 513)])
def test_plain_forward_matches_pallas(h, w, cs, r):
    rng = np.random.default_rng(0)
    g = 3
    feat = rng.standard_normal((g, h, w, cs)).astype(np.float32)
    fy, fx = _rand_coords(rng, g, r, h, w)
    want = np.asarray(bilinear_sample_mm(jnp.asarray(feat), jnp.asarray(fy),
                                         jnp.asarray(fx), 128, True))
    got = bs.bilinear_fwd(_t(feat), _t(fy), _t(fx)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("g,h,w,cs,r", [(2, 10, 12, 8, 50), (3, 8, 16, 10, 150)])
def test_gradients_match_pallas_backward(g, h, w, cs, r):
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((g, h, w, cs)).astype(np.float32)
    fy, fx = _rand_coords(rng, g, r, h, w)
    # off the integer points, where both rules agree with the floor form
    fy = np.clip(fy, -1.9, h + 0.9) + 0.017
    fx = np.clip(fx, -1.9, w + 0.9) + 0.013
    ct = rng.standard_normal((g, r, cs)).astype(np.float32)
    want = jax.grad(lambda f, y, x: jnp.sum(
        bilinear_sample_mm(f, y, x, 64, True) * ct), argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(fy), jnp.asarray(fx))
    args = [_t(a).requires_grad_() for a in (feat, fy, fx)]
    (bs.bilinear_sample(*args) * _t(ct)).sum().backward()
    for a, b in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_integer_coordinate_subgradient_is_pinned():
    """At exact integer coordinates the plain backward gives dfy = dfx = 0,
    as the Pallas kernel does (sign(0)·ceil(1) = 0); autograd of the gather
    route's floor form gives the one-sided derivative. Both are valid
    subgradients; the port follows the Pallas kernel."""
    rng = np.random.default_rng(11)
    feat = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    fy = np.asarray([[3.0, 5.0, 2.5]], np.float32)
    fx = np.asarray([[2.0, 6.0, 4.0]], np.float32)
    ct = rng.standard_normal((1, 3, 8)).astype(np.float32)
    _, dfy_j, dfx_j = jax.grad(lambda f, y, x: jnp.sum(
        bilinear_sample_mm(f, y, x, 128, True) * ct), argnums=(0, 1, 2))(
        jnp.asarray(feat), jnp.asarray(fy), jnp.asarray(fx))
    _, dfy, dfx = bs.bilinear_bwd(_t(feat), _t(fy), _t(fx), _t(ct))
    np.testing.assert_array_equal(dfy.numpy()[:, :2], 0.0)
    np.testing.assert_array_equal(dfx.numpy(), 0.0)
    np.testing.assert_allclose(dfy.numpy(), np.asarray(dfy_j), atol=TOL)
    np.testing.assert_allclose(dfx.numpy(), np.asarray(dfx_j), atol=TOL)
    assert abs(dfy.numpy()[0, 2]) > 1e-3          # y = 2.5 has a fraction
    args = [_t(a).requires_grad_() for a in (feat, fy, fx)]
    (twarp._sample_bilinear(args[0], args[1], args[2]) * _t(ct)).sum().backward()
    assert np.abs(args[1].grad.numpy()[:, :2]).max() > 1e-3
    assert np.abs(args[2].grad.numpy()).max() > 1e-3


def dcn_case(seed=4):
    rng = np.random.default_rng(seed)
    n, h, w, cin, cout, dg = 2, 12, 20, 8, 10, 2
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    off = rng.uniform(-4, 4, (n, h, w, dg * 18)).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.standard_normal((n, h, w, dg * 9))))
            ).astype(np.float32)
    weight = (rng.standard_normal((cout, cin, 3, 3)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    ct = rng.standard_normal((n, h, w, cout)).astype(np.float32)
    return (x, off, mask, weight, bias), ct, dg


def test_deform_conv_mxu_matches_jax_mxu_and_gather():
    from kair_tpu.ops.warp import modulated_deform_conv as j_mdc
    (x, off, mask, weight, bias), ct, dg = dcn_case()
    hwio = weight.transpose(2, 3, 1, 0)

    def j_loss(a, o, m, wt, b):
        y = j_mdc(a, o, m, wt, b, deformable_groups=dg, impl="mxu",
                  _interpret=True)
        return jnp.sum(y * ct), y
    (_, want), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3, 4),
                                       has_aux=True)(
        *map(jnp.asarray, (x, off, mask, hwio, bias)))
    args = [_t(a).requires_grad_() for a in (x, off, mask, weight, bias)]
    got = twarp.modulated_deform_conv(*args, deformable_groups=dg, impl="mxu")
    (got * _t(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    jg = list(jg)
    jg[3] = np.asarray(jg[3]).transpose(3, 2, 0, 1)
    for a, b in zip(args, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    gather = twarp.modulated_deform_conv(*map(_t, (x, off, mask, weight, bias)),
                                         deformable_groups=dg, impl="gather")
    np.testing.assert_allclose(got.detach().numpy(), gather.numpy(),
                               rtol=2e-5, atol=2e-5)


def gda_case(t=1, seed=2):
    rng = np.random.default_rng(seed)
    b, clip, h, w, c, dg = 1, 2, 16, 16, 24, 4
    q = rng.standard_normal((b * t, h, w, c)).astype(np.float32)
    k = rng.standard_normal((b, clip, h, w, c)).astype(np.float32)
    v = rng.standard_normal((b, clip, h, w, c)).astype(np.float32)
    off = rng.uniform(-6, 6, (b * t, clip, h, w, dg * 18)).astype(np.float32)
    ct = rng.standard_normal((b * t, h, w, c)).astype(np.float32)
    return (q, k, v, off), ct, dg


def test_deform_attention_mxu_matches_jax_mxu_and_gather():
    from kair_tpu.ops.deform_attn import deform_attention as j_da
    (q, k, v, off), ct, dg = gda_case()

    def j_loss(*a):
        y = j_da(*a, (3, 3), dg, dg, impl="mxu", _interpret=True)
        return jnp.sum(y * ct), y
    (_, want), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *map(jnp.asarray, (q, k, v, off)))
    args = [_t(a).requires_grad_() for a in (q, k, v, off)]
    got = tda.deform_attention(*args, (3, 3), dg, dg, impl="mxu")
    (got * _t(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(args, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_deform_attention_mxu_pairs_query_frames_as_gather():
    """Two query frames per KV clip (K/V un-rotated): the "mxu" route pairs
    query frame j with KV frame (n + j) % clip, as the gather route and the
    GDA kernel do."""
    (q, k, v, off), _, dg = gda_case(t=2, seed=3)
    args = list(map(_t, (q, k, v, off)))
    got = tda.deform_attention(*args, (3, 3), dg, dg, impl="mxu")
    want = tda.deform_attention(*args, (3, 3), dg, dg, impl="gather")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


def test_mxu_routes_run_the_bilinear_wrappers():
    """On "mxu" both deform ops sample through the bilinear wrappers,
    forward and backward, and never through the gather route's sampler."""
    calls = {"fwd": 0, "bwd": 0}

    def count(key, fn):
        def f(*a):
            calls[key] += 1
            return fn(*a)
        return f
    (x, off, mask, weight, bias), _, dg = dcn_case()
    (q, k, v, aoff), _, adg = gda_case()
    with mock.patch.object(bs, "bilinear_fwd", count("fwd", bs.bilinear_fwd)), \
            mock.patch.object(bs, "bilinear_bwd", count("bwd", bs.bilinear_bwd)), \
            mock.patch.object(twarp, "_sample_bilinear", None), \
            mock.patch.object(tda, "_sample_bilinear", None):
        y = twarp.modulated_deform_conv(
            _t(x).requires_grad_(), *map(_t, (off, mask, weight, bias)),
            deformable_groups=dg, impl="mxu")
        y.sum().backward()
        z = tda.deform_attention(_t(q), _t(k).requires_grad_(), _t(v),
                                 _t(aoff), (3, 3), adg, adg, impl="mxu")
        z.sum().backward()
    assert calls == {"fwd": 2, "bwd": 2}, calls


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f = torch.zeros(2, 4, 4, 3)
    y = torch.zeros(2, 5)
    with pytest.raises(TypeError, match="f32 or bf16"):
        bs._check(f.half(), y, y)
    with pytest.raises(ValueError, match="fy must be"):
        bs._check(f, y.double(), y)
    with pytest.raises(ValueError, match="fx must be"):
        bs._check(f, y, torch.zeros(3, 5))
    with pytest.raises(ValueError, match="dout"):
        bs._check(f, y, y, torch.zeros(2, 5, 4))
    with pytest.raises(ValueError, match="contiguous"):
        bs._check(f.transpose(1, 2), y, y)
    bs._check(f, y, y, torch.zeros(2, 5, 3))


def test_forward_refuses_2_31_pixels():
    """The forward kernel's pixel index is 32-bit: G*H*W < 2^31 (checked
    before anything is allocated; the meta device holds no data)."""
    f = torch.empty(2 ** 15, 256, 256, 1, dtype=torch.bfloat16, device="meta")
    y = torch.empty(2 ** 15, 1, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        bs.bilinear_fwd(f, y, y)


# ---------------------------------------------------------------------------
# a replay of the CUDA kernels' thread mapping
# ---------------------------------------------------------------------------

LANES, THREADS = 8, 256


def _corners_of(fy, fx, h, w):
    """The kernel's corners(): flat pixel, weight and validity of the four
    corners, from the clamped floor, and the fractions."""
    y, x = np.float32(fy), np.float32(fx)
    y0f, x0f = np.floor(y), np.floor(x)
    ty, tx = np.float32(y - y0f), np.float32(x - x0f)
    y0 = int(min(max(y0f, -2), h))
    x0 = int(min(max(x0f, -2), w))
    wy, wx = (1 - ty, ty), (1 - tx, tx)
    p, wt, inside = [], [], []
    for i in range(2):
        for j in range(2):
            ok = 0 <= y0 + i < h and 0 <= x0 + j < w
            inside.append(ok)
            p.append((y0 + i) * w + x0 + j if ok else 0)
            wt.append(np.float32(wy[i] * wx[j]) if ok else 0.0)
    return p, wt, inside, ty, tx, wy, wx


def emulate_bilin_fwd(feat, fy, fx, elem_bytes, rows_per_warp=64):
    """The forward kernel in numpy, warp by warp: a warp takes 64 rows; lane
    l computes the corners of rows l and l + 32 (slab folded into the pixel
    index) into the warp's shared arrays; V = Cs / (vector_bytes /
    elem_bytes) vectors a row; lane l then takes items l, l + 32, ... of the
    rows' (row, vector) items, reads the four corners' vectors at (pixel · V
    + v) and stores vector item (the warp's first row · V + item) of out."""
    g, h, w, cs = feat.shape
    r = fy.shape[1]
    rows = g * r
    n = bs.vector_bytes(cs, elem_bytes) // elem_bytes
    nv = cs // n
    fvec = feat.reshape(g * h * w * nv, n)
    ovec = np.full((rows * nv, n), np.nan, np.float32)
    for base in range(0, rows, rows_per_warp):
        cpix = np.zeros((rows_per_warp, 4), np.int64)
        cwt = np.zeros((rows_per_warp, 4), np.float32)
        nrows = min(rows_per_warp, rows - base)
        for lane in range(32):
            for row in range(lane, nrows, 32):
                gi, ri = divmod(base + row, r)
                p, wt, _, _, _, _, _ = _corners_of(fy[gi, ri], fx[gi, ri], h, w)
                cpix[row] = [gi * h * w + q for q in p]
                cwt[row] = wt
        for lane in range(32):
            for it in range(lane, nrows * nv, 32):
                row, v = divmod(it, nv)
                acc = np.zeros(n, np.float32)
                for i in range(4):
                    acc += cwt[row, i] * fvec[cpix[row, i] * nv + v]
                ovec[base * nv + it] = acc
    return ovec.reshape(g, r, cs)


def emulate_bilin(feat, fy, fx, dout):
    """The backward kernel in numpy, thread by thread: row = block·32 +
    thread/8, lane = thread % 8 takes channels lane, lane + 8, ...; corners
    from the clamped floor; atomic adds into f32 dfeat and the per-lane
    dfy/dfx partials reduced by xor over the 8 lanes."""
    g, h, w, cs = feat.shape
    r = fy.shape[1]
    rows = g * r
    dfeat = np.zeros((g, h * w, cs), np.float32)
    dfy = np.zeros(rows, np.float32)
    dfx = np.zeros(rows, np.float32)
    flat, d = feat.reshape(g, h * w, cs), dout.reshape(rows, cs)
    blocks = -(-rows // (THREADS // LANES))
    for blk in range(blocks):
        part = np.zeros((THREADS, 2), np.float32)
        for tid in range(THREADS):
            row, lane = blk * (THREADS // LANES) + tid // LANES, tid % LANES
            if row >= rows:
                continue
            gi, ri = divmod(row, r)
            p, wt, inside, ty, tx, wy, wx = _corners_of(fy[gi, ri], fx[gi, ri],
                                                        h, w)
            sy = np.float32(1.0 if ty > 0 else 0.0)
            sx = np.float32(1.0 if tx > 0 else 0.0)
            for c in range(lane, cs, LANES):
                go = d[row, c]
                v = [flat[gi, p[i], c] if inside[i] else 0.0 for i in range(4)]
                for i in range(4):
                    if wt[i] != 0:
                        dfeat[gi, p[i], c] += wt[i] * go
                part[tid, 0] += go * sy * (wx[0] * (v[2] - v[0]) + wx[1] * (v[3] - v[1]))
                part[tid, 1] += go * sx * (wy[0] * (v[1] - v[0]) + wy[1] * (v[3] - v[2]))
        for o in (4, 2, 1):                     # __shfl_xor_sync over 8 lanes
            part = part + part[np.arange(THREADS) ^ o]
        for tid in range(0, THREADS, LANES):
            row = blk * (THREADS // LANES) + tid // LANES
            if row < rows:
                dfy[row], dfx[row] = part[tid]
    return (dfeat.reshape(g, h, w, cs), dfy.reshape(g, r), dfx.reshape(g, r))


@pytest.mark.parametrize("g,h,w,cs,r", [(2, 6, 7, 10, 37), (1, 5, 9, 17, 20),
                                        (3, 4, 4, 3, 11), (2, 5, 6, 48, 45)])
def test_kernel_thread_mapping_matches_plain(g, h, w, cs, r):
    """The forward's (row, vector) items at the vector widths of bf16 (2 B
    elements) and f32 (4 B): Cs=3 → 2 / 4 B, Cs=10 → 4 / 8 B, Cs=17 → 2 /
    4 B, Cs=48 → 16 / 16 B; row counts not a multiple of 64. The
    backward's 8-lane mapping."""
    rng = np.random.default_rng(7)
    feat = rng.standard_normal((g, h, w, cs)).astype(np.float32)
    fy, fx = _rand_coords(rng, g, r, h, w)
    fx[:, r // 4:r // 2] = np.round(fx[:, r // 4:r // 2])
    dout = rng.standard_normal((g, r, cs)).astype(np.float32)
    want = (bs.bilinear_reference(_t(feat), _t(fy), _t(fx)),
            *bs.bilinear_bwd_reference(_t(feat), _t(fy), _t(fx), _t(dout)))
    for elem_bytes in (2, 4):
        got = emulate_bilin_fwd(feat, fy, fx, elem_bytes)
        np.testing.assert_allclose(got, want[0].numpy(), rtol=TOL, atol=TOL)
    for a, b in zip(emulate_bilin(feat, fy, fx, dout), want[1:]):
        np.testing.assert_allclose(a, b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cs,elem_bytes,ptrs,want", [
    (10, 2, (), 4), (48, 2, (), 16), (3, 2, (), 2), (10, 4, (), 8),
    (48, 4, (), 16), (3, 4, (), 4), (48, 2, (1024, 4104), 8)])
def test_forward_vector_width(cs, elem_bytes, ptrs, want):
    """The widest vector that divides a pixel's bytes and every pointer."""
    assert bs.vector_bytes(cs, elem_bytes, *ptrs) == want
