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
  bf16 and f32 take; the backward's row pass (dfy, dfx in channel vectors;
  each row counted in the windows of dfeat its corners reach), the scan and
  fill that list the rows within 4·R entries a slab, and its window
  pass (a block a window: its rows' corners linked into per-pixel lists a
  chunk at a time, each list summed in channel vectors into a shared-memory
  tile)) against the plain versions, atol 1e-5. The kernels themselves run only on the
  card (chip_smoke.py phase 20); tests/test_torch_bilin_bwd.py holds the
  backward's replay to JAX as well.
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


def _floor_clamped(f, n):
    """The kernel's floor_clamped: the clamped floor corner and the
    fraction, in f32."""
    f = np.float32(f)
    f0 = np.floor(f)
    return int(min(max(f0, -2), n)), np.float32(f - f0)


def _touched(c0, t, n, step):
    """The kernel's touched(): the windows along one axis that a row's two
    corner lines (c0 with weight 1 - t, c0 + 1 with t) reach with nonzero
    weight inside the frame, deduplicated."""
    a = c0 // step if 0 <= c0 < n and t < 1 else -1
    b = (c0 + 1) // step if t > 0 and 0 <= c0 + 1 < n else -1
    return [v for v in dict.fromkeys((a, b)) if v >= 0]


def emulate_bilin(feat, fy, fx, dout, elem_bytes=4, tiles=None, stats=None,
                  chunk=bs.BWD_CHUNK):
    """The backward's kernels in numpy. Pass 1, a row at a time: dfy and
    dfx in channel vectors of ``vector_bytes(Cs, elem_bytes)``, summed in
    channel order; the row counted in every window (th x tw pixels of its
    slab) that its corners of nonzero weight reach. The scan: a slab's
    counts into its lists' starts. The fill: the row appended to those
    windows' lists, each from its start in the slab's 4·R entries (the
    kernel ranks a block's rows per window in shared memory; any order of a
    list sums the same but for rounding). Pass
    2, a block per (slab, window, channel chunk of tc): a zeroed f32 tile
    (pixel stride tc | 1); the window's rows ``chunk`` at a time: each
    corner of nonzero weight inside the window linked into its pixel's list
    (entry 4·row + corner, the last linked first: an atomic exchange on the
    pixel's head), each pixel's list summed a vector at a time (weight x
    dout) into its tile elements; then the window written. ``tiles`` =
    (th, tw, tc), else ``bwd_tiles``'. Asserts that every dfeat element and
    every row's dfy/dfx is written once, that the lists fill a slab's
    entries up to their counts and within 4·R, and that no list holds a row
    twice; ``stats`` (a dict) gets the blocks, each window's list length,
    each slab's entries and the corner shares each window saw fall outside
    it."""
    g, h, w, cs = feat.shape
    r = fy.shape[1]
    n = bs.vector_bytes(cs, elem_bytes) // elem_bytes
    th, tw, tc = tiles or bs.bwd_tiles(g, h, w, cs, n, elem_bytes)
    assert tc % n == 0 or tc == cs
    tcp = tc | 1
    nwy, nwx, nwc = -(-h // th), -(-w // tw), -(-cs // tc)
    dfeat = np.full((g, h, w, cs), np.nan, np.float32)
    dfy = np.zeros((g, r), np.float32)
    dfx = np.zeros((g, r), np.float32)
    written = np.zeros((g, h, w, cs), np.int64)
    counts = np.zeros((g, nwy * nwx), np.int64)
    windows = {}
    # pass 1
    for gi in range(g):
        for ri in range(r):
            y0, ty = _floor_clamped(fy[gi, ri], h)
            x0, tx = _floor_clamped(fx[gi, ri], w)
            hy, hx = (1 - ty, ty), (1 - tx, tx)
            f = []
            for k in range(4):
                y, x = y0 + k // 2, x0 + k % 2
                f.append(feat[gi, y, x] if 0 <= y < h and 0 <= x < w
                         else np.zeros(cs, np.float32))
            dy = np.float32(1.0 if ty > 0 else 0.0)
            dx = np.float32(1.0 if tx > 0 else 0.0)
            sy = sx = np.float32(0)
            for c in range(0, cs, n):                  # vector by vector
                for k in range(c, c + n):
                    go = dout[gi, ri, k]
                    sy = np.float32(sy + go * (
                        -dy * (hx[0] * f[0][k] + hx[1] * f[1][k])
                        + dy * (hx[0] * f[2][k] + hx[1] * f[3][k])))
                    sx = np.float32(sx + go * (
                        -dx * (hy[0] * f[0][k] + hy[1] * f[2][k])
                        + dx * (hy[0] * f[1][k] + hy[1] * f[3][k])))
            dfy[gi, ri], dfx[gi, ri] = sy, sx
            windows[gi, ri] = [wy * nwx + wx for wy in _touched(y0, ty, h, th)
                               for wx in _touched(x0, tx, w, tw)]
            for key in windows[gi, ri]:
                counts[gi, key] += 1
    # the scan and the fill
    starts = np.cumsum(counts, 1) - counts
    assert (counts.sum(1) <= 4 * r).all()
    slab_lists = np.full((g, 4 * r), -1, np.int64)
    cursor = np.zeros_like(counts)
    for gi in range(g):
        for ri in range(r):
            for key in windows[gi, ri]:
                assert cursor[gi, key] < counts[gi, key]
                at = starts[gi, key] + cursor[gi, key]
                assert slab_lists[gi, at] == -1
                slab_lists[gi, at] = ri
                cursor[gi, key] += 1
    assert (cursor == counts).all()
    # pass 2
    lengths, outside = [], 0
    for gi in range(g):
        for b in range(nwy * nwx * nwc):
            wy, wx, wc = b // (nwc * nwx), b // nwc % nwx, b % nwc
            ty0, tx0, tc0 = wy * th, wx * tw, wc * tc
            ty1, tx1, tc1 = min(h, ty0 + th), min(w, tx0 + tw), min(cs, tc0 + tc)
            at = starts[gi, wy * nwx + wx]
            rows = list(slab_lists[gi, at:at + counts[gi, wy * nwx + wx]])
            assert len(set(rows)) == len(rows)
            lengths.append(len(rows))
            tile = np.zeros(th * tw * tcp, np.float32)
            for c0 in range(0, len(rows), chunk):
                heads = {}
                for ri in rows[c0:c0 + chunk]:
                    y0, ty = _floor_clamped(fy[gi, ri], h)
                    x0, tx = _floor_clamped(fx[gi, ri], w)
                    hy, hx = (1 - ty, ty), (1 - tx, tx)
                    for k in range(4):
                        y, x = y0 + k // 2, x0 + k % 2
                        wt = np.float32(hy[k // 2] * hx[k % 2])
                        if wt == 0 or not (0 <= y < h and 0 <= x < w):
                            continue
                        if ty0 <= y < ty1 and tx0 <= x < tx1:
                            heads.setdefault((y - ty0) * tw + x - tx0, []) \
                                .insert(0, (ri, wt))
                        elif wc == 0:
                            outside += 1
                for pix, entries in heads.items():
                    for c in range(tc0, tc1, n):
                        acc = np.zeros(n, np.float32)
                        for ri, wt in entries:
                            acc += wt * dout[gi, ri, c:c + n]
                        at = pix * tcp + c - tc0
                        tile[at:at + n] += acc
            for yy in range(ty1 - ty0):
                for xx in range(tx1 - tx0):
                    at = (yy * tw + xx) * tcp
                    dfeat[gi, ty0 + yy, tx0 + xx, tc0:tc1] = \
                        tile[at:at + tc1 - tc0]
                    written[gi, ty0 + yy, tx0 + xx, tc0:tc1] += 1
    assert (written == 1).all()
    if stats is not None:
        stats.update(blocks=len(lengths), kept=lengths, outside=outside,
                     tiles=(th, tw, tc), entries=counts.sum(1))
    return dfeat, dfy, dfx


@pytest.mark.parametrize("g,h,w,cs,r", [(2, 6, 7, 10, 37), (1, 5, 9, 17, 20),
                                        (3, 4, 4, 3, 11), (2, 5, 6, 48, 45)])
def test_kernel_thread_mapping_matches_plain(g, h, w, cs, r):
    """The forward's (row, vector) items at the vector widths of bf16 (2 B
    elements) and f32 (4 B): Cs=3 → 2 / 4 B, Cs=10 → 4 / 8 B, Cs=17 → 2 /
    4 B, Cs=48 → 16 / 16 B; row counts not a multiple of 64. The
    backward's windows at both widths as ``bwd_tiles`` picks them, and at
    windows of 2 x 3 pixels and one vector of channels (columns and
    channel chunks split too) with chunks of 16 rows."""
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
        n = bs.vector_bytes(cs, elem_bytes) // elem_bytes
        for tiles, chunk in ((None, bs.BWD_CHUNK), ((2, 3, n), 16)):
            for a, b in zip(emulate_bilin(feat, fy, fx, dout, elem_bytes,
                                          tiles, chunk=chunk), want[1:]):
                np.testing.assert_allclose(a, b.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cs,elem_bytes,ptrs,want", [
    (10, 2, (), 4), (48, 2, (), 16), (3, 2, (), 2), (10, 4, (), 8),
    (48, 4, (), 16), (3, 4, (), 4), (48, 2, (1024, 4104), 8)])
def test_forward_vector_width(cs, elem_bytes, ptrs, want):
    """The widest vector that divides a pixel's bytes and every pointer."""
    assert bs.vector_bytes(cs, elem_bytes, *ptrs) == want
