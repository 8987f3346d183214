"""The bilinear sampler's backward kernel (``csrc/bilin_sample.cu``,
``kair_bilin_bwd``) on the CPU: its work partition replayed in numpy
(``emulate_bilin``, tests/test_torch_bilin.py) against the plain version
and JAX.

* The replay at Cs 3, 10 and 48, at the vector widths of bf16 and f32, with
  rows on integer coordinates, in the zero ring and far outside the frame,
  at the windows ``bwd_tiles`` picks and at windows that split columns and
  channels, in chunks of rows as the kernel's and smaller: against
  ``bilinear_bwd_reference`` and against ``jax.vjp`` of
  ``bilinear_sample_mm`` in interpret mode (the Pallas backward it
  replaces); atol/rtol 1e-5, tests/test_pallas_bilin.py's limits. dfy and
  dfx are exactly 0 on the integer rows.
* Tap-major rows as VRT's DCN makes them (pixel + 3x3 tap + an offset):
  a window's list holds the rows that reach it, a row is listed once per
  window it reaches, the corners that fall outside a window are added by
  the window that owns them, and every dfeat element is written once (the
  replay asserts it).
* ``bwd_tiles``: the windows at the model's calls, the tile budget at wide
  frames and wide pixels. The scratch: rows that straddle a window corner
  fill four lists, 4·R entries a slab, and the scratch grows linearly with
  the frame (16 bytes a row, 12 a window).
* The refusals the wrapper makes before a launch.

The kernel itself runs only on the card (chip_smoke.py phase 20).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.ops.pallas.bilin_mm import bilinear_sample_mm
from kair_tpu_torch.ops.kernels import bilin_sample as bs
from tests.test_torch_bilin import _rand_coords, _t, emulate_bilin

TOL = 1e-5


def _case(seed, g, h, w, cs, r):
    """feat, coordinates (integer y on the first eighth of the rows, integer
    x on the next, far taps, the zero ring) and dout, in numpy."""
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((g, h, w, cs)).astype(np.float32)
    fy, fx = _rand_coords(rng, g, r, h, w)
    fx[:, r // 8:r // 4] = np.round(fx[:, r // 8:r // 4])
    fx[:, r // 4:r // 4 + 3] = -40.5                  # far left of the frame
    dout = rng.standard_normal((g, r, cs)).astype(np.float32)
    return feat, fy, fx, dout


@pytest.mark.parametrize("cs", [3, 10, 48])
def test_partition_matches_plain_and_pallas(cs):
    g, h, w, r = 2, 6, 7, 48
    feat, fy, fx, dout = _case(cs, g, h, w, cs, r)
    want = bs.bilinear_bwd_reference(_t(feat), _t(fy), _t(fx), _t(dout))
    _, vjp = jax.vjp(lambda f, y, x: bilinear_sample_mm(f, y, x, 64, True),
                     jnp.asarray(feat), jnp.asarray(fy), jnp.asarray(fx))
    jax_grads = [np.asarray(a) for a in vjp(jnp.asarray(dout))]
    for elem_bytes in (2, 4):
        n = bs.vector_bytes(cs, elem_bytes) // elem_bytes
        for tiles, chunk in ((None, bs.BWD_CHUNK), ((2, 4, n), 20)):
            got = emulate_bilin(feat, fy, fx, dout, elem_bytes, tiles,
                                chunk=chunk)
            for a, b, j in zip(got, want, jax_grads):
                np.testing.assert_allclose(a, b.numpy(), rtol=TOL, atol=TOL)
                np.testing.assert_allclose(a, j, rtol=TOL, atol=TOL)
            assert (got[1][:, :r // 8] == 0).all()        # integer y
            assert (got[2][:, r // 8:r // 4] == 0).all()  # integer x


def tap_major(g, h, w, reach, seed):
    """(fy, fx) (G, 9·H·W) as ops/warp.deform_columns_mxu makes them: rows
    tap-major, the pixel + its 3x3 tap (padding 1) + an offset of up to
    ±reach px; an eighth of the rows on integer y."""
    rng = np.random.default_rng(seed)
    r = 9 * h * w
    tap = np.arange(9)
    fy = (np.arange(h)[None, :, None] + (tap // 3 - 1)[:, None, None]
          + np.zeros((1, 1, w))).reshape(1, r)
    fx = (np.arange(w)[None, None, :] + (tap % 3 - 1)[:, None, None]
          + np.zeros((1, h, 1))).reshape(1, r)
    fy = (fy + rng.uniform(-reach, reach, (g, r))).astype(np.float32)
    fx = (fx + rng.uniform(-reach, reach, (g, r))).astype(np.float32)
    fy[:, :r // 8] = np.round(fy[:, :r // 8])
    return fy, fx


def test_tap_major_rows_keep_their_windows():
    g, h, w, cs, reach = 2, 8, 8, 10, 2.5
    fy, fx = tap_major(g, h, w, reach, seed=3)
    r = fy.shape[1]
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((g, h, w, cs)).astype(np.float32)
    dout = rng.standard_normal((g, r, cs)).astype(np.float32)
    want = bs.bilinear_bwd_reference(_t(feat), _t(fy), _t(fx), _t(dout))
    for tiles in (None, (4, 8, cs), (2, 4, cs)):
        stats = {}
        got = emulate_bilin(feat, fy, fx, dout, 2, tiles, stats, chunk=128)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b.numpy(), rtol=TOL, atol=TOL)
        th, tw, tc = stats["tiles"]
        windows = -(-h // th) * -(-w // tw)
        assert stats["blocks"] == g * windows
        # a window lists the rows that reach it, not its slab's; a row is
        # listed once or, straddling windows, up to four times
        assert max(stats["kept"]) < r
        reach_frame = sum(
            any(0 <= int(np.floor(y)) + i < h and 0 <= int(np.floor(x)) + j < w
                for i in (0, 1) for j in (0, 1))
            for y, x in zip(fy.ravel(), fx.ravel()))
        assert reach_frame <= sum(stats["kept"]) < 2 * reach_frame
        assert (stats["entries"] <= 4 * r).all()
        # corners outside a block's window: added by the window that owns them
        assert stats["outside"] > 0
    assert (got[1][:, :r // 8] == 0).all()


def _fits(th, tw, tc, es):
    """The window's tile and heads, and the chunk's stage, within their
    budgets; the block within the card's shared memory."""
    assert th * tw * (4 * (tc | 1) + 8) <= bs.BWD_TILE_BYTES
    assert bs.BWD_CHUNK * tc * es <= bs.BWD_STAGE_BYTES
    assert bs.bwd_shared_bytes(th, tw, tc, es) <= 232448


@pytest.mark.parametrize("g,h,w,cs,n,es,want", [
    (96, 64, 64, 10, 2, 2, (8, 64, 10)),     # VRT-001 stage 1, B=8, bf16
    (96, 32, 32, 10, 2, 2, (6, 32, 10)),     # its stage at 32x32
    (48, 64, 64, 48, 8, 2, (4, 64, 24)),     # RVRT-001's GDA call
    (48, 64, 64, 48, 4, 4, (8, 64, 12)),     # the same in f32
    (24, 64, 64, 3, 1, 2, (3, 64, 3)),       # odd Cs
    (12, 64, 64, 10, 2, 2, (2, 64, 10)),     # B=1: more windows a slab
])
def test_bwd_tiles_at_the_model_calls(g, h, w, cs, n, es, want):
    th, tw, tc = bs.bwd_tiles(g, h, w, cs, n, es)
    assert (th, tw, tc) == want
    _fits(th, tw, tc, es)
    # enough windows for the SMs (rounding th up can halve the count)
    assert g * -(-h // th) * -(-cs // tc) >= min(bs.BWD_BLOCKS, g * h) // 2


@pytest.mark.parametrize("g,h,w,cs,n,es", [(1, 720, 1280, 64, 8, 2),
                                           (2, 3, 3, 70000, 8, 2),
                                           (1, 5, 5, 30001, 1, 4),
                                           (2, 64, 64, 1, 1, 2),
                                           (1, 2160, 3840, 10, 2, 2)])
def test_bwd_tiles_split_wide_frames_and_pixels(g, h, w, cs, n, es):
    """A pixel row over the budget splits the columns; a pixel over it (or
    a chunk's stage), the channels, in whole vectors; a slab has at most
    ``BWD_MAX_WINDOWS`` windows (the row pass's histogram)."""
    th, tw, tc = bs.bwd_tiles(g, h, w, cs, n, es)
    _fits(th, tw, tc, es)
    assert tc % n == 0 or tc == cs
    assert (tc < cs) == (4 * (cs | 1) + 8 > bs.BWD_TILE_BYTES
                         or bs.BWD_CHUNK * cs * es > bs.BWD_STAGE_BYTES)
    assert (tw < w) == (w * (4 * (tc | 1) + 8) > bs.BWD_TILE_BYTES)
    assert -(-h // th) * -(-w // tw) <= bs.BWD_MAX_WINDOWS


def test_bwd_tiles_grow_past_the_budget_on_a_huge_frame():
    """An 8K frame of 64 channels keeps its windows within the histogram's
    bound with tiles over the budget, still within the card's shared
    memory."""
    th, tw, tc = bs.bwd_tiles(1, 4320, 7680, 64, 8, 2)
    assert -(-4320 // th) * -(-7680 // tw) <= bs.BWD_MAX_WINDOWS
    assert th * tw * (4 * (tc | 1) + 8) > bs.BWD_TILE_BYTES
    assert bs.bwd_shared_bytes(th, tw, tc, 2) <= bs.SMEM_LIMIT


def test_scratch_holds_a_full_list_per_window():
    """Each window's list holds all its rows: the count pass sizes them and
    the scan places them in the slab's 4·R entries, after the windows'
    counts (int) and, 16-byte aligned, their starts (64-bit)."""
    g, h, w, r = 96, 64, 64, 9 * 64 * 64
    th, tw, _ = bs.bwd_tiles(g, h, w, 10, 2, 2)
    windows = g * -(-h // th) * -(-w // tw)
    assert bs.bwd_scratch_bytes(g, h, w, r, th, tw) == \
        -(-4 * windows // 16) * 16 + 8 * windows + 16 * g * r
    assert bs.bwd_scratch_bytes(3, 5, 7, 11, 2, 7) == 48 + 8 * 9 + 16 * 3 * 11
    # VRT-001's stage-1 call at batch 8: 57 MB
    assert bs.bwd_scratch_bytes(g, h, w, r, th, tw) < 57e6


def test_rows_at_window_corners_fill_four_lists():
    """Rows whose corners straddle a window corner enter four lists: the
    slab's entries reach 4·R exactly and no list runs into the next."""
    g, h, w, cs, r = 2, 8, 8, 3, 20
    rng = np.random.default_rng(11)
    feat = rng.standard_normal((g, h, w, cs)).astype(np.float32)
    dout = rng.standard_normal((g, r, cs)).astype(np.float32)
    fy = np.full((g, r), 3.5, np.float32)
    fx = np.full((g, r), 3.25, np.float32)
    want = bs.bilinear_bwd_reference(_t(feat), _t(fy), _t(fx), _t(dout))
    stats = {}
    got = emulate_bilin(feat, fy, fx, dout, 4, (4, 4, cs), stats, chunk=8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), rtol=TOL, atol=TOL)
    assert list(stats["entries"]) == [4 * r] * g
    assert sorted(stats["kept"]) == [r] * 4 * g


@pytest.mark.parametrize("cs,n,es", [(10, 2, 2), (48, 8, 2), (3, 1, 4)])
def test_scratch_is_linear_in_the_frame(cs, n, es):
    """At the DCN's R = 9·H·W the scratch per pixel stays within 16·9 + 12
    bytes from 128x128 to 256x256 and an 8K frame, at batch 8 (G = 96) and
    1 (G = 12): it grows with H·W, not (H·W)²."""
    for g in (96, 12):
        per_pixel = []
        for h, w in ((128, 128), (256, 256), (4320, 7680)):
            th, tw, _ = bs.bwd_tiles(g, h, w, cs, n, es)
            b = bs.bwd_scratch_bytes(g, h, w, 9 * h * w, th, tw)
            per_pixel.append(b / (g * h * w))
        assert all(16 * 9 <= p <= 16 * 9 + 13 for p in per_pixel)
        assert max(per_pixel) - min(per_pixel) < 1


@pytest.mark.parametrize("case", ["f16", "dout_dtype", "dout_shape", "fy_shape",
                                  "strided", "pixels"])
def test_backward_refuses_before_a_launch(case):
    """What the wrapper refuses on a tensor off the CPU (the meta device:
    shapes and dtypes without data), before it builds or launches."""
    f = torch.empty(2, 4, 4, 3, device="meta")
    y = torch.empty(2, 5, device="meta")
    d = torch.empty(2, 5, 3, device="meta")
    err, match = ValueError, "dout"
    if case == "f16":
        f, d, err, match = f.half(), d.half(), TypeError, "f32 or bf16"
    elif case == "dout_dtype":
        d = d.to(torch.bfloat16)
    elif case == "dout_shape":
        d = torch.empty(2, 5, 4, device="meta")
    elif case == "fy_shape":
        y, match = torch.empty(3, 5, device="meta"), "fy must be"
    elif case == "strided":
        f, match = f.transpose(1, 2), "contiguous"
    else:
        f = torch.empty(2 ** 15, 256, 256, 1, device="meta")
        y = torch.empty(2 ** 15, 1, device="meta")
        d = torch.empty(2 ** 15, 1, 1, device="meta")
        match = "2\\^31"
    with pytest.raises(err, match=match):
        bs.bilinear_bwd(f, y, y, d)
