"""The GDA kernel's design (csrc/gda_block.cu) on the CPU, f32.

``emulate_gda`` (tests/test_torch_rvrt_kernels.py) replays the kernel as
its plan lays it out: the blocks' tiles of query pixels, an item's channels
in vec-wide vectors summed in the kernel's order, its online softmax over
the taps. Here it is held:

* to the plain version ``gda_reference`` at 1e-5 of max|ref| (the same
  f32 arithmetic in another order), at cg 24 and 32 (RVRT's groups), one
  and two query frames a clip, a 13x11 map (no multiple of a tile) and
  offsets up to ±3 and ±12 px (taps outside the frame);
* to JAX's ``gda_fused(interpret=True)`` and ``deform_attention(impl=
  "gather")`` at 1e-4 of max|ref|, the query frames paired with KV frames
  by the rotation the JAX module makes;
* at the narrow vectors a group or its pointers force (cg 10: five threads
  an item, summed in thread order; cg 5 and 2-byte alignment: one channel
  a thread) and at other tap counts (one clip slot of 3x3 or 1x3 taps).

The plan's walk covers every (query frame, group, pixel) once, the plan
is pinned at RVRT's geometries, and the wrapper refuses what the kernel
does not take. The kernel itself runs only on the card (chip_smoke.py
phases 18-19).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.ops.deform_attn import deform_attention as j_deform_attention
from kair_tpu.ops.pallas.gda_block import gda_fused as j_gda_fused
from kair_tpu_torch.ops.kernels import gda_block
from tests.test_torch_rvrt_kernels import emulate_gda


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the suite runs six workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def case(frames, h, w, cg, dg, off_scale, clip=2, kernel=(3, 3), seed=0):
    """q (frames, H, W, C), k and v (1, clip, H, W, C), offsets uniform over
    ±off_scale px, numpy f32 from a seed."""
    rng = np.random.RandomState(seed)
    c, taps = cg * dg, kernel[0] * kernel[1]
    q = rng.randn(frames, h, w, c).astype(np.float32)
    k = rng.randn(1, clip, h, w, c).astype(np.float32)
    v = rng.randn(1, clip, h, w, c).astype(np.float32)
    off = rng.uniform(-off_scale, off_scale,
                      (frames, clip, h, w, dg * taps * 2)).astype(np.float32)
    return q, k, v, off


def assert_within(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert np.isfinite(got).all()
    err, ref_max = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * ref_max, f"max_abs {err:.3g} > {tol} x {ref_max:.3g}"


def jax_oracle(fn, q, k, v, off, kernel, dg):
    """The JAX contract is one query frame a KV clip, pre-rotated: query
    frame j reads KV slot n from frame (n + j) % clip."""
    clip = k.shape[1]
    outs = []
    for j in range(q.shape[0]):
        rot = [(n + j) % clip for n in range(clip)]
        outs.append(np.asarray(fn(jnp.asarray(q[j:j + 1]),
                                  jnp.asarray(k[:, rot]),
                                  jnp.asarray(v[:, rot]),
                                  jnp.asarray(off[j:j + 1]), kernel, dg, dg)))
    return np.concatenate(outs)


def replay(q, k, v, off, kernel, dg, frames, align=16):
    return emulate_gda(*map(torch.from_numpy, (q, k, v, off)), *kernel, dg,
                       frames, align).numpy()


def plain(q, k, v, off, kernel, dg):
    return gda_block.gda_reference(*map(torch.from_numpy, (q, k, v, off)),
                                   kernel, dg, dg).numpy()


@pytest.mark.parametrize("cg", [24, 32])
@pytest.mark.parametrize("frames,off_scale", [(1, 3.0), (2, 12.0),
                                              (2, 3.0), (1, 12.0)])
def test_replay_matches_plain_and_jax(cg, frames, off_scale):
    dg, kernel = 2, (3, 3)
    q, k, v, off = case(frames, 13, 11, cg, dg, off_scale, seed=cg + frames)
    got = replay(q, k, v, off, kernel, dg, frames)
    ref = plain(q, k, v, off, kernel, dg)
    assert_within(got, ref, 1e-5)
    gather = jax_oracle(
        lambda *a: j_deform_attention(*a, impl="gather"), q, k, v, off,
        kernel, dg)
    fused = jax_oracle(
        lambda *a: j_gda_fused(*a, 256, True), q, k, v, off, kernel, dg)
    assert_within(got, gather, 1e-4)
    assert_within(got, fused, 1e-4)


@pytest.mark.parametrize("cg,dg,align,clip,kernel", [
    (10, 3, 16, 2, (3, 3)),     # vec 2, five threads an item: thread order
    (5, 4, 16, 2, (3, 3)),      # vec 1
    (24, 2, 2, 2, (3, 3)),      # 2-byte pointers: vec 1, 24 threads
    (24, 2, 16, 1, (3, 3)),     # 9 taps, one clip slot
    (16, 2, 8, 1, (1, 3)),      # vec 4, 3 taps
])
def test_replay_at_narrow_vectors_and_other_tap_counts(cg, dg, align, clip, kernel):
    q, k, v, off = case(2, 9, 10, cg, dg, 6.0, clip=clip, kernel=kernel,
                        seed=cg)
    got = replay(q, k, v, off, kernel, dg, 2, align)
    assert_within(got, plain(q, k, v, off, kernel, dg), 1e-5)


@pytest.mark.parametrize("c,dg,h,w,align", [
    (288, 12, 64, 64, 16), (384, 12, 64, 64, 16), (48, 2, 13, 11, 16),
    (64, 2, 13, 11, 16), (30, 3, 7, 17, 16), (20, 4, 9, 10, 16),
    (48, 2, 9, 10, 2), (32, 2, 5, 3, 8), (96, 3, 1, 1, 16),
])
@pytest.mark.parametrize("bq", [1, 3])
def test_walk_covers_every_item_once(c, dg, h, w, align, bq):
    pl = gda_block.gda_plan(c, dg, h, w, align)
    walk = gda_block.gda_walk(pl, bq, dg)
    assert pl.tpi * pl.ipw <= 32 and pl.vec * pl.tpi == c // dg
    assert pl.th * pl.tw == gda_block.WARPS * pl.ipw
    inside = (walk[:, 2] < h) & (walk[:, 3] < w)
    ids = ((walk[inside, 0] * dg + walk[inside, 1]) * h
           + walk[inside, 2]) * w + walk[inside, 3]
    assert len(ids) == bq * dg * h * w
    assert torch.equal(torch.sort(ids).values, torch.arange(bq * dg * h * w))
    # a whole tile row of an edge tile at most lies past the edge
    assert (~inside).sum() < bq * dg * (pl.tiles_x * pl.tw * pl.th
                                        + pl.tiles_y * pl.th * pl.tw)


def test_plan_at_rvrt_geometries():
    """RVRT-001's call (cg 24): three threads of 8 channels an item, 10
    items a warp (30 lanes), 10x8 tiles; RVRT's C=192 presets (cg 32): four
    threads, 8 items, 8x8."""
    assert tuple(gda_block.gda_plan(288, 12, 64, 64)) == (
        8, 3, 10, 10, 8, 7, 8)
    assert tuple(gda_block.gda_plan(384, 12, 128, 128)) == (
        8, 4, 8, 8, 8, 16, 16)
    assert gda_block.gda_plan(288, 12, 64, 64, 4).vec == 2


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(2, 8, 8, 48, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 8, 8, 48, dtype=torch.bfloat16)
    off = torch.zeros(2, 2, 8, 8, 6 * 18)
    gda_block._check(q, kv, kv, off, (3, 3), 6, 6)          # taken
    with pytest.raises(TypeError, match="bfloat16"):
        gda_block._check(q.float(), kv, kv, off, (3, 3), 6, 6)
    with pytest.raises(ValueError, match="does not take"):
        gda_block._check(q, kv, kv, off, (3, 3), 6, 3)      # heads != groups
    with pytest.raises(ValueError, match="does not take"):
        gda_block._check(q, kv, kv, torch.zeros(2, 2, 8, 8, 18), (3, 3), 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        gda_block._check(q, kv.transpose(2, 3), kv, off, (3, 3), 6, 6)
    with pytest.raises(ValueError, match="offset"):
        gda_block._check(q, kv, kv, off[..., :-2], (3, 3), 6, 6)
    assert not gda_block.gda_supported(33 * 4, 4, 4, (3, 3), 2)   # 33 a group
    assert not gda_block.gda_supported(96, 4, 4, (3, 5), 3)       # 45 taps
