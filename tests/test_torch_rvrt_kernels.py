"""The port's two RVRT kernels on the CPU, f32: their plain versions
against the JAX package's Pallas kernels in interpret mode, replays of the
CUDA kernels' layouts, and the shared-memory arithmetic.

* ``stl2_block`` (plain version) against ``stl2_block_pallas`` at
  1x4x16x16 (unshifted, shift (1, 4, 4)) and 1x2x16x16 (shift (0, 4, 4)),
  C=24, 2 heads; the (1, 8, 8) route through ``swin_block_2d``'s plain
  version against JAX's ``TMSA(geglu=False, fuse_block=True)`` with
  ``swin_block_pallas_2d`` interpreted. atol 1e-4: the Pallas bodies use
  the A&S GELU (~1.5e-7), a max-free softmax and folded LN affines, and
  keep a shifted block's score bias in bf16 (the tables here hold
  bf16-representable values).
* ``gda_fused`` (plain version) against JAX's ``deform_attention(impl=
  "gather")`` and ``gda_fused(interpret=True)`` at tests/test_pallas_gda.py's
  sizes, offsets up to ±3 and ±30 px; the un-rotated KV pairing (two
  query frames per KV clip) against the JAX module's rotated stacks. atol
  1e-4.
* Replays in PyTorch of the CUDA kernels on their operands: the STL2
  block's three passes with the plain MLP in pass 3, and the GDA kernel's
  (pixel, group) walk over taps with the (n + j) % clip pairing in its
  indices and an online softmax, against the plain versions, atol 1e-4.
  The kernels themselves run only on the card (chip_smoke.py phases 17-19).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kair_tpu.ops.pallas.stl_block as jstl
import kair_tpu.ops.pallas.swin_block as jsw
from kair_tpu.models.vrt import TMSA as JTMSA
from kair_tpu.models.vrt import rel_position_index_3d as j_rel_index
from kair_tpu.ops.deform_attn import deform_attention as j_deform_attention
from kair_tpu.ops.pallas.gda_block import gda_fused as j_gda_fused
from kair_tpu.ops.pallas.tmsa_block import tmsa_mask_patterns
from kair_tpu_torch.models import vrt as tvrt
from kair_tpu_torch.ops import deform_attn, window3d
from kair_tpu_torch.ops.kernels import gda_block, stl2_block, win3d
from kair_tpu_torch.ops.kernels.win3d import labels_on, pack_win3d, shared_bytes
from kair_tpu_torch.ops.kernels.window_msa import SMEM_LIMIT
from kair_tpu_torch.ops.window_attention import relative_position_index
from tests.test_torch_vrt_kernels import (_jroll, _x, block_weights,
                                          emulate_win3d, torch_params)

ATOL = 1e-4
C, NH = 24, 2


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the suite runs six workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def stl_params(w, c):
    """An STL block's parameters: fc11 stands for fc1, no fc12."""
    return torch_params(w, c)._replace(fc12_weight=None, fc12_bias=None)


def _flat(w):
    return tuple(jnp.asarray(w[k]) for k in (
        "qkv_s_k", "qkv_s_b", "proj_k", "proj_b", "ln1s", "ln1b", "ln2s",
        "ln2b", "fc11k", "fc11b", "fc2k", "fc2b"))


# ---------------------------------------------------------------------------
# the STL blocks against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dhw,shift", [((4, 16, 16), (0, 0, 0)),
                                       ((4, 16, 16), (1, 4, 4)),
                                       ((2, 16, 16), (0, 4, 4))])
def test_stl2_plain_matches_pallas(dhw, shift):
    d, h, w = dhw
    x = _x((1, d, h, w, C), 11)
    wt = block_weights(C, NH, 2, False, 12)
    shifted = any(shift)
    pats = tmsa_mask_patterns(d, h, w, (2, 8, 8), shift) if shifted else None
    bias = jstl.make_stl2_bias(jnp.asarray(wt["table"]), j_rel_index(2, 8, 8),
                               NH, pats)
    xin = _jroll(jnp.asarray(x), tuple(-s for s in shift))
    want = jstl.stl2_block_pallas(xin, _flat(wt), NH, bias, shifted,
                                  interpret=True)
    want = np.asarray(_jroll(want, shift))
    got = stl2_block.stl2_block(torch.from_numpy(x), stl_params(wt, C), NH,
                                shift).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_rel_index_of_a_one_frame_window_is_the_2d_index():
    """What lets a (1, 8, 8) block run the 2-D Swin kernel with its 3-D
    table: the 3-D index of a one-frame window is SwinIR's 2-D index."""
    np.testing.assert_array_equal(window3d.rel_position_index_3d(1, 8, 8),
                                  relative_position_index(8, 8))


@pytest.mark.parametrize("shift", [(0, 0, 0), (0, 4, 4)])
def test_stl1_route_matches_jax_kernel(shift):
    x = _x((1, 2, 16, 32, C), 13)
    wt = block_weights(C, NH, 1, False, 14)
    params = {"norm1": {"scale": wt["ln1s"], "bias": wt["ln1b"]},
              "norm2": {"scale": wt["ln2s"], "bias": wt["ln2b"]},
              "attn": {"rel_bias_table": wt["table"],
                       "qkv_self_kernel": wt["qkv_s_k"],
                       "qkv_self_bias": wt["qkv_s_b"],
                       "proj_kernel": wt["proj_k"], "proj_bias": wt["proj_b"]},
              "mlp_fc1": {"kernel": wt["fc11k"], "bias": wt["fc11b"]},
              "mlp_fc2": {"kernel": wt["fc2k"], "bias": wt["fc2b"]}}
    fused = JTMSA(C, NH, (1, 8, 8), shift, mut_attn=False, geglu=False,
                  fuse_block=True)
    orig, calls = jsw.swin_block_pallas_2d, []

    def interpreted(*a, **k):
        calls.append(1)
        return orig(*a, **{**k, "interpret": True})
    with mock.patch.object(jsw, "swin_block_pallas_2d", interpreted):
        init = fused.init(jax.random.PRNGKey(0), jnp.asarray(x))
        assert jax.tree_util.tree_structure(init["params"]) == \
            jax.tree_util.tree_structure(params)
        want = np.asarray(fused.apply({"params": params}, jnp.asarray(x)))
    assert calls
    p = stl_params(wt, C)
    blk = tvrt.TMSA(C, NH, (1, 8, 8), shift, mut_attn=False, geglu=False)
    a, m = blk.attn, blk.mlp
    with torch.no_grad():
        for dst, src in ((a.qkv_self.weight, p.qkv_self_weight),
                         (a.qkv_self.bias, p.qkv_self_bias),
                         (a.proj.weight, p.proj_weight), (a.proj.bias, p.proj_bias),
                         (a.relative_position_bias_table, p.rel_table),
                         (blk.norm1.weight, p.norm1_weight),
                         (blk.norm1.bias, p.norm1_bias),
                         (blk.norm2.weight, p.norm2_weight),
                         (blk.norm2.bias, p.norm2_bias),
                         (m.fc1.weight, p.fc11_weight), (m.fc1.bias, p.fc11_bias),
                         (m.fc2.weight, p.fc2_weight), (m.fc2.bias, p.fc2_bias)):
            dst.copy_(src)
    blk.eval()
    assert blk.kernel_route(2, 16, 32, (1, 8, 8), shift) == "stl1"
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# guided deformable attention against the JAX package
# ---------------------------------------------------------------------------

def make_case(b=1, clip=2, h=16, w=16, c=48, dg=6, K=9, seed=0, off_scale=3.0):
    """tests/test_pallas_gda.py's case, as numpy arrays."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, w, c).astype(np.float32)
    k = rng.randn(b, clip, h, w, c).astype(np.float32)
    v = rng.randn(b, clip, h, w, c).astype(np.float32)
    off = (rng.randn(b, clip, h, w, dg * K * 2) * off_scale).astype(np.float32)
    return q, k, v, off


@pytest.mark.parametrize("seed,off_scale", [(0, 3.0), (2, 30.0)])
def test_gda_plain_matches_jax_gather_and_pallas(seed, off_scale):
    q, k, v, off = make_case(seed=seed, off_scale=off_scale)
    jq, jk, jv, joff = map(jnp.asarray, (q, k, v, off))
    gather = np.asarray(j_deform_attention(jq, jk, jv, joff, (3, 3), 6, 6,
                                           impl="gather"))
    fused = np.asarray(j_gda_fused(jq, jk, jv, joff, (3, 3), 6, 6, 256, True))
    got = gda_block.gda_fused(*map(torch.from_numpy, (q, k, v, off)), (3, 3),
                              6, 6).numpy()
    np.testing.assert_allclose(got, gather, atol=ATOL)
    np.testing.assert_allclose(got, fused, atol=ATOL)
    # taps outside the frame did happen, and the offsets move the result
    fy = np.arange(16)[None, None, :, None, None] + off[..., 0::2]
    assert (fy < -2).any() and (fy > 17).any()
    plain = gda_block.gda_fused(*map(torch.from_numpy, (
        q, k, v, np.zeros_like(off))), (3, 3), 6, 6).numpy()
    assert np.abs(plain - got).max() > 0.1


def test_gda_frames_pairing_matches_the_jax_rotation():
    """Un-rotated K/V, two query frames a clip: query frame j pairs KV
    slot n with frame (n + j) % clip, as the JAX module's stacks do
    (kair_tpu/models/rvrt.py:146-153)."""
    b, t, clip, h, w, c, dg = 2, 2, 2, 8, 8, 24, 3
    rng = np.random.RandomState(4)
    q = rng.randn(b * t, h, w, c).astype(np.float32)
    k = rng.randn(b, clip, h, w, c).astype(np.float32)
    v = rng.randn(b, clip, h, w, c).astype(np.float32)
    off = (rng.randn(b * t, clip, h, w, dg * 18) * 2).astype(np.float32)
    qb = q.reshape(b, t, h, w, c)
    ob = off.reshape(b, t, clip, h, w, -1)
    want = np.stack([np.asarray(j_deform_attention(
        jnp.asarray(qb[:, j]),
        jnp.asarray(np.stack([k[:, (n + j) % clip] for n in range(clip)], 1)),
        jnp.asarray(np.stack([v[:, (n + j) % clip] for n in range(clip)], 1)),
        jnp.asarray(ob[:, j]), (3, 3), dg, dg, impl="gather"))
        for j in range(t)], 1).reshape(b * t, h, w, c)
    for impl in ("gather", "fused"):
        got = deform_attn.deform_attention(
            *map(torch.from_numpy, (q, k, v, off)), (3, 3), dg, dg, impl).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


# ---------------------------------------------------------------------------
# replays of the CUDA kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dhw,shift", [((2, 16, 16), (0, 4, 4)),
                                       ((4, 16, 24), (1, 4, 4))])
def test_stl2_kernel_layout_matches_plain(dhw, shift):
    """csrc/window3d_block.cu's passes on the packed STL2 operands: pass 3
    runs fc1 → exact GELU alone (the pack has no fc12)."""
    x = torch.from_numpy(_x((1, *dhw, C), 15))
    p = stl_params(block_weights(C, NH, 2, False, 16), C)
    pk = pack_win3d(p, NH, torch.float32)
    assert pk.w12 is None and pk.b12 is None
    got = emulate_win3d(x, pk, NH, 2, 2, shift, labels_on(dhw, (2, 8, 8), shift,
                                                          "cpu"), False)
    want = stl2_block.stl2_block_reference(x, p, NH, shift)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def emulate_gda(q, k, v, off, kh, kw, dg, frames):
    """csrc/gda_block.cu in PyTorch, f32: per (query pixel, group), the taps
    s = (n, tap) in order, each at the pixel + (tap / kw − kh / 2,
    tap % kw − kw / 2) + its offset, read from KV frame (n + j) % clip of
    batch bq / frames (j = bq % frames), four integer corners zero outside
    the frame, the score a dot over the group's channels, an online softmax
    (running max, sum, accumulator)."""
    bq, h, w, c = q.shape
    clip = k.shape[1]
    cg, K = c // dg, kh * kw
    qg = q.reshape(bq, h, w, dg, cg) * cg ** -0.5
    o = off.reshape(bq, clip, h, w, dg, K, 2)
    yy = torch.arange(h).view(1, h, 1, 1).float()
    xx = torch.arange(w).view(1, 1, w, 1).float()
    bidx = torch.arange(bq)
    kf = k.reshape(k.shape[0], clip, h * w, dg, cg)
    vf = v.reshape(v.shape[0], clip, h * w, dg, cg)
    m_run = torch.full((bq, h, w, dg), -1e30)
    l_run = torch.zeros(bq, h, w, dg)
    acc = torch.zeros(bq, h, w, dg, cg)
    gi = torch.arange(dg).view(1, 1, 1, dg)
    for s in range(clip * K):
        n, tap = divmod(s, K)
        fy = yy + tap // kw - kh // 2 + o[:, n, :, :, :, tap, 0]
        fx = xx + tap % kw - kw // 2 + o[:, n, :, :, :, tap, 1]
        frame = (n + bidx % frames) % clip
        ksrc, vsrc = kf[bidx // frames, frame], vf[bidx // frames, frame]
        y0, x0 = torch.floor(fy), torch.floor(fx)
        ly, lx = fy - y0, fx - x0
        ks = torch.zeros(bq, h, w, dg, cg)
        vs = torch.zeros(bq, h, w, dg, cg)
        for cy in (0, 1):
            for cx in (0, 1):
                yc, xc = y0 + cy, x0 + cx
                ok = (yc >= 0) & (yc < h) & (xc >= 0) & (xc < w)
                wgt = ((ly if cy else 1 - ly) * (lx if cx else 1 - lx) * ok)[..., None]
                at = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
                bi = bidx.view(bq, 1, 1, 1)
                ks = ks + wgt * ksrc[bi, at, gi]
                vs = vs + wgt * vsrc[bi, at, gi]
        score = (qg * ks).sum(-1)
        m_new = torch.maximum(m_run, score)
        corr, p = torch.exp(m_run - m_new), torch.exp(score - m_new)
        l_run = l_run * corr + p
        acc = acc * corr[..., None] + p[..., None] * vs
        m_run = m_new
    return (acc / l_run[..., None]).reshape(bq, h, w, c)


@pytest.mark.parametrize("frames,off_scale", [(1, 3.0), (2, 12.0)])
def test_gda_kernel_layout_matches_plain(frames, off_scale):
    b, clip, h, w, c, dg = 1, 2, 12, 10, 48, 6
    rng = np.random.RandomState(17)
    q = torch.from_numpy(rng.randn(b * frames, h, w, c).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, clip, h, w, c).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, clip, h, w, c).astype(np.float32))
    off = torch.from_numpy((rng.randn(b * frames, clip, h, w, dg * 18)
                            * off_scale).astype(np.float32))
    got = emulate_gda(q, k, v, off, 3, 3, dg, frames)
    want = gda_block.gda_reference(q, k, v, off, (3, 3), dg, dg)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# shared memory and the checks before a launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,want", [(144, 136192), (192, 166912)])
def test_stl2_shared_memory_arithmetic(c, want):
    """The STL2 block's largest pass (pass 3, the self block's layout) at
    RVRT's widths, 6 heads, hidden 2C: within the card's opt-in limit."""
    assert shared_bytes(c, 6, 2 * c, 1) == want
    assert want <= SMEM_LIMIT


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 2, 16, 16, C, dtype=torch.bfloat16)
    gated = torch_params(block_weights(C, NH, 2, False, 0), C)
    with pytest.raises(ValueError, match="wrong kind"):
        win3d.check_geometry("stl2_block", x, gated, NH, 2, mutual=False,
                             gated=False)
    with pytest.raises(ValueError, match="wrong kind"):
        win3d.check_geometry("self6_block", x, stl_params(
            block_weights(C, NH, 2, False, 0), C), NH, 2, mutual=False)
    assert gda_block.gda_supported(288, 12, 12, (3, 3), 2)
    assert gda_block.gda_supported(384, 12, 12, (3, 3), 2)       # 32 a group
    assert not gda_block.gda_supported(288, 12, 6, (3, 3), 2)     # heads != dg
    assert not gda_block.gda_supported(480, 12, 12, (3, 3), 2)    # 40 a group
    assert not gda_block.gda_supported(288, 12, 12, (3, 3), 4)    # 36 taps
    q = torch.zeros(2, 8, 8, 48, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 8, 8, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="offset"):
        gda_block._check(q, kv, kv, torch.zeros(2, 2, 8, 8, 6 * 18,
                                                dtype=torch.float64),
                         (3, 3), 6, 6)
    q3 = torch.zeros(3, 8, 8, 48, dtype=torch.bfloat16)
    kv2 = torch.zeros(2, 2, 8, 8, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pair"):
        gda_block._check(q3, kv2, kv2, torch.zeros(3, 2, 8, 8, 6 * 18), (3, 3),
                         6, 6)


def test_deform_attention_routes():
    """"fused" on a CUDA tensor raises where the kernel does not take the
    geometry, and where a gradient is wanted (the kernel has no backward);
    "auto" there takes the gather route and counts it; "mxu" (the bilinear
    sampler route, tests/test_torch_bilin.py) agrees with the gather route.
    On the CPU "fused" is the kernel's plain version."""
    q, k, v, off = map(torch.from_numpy, make_case(h=8, w=8, c=24, dg=3))
    with mock.patch.object(torch.Tensor, "is_cuda", property(lambda t: True)):
        with pytest.raises(ValueError, match="does not take"):
            deform_attn.deform_attention(q, k, v, off, (3, 3), 6, 3, "fused")
        with pytest.raises(NotImplementedError, match="no backward"):
            deform_attn.deform_attention(q.clone().requires_grad_(), k, v, off,
                                         (3, 3), 3, 3, "fused")
        n = deform_attn.deform_attention.composed_calls
        deform_attn.deform_attention(q, k, v, off, (3, 3), 6, 3, "auto")
        assert deform_attn.deform_attention.composed_calls == n + 1
    want = deform_attn.deform_attention(q, k, v, off, (3, 3), 3, 3, "gather")
    mxu = deform_attn.deform_attention(q, k, v, off, (3, 3), 3, 3, "mxu")
    torch.testing.assert_close(mxu, want, rtol=2e-5, atol=2e-5)
    got = deform_attn.deform_attention(q, k, v, off, (3, 3), 3, 3, "fused")
    assert torch.equal(got, want)
