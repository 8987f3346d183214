"""The training routes of RVRT's kernels on the CPU, f32, against the JAX
package's custom VJPs run in interpret mode.

* ``stl2_block_train`` (the plain forward, autograd through the composed
  block) against ``jax.grad`` through ``stl2_block_pallas`` (the max-safe
  kernel forward, the composed block's VJP), unshifted and at shift
  (1, 4, 4);
* ``gda_train`` (the plain forward, autograd through the gather route)
  against ``jax.grad`` through ``gda_fused(interpret=True)`` (the gather
  route's VJP), at offsets of ±3 and ±30 px;
* the (1, 8, 8) STL block in training (``TMSA._stl1`` →
  ``swin_block_train`` at phase 4 with the block's 3-D table) against
  ``jax.grad`` through JAX's ``TMSA`` on ``swin_block_pallas_2d``, whose
  ``_fused_2d`` VJP runs the Pallas backward kernel in interpret mode;
  ``rel_table_grad``, the sum the card's backward kernel uses for the table
  gradient, against autograd through the 3-D index's gather;
* ``deform_attention`` "auto" and "fused" under autograd on a CUDA tensor
  (mocked) take ``gda_train`` and raise nothing.

dx and every parameter's gradient: max abs error at most 1e-4 of the
gradient's own max (f32 sums in another order; the Pallas bodies use the
A&S GELU, bf16-held score biases and folded LN affines, so the tables hold
bf16-representable values). On the card the forwards are the kernels
(chip_smoke.py phase 25).
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
from kair_tpu.ops.pallas.gda_block import gda_fused as j_gda_fused
from kair_tpu.ops.pallas.tmsa_block import tmsa_mask_patterns
from kair_tpu_torch.models import vrt as tvrt
from kair_tpu_torch.ops import deform_attn, window3d
from kair_tpu_torch.ops.kernels import gda_block, stl2_block, swin_block
from tests.test_torch_rvrt_kernels import _flat, make_case, stl_params
from tests.test_torch_vrt_kernels import _jroll, _x, block_weights
from tests.test_torch_vrt_train_kernels import FIELD, assert_grad_close

C, NH = 24, 2
FLAT_STL = ("qkv_s_k", "qkv_s_b", "proj_k", "proj_b", "ln1s", "ln1b", "ln2s",
            "ln2b", "fc11k", "fc11b", "fc2k", "fc2b")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaf_params(p):
    return p._replace(**{k: v.clone().requires_grad_()
                         for k, v in p._asdict().items() if v is not None})


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 4, 4)])
def test_stl2_training_function_matches_jax_grad(shift):
    d, h, w = 4, 16, 16
    x = _x((1, d, h, w, C), 21)
    ct = np.random.RandomState(22).randn(1, d, h, w, C).astype(np.float32)
    wt = block_weights(C, NH, 2, False, 23)
    shifted = any(shift)
    pats = tmsa_mask_patterns(d, h, w, (2, 8, 8), shift) if shifted else None

    def loss(xx, flat, table):
        bias = jstl.make_stl2_bias(table, j_rel_index(2, 8, 8), NH, pats)
        y = jstl.stl2_block_pallas(_jroll(xx, tuple(-s for s in shift)), flat,
                                   NH, bias, shifted, interpret=True)
        return jnp.sum(_jroll(y, shift) * ct)
    gx, gflat, gtable = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), _flat(wt), jnp.asarray(wt["table"]))

    xt = torch.from_numpy(x).requires_grad_()
    pt = _leaf_params(stl_params(wt, C))
    (stl2_block.stl2_block_train(xt, pt, NH, shift)
     * torch.from_numpy(ct)).sum().backward()
    assert_grad_close(xt.grad.numpy(), gx, "x")
    assert_grad_close(pt.rel_table.grad.numpy(), gtable, "table")
    for k, g in zip(FLAT_STL, gflat):
        t = getattr(pt, FIELD[k]).grad.numpy()
        assert_grad_close(t.T if k.endswith("k") else t, g, k)


@pytest.mark.parametrize("seed,off_scale", [(30, 3.0), (31, 30.0)])
def test_gda_training_function_matches_jax_grad(seed, off_scale):
    q, k, v, off = make_case(h=8, w=16, c=24, dg=3, seed=seed,
                             off_scale=off_scale)
    ct = np.random.RandomState(seed + 1).randn(*q.shape).astype(np.float32)
    want = jax.grad(lambda a, b, c, o: jnp.sum(
        j_gda_fused(a, b, c, o, (3, 3), 3, 3, 256, True) * ct),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, off)))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, off)]
    (gda_block.gda_train(*args, (3, 3), 3, 3)
     * torch.from_numpy(ct)).sum().backward()
    for name, a, b in zip(("q", "k", "v", "offset"), args, want):
        assert_grad_close(a.grad.numpy(), b, name)
    assert np.abs(args[3].grad.numpy()).max() > 1e-3   # the offsets matter


def _port_stl1_block(p, shift):
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
    return blk.train()


def test_stl1_training_route_matches_jax_fused_2d_vjp():
    """A shifted (1, 8, 8) block: the port folds the shift into
    ``swin_block_train`` (phase 4) and rolls the output back; JAX rolls
    explicitly around ``swin_block_pallas_2d``, whose VJP is the Pallas
    backward kernel (``_fused_2d_bwd_pallas``) in interpret mode."""
    shift = (0, 4, 4)
    x = _x((1, 2, 16, 16, C), 24)
    ct = np.random.RandomState(25).randn(*x.shape).astype(np.float32)
    wt = block_weights(C, NH, 1, False, 26)
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
    with mock.patch.object(jsw, "swin_block_pallas_2d", interpreted), \
            mock.patch.object(jsw, "PALLAS_BWD", True):
        gp, gx = jax.grad(lambda pp, xx: jnp.sum(
            fused.apply({"params": pp}, xx) * ct), argnums=(0, 1))(
                jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    assert calls

    blk = _port_stl1_block(stl_params(wt, C), shift)
    assert blk.kernel_route(2, 16, 16, (1, 8, 8), shift) == "stl1"
    xt = torch.from_numpy(x).requires_grad_()
    n = swin_block.swin_block_2d_bwd.launches
    with mock.patch.object(tvrt, "swin_block_train",
                           wraps=tvrt.swin_block_train) as train, \
            mock.patch.object(tvrt, "tmsa_composed") as composed:
        (blk(xt) * torch.from_numpy(ct)).sum().backward()
    assert train.call_args.args[6] == 4 and not composed.called   # phase 4
    assert swin_block.swin_block_2d_bwd.launches == n             # the CPU
    a, m = blk.attn, blk.mlp
    assert_grad_close(xt.grad.numpy(), gx, "x")
    for got, want, name in (
            (a.relative_position_bias_table, gp["attn"]["rel_bias_table"], "table"),
            (a.qkv_self.weight, gp["attn"]["qkv_self_kernel"].T, "qkv"),
            (a.qkv_self.bias, gp["attn"]["qkv_self_bias"], "qkv bias"),
            (a.proj.weight, gp["attn"]["proj_kernel"].T, "proj"),
            (a.proj.bias, gp["attn"]["proj_bias"], "proj bias"),
            (blk.norm1.weight, gp["norm1"]["scale"], "ln1 scale"),
            (blk.norm1.bias, gp["norm1"]["bias"], "ln1 bias"),
            (blk.norm2.weight, gp["norm2"]["scale"], "ln2 scale"),
            (blk.norm2.bias, gp["norm2"]["bias"], "ln2 bias"),
            (m.fc1.weight, gp["mlp_fc1"]["kernel"].T, "fc1"),
            (m.fc1.bias, gp["mlp_fc1"]["bias"], "fc1 bias"),
            (m.fc2.weight, gp["mlp_fc2"]["kernel"].T, "fc2"),
            (m.fc2.bias, gp["mlp_fc2"]["bias"], "fc2 bias")):
        assert_grad_close(got.grad.numpy(), want, name)


def test_table_grad_sums_by_the_one_frame_index():
    """The card's backward kernel returns the score-bias gradient (nh, 64,
    64), which ``rel_table_grad`` sums into the table by the 2-D index: the
    same sum as autograd through the (1, 8, 8) block's 3-D gather."""
    idx = torch.from_numpy(window3d.rel_position_index_3d(1, 8, 8).astype(
        np.int64))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_rel_index(1, 8, 8)))
    dbias = torch.randn(3, 64, 64, generator=torch.Generator().manual_seed(27))
    table = torch.zeros(225, 3, requires_grad=True)
    table[idx.reshape(-1)].reshape(64, 64, 3).permute(2, 0, 1).backward(dbias)
    got = swin_block.rel_table_grad(dbias, 225, 3)
    torch.testing.assert_close(got, table.grad, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "fused"])
def test_deform_attention_trains_on_a_cuda_tensor(impl):
    """On a CUDA tensor (mocked; the wrappers then run their plain versions)
    "auto" and "fused" under autograd take ``gda_train``: no composed call,
    no NotImplementedError, and the gather route's gradients."""
    q, k, v, off = (torch.from_numpy(a) for a in make_case(h=8, w=8, c=24,
                                                            dg=3, seed=32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, off)]
    n = deform_attn.deform_attention.composed_calls
    with mock.patch.object(torch.Tensor, "is_cuda", property(lambda t: True)), \
            mock.patch.object(gda_block, "gda_train",
                              wraps=gda_block.gda_train) as train:
        out = deform_attn.deform_attention(*leaves, (3, 3), 3, 3, impl)
    assert train.called and deform_attn.deform_attention.composed_calls == n
    out.float().sum().backward()
    ref = [t.clone().requires_grad_() for t in (q, k, v, off)]
    deform_attn.deform_attention_gather(*ref, (3, 3), 3, 3).sum().backward()
    for name, a, b in zip(("q", "k", "v", "offset"), leaves, ref):
        # the mocked card runs q, k and v in bf16, as the kernel does: the
        # gradients within 2e-2 of their norm
        assert a.grad.dtype == torch.float32, name
        rel = (a.grad - b.grad).norm() / b.grad.norm()
        assert rel < 2e-2, (name, rel)
