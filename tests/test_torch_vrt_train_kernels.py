"""The training functions of the port's three VRT block kernels on the
CPU, f32, against the JAX package's custom VJPs.

``tmsa_block_train``, ``self6_block_train`` (``Win3dBlockFunction``) and
``DcnFunction`` on the CPU route (the plain forward, autograd through the
composed route) against ``jax.grad`` through ``tmsa_block_pallas`` /
``self6_block_pallas`` / ``dcn_fused`` in interpret mode (the max-safe
kernel forward, the composed route's VJP): dx and every parameter's gradient, max abs error at most 1e-4
of the gradient's own max (f32 sums in another order; the Pallas mirrors
use the A&S GELU and bf16-held score biases, so the tables hold
bf16-representable values). On the card the forward is the kernel
(chip_smoke.py phase 21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kair_tpu.ops.pallas.self6_block as js6
from kair_tpu.models.vrt import rel_position_index_3d as j_rel_index
from kair_tpu.ops.pallas.dcn_block import dcn_fused as j_dcn_fused
from kair_tpu.ops.pallas.tmsa_block import (make_tmsa_biases,
                                            tmsa_block_pallas,
                                            tmsa_mask_patterns)
from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.kernels import dcn_block, self6_block, tmsa_block
from tests.test_torch_vrt_kernels import block_weights, dcn_inputs, torch_params

C, NH = 24, 2
FLAT_MUT = ("qkv_s_k", "qkv_s_b", "qkv_m_k", "qkv_m_b", "proj_k", "proj_b",
            "ln1s", "ln1b", "ln2s", "ln2b", "fc11k", "fc11b", "fc12k", "fc12b",
            "fc2k", "fc2b")
FLAT_SELF = tuple(k for k in FLAT_MUT if not k.startswith("qkv_m"))
# Tmsa3dParams field of each JAX weight (kernels (in, out): transposed)
FIELD = {"qkv_s_k": "qkv_self_weight", "qkv_s_b": "qkv_self_bias",
         "qkv_m_k": "qkv_mut_weight", "qkv_m_b": "qkv_mut_bias",
         "proj_k": "proj_weight", "proj_b": "proj_bias", "ln1s": "norm1_weight",
         "ln1b": "norm1_bias", "ln2s": "norm2_weight", "ln2b": "norm2_bias",
         "fc11k": "fc11_weight", "fc11b": "fc11_bias", "fc12k": "fc12_weight",
         "fc12b": "fc12_bias", "fc2k": "fc2_weight", "fc2b": "fc2_bias"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_grad_close(got, want, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 1e-4 * max(np.abs(want).max(), 1e-6), (what, err)


def _port_grads(fn, x, p, ct):
    xt = torch.from_numpy(x).requires_grad_()
    pt = window3d.Tmsa3dParams(*[
        None if t is None else (t.requires_grad_() if n != "position_bias" else t)
        for n, t in zip(window3d.Tmsa3dParams._fields, p)])
    (fn(xt, pt) * torch.from_numpy(ct)).sum().backward()
    return xt.grad.numpy(), pt


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 4, 4)])
def test_tmsa_training_function_matches_jax_grad(shift):
    d, h, w = 4, 16, 16
    rng = np.random.RandomState(1)
    x = rng.rand(1, d, h, w, C).astype(np.float32)
    ct = rng.randn(1, d, h, w, C).astype(np.float32)
    wt = block_weights(C, NH, 2, True, 2)
    pos = window3d.sine_position_encoding(8, 8, C // 2)
    pos2 = jnp.asarray(np.concatenate([pos, pos]))
    shifted = any(shift)
    pats = tmsa_mask_patterns(d, h, w, (2, 8, 8), shift) if shifted else None
    idx = j_rel_index(2, 8, 8)[:128, :128]

    def loss(xx, flat, table):
        bs, bm = make_tmsa_biases(table, idx, NH, pats)
        xin = jnp.roll(xx, tuple(-s for s in shift), axis=(1, 2, 3))
        y = tmsa_block_pallas(xin, flat, pos2, NH, bs, bm, shifted,
                              interpret=True)
        return jnp.sum(jnp.roll(y, shift, axis=(1, 2, 3)) * ct)
    gx, gflat, gtable = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), tuple(jnp.asarray(wt[k]) for k in FLAT_MUT),
        jnp.asarray(wt["table"]))
    dx, pt = _port_grads(
        lambda a, p: tmsa_block.tmsa_block_train(a, p, NH, shift), x,
        torch_params(wt, C), ct)
    assert_grad_close(dx, gx, "x")
    assert_grad_close(pt.rel_table.grad.numpy(), gtable, "table")
    for k, g in zip(FLAT_MUT, gflat):
        t = getattr(pt, FIELD[k]).grad.numpy()
        assert_grad_close(t.T if k.endswith("k") else t, g, k)


@pytest.mark.parametrize("wd,dhw,shift", [(6, (6, 16, 16), (3, 4, 4)),
                                          (2, (4, 16, 16), (1, 0, 0)),
                                          (1, (2, 16, 16), (0, 4, 4))])
def test_self_training_function_matches_jax_grad(wd, dhw, shift):
    d, h, w = dhw
    rng = np.random.RandomState(3)
    x = rng.rand(1, d, h, w, C).astype(np.float32)
    ct = rng.randn(1, d, h, w, C).astype(np.float32)
    wt = block_weights(C, NH, wd, False, 4)
    shifted = any(shift)
    pats = tmsa_mask_patterns(d, h, w, (wd, 8, 8), shift) if shifted else None

    def loss(xx, flat, table):
        rel = js6.make_self6_rel(table, NH, wd)
        xin = jnp.roll(xx, tuple(-s for s in shift), axis=(1, 2, 3))
        y = js6.self6_block_pallas(xin, flat, NH, rel, pats, shifted,
                                   interpret=True, wd=wd)
        return jnp.sum(jnp.roll(y, shift, axis=(1, 2, 3)) * ct)
    gx, gflat, gtable = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), tuple(jnp.asarray(wt[k]) for k in FLAT_SELF),
        jnp.asarray(wt["table"]))
    dx, pt = _port_grads(
        lambda a, p: self6_block.self6_block_train(a, p, NH, wd, shift), x,
        torch_params(wt, C), ct)
    assert_grad_close(dx, gx, "x")
    assert_grad_close(pt.rel_table.grad.numpy(), gtable, "table")
    for k, g in zip(FLAT_SELF, gflat):
        t = getattr(pt, FIELD[k]).grad.numpy()
        assert_grad_close(t.T if k.endswith("k") else t, g, k)


def test_dcn_training_function_matches_jax_grad():
    x, off, mask, weight, bias = dcn_inputs()
    dg = 3
    ct = np.random.RandomState(6).randn(1, 8, 10, weight.shape[0]).astype(
        np.float32)
    want = jax.grad(lambda a, o, m, wt, b: jnp.sum(
        (j_dcn_fused(a, o, m, wt, 1, 1, 1, dg, 256, True) + b) * ct),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (
            x, off, mask, weight.transpose(2, 3, 1, 0), bias)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, off, mask,
                                                          weight, bias)]
    (dcn_block.dcn_train(*args, dg) * torch.from_numpy(ct)).sum().backward()
    for name, a, b in zip(("x", "offset", "mask", "weight", "bias"), args, want):
        b = np.asarray(b)
        assert_grad_close(a.grad.numpy(),
                          b.transpose(3, 2, 0, 1) if name == "weight" else b,
                          name)
