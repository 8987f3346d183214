"""The port's window attention (kair_tpu_torch.ops.window_attention) against
the JAX package's (kair_tpu.ops.window_attention), on the same numpy inputs,
f32 on the CPU, atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.ops import window_attention as jwa
from kair_tpu_torch.ops import window_attention as twa

ATOL = 1e-5


@pytest.mark.parametrize("shape,ws", [((2, 16, 24, 5), 8), ((1, 14, 21, 3), 7)])
def test_partition_and_reverse(shape, ws):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jwa.window_partition(jnp.asarray(x), ws))
    got = twa.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    back = twa.window_reverse(got, ws, shape[1], shape[2])
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("ws", [7, 8])
def test_relative_position_index(ws):
    np.testing.assert_array_equal(twa.relative_position_index(ws, ws),
                                  jwa.relative_position_index(ws, ws))


@pytest.mark.parametrize("h,w,ws,shift", [(16, 32, 8, 4), (64, 48, 8, 4),
                                          (21, 14, 7, 3)])
def test_shift_labels_and_mask(h, w, ws, shift):
    np.testing.assert_array_equal(twa.shift_window_labels(h, w, ws, shift),
                                  jwa.shift_window_labels(h, w, ws, shift))
    np.testing.assert_array_equal(twa.shift_attn_mask(h, w, ws, shift),
                                  jwa.shift_attn_mask(h, w, ws, shift))


@pytest.mark.parametrize("masked,qkv_bias", [(False, True), (True, True),
                                             (True, False)])
def test_window_msa_matches_jax(masked, qkv_bias):
    rng = np.random.RandomState(1)
    b, c, nh, ws, h, w = 2, 24, 4, 8, 16, 32
    nw = (h // ws) * (w // ws)
    xw = rng.randn(b, nw, ws * ws, c).astype(np.float32)
    qkv_k = (rng.randn(c, 3 * c) * 0.2).astype(np.float32)     # (in, out)
    qkv_b = (rng.randn(3 * c) * 0.1).astype(np.float32) if qkv_bias else None
    proj_k = (rng.randn(c, c) * 0.2).astype(np.float32)
    proj_b = (rng.randn(c) * 0.1).astype(np.float32)
    table = (rng.randn((2 * ws - 1) ** 2, nh) * 0.5).astype(np.float32)
    rel = jwa.relative_position_index(ws, ws)
    mask = jwa.shift_attn_mask(h, w, ws, ws // 2) if masked else None

    want = jwa.window_msa(jnp.asarray(xw), jnp.asarray(qkv_k),
                          None if qkv_b is None else jnp.asarray(qkv_b),
                          jnp.asarray(proj_k), jnp.asarray(proj_b),
                          jnp.asarray(table), rel, nh,
                          None if mask is None else jnp.asarray(mask))
    t = torch.from_numpy
    got = twa.window_msa(t(xw), t(qkv_k.T.copy()),
                         None if qkv_b is None else t(qkv_b),
                         t(proj_k.T.copy()), t(proj_b), t(table), rel, nh,
                         None if mask is None else t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
