"""Routing of the 3-D window blocks: ``TMSA.kernel_route`` sends a block to
a kernel only where that kernel takes its widths.

* At the geometries the wgmma window kernels refuse and the JAX dispatch
  sends to its fused kernels (a TMSA block at C=180, a self block at
  C=192, an STL2 block at C=240 with 8 heads, C=96 with 3 heads and C=128
  with 4 heads; an STL1 block past the 2-D kernel's head dim), the route
  is None. On the CPU the block takes its plain version; on the card it
  raises with the kernel's reason, before any work, and falls back to
  nothing (``TMSA.composed_calls`` stays as it was).
* The shipped presets keep their routes: every TMSA module of VRT 001-009
  and RVRT 001-006 (built on the meta device) routes as the windows alone
  decide, at the clip sizes it sees.
* ``win3d.takes`` agrees with ``_check_plan`` over a sweep of widths,
  heads, hidden widths and window depths, and ``block_takes`` with the
  2-D kernel's ``_check_cuda_args``.
* At one refused geometry, small (an STL2 block at C=24 with 3 heads),
  the module's forward on the CPU (the composed route) is held to the JAX
  ``TMSA`` module, whose fused Pallas kernel runs in interpret mode, at
  atol 1e-4.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kair_tpu.ops.pallas.stl_block as jstl
from kair_tpu.models.vrt import TMSA as JTMSA
from kair_tpu_torch.cli.test_video import RVRT_TASKS, VRT_TASKS
from kair_tpu_torch.models import vrt as tvrt
from kair_tpu_torch.models.rvrt import RVRT
from kair_tpu_torch.ops.kernels import swin_block, win3d
from kair_tpu_torch.ops.window3d import get_window_size
from tests.test_torch_rvrt_kernels import stl_params
from tests.test_torch_vrt_kernels import _x, block_weights

REFUSED = [
    # (name, TMSA kwargs, (d, h, w))
    ("tmsa C=180", dict(dim=180, num_heads=6, window_size=(2, 8, 8)),
     (2, 64, 64)),
    ("self6 C=192", dict(dim=192, num_heads=6, window_size=(6, 8, 8),
                         mut_attn=False), (6, 64, 64)),
    ("stl2 C=240 8 heads", dict(dim=240, num_heads=8, window_size=(2, 8, 8),
                                mut_attn=False, geglu=False), (2, 64, 64)),
    ("stl2 C=96 3 heads", dict(dim=96, num_heads=3, window_size=(2, 8, 8),
                               mut_attn=False, geglu=False), (2, 64, 64)),
    ("stl2 C=128 4 heads", dict(dim=128, num_heads=4, window_size=(2, 8, 8),
                                mut_attn=False, geglu=False), (2, 64, 64)),
    ("stl1 C=288 6 heads", dict(dim=288, num_heads=6, window_size=(1, 8, 8),
                                mut_attn=False, geglu=False), (2, 64, 64)),
]


def route_of(m, dhw, ss=(0, 0, 0)):
    ws, ss = get_window_size(dhw, m.window_size, ss)
    return m._window_route(*dhw, ws, ss), m.kernel_route(*dhw, ws, ss)


@pytest.mark.parametrize("name,kw,dhw", REFUSED, ids=[r[0] for r in REFUSED])
def test_route_is_composed_where_the_kernel_refuses(name, kw, dhw):
    with torch.device("meta"):
        m = tvrt.TMSA(**kw).eval()
    by_windows, route = route_of(m, dhw)
    assert by_windows is not None          # the windows alone would route it
    assert route is None


@pytest.mark.parametrize("task", sorted(VRT_TASKS) + sorted(RVRT_TASKS))
def test_shipped_presets_keep_their_routes(task):
    cfg = {**VRT_TASKS, **RVRT_TASKS}[task]
    with torch.device("meta"):
        model = (RVRT if task in RVRT_TASKS else tvrt.VRT)(**cfg).eval()
    blocks = [m for m in model.modules() if isinstance(m, tvrt.TMSA)]
    assert blocks
    routed = set()
    for m in blocks:
        for dhw in ((2, 64, 64), (6, 64, 64), (8, 32, 32), (6, 8, 8),
                    (4, 128, 128)):
            for ss in ((0, 0, 0), m.shift_size):
                by_windows, route = route_of(m, dhw, ss)
                assert route == by_windows, (task, m.window_size, dhw)
                routed.add(route)
    assert routed - {None}                 # each preset reaches a kernel


def test_shipped_widths_take_their_kernels():
    """VRT-001's TMSA (C=120) and self blocks (C=120 and 180, wd 6); VRT
    005-009's C=96; RVRT's STL2 and (1, 8, 8) blocks at C=144 and 192."""
    for c in (96, 120):
        assert win3d.takes(True, c, 6, 2 * c, 2, 2)
    for c, wd in ((96, 6), (120, 6), (180, 6), (120, 8), (180, 1), (96, 4)):
        assert win3d.takes(False, c, 6, 2 * c, wd, wd)
    for c in (144, 192):
        assert win3d.takes(False, c, 6, 2 * c, 2, 2, plain=True)
        assert swin_block.block_takes(c, 6, 2 * c)


@pytest.mark.parametrize("mutual,plain", [(True, False), (False, False),
                                          (False, True)])
def test_takes_agrees_with_check_plan(mutual, plain):
    seen = set()
    for c in (24, 48, 90, 96, 100, 120, 128, 144, 160, 180, 184, 192, 200,
              240):
        for nh in (1, 2, 3, 4, 5, 6, 8, 12):
            if c % nh:
                continue
            for hidden, wd, twd in ((2 * c, 2, 2), (4 * c, 6, 6),
                                    (2 * c, 1, 8), (c // 2, 8, 8)):
                pl = win3d.win3d_plan(mutual, c, nh, hidden, wd, twd, plain)
                try:
                    win3d._check_plan("block", pl, c, nh, mutual, plain)
                    ok = True
                except ValueError:
                    ok = False
                assert win3d.takes(mutual, c, nh, hidden, wd, twd,
                                   plain) == ok, (c, nh, hidden, wd, twd)
                seen.add(ok)
    assert seen == {True, False}


@pytest.mark.parametrize("c,nh,hidden,ok", [
    (180, 6, 360, True), (240, 8, 480, True), (144, 6, 288, True),
    (60, 6, 120, True), (288, 6, 576, False), (256, 8, 512, False),
    (30, 2, 60, True), (45, 3, 90, False)])
def test_block_takes_agrees_with_the_2d_kernels_checks(c, nh, hidden, ok):
    assert swin_block.block_takes(c, nh, hidden) is ok


def test_refused_stl2_forward_matches_jax():
    """An STL2 block at C=24 with 3 heads (an odd head count the wgmma
    kernel refuses) on 1x2x16x16, shifted: the route is None, the CPU
    forward takes the composed block, and it equals the JAX module's fused
    kernel (interpret mode)."""
    c, nh, shift = 24, 3, (0, 4, 4)
    x = _x((1, 2, 16, 16, c), 21)
    wt = block_weights(c, nh, 2, False, 22)
    params = {"norm1": {"scale": wt["ln1s"], "bias": wt["ln1b"]},
              "norm2": {"scale": wt["ln2s"], "bias": wt["ln2b"]},
              "attn": {"rel_bias_table": wt["table"],
                       "qkv_self_kernel": wt["qkv_s_k"],
                       "qkv_self_bias": wt["qkv_s_b"],
                       "proj_kernel": wt["proj_k"], "proj_bias": wt["proj_b"]},
              "mlp_fc1": {"kernel": wt["fc11k"], "bias": wt["fc11b"]},
              "mlp_fc2": {"kernel": wt["fc2k"], "bias": wt["fc2b"]}}
    fused = JTMSA(c, nh, (2, 8, 8), shift, mut_attn=False, geglu=False,
                  fuse_block=True)
    orig, calls = jstl.stl2_block_pallas, []

    def interpreted(*a, **k):
        calls.append(1)
        return orig(*a, **{**k, "interpret": True})
    with mock.patch.object(jstl, "stl2_block_pallas", interpreted):
        init = fused.init(jax.random.PRNGKey(0), jnp.asarray(x))
        assert jax.tree_util.tree_structure(init["params"]) == \
            jax.tree_util.tree_structure(params)
        want = np.asarray(fused.apply({"params": params}, jnp.asarray(x)))
    assert calls                           # JAX ran its fused kernel

    p = stl_params(wt, c)
    blk = tvrt.TMSA(c, nh, (2, 8, 8), shift, mut_attn=False, geglu=False)
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
    assert route_of(blk, (2, 16, 16), shift) == ("stl2", None)
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_refused_route_raises_on_the_card():
    """An STL2 block at C=24 with 3 heads: on the CPU the forward takes the
    plain version and counts no composed call; on a CUDA tensor (mocked
    here) it raises with the kernel's refusal, the stl2 wrapper is never
    called and no composed call is counted."""
    c, nh = 24, 3
    blk = tvrt.TMSA(c, nh, (2, 8, 8), (0, 0, 0), mut_attn=False,
                    geglu=False).eval()
    x = torch.from_numpy(_x((1, 2, 8, 8, c), 23))
    n = tvrt.TMSA.composed_calls
    with mock.patch.object(tvrt, "stl2_block",
                           side_effect=AssertionError("kernel route")), \
            torch.no_grad():
        y = blk(x)
        assert tvrt.TMSA.composed_calls == n
        assert y.shape == x.shape and torch.isfinite(y).all()
        with mock.patch.object(torch.Tensor, "is_cuda",
                               property(lambda t: True)), \
                pytest.raises(ValueError, match="even number of heads"):
            blk(x)
    assert tvrt.TMSA.composed_calls == n


@pytest.mark.parametrize("name,kw,dhw", REFUSED, ids=[r[0] for r in REFUSED])
def test_refused_width_raises_on_the_card(name, kw, dhw):
    """At each refused width a CUDA tensor (mocked here, on the meta
    device) raises with the routed kernel's reason, and no composed call
    is counted."""
    with torch.device("meta"):
        m = tvrt.TMSA(**kw).eval()
        x = torch.empty((1, *dhw, kw["dim"]))
    ws, _ = get_window_size(dhw, m.window_size, m.shift_size)
    why = m.kernel_refusal(m._window_route(*dhw, ws, m.shift_size), ws)
    assert why
    n = tvrt.TMSA.composed_calls
    with mock.patch.object(torch.Tensor, "is_cuda",
                           property(lambda t: True)), \
            pytest.raises(ValueError, match="runs its fused kernel") as e:
        m(x)
    assert why in str(e.value)
    assert tvrt.TMSA.composed_calls == n
