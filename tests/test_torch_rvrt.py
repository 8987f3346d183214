"""The port's RVRT video slice on the CPU, f32, against KAIR and the JAX
package.

* RVRT loaded ``strict=True`` from the KAIR state dict of
  tests/fixtures/model_rvrt.npz against KAIR's own output, at the JAX
  test's limits (max 5e-3, mean 2e-4, tests/test_video_parity.py).
* ``rvrt_from_jax``: a JAX RVRT tree (scanned STL pairs, built by the JAX
  converter) carried across; the port's forward against the JAX forward
  with ``fuse_block=True`` (the STL2 kernel replaced by its jnp mirror),
  atol 5e-4 as for VRT.
* The route: at RVRT-001's geometry (1x8x64x64, released depths, a narrow
  width with heads == groups) 4 Swin-block, 64 STL2 and 12 GDA calls and no
  composed call.
* ``rvrt_forward_streamed`` against the full forward (atol 2e-4, rtol 1e-4,
  tests/test_video_pipeline.py); ``cli/test_video.build_task`` on tiny RVRT
  ``.pth`` files (video SR, and non-blind denoising with grouped input
  convs) and on every released preset's KAIR keys; ``define_g``.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu_torch.ckpt.torch_convert import rvrt_from_jax
from kair_tpu_torch.models import rvrt as trvrt
from kair_tpu_torch.models import vrt as tvrt
from tests.conftest import FIXTURES


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the suite runs six workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _sd(z):
    return {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}


def _ndhwc(a):
    return a.transpose(0, 1, 3, 4, 2)


def _forward(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(np.ascontiguousarray(x))).numpy()


FIXTURE_CFG = dict(upscale=4, clip_size=2, window_size=(2, 8, 8),
                   num_blocks=(1, 1, 1), depths=(2, 2, 2),
                   embed_dims=(16, 16, 16), num_heads=(2, 2, 2),
                   deformable_groups=2, attention_heads=2)


def jax_query_branch(feats):
    """The JAX package's choice (kair_tpu/models/rvrt.py:364): it reads the
    list of branches before the new one is in, so from the second branch on
    it takes the branch two back (the shallow features for forward_1)."""
    return list(feats)[-2] if len(feats) > 1 else "shallow"


def test_rvrt_matches_kair():
    z = np.load(FIXTURES / "model_rvrt.npz")
    model = trvrt.RVRT(**FIXTURE_CFG)
    model.load_state_dict(_sd(z), strict=True)
    got = _forward(model, _ndhwc(z["x"]))
    want = _ndhwc(z["out"])
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() < 5e-3, err.max()
    assert err.mean() < 2e-4, err.mean()
    # the JAX package's query branch is not KAIR's (ROADMAP Queue 3): with
    # it the same weights move the output by well over KAIR's float noise
    with mock.patch.object(trvrt.RVRT, "query_branch",
                           staticmethod(jax_query_branch)):
        jax_rule = _forward(model, _ndhwc(z["x"]))
    assert np.abs(jax_rule - want).max() > 10 * err.max()


# ---------------------------------------------------------------------------
# JAX parameters carried across
# ---------------------------------------------------------------------------

SMALL = dict(upscale=4, clip_size=2, window_size=(2, 8, 8),
             num_blocks=(1, 2, 1), depths=(2, 2, 2), embed_dims=(24, 24, 24),
             num_heads=(2, 2, 2), deformable_groups=4, attention_heads=4)


def seeded_rvrt(cfg, seed=0, **kw):
    """A port RVRT with seeded weights whose offset nets move the offsets
    off the flows, and a rel-pos bias that matters."""
    torch.manual_seed(seed)
    model = trvrt.RVRT(**cfg, **kw)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset.10" in name:
                p.normal_(0, 0.05)
            elif "relative_position_bias_table" in name:
                p.normal_(0, 0.5)
    return model


def test_rvrt_from_jax_matches_jax_forward():
    """JAX's fused dispatch runs with the STL2 kernel replaced by its jnp
    mirror (``_reference_stl2``, which the JAX package holds equal to the
    kernel) and its (1, 8, 8) blocks on the XLA route (``strip_w_max``
    patched to 0: interpret mode would take minutes under jit; the 2-D
    kernel's (1, 8, 8) route is held to JAX's kernel in
    tests/test_torch_rvrt_kernels.py). The port takes the JAX package's
    query branch here; KAIR's differs (test_rvrt_matches_kair)."""
    import jax
    from kair_tpu.ckpt.torch_convert import convert_rvrt
    from kair_tpu.models.rvrt import RVRT as JRVRT
    import kair_tpu.ops.pallas.stl_block as jstl
    import kair_tpu.ops.pallas.swin_block as jsw
    from kair_tpu.ops.pallas.tmsa_block import window_pattern_index

    calls = {"stl2": 0}

    def stl2_mirror(x, flat, nh, bias, shifted, **_):
        calls["stl2"] += 1
        widx = window_pattern_index(*x.shape[1:4], shifted)
        return jstl._reference_stl2(x, flat, nh, bias, widx)

    model = seeded_rvrt(SMALL)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_rvrt(sd, num_blocks=SMALL["num_blocks"],
                             depths=SMALL["depths"])
    pairs = variables["params"]["backbone_forward_1"]["rstb00"]["group"]["pairs"]
    assert np.asarray(pairs["a"]["norm1"]["scale"]).shape[0] == 1
    x = np.random.RandomState(7).rand(1, 4, 64, 64, 3).astype(np.float32)
    fused = JRVRT(**SMALL, fuse_block=True, deform_impl="gather")
    with mock.patch.object(jstl, "stl2_block_pallas", stl2_mirror), \
            mock.patch.object(jsw, "strip_w_max", lambda c: 0):
        want = np.asarray(jax.jit(fused.apply)(variables, jnp.asarray(x)))
    assert calls["stl2"], calls
    port = trvrt.RVRT(**SMALL)
    port.load_state_dict(rvrt_from_jax(variables), strict=True)
    with mock.patch.object(trvrt.RVRT, "query_branch",
                           staticmethod(jax_query_branch)):
        got = _forward(port, x)
    np.testing.assert_allclose(got, want, atol=5e-4)


# ---------------------------------------------------------------------------
# the kernel route at RVRT-001's geometry
# ---------------------------------------------------------------------------

class Counts:
    """Counting wrappers around the kernel wrappers and the composed routes
    as the model calls them."""

    def __enter__(self):
        from kair_tpu_torch.ops import deform_attn
        from kair_tpu_torch.ops.kernels import gda_block
        self.n = dict(swin=0, stl2=0, gda=0, composed=0, gather=0)

        def count(key, fn):
            def wrapped(*a, **k):
                self.n[key] += 1
                return fn(*a, **k)
            return wrapped
        self.patches = [
            mock.patch.object(tvrt, "swin_block_2d",
                              count("swin", tvrt.swin_block_2d)),
            mock.patch.object(tvrt, "stl2_block", count("stl2", tvrt.stl2_block)),
            mock.patch.object(tvrt, "tmsa_composed",
                              count("composed", tvrt.tmsa_composed)),
            mock.patch.object(gda_block, "gda_fused",
                              count("gda", gda_block.gda_fused)),
            mock.patch.object(deform_attn, "deform_attention_gather",
                              count("gather", deform_attn.deform_attention_gather))]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()
        return False


def test_rvrt_001_geometry_runs_every_block_on_a_kernel():
    """The released layout (num_blocks (1,2,1), depths (2,2,2), window
    (2,8,8), clip 2, 12 heads = 12 groups) at embed 24 on a 1x8x64x64
    clip: 2 + 2 (1,8,8) blocks on the 2-D Swin kernel, 4 branches x 4 clips
    x 2 RSTBs x 2 STL2 blocks, 4 branches x 3 clips of GDA; the gather
    route runs only inside the GDA kernel's plain version."""
    cfg = dict(SMALL, embed_dims=(24, 24, 24), deformable_groups=12,
               attention_heads=12)
    model = seeded_rvrt(cfg, deform_impl="fused")
    x = np.random.RandomState(1).rand(1, 8, 64, 64, 3).astype(np.float32)
    with Counts() as c:
        out = _forward(model, x)
    assert out.shape == (1, 8, 256, 256, 3) and np.isfinite(out).all()
    assert c.n == dict(swin=4, stl2=64, gda=12, composed=0, gather=12), c.n


def test_stl_blocks_take_the_composed_route_where_no_kernel_does():
    """A (2,8,8) STL block on an odd frame count, a (1,8,8) one whose h
    shift is clamped away (H = 8) but whose w shift is not, and fuse off."""
    torch.manual_seed(0)
    cases = [(tvrt.TMSA(16, 2, (2, 8, 8), (1, 4, 4), mut_attn=False,
                        geglu=False), (3, 16, 16)),
             (tvrt.TMSA(16, 2, (1, 8, 8), (0, 4, 4), mut_attn=False,
                        geglu=False), (2, 8, 16)),
             (tvrt.TMSA(16, 2, (2, 8, 8), (1, 4, 4), mut_attn=False,
                        geglu=False, fuse_block=False), (4, 16, 16))]
    for blk, (d, h, w) in cases:
        with Counts() as c, torch.no_grad():
            blk.eval()(torch.rand(1, d, h, w, 16))
        assert c.n["composed"] == 1 and c.n["stl2"] == c.n["swin"] == 0


# ---------------------------------------------------------------------------
# streamed inference, the CLI and the registry
# ---------------------------------------------------------------------------

TINY = dict(upscale=4, clip_size=2, window_size=(2, 8, 8), num_blocks=(1, 1, 1),
            depths=(1, 1, 1), embed_dims=(16, 16, 16), num_heads=(2, 2, 2),
            deformable_groups=2, attention_heads=2)


def test_streamed_matches_full_forward():
    from kair_tpu_torch.eval.rvrt_stream import rvrt_forward_streamed

    model = seeded_rvrt(TINY, seed=2).eval()
    x = np.random.RandomState(0).rand(1, 6, 64, 64, 3).astype(np.float32)
    want = _forward(model, x)
    got = rvrt_forward_streamed(model, x)
    assert got.shape == want.shape == (1, 6, 256, 256, 3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def _save(model, path):
    torch.save({"params": model.state_dict()}, path)
    return str(path)


@pytest.mark.parametrize("task,cfg,shape", [
    ("001_RVRT_videosr_bi_REDS_30frames", TINY, (1, 4, 64, 64, 3)),
    ("006_RVRT_videodenoising_DAVIS_16frames",
     dict(TINY, upscale=1, embed_dims=(24, 24, 24),
          inputconv_groups=(1, 3, 4, 6, 8, 4), nonblind_denoising=True),
     (1, 2, 256, 256, 4))])
def test_build_task_loads_a_kair_pth(tmp_path, task, cfg, shape):
    import kair_tpu_torch.cli.test_video as tcli

    model = seeded_rvrt(cfg, seed=3)
    path = _save(model, tmp_path / "rvrt.pth")
    with mock.patch.dict(tcli.RVRT_TASKS, {task: cfg}):
        fwd, sf, ws, nonblind = tcli.build_task(task, path, device="cpu")
    x = np.random.RandomState(5).rand(*shape).astype(np.float32)
    out = fwd(x)
    np.testing.assert_allclose(out, _forward(model, x), atol=1e-6)
    assert out.shape == (1, shape[1], sf * shape[2], sf * shape[3], 3)
    assert (sf, tuple(ws), nonblind) == (cfg["upscale"], (2, 8, 8),
                                         cfg.get("nonblind_denoising", False))


def test_every_released_preset_loads_its_kair_keys():
    """The six presets build, and each model's KAIR keys (the shapes of the
    released checkpoints) load back strictly into a fresh model."""
    import kair_tpu_torch.cli.test_video as tcli

    assert len(tcli.RVRT_TASKS) == 6
    for task, cfg in tcli.RVRT_TASKS.items():
        a, b = trvrt.RVRT(**cfg), trvrt.RVRT(**cfg)
        sd = a.state_dict()
        b.load_state_dict(sd, strict=True)
        assert sd["deform_align.forward_2.conv_offset.10.weight"].shape == (
            432, 64, 1, 1, 1)
        stl2 = b.backbone["forward_2"].main[5][1].residual_group.blocks[1]
        assert stl2.window_size == (2, 8, 8) and not stl2.geglu
        if cfg["upscale"] == 1:
            assert sd["feat_extract.1.weight"].shape[1] == (
                4 if cfg.get("nonblind_denoising") else 3)


def test_define_g_builds_rvrt():
    from kair_tpu_torch.models.registry import define_g

    model = define_g({"netG": {"net_type": "rvrt"}})
    assert isinstance(model, trvrt.RVRT)
    blocks = [m for m in model.modules() if isinstance(m, tvrt.TMSA)]
    assert len(blocks) == 2 + 4 * 2 * 2 + 2 and all(b.fuse_block for b in blocks)
    assert model.deform_align["backward_1"].deform_impl == "auto"
    assert model.deform_align["backward_1"].dg == 12
