"""The port's VRT video slice on the CPU, f32, against KAIR and the JAX
package.

* VRT loaded ``strict=True`` from the KAIR state dicts of
  tests/fixtures/model_vrt.npz (video SR) and model_vrt_fi.npz (frame
  interpolation) against KAIR's own outputs, at the JAX test's limits (max
  5e-3, mean 2e-4, tests/test_video_parity.py); SpyNet against
  model_spynet.npz (atol 5e-4, as there).
* ``flow_warp`` and the 2/4/6-frame aligners against the JAX package's.
* ``vrt_from_jax``: a JAX VRT tree with scanned TMSA pairs (built by the
  JAX converter) carried across; the port's forward against the JAX
  forward with ``fuse_block=True`` (its kernels' jnp mirrors).
* The route: at VRT-001's geometry (1x6x64x64, depths 8x7 + 4x6, window
  (6,8,8)) every block and every DCN goes through the three kernel
  wrappers, 42/38/70 calls and no composed call; geometries that the JAX
  package sends to XLA take the composed route.
* ``eval/video_test`` and ``cli/test_video`` against the JAX package's, on
  seeded PNG frames in a temporary folder, with a stand-in forward; the
  CLI's ``build_task`` loading a tiny VRT's ``.pth``.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.ckpt.torch_convert import convert_vrt
from kair_tpu.ops import warp as jwarp
from kair_tpu_torch.ckpt.torch_convert import vrt_from_jax
from kair_tpu_torch.models import vrt as tvrt
from kair_tpu_torch.models.spynet import SpyNet
from kair_tpu_torch.ops import warp as twarp
from tests.conftest import FIXTURES


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the suite runs six workers on
    the machine's cores, and eight threads each made these tests several
    times slower than alone."""
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


# ---------------------------------------------------------------------------
# KAIR fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture,cfg", [
    ("model_vrt", dict(upscale=4, window_size=(2, 8, 8), depths=(2,) * 8,
                       embed_dims=(12,) * 7 + (16,), num_heads=(2,) * 8,
                       pa_frames=2, deformable_groups=2)),
    ("model_vrt_fi", dict(upscale=1, window_size=(4, 8, 8), depths=(2,) * 9,
                          embed_dims=(12,) * 7 + (16, 16), num_heads=(2,) * 9,
                          pa_frames=0, indep_reconsts=(), img_size=(4, 64, 64))),
])
def test_vrt_matches_kair(fixture, cfg):
    z = np.load(FIXTURES / f"{fixture}.npz")
    model = tvrt.VRT(**cfg)
    model.load_state_dict(_sd(z), strict=True)
    got = _forward(model, _ndhwc(z["x"]))
    want = _ndhwc(z["out"])
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.max() < 5e-3, err.max()
    assert err.mean() < 2e-4, err.mean()


def test_spynet_matches_kair():
    z = np.load(FIXTURES / "model_spynet.npz")
    model = SpyNet((2, 3, 4, 5))
    model.load_state_dict(_sd(z), strict=True)
    with torch.no_grad():
        flows = model(*(torch.from_numpy(z[k].transpose(0, 2, 3, 1))
                        for k in ("ref", "supp")))
    assert len(flows) == 4
    for i, f in enumerate(flows):
        np.testing.assert_allclose(f.numpy(), z[f"flow{i}"].transpose(0, 2, 3, 1),
                                   atol=5e-4)


# ---------------------------------------------------------------------------
# warping and alignment against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,padding", [("bilinear", "zeros"),
                                          ("nearest4", "zeros"),
                                          ("bilinear", "border"),
                                          ("nearest", "zeros")])
def test_flow_warp_matches_jax(mode, padding):
    rng = np.random.RandomState(3)
    x = rng.rand(2, 12, 14, 5).astype(np.float32)
    # flows up to ±4 px push samples past every border
    flow = (rng.rand(2, 12, 14, 2) * 8 - 4).astype(np.float32)
    want = np.asarray(jwarp.flow_warp(jnp.asarray(x), jnp.asarray(flow), mode,
                                      padding))
    got = twarp.flow_warp(torch.from_numpy(x), torch.from_numpy(flow), mode,
                          padding).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("pa_frames", [2, 4, 6])
def test_aligners_match_jax(pa_frames):
    from kair_tpu.models import vrt as jvrt
    from kair_tpu.ckpt.torch_convert import t_conv

    rng = np.random.RandomState(pa_frames)
    b, t, h, w, c, dg = 1, 6, 16, 16, 8, 2
    nf = pa_frames // 2
    x = rng.rand(b, t, h, w, c).astype(np.float32)
    fb = [(rng.rand(b, t - 1 - j, h, w, 2) * 4 - 2).astype(np.float32)
          for j in range(nf)]
    ff = [(rng.rand(b, t - 1 - j, h, w, 2) * 4 - 2).astype(np.float32)
          for j in range(nf)]
    torch.manual_seed(pa_frames)
    dcn = tvrt.DCNv2PackFlowGuided(c, dg, 10.0, pa_frames)
    with torch.no_grad():         # offsets that leave the flow, a live mask
        dcn.conv_offset[6].weight.normal_(0, 0.05)
        dcn.conv_offset[6].bias.normal_(0, 0.1)
    sd = {k: v.numpy() for k, v in dcn.state_dict().items()}
    leaf = lambda p: {"conv": {"kernel": t_conv(sd[p + ".weight"]),
                               "bias": sd[p + ".bias"]}}
    params = {"dcn_kernel": t_conv(sd["weight"]), "dcn_bias": sd["bias"],
              "off0": leaf("conv_offset.0"), "off1": leaf("conv_offset.2"),
              "off2": leaf("conv_offset.4"),
              "off3": leaf("conv_offset.6")["conv"]}
    jdcn = jvrt.DCNv2PackFlowGuided(c, dg, 10.0, pa_frames, deform_impl="gather")
    pa = lambda a, ws_, cur, fl: jdcn.apply({"params": params}, a, ws_, cur, fl)
    jfn = {2: jvrt._aligned_2frames, 4: jvrt._aligned_4frames,
           6: jvrt._aligned_6frames}[pa_frames]
    want = jfn(jnp.asarray(x), [jnp.asarray(f) for f in fb],
               [jnp.asarray(f) for f in ff], pa)
    tfn = {2: tvrt.aligned_2frames, 4: tvrt.aligned_4frames,
           6: tvrt.aligned_6frames}[pa_frames]
    with torch.no_grad():
        got = tfn(torch.from_numpy(x), [torch.from_numpy(f) for f in fb],
                  [torch.from_numpy(f) for f in ff], dcn)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-4)
    assert np.abs(np.asarray(want[0])).max() > 0.1


# ---------------------------------------------------------------------------
# JAX parameters carried across
# ---------------------------------------------------------------------------

SMALL = dict(upscale=4, embed_dims=(24,) * 7 + (32,) * 2,
             depths=(2,) * 7 + (2,) * 2, num_heads=(2,) * 9,
             deformable_groups=2, pa_frames=2, mul_attn_ratio=0.5)


def seeded_vrt(cfg, seed=0, **kw):
    """A port VRT with seeded weights whose offset nets move the offsets off
    the flows and the mask off 0.5, and a rel-pos bias that matters."""
    torch.manual_seed(seed)
    model = tvrt.VRT(**cfg, **kw)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset.6" in name:
                p.normal_(0, 0.02)
            elif "relative_position_bias_table" in name:
                p.normal_(0, 0.5)
    return model


def test_vrt_from_jax_matches_jax_forward():
    """JAX's fused dispatch runs with its kernels replaced by their jnp
    mirrors (``_reference_tmsa``, ``_reference_self6``, which the JAX
    package holds equal to the kernels): interpret mode would take minutes
    at 6x64x64; the kernels themselves are held to the port's plain
    versions in tests/test_torch_vrt_kernels.py. jit: an eager first run
    compiles every op apart and takes minutes."""
    import jax
    from kair_tpu.models.vrt import VRT as JVRT
    import kair_tpu.ops.pallas.self6_block as js6
    import kair_tpu.ops.pallas.tmsa_block as jtb

    def tmsa_mirror(x, flat, pos, nh, bs, bm, shifted, **_):
        widx = jtb.window_pattern_index(*x.shape[1:4], shifted)
        return jtb._reference_tmsa(x, flat, pos, nh, bs, bm, widx)

    def self6_mirror(x, flat, nh, rel, pats, shifted, wd=6, **_):
        n = wd * 64
        pats = jnp.zeros((1, n, n)) if pats is None else jnp.asarray(pats)
        widx = js6.window_pattern_index6(*x.shape[1:4], shifted, wd)
        return js6._reference_self6(x, flat, nh, rel, pats, widx, wd)

    model = seeded_vrt(SMALL)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_vrt(sd, depths=SMALL["depths"], pa_frames=2, upscale=4,
                            mul_attn_ratio=0.5)
    # stage 8's depth-2 groups are nn.scan pairs: leaves stacked over pairs
    pairs = variables["params"]["stage8_0"]["group"]["pairs"]
    assert np.asarray(pairs["a"]["norm1"]["scale"]).shape[0] == 1
    x = np.random.RandomState(7).rand(1, 6, 64, 64, 3).astype(np.float32)
    calls = {"tmsa": 0, "self6": 0}

    def counted(key, fn):
        def f(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return f
    fused = JVRT(**SMALL, fuse_block=True, deform_impl="gather")
    with mock.patch.object(jtb, "tmsa_block_pallas",
                           counted("tmsa", tmsa_mirror)), \
            mock.patch.object(js6, "self6_block_pallas",
                              counted("self6", self6_mirror)):
        want = np.asarray(jax.jit(fused.apply)(variables, jnp.asarray(x)))
    assert calls["tmsa"] and calls["self6"], calls
    port = tvrt.VRT(**SMALL)
    port.load_state_dict(vrt_from_jax(variables, (6, 8, 8)), strict=True)
    got = _forward(port, x)
    np.testing.assert_allclose(got, want, atol=5e-4)


# ---------------------------------------------------------------------------
# the kernel route at VRT-001's geometry
# ---------------------------------------------------------------------------

class Counts:
    """Counting wrappers around the three kernel wrappers and the composed
    routes as the model calls them."""

    def __enter__(self):
        from kair_tpu_torch.ops.kernels import dcn_block
        self.n = dict(tmsa=0, self6=0, dcn=0, composed=0, deform=0)

        def count(key, fn):
            def wrapped(*a, **k):
                self.n[key] += 1
                return fn(*a, **k)
            return wrapped
        self.patches = [
            mock.patch.object(tvrt, "tmsa_block", count("tmsa", tvrt.tmsa_block)),
            mock.patch.object(tvrt, "self6_block",
                              count("self6", tvrt.self6_block)),
            mock.patch.object(tvrt, "tmsa_composed",
                              count("composed", tvrt.tmsa_composed)),
            mock.patch.object(tvrt, "modulated_deform_conv",
                              count("deform", tvrt.modulated_deform_conv)),
            mock.patch.object(dcn_block, "dcn_fused",
                              count("dcn", dcn_block.dcn_fused))]
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()
        return False


def test_vrt_001_geometry_runs_every_block_on_a_kernel():
    cfg = dict(upscale=4, window_size=(6, 8, 8), depths=(8,) * 7 + (4,) * 6,
               embed_dims=(24,) * 7 + (32,) * 6, num_heads=(2,) * 13,
               pa_frames=2, deformable_groups=12)
    model = seeded_vrt(cfg, deform_impl="fused")
    x = np.random.RandomState(1).rand(1, 6, 64, 64, 3).astype(np.float32)
    with Counts() as c:
        out = _forward(model, x)
    assert out.shape == (1, 6, 256, 256, 3) and np.isfinite(out).all()
    assert c.n == dict(tmsa=42, self6=38, dcn=70, composed=0, deform=70), c.n


def test_geometries_jax_sends_to_xla_take_the_composed_route():
    """Mutual blocks on an odd frame count, self blocks whose window depth
    does not divide D, maps not tiled by 8, and fuse_block off."""
    torch.manual_seed(0)
    cases = [(tvrt.TMSA(16, 2, (2, 8, 8), (1, 4, 4), mut_attn=True), (3, 16, 16)),
             (tvrt.TMSA(16, 2, (6, 8, 8), (3, 4, 4), mut_attn=False), (8, 16, 16)),
             (tvrt.TMSA(16, 2, (6, 8, 8), (3, 4, 4), mut_attn=False), (6, 12, 16)),
             (tvrt.TMSA(16, 2, (2, 8, 8), (1, 4, 4), mut_attn=True,
                        fuse_block=False), (4, 16, 16))]
    for blk, (d, h, w) in cases:
        x = torch.rand(1, d, h, w, 16)
        with Counts() as c, torch.no_grad():
            blk.eval()(x)
        assert c.n["composed"] == 1 and c.n["tmsa"] == c.n["self6"] == 0
    with Counts() as c, torch.no_grad():
        tvrt.TMSA(16, 2, (6, 8, 8), (3, 4, 4), mut_attn=False).eval()(
            torch.rand(1, 2, 16, 16, 16))     # D=2 clamps the window to 2
    assert c.n["self6"] == 1 and c.n["composed"] == 0


def test_deform_impl_resolution():
    assert twarp.resolve_deform_impl("auto", torch.device("cpu")) == "gather"
    assert twarp.resolve_deform_impl("auto", torch.device("cuda")) == "fused"
    for impl in ("mxu", "fused", "gather"):
        assert twarp.resolve_deform_impl(impl, torch.device("cpu")) == impl
    with pytest.raises(ValueError, match="unknown deform impl"):
        twarp.resolve_deform_impl("scatter", torch.device("cpu"))


def test_fused_deform_raises_on_the_card_where_the_kernel_does_not_take_it():
    """impl 'fused' on a CUDA tensor with Cout=272 (over the kernel's 256)
    raises rather than running the composed route; on the CPU the same call
    is the kernel's plain version, the composed route."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 12), np.float32))
    off = torch.from_numpy(rng.standard_normal((1, 8, 8, 3 * 18), np.float32))
    mask = torch.rand(1, 8, 8, 3 * 9)
    weight = torch.from_numpy(rng.standard_normal((272, 12, 3, 3), np.float32))
    with mock.patch.object(torch.Tensor, "is_cuda", property(lambda t: True)):
        with pytest.raises(ValueError, match="does not take weight"):
            twarp.modulated_deform_conv(x, off, mask, weight,
                                        deformable_groups=3, impl="fused")
    got = twarp.modulated_deform_conv(x, off, mask, weight,
                                      deformable_groups=3, impl="fused")
    want = twarp.modulated_deform_conv(x, off, mask, weight,
                                       deformable_groups=3, impl="gather")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# tiled inference and the test CLI against the JAX package
# ---------------------------------------------------------------------------

def stand_in(a):
    """A deterministic x4 'model': nearest upscale and a pointwise curve."""
    up = np.repeat(np.repeat(np.asarray(a, np.float32), 4, 2), 4, 3)
    return np.clip(up ** 1.1 + 0.01 * np.sin(up * 7), 0, 1)


@pytest.mark.parametrize("kw", [
    dict(num_frame_testing=4, num_frame_overlapping=2, size_patch_testing=16,
         patch_overlap=4),
    dict(num_frame_testing=0, size_patch_testing=0)])
def test_video_tiling_matches_jax(kw):
    from kair_tpu.eval import video_test as jvt
    from kair_tpu_torch.eval import video_test as tvt

    lq = np.random.RandomState(2).rand(1, 7, 20, 28, 3).astype(np.float32)
    want = jvt.test_video(stand_in, lq, 4, (2, 8, 8), **kw)
    got = tvt.test_video(lambda a: torch.from_numpy(stand_in(a)), lq, 4,
                         (2, 8, 8), **kw)
    np.testing.assert_allclose(got, want, atol=1e-6)
    want = jvt.test_video_ensembled(stand_in, lq, 4, pad_seq=True,
                                    flip_seq=True, window_size=(2, 8, 8), **kw)
    got = tvt.test_video_ensembled(stand_in, lq, 4, pad_seq=True, flip_seq=True,
                                   window_size=(2, 8, 8), **kw)
    np.testing.assert_allclose(got, want, atol=1e-6)
    lq16 = lq[:, :, :16, :24]
    assert tvt.clamped_window_starts(24, 8, 4) == jvt.clamped_window_starts(24, 8, 4)
    np.testing.assert_allclose(tvt.test_clip_grid(stand_in, lq16, 4, (8, 8), 4),
                               jvt.test_clip_grid(stand_in, lq16, 4, (8, 8), 4),
                               atol=1e-6)


def _write_clips(root, rng):
    from kair_tpu_torch.utils import image as im
    for clip in ("000", "011"):
        for sub, size in (("lq", 24), ("gt", 96)):
            d = root / sub / clip
            d.mkdir(parents=True)
            for f in range(5):
                img = (rng.rand(size, size, 3) * 255).astype(np.uint8)
                im.imsave(img, str(d / f"{f:08d}.png"))


def test_test_video_cli_matches_jax(tmp_path):
    import kair_tpu.cli.test_video as jcli
    import kair_tpu_torch.cli.test_video as tcli

    _write_clips(tmp_path, np.random.RandomState(4))
    argv = ["--model_path", "unused.pth", "--folder_lq", str(tmp_path / "lq"),
            "--folder_gt", str(tmp_path / "gt"), "--tile", "4", "16", "16",
            "--tile_overlap", "2", "4", "4"]
    ret = (stand_in, 4, (2, 8, 8), False)
    with mock.patch.object(jcli, "build_task", lambda *a, **k: ret):
        want = jcli.main(argv)
    with mock.patch.object(tcli, "build_task", lambda *a, **k: ret):
        got = tcli.main(argv + ["--device", "cpu"])
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-6, (k, got[k], want[k])


def test_build_task_loads_a_kair_pth(tmp_path):
    import kair_tpu_torch.cli.test_video as tcli

    tiny = dict(upscale=4, window_size=(2, 8, 8), depths=(2,) * 8,
                embed_dims=(12,) * 7 + (16,), num_heads=(2,) * 8, pa_frames=2,
                deformable_groups=2)
    model = seeded_vrt(tiny, seed=3)
    path = tmp_path / "vrt.pth"
    torch.save({"params": model.state_dict()}, path)
    task = "001_VRT_videosr_bi_REDS_6frames"
    with mock.patch.dict(tcli.VRT_TASKS, {task: tiny}):
        fwd, sf, ws, nonblind = tcli.build_task(task, str(path), device="cpu")
    x = np.random.RandomState(5).rand(1, 4, 64, 64, 3).astype(np.float32)
    np.testing.assert_allclose(fwd(x), _forward(model, x), atol=1e-6)
    assert (sf, tuple(ws), nonblind) == (4, (2, 8, 8), False)
    with pytest.raises(KeyError, match="unknown task"):
        tcli.build_task("010_VRT_unknown", str(path), "cpu")


def test_define_g_builds_vrt_001_from_the_option_file():
    from kair_tpu_torch import config
    from kair_tpu_torch.models.registry import define_g

    opt = config.parse("options/vrt/001_train_vrt_videosr_bi_reds_6frames.json",
                       is_train=False)
    model = define_g(opt)
    assert isinstance(model, tvrt.VRT)
    blocks = [m for m in model.modules() if isinstance(m, tvrt.TMSA)]
    assert len(blocks) == 7 * 8 + 6 * 4 and all(b.fuse_block for b in blocks)
    assert model.stage1.pa_deform.dg == 12
    assert model.stage1.pa_deform.deform_impl == "auto"
    assert model.stage8[-1].residual_group.blocks[0].window_size == (1, 8, 8)
    assert model.stage8[1].residual_group.blocks[0].window_size == (6, 8, 8)


def test_cast_for_inference_keeps_spynet_weights_exact():
    """SpyNet goes to f32 directly: a trip through bf16 would move the
    flows, and the nearest-pixel pre-warp flips where a flow is near an
    integer."""
    model = seeded_vrt(SMALL)
    want = {k: v.clone() for k, v in model.spynet.state_dict().items()}
    tvrt.cast_for_inference(model, "cpu", torch.bfloat16)
    for k, v in model.spynet.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k
    assert model.stage1.residual_group1.blocks[0].attn.qkv_self.weight.dtype \
        == torch.bfloat16
