"""The face slice in the port on the CPU, f32, against the JAX package, the
GPEN fixture and cv2 itself.

* GPEN: ``FullGenerator`` (size 64, style 64, n_mlp 2, multiplier 1) on
  ``tests/fixtures/model_gpen.npz``'s KAIR state dict against its ``out``
  within 2e-3 (as tests/test_video_parity.py holds the JAX model), and
  against the JAX ``FullGenerator`` on the same weights within 1e-4 of
  max|ref|; ``gpen_from_jax`` inverts ``convert_gpen`` exactly.
* The StyleGAN ops against ``kair_tpu/ops/stylegan.py`` within 1e-6.
* RetinaFace (seeded, BN statistics drawn) against the JAX module on
  ``convert_retinaface``'s tree: boxes, scores and landmarks within 1e-4
  of max|ref| at 64x96; ``retinaface_from_jax`` inverts the converter
  exactly; ``prior_box``, ``decode_*`` and ``nms`` equal to JAX's.
* Each cv2-free op of ``utils/cv_ops`` against cv2 at the pipeline's
  sizes: warps (the 512² crop of a 320-wide image, the paste-back to
  320x240) equal on 8-bit images and within 1e-6 on float ones where the
  width is a multiple of 16 (cv2's vector path), the last columns of a
  90-wide warp within 1 level / 1e-5 (its scalar path); erode,
  filter2D and convertScaleAbs equal; the σ 11 (101²) and σ 3 Gaussian
  blurs within 1e-6; INTER_LINEAR resize of float32 within 1e-6, of
  uint8 within one level on under 0.5% of the pixels (readings ≤ 0.17%:
  cv2's vectorised rounding); the blend mask's rectangle equal to cv2's
  anti-aliased fill.
* ``warp_and_crop_face``, ``paste_face_back`` and ``enhance_faces`` with
  given boxes and five landmarks (a stand-in enhancer) against the JAX
  functions: aligned and enhanced faces equal, the blended image within
  one level.
* ``cli.test_face`` end to end on the CPU from seeded KAIR-keyed .pth
  files (GPEN at 64, RetinaFace-R50) and a PNG.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.ops import stylegan as jsg
from kair_tpu_torch.ops import stylegan as tsg
from kair_tpu_torch.utils import cv_ops

cv2 = pytest.importorskip("cv2")
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process (six workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


# ----------------------------------------------------------------------------
# StyleGAN ops and GPEN
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("up,down,pad", [(1, 1, (1, 2)), (2, 1, (2, 1)),
                                         (1, 2, (1, 1)), (2, 1, (-1, 0))])
def test_upfirdn2d_matches_jax(up, down, pad):
    x = np.random.RandomState(0).randn(2, 9, 11, 3).astype(np.float32)
    k = jsg.make_kernel([1, 3, 3, 1])
    want = np.asarray(jsg.upfirdn2d(jnp.asarray(x), k, up, down, pad))
    got = tsg.upfirdn2d(torch.from_numpy(x), tsg.make_kernel([1, 3, 3, 1]),
                        up, down, pad).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_stylegan_resamplers_match_jax():
    x = np.random.RandomState(1).randn(1, 8, 8, 4).astype(np.float32)
    b = np.random.RandomState(2).randn(4).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    pairs = [
        (tsg.upsample2(tx, [1, 3, 3, 1]), jsg.upsample2(jx, [1, 3, 3, 1])),
        (tsg.downsample2(tx, [1, 3, 3, 1]), jsg.downsample2(jx, [1, 3, 3, 1])),
        (tsg.blur(tx, [1, 3, 3, 1], (2, 1), 2),
         jsg.blur(jx, [1, 3, 3, 1], (2, 1), 2)),
        (tsg.fused_leaky_relu(tx, torch.from_numpy(b)),
         jsg.fused_leaky_relu(jx, jnp.asarray(b)))]
    for got, want in pairs:
        assert got.shape == want.shape
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


@pytest.fixture(scope="module")
def gpen_fixture():
    z = np.load(os.path.join(FIXTURES, "model_gpen.npz"))
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
    return sd, z["x"].transpose(0, 2, 3, 1), z["out"].transpose(0, 2, 3, 1)


def test_gpen_matches_fixture_and_jax(gpen_fixture):
    from kair_tpu.ckpt.torch_convert import convert_gpen
    from kair_tpu.models.gpen import FullGenerator as JaxGPEN
    from kair_tpu_torch.ckpt.torch_convert import gpen_from_jax
    from kair_tpu_torch.models.gpen import FullGenerator

    sd, x, want = gpen_fixture
    model = FullGenerator(size=64, style_dim=64, n_mlp=2,
                          channel_multiplier=1).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-3)

    variables = convert_gpen(sd, size=64, n_mlp=2)
    jm = JaxGPEN(size=64, style_dim=64, n_mlp=2, channel_multiplier=1)
    jout = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    assert rel(got, jout) <= 1e-4
    back = gpen_from_jax(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k], np.float32)
                                      .reshape(v.shape), err_msg=k)


# ----------------------------------------------------------------------------
# RetinaFace
# ----------------------------------------------------------------------------

def test_retinaface_matches_jax():
    from kair_tpu.ckpt.torch_convert import convert_retinaface
    from kair_tpu.models.retinaface import RetinaFace as JaxRetina
    from kair_tpu_torch.ckpt.torch_convert import retinaface_from_jax
    from kair_tpu_torch.models.retinaface import RetinaFace

    torch.manual_seed(3)
    model = RetinaFace().eval()
    rng = np.random.RandomState(5)
    sd = model.state_dict()
    for k, v in sd.items():            # drawn BatchNorm statistics
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(rng.rand(*v.shape).astype(np.float32) + 0.5))
    variables = convert_retinaface({"module." + k: v.numpy()
                                    for k, v in sd.items()})
    back = retinaface_from_jax(variables)
    assert set(back) == set(sd)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    x = (np.random.RandomState(4).rand(1, 64, 96, 3) * 255 - 110).astype(
        np.float32)
    want = jax.jit(JaxRetina().apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g.numpy(), np.asarray(w)) <= 1e-4


def test_retinaface_host_stages_match_jax():
    from kair_tpu.models import retinaface as jr
    from kair_tpu_torch.models import retinaface as tr
    for size in ((64, 96), (120, 90)):
        np.testing.assert_array_equal(tr.prior_box(size), jr.prior_box(size))
    pri = tr.prior_box((64, 96))
    rng = np.random.RandomState(6)
    loc = rng.randn(len(pri), 4).astype(np.float32) * 0.5
    lm = rng.randn(len(pri), 10).astype(np.float32)
    var = tr.CFG_RE50["variance"]
    np.testing.assert_array_equal(tr.decode_boxes(loc, pri, var),
                                  jr.decode_boxes(loc, pri, var))
    np.testing.assert_array_equal(tr.decode_landms(lm, pri, var),
                                  jr.decode_landms(lm, pri, var))
    dets = np.hstack([tr.decode_boxes(loc, pri, var) * 96,
                      rng.rand(len(pri), 1)]).astype(np.float32)
    assert tr.nms(dets, 0.4) == jr.nms(dets, 0.4)


# ----------------------------------------------------------------------------
# the cv2-free ops
# ----------------------------------------------------------------------------

def _similarity(scale, theta, tx, ty):
    return np.array([[scale * np.cos(theta), -scale * np.sin(theta), tx],
                     [scale * np.sin(theta), scale * np.cos(theta), ty]])


@pytest.mark.parametrize("dsize,m", [
    ((512, 512), _similarity(2.7, 0.21, -310.4, -50.2)),     # the crop
    ((320, 240), _similarity(0.37, -0.21, 118.6, 40.9)),     # paste back
    ((90, 70), _similarity(1.3, 0.3, 7.3, -5.1))])           # a tail
def test_warp_affine_matches_cv2(dsize, m):
    rng = np.random.RandomState(7)
    src = (rng.rand(240, 320, 3) * 255).astype(np.uint8)
    srcf = rng.rand(240, 320).astype(np.float32)
    a, b = cv2.warpAffine(src, m, dsize, flags=3), cv_ops.warp_affine(src, m, dsize, 3)
    af, bf = cv2.warpAffine(srcf, m, dsize), cv_ops.warp_affine(srcf, m, dsize)
    n = dsize[0] // 16 * 16
    np.testing.assert_array_equal(a[:, :n], b[:, :n])
    assert np.abs(af[:, :n] - bf[:, :n]).max() <= 1e-6
    assert np.abs(a.astype(int) - b).max() <= 1
    assert np.abs(af - bf).max() <= 1e-5


def test_filters_match_cv2():
    rng = np.random.RandomState(8)
    rect = np.zeros((512, 512), np.float32)
    cv2.rectangle(rect, (26, 26), (486, 486), (1, 1, 1), -1, cv2.LINE_AA)
    mine = np.zeros((512, 512), np.float32)
    mine[26:487, 26:487] = 1.0
    np.testing.assert_array_equal(rect, mine)
    for args in (((101, 101), 11), ((0, 0), 3)):
        assert np.abs(cv2.GaussianBlur(rect, *args)
                      - cv_ops.gaussian_blur(rect, *args)).max() <= 1e-6
    np.testing.assert_array_equal(cv2.getGaussianKernel(101, 11, cv2.CV_32F)[:, 0],
                                  cv_ops.gaussian_kernel(101, 11).numpy())
    m = (rng.rand(240, 320) > 0.2).astype(np.float32)
    np.testing.assert_array_equal(cv2.erode(m, np.ones((5, 5), np.uint8)),
                                  cv_ops.erode(m, 5))
    img = (rng.rand(512, 512, 3) * 255).astype(np.uint8)
    from kair_tpu_torch.eval.face_pipeline import _SMOOTH3
    np.testing.assert_array_equal(cv2.filter2D(img, -1, _SMOOTH3),
                                  cv_ops.filter2d_u8(img, _SMOOTH3))
    x = rng.randn(240, 320, 3) * 300
    np.testing.assert_array_equal(cv2.convertScaleAbs(x),
                                  cv_ops.convert_scale_abs(x))


@pytest.mark.parametrize("src_hw,dsize", [((240, 320), (640, 480)),
                                          ((512, 512), (256, 256)),
                                          ((97, 131), (200, 150))])
def test_resize_linear_matches_cv2(src_hw, dsize):
    rng = np.random.RandomState(9)
    f = rng.rand(*src_hw).astype(np.float32)
    assert np.abs(cv2.resize(f, dsize) - cv_ops.resize_linear(f, dsize)).max() <= 1e-6
    u = (rng.rand(*src_hw, 3) * 255).astype(np.uint8)
    a, b = cv2.resize(u, dsize), cv_ops.resize_linear(u, dsize)
    assert np.abs(a.astype(int) - b).max() <= 1
    assert (a != b).mean() < 0.005
    np.testing.assert_array_equal(cv_ops.resize_linear(u, src_hw[::-1]), u)


# ----------------------------------------------------------------------------
# alignment and the pipeline against the JAX functions
# ----------------------------------------------------------------------------

def _faces():
    """A 320x240 image, two synthetic faces (the template moved) and one
    detection under the threshold (tests/test_face_pipeline.py's)."""
    from kair_tpu.utils.alignfaces import get_reference_facial_points
    rng = np.random.RandomState(11)
    img = (rng.rand(240, 320, 3) * 255).astype(np.uint8)
    tmpl = get_reference_facial_points((512, 512), 0.25, (0, 0), True)

    def face_at(scale, tx, ty):
        pts = tmpl * scale + np.array([tx, ty])
        x0, y0 = pts.min(0) - 8
        x1, y1 = pts.max(0) + 8
        return pts, [x0, y0, x1, y1]
    pts_a, box_a = face_at(0.12, 40, 30)                 # under 100 px
    pts_b, box_b = face_at(0.35, 150, 60)
    facebs = np.array([box_a + [0.98], box_b + [0.95], box_b + [0.5]],
                      np.float32)
    landms = np.stack([np.concatenate([p[:, 0], p[:, 1]])
                       for p in (pts_a, pts_b, pts_b)]).astype(np.float32)

    def enhancer(face):
        f = face.astype(np.float32)
        return np.clip(1.2 * f[:, :, ::-1] + 5.0, 0, 255).astype(np.uint8)
    return img, facebs, landms, enhancer


def test_alignment_matches_jax():
    from kair_tpu.utils import alignfaces as ja
    from kair_tpu_torch.utils import alignfaces as ta
    img, facebs, landms, _ = _faces()
    ref = ja.get_reference_facial_points((512, 512), 0.25, (0, 0), True)
    np.testing.assert_array_equal(
        ta.get_reference_facial_points((512, 512), 0.25, (0, 0), True), ref)
    for lm in landms[:2]:
        pts = lm.reshape(2, 5)
        fj, tj = ja.warp_and_crop_face(img, pts, ref, (512, 512))
        ft, tt = ta.warp_and_crop_face(img, pts, ref, (512, 512))
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_array_equal(ft, fj)
        pj = ja.paste_face_back(img, fj[:, :, ::-1].copy(), tj)
        pt = ta.paste_face_back(img, fj[:, :, ::-1].copy(), tj)
        assert np.abs(pj.astype(int) - pt).max() <= 1
        assert (pj != pt).mean() < 1e-3


def test_enhance_faces_matches_jax():
    from kair_tpu.eval import face_pipeline as jf
    from kair_tpu_torch.eval import face_pipeline as tf
    img, facebs, landms, enhancer = _faces()
    detector = lambda bgr: (facebs, landms)
    want, wof, wef = jf.enhance_faces(img, detector, enhancer, 512, 0.9)
    got, gof, gef = tf.enhance_faces(img, detector, enhancer, 512, 0.9)
    assert len(gof) == len(wof) == 2
    for a, b in zip(gof + gef, wof + wef):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got.astype(int) - want).max() <= 1
    assert (got != want).mean() < 1e-3
    assert np.abs(tf.make_blend_mask(512) - jf.make_blend_mask(512)).max() <= 1e-6
    assert np.abs(tf.make_blend_mask(256) - jf.make_blend_mask(256)).max() <= 1e-6


# ----------------------------------------------------------------------------
# cli.test_face
# ----------------------------------------------------------------------------

def seeded_gpen_state(size: int, seed: int) -> dict:
    from kair_tpu_torch.models.gpen import FullGenerator
    torch.manual_seed(seed)
    return FullGenerator(size=size, style_dim=512, n_mlp=8,
                         channel_multiplier=1).state_dict()


def test_cli_test_face_runs_on_the_cpu(tmp_path):
    from kair_tpu_torch.cli import test_face
    from kair_tpu_torch.models.retinaface import RetinaFace
    from kair_tpu_torch.utils.png import read_png, write_png
    torch.manual_seed(1)
    ret = RetinaFace().state_dict()
    # class heads that score the coarsest level's 8 anchors faces and no
    # other (the boxes and landmarks seeded): the pipeline aligns,
    # enhances and pastes those back
    for i in range(3):
        ret[f"ClassHead.{i}.conv1x1.weight"].zero_()
        ret[f"ClassHead.{i}.conv1x1.bias"].copy_(
            torch.tensor([-4.0, 4.0] * 2) * (1 if i == 2 else -1))
    torch.save({"module." + k: v for k, v in ret.items()},
               tmp_path / "retina.pth")
    torch.save(seeded_gpen_state(64, 2), tmp_path / "gpen.pth")
    img = (np.random.RandomState(12).rand(64, 64, 3) * 255).astype(np.uint8)
    write_png(str(tmp_path / "in.png"), img)
    out = test_face.main([
        "--input", str(tmp_path / "in.png"), "--output", str(tmp_path / "o"),
        "--retinaface", str(tmp_path / "retina.pth"),
        "--gpen", str(tmp_path / "gpen.pth"), "--size", "64",
        "--channel_multiplier", "1", "--sr", "1", "--device", "cpu",
        "--threshold", "0.99"])
    (name, res, n_faces), = out
    assert name == "in" and res.shape == img.shape and 1 <= n_faces <= 8
    np.testing.assert_array_equal(read_png(str(tmp_path / "o" /
                                               "in_enhanced.png")), res)
    assert (res != img).any()
