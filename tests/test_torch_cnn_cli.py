"""The CNN zoo's test CLI, its degradation module and the port's timing
CLIs on the CPU, against the JAX package.

* ``degrade/sisr`` against ``kair_tpu/degrade/sisr.py`` on seeded
  kernels; the two copied assets byte-equal to the JAX package's.
* ``cli/test.main`` for one preset of each forward kind (plain, ffdnet,
  drunet, srmd, usrnet, sr4) on two seeded 32x32 images, a ``.pth`` of
  seeded weights at the preset's own width: the same PSNR and SSIM as
  ``kair_tpu.cli.test.main`` on the same files, to 1e-3 dB. The JAX CLI's
  usrnet branch raises (it reads ``dsisr`` imported only in its srmd
  branch, ``kair_tpu/cli/test.py:171``), so usrnet is held against that
  branch's protocol run with the JAX package's own modules.
* ``cli/challenge``, ``cli/video_bench`` and ``cli/bench`` on
  ``--device cpu`` with small models: their JSON keys, and challenge's
  parameter count against the JAX ``count_params``.
"""

import json
import math
import pathlib

import numpy as np
import pytest
import torch

from kair_tpu_torch.cli import test as pt
from tests.conftest import REPO_ROOT


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# degrade/sisr and the assets
# --------------------------------------------------------------------------

def _kernel(rng):
    from kair_tpu_torch.degrade import sisr
    return sisr.anisotropic_gaussian(15, rng.uniform(0, np.pi),
                                     rng.uniform(0.2, 8), rng.uniform(0.2, 8))


SISR_CASES = {
    "anisotropic_gaussian": lambda m, rng: m.anisotropic_gaussian(
        15, 0.7, 4.0, 1.5),
    "gm_blur_kernel": lambda m, rng: m.gm_blur_kernel(
        [0.5, -1.0], np.array([[3.0, 0.4], [0.4, 1.2]]), 21),
    "pca_project": lambda m, rng: m.pca_project(_kernel(rng),
                                                m.load_srmd_pca()),
    "srmd_degradation": lambda m, rng: m.srmd_degradation(
        rng.rand(24, 24, 3).astype(np.float32), _kernel(rng), 4),
    "dpsr_degradation": lambda m, rng: m.dpsr_degradation(
        rng.rand(24, 24, 3).astype(np.float32), _kernel(rng), 3),
    "classical_degradation": lambda m, rng: m.classical_degradation(
        rng.rand(24, 24, 3), _kernel(rng), 2),
    "shifted_anisotropic_gaussian": lambda m, rng: m.shifted_anisotropic_gaussian(
        (15, 15), 4, rng=np.random.default_rng(3)),
    "kernels_12": lambda m, rng: m.load_kernels_12(),
}


@pytest.mark.parametrize("name", list(SISR_CASES))
def test_sisr_matches_jax_module(name):
    from kair_tpu.degrade import sisr as jsisr
    from kair_tpu_torch.degrade import sisr

    got = SISR_CASES[name](sisr, np.random.RandomState(7))
    want = SISR_CASES[name](jsisr, np.random.RandomState(7))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("asset", ["kernels_12.npz", "srmd_pca.npz"])
def test_assets_are_byte_copies(asset):
    ours = REPO_ROOT / "kair_tpu_torch" / "data" / "assets" / asset
    theirs = REPO_ROOT / "kair_tpu" / "data" / "assets" / asset
    assert ours.read_bytes() == theirs.read_bytes()


# --------------------------------------------------------------------------
# cli/test.main against the JAX CLI
# --------------------------------------------------------------------------

PRESETS = ["dncnn_25", "ffdnet_gray", "drunet_color", "srmd_x4",
           "msrresnet_x4", "usrnet"]


def _seeded_pth(name: str, path: pathlib.Path, images) -> None:
    """Seeded weights at the preset's width: convs LeCun-normal (std
    sqrt(1 / fan_in)), small biases (DRUNet with biases, which the JAX
    preset expects); USRNet at its own seeded initialisation (eight
    unrolled priors would compound a larger gain into overflow); then the
    last conv scaled so the output's spread is
    0.1 on the first LR image and, where it has a bias, shifted to a mean
    of 0.5: away from the clipping that would hide a wrong protocol."""
    torch.manual_seed(11)
    model, kind, _ = pt.preset_model(name, {"m_head.bias": None})
    gen = torch.Generator().manual_seed(11)
    sd = {}
    for k, v in model.state_dict().items():
        if kind == "usrnet":
            sd[k] = v
        elif k.endswith("weight") and v.ndim == 4:
            fan_in = v[0].numel() if not k.startswith(("m_up", "p.m_up")) \
                else v.shape[0] * v.shape[2] * v.shape[3] // v.shape[1]
            sd[k] = torch.randn(v.shape, generator=gen) / math.sqrt(fan_in)
        elif k.endswith("bias"):
            sd[k] = torch.randn(v.shape, generator=gen) * 0.01
        else:
            sd[k] = v
    model.load_state_dict(sd)
    last = model.p.m_tail if kind == "usrnet" else [
        m for m in model.modules() if isinstance(m, torch.nn.Conv2d)][-1]
    img_h, img_l, _, sf, k = pt.degrade(kind, images[0], 25 / 255.0)
    x = img_l[None].astype(np.float32)
    out = (pt.usrnet_forward(model, x, k, sf) if kind == "usrnet" else
           pt.make_forward(model, 25 / 255 if kind == "ffdnet" else None)(x))
    out = out.astype(np.float64)
    assert np.isfinite(out).all()
    with torch.no_grad():
        last.weight.mul_(0.1 / out.std())
        if last.bias is not None and kind != "plain":
            last.bias.add_(0.5 - 0.1 * out.mean() / out.std())
    torch.save(model.state_dict(), path)


def _images(tmp_path, n_channels):
    import cv2
    d = tmp_path / "hr"
    d.mkdir()
    imgs = []
    for i in range(2):
        rng = np.random.RandomState(20 + i)
        yy, xx = np.mgrid[0:32, 0:32] / 32.0
        img = 0.5 + 0.3 * np.sin(6 * yy + 3 * i)[..., None] * np.cos(
            5 * xx)[..., None] + rng.normal(0, 0.05, (32, 32, 3))
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        cv2.imwrite(str(d / f"{i}.png"), img)
        imgs.append(img if n_channels == 3 else
                    cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[..., None])
    return d, imgs


def _jax_usrnet_protocol(model_path, hr_dir):
    """``kair_tpu/cli/test.py``'s usrnet branch (:167-181, :188-197) with
    the JAX package's own sisr, image and model modules."""
    import jax.numpy as jnp
    from scipy import ndimage
    from kair_tpu.cli.test import build_preset
    from kair_tpu.degrade import sisr as dsisr
    from kair_tpu.utils import image as im

    model, variables, _, n_channels = build_preset("usrnet", model_path)
    psnrs, ssims = [], []
    for path in im.get_image_paths(hr_dir):
        img_h = im.imread_uint(path, n_channels)
        k = dsisr.load_kernels_12()[0]
        k = (k / k.sum()).astype(np.float32)
        img_h = im.modcrop(img_h, 4)
        img_l = ndimage.convolve(im.uint2single(img_h),
                                 k[:, :, None].astype(np.float64),
                                 mode="wrap")[::4, ::4]
        x = im.hwc_to_nhwc(img_l.astype(np.float32))
        e = np.asarray(model.apply(variables, jnp.asarray(x),
                                   jnp.asarray(k)[None, :, :, None], 4,
                                   jnp.zeros((1, 1, 1, 1), jnp.float32)))
        img_e = im.nhwc_to_uint(e[:, :img_h.shape[0], :img_h.shape[1]])
        psnrs.append(im.calculate_psnr(img_e, img_h.squeeze(), border=4))
        ssims.append(im.calculate_ssim(img_e, img_h.squeeze(), border=4))
    return float(np.mean(psnrs)), float(np.mean(ssims))


@pytest.mark.parametrize("name", PRESETS)
def test_cli_test_main_matches_jax_cli(name, tmp_path):
    import kair_tpu.cli.test as jt

    n_channels = pt.preset_model(name, {})[2]
    hr, imgs = _images(tmp_path, n_channels)
    pth = tmp_path / f"{name}.pth"
    _seeded_pth(name, pth, imgs)
    args = ["--model_name", name, "--model_path", str(pth),
            "--testset_dir", str(hr)]
    got = pt.main(args + ["--device", "cpu"])
    want = (_jax_usrnet_protocol(str(pth), str(hr)) if name == "usrnet"
            else jt.main(args))
    assert np.isfinite(got[0]) and got[0] > 6.0
    assert abs(got[0] - want[0]) < 1e-3 and abs(got[1] - want[1]) < 1e-3


# --------------------------------------------------------------------------
# the timing CLIs
# --------------------------------------------------------------------------

def test_challenge_reports_jax_keys_and_param_count(capsys):
    import jax
    from kair_tpu.models.registry import define_g
    from kair_tpu.utils.summary import count_params
    from kair_tpu_torch.cli import challenge

    rep = challenge.main(["--device", "cpu", "--nc", "16", "--nb", "2",
                          "--input", "16", "16", "--iters", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rep
    for key in ("net", "input", "params", "flops_G", "activations_M",
                "bytes_accessed_MB", "runtime_ms", "throughput_MP_per_s",
                "device", "dtype", "value", "mfu", "peak_memory_MB"):
        assert key in rep
    opt = {"netG": {"net_type": "msrresnet0", "in_nc": 3, "out_nc": 3,
                    "nc": 16, "nb": 2, "scale": 4, "upscale": 4}}
    jmodel = define_g(opt)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 16, 16, 3), np.float32)))
    assert rep["params"] == count_params(shapes["params"])
    assert rep["dtype"] == "f32" and rep["device"] == "cpu"
    assert rep["bytes_accessed_MB"] is None and rep["mfu"] is None
    # 2·MACs of the convs: head, 2 ResBlocks (2 convs), body tail, two
    # upconvs at 32² and 64², the HR conv and the last at 64²
    macs = 9 * 16 * 16 * (3 * 16 * 16 // 16 + 16 * 16 * 5
                          + 16 * 16 * (4 + 16 + 16) + 3 * 16 * 16)
    assert rep["flops_G"] == round(2 * macs / 1e9, 3)
    assert rep["activations_M"] == round(16 * 16 * (16 * 6 + 16 * 4 + 16 * 16
                                                    * 2 + 3 * 16) / 1e6, 3)
    assert rep["runtime_ms"] > 0 and rep["value"] > 0


def _tiny_clip_model(net, deform, fuse):
    from kair_tpu_torch.models.rvrt import RVRT
    from kair_tpu_torch.models.vrt import VRT
    torch.manual_seed(0)
    if net == "rvrt":
        return RVRT(upscale=4, clip_size=2, window_size=(2, 8, 8),
                    num_blocks=(1, 1, 1), depths=(1, 1, 1),
                    embed_dims=(16, 16, 16), num_heads=(2, 2, 2),
                    deformable_groups=2, attention_heads=2,
                    fuse_block=fuse, deform_impl=deform)
    return VRT(upscale=4, window_size=(2, 8, 8), depths=(1,) * 8,
               embed_dims=(12,) * 7 + (16,), num_heads=(2,) * 8,
               pa_frames=2, deformable_groups=2, fuse_block=fuse,
               deform_impl=deform)


VIDEO_KEYS = ("metric", "value", "unit", "vs_baseline", "ms_per_clip",
              "ms_min", "tflops", "mfu")


@pytest.mark.parametrize("net,extra", [("vrt", []), ("rvrt", ["--compare"])])
def test_video_bench_prints_its_keys(net, extra, capsys):
    from kair_tpu_torch.cli import video_bench

    reps = video_bench.main(["--net", net, "--frames", "2", "--size", "64",
                             "--k", "1", "--device", "cpu"] + extra,
                            build=_tiny_clip_model)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(l) for l in lines] == reps
    assert len(reps) == (3 if extra else 1)
    for rep in reps:
        assert tuple(rep) == VIDEO_KEYS
        assert rep["value"] > 0 and rep["mfu"] is None
        assert net.upper() in rep["metric"]


def test_bench_prints_its_keys(capsys, monkeypatch):
    from kair_tpu_torch.cli import bench
    from kair_tpu_torch.models.swinir import SwinIR

    def tiny():
        torch.manual_seed(0)
        return SwinIR(upscale=4, in_chans=3, embed_dim=12, depths=(2,),
                      num_heads=(2,), window_size=8, mlp_ratio=2.0,
                      upsampler="pixelshuffle", fuse_block=True)

    monkeypatch.setattr(bench, "SIZE", 16)
    monkeypatch.setattr(bench, "ITERS", 2)
    rep = bench.main(["--device", "cpu", "--batch", "1"], build=tiny)
    assert json.loads(capsys.readouterr().out.strip()) == rep
    for key in ("metric", "value", "unit", "vs_baseline", "tflops", "mfu",
                "device_kind", "flops_per_lr_pixel", "ms_per_forward",
                "ms_min"):
        assert key in rep
    # the FLOP count is SwinIR-M x4's, so none is given for another model
    assert rep["flops_per_lr_pixel"] is None and rep["tflops"] is None
    assert rep["value"] > 0 and rep["mfu"] is None
    assert "B=1 of 16x16" in rep["metric"]
