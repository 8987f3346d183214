"""The port's SwinIR (kair_tpu_torch.models.swinir) on the CPU, f32.

(a) against the KAIR torch-oracle fixtures (NCHW in and out), atol 2e-4 as
    tests/test_model_parity.py holds the JAX model;
(b) one seeded KAIR state dict run through JAX (convert_swinir;
    fuse_block=True with the Pallas kernels in interpret mode, and
    fuse_block=False) and through the port, depths (2, 2) on 32x32, atol
    1e-4; the port's kernel wrappers are counted on the way;
(c) swinir_from_jax(convert_swinir(sd)) == sd key for key, full SwinIR-M x4;
(d) full-width, full-depth SwinIR-M x4 on a 1x16x16 input, the port loaded
    through cli.test.build_preset from a .pth against JAX fuse_block=False,
    atol 2e-4 (f32 sums in another order through 36 blocks);
and the kernel route for a width of 8 mod 16, the composed route for a window
under 8, and cli.test.main.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kair_tpu.ops.pallas.conv_block as jcb
import kair_tpu.ops.pallas.swin_block as jsb
from kair_tpu.ckpt.torch_convert import convert_swinir
from kair_tpu.models.swinir import SwinIR as JaxSwinIR
from kair_tpu.models.swinir import fused_block_params
from kair_tpu_torch.ckpt.torch_convert import swinir_from_jax
from kair_tpu_torch.cli.test import SWINIR_X4, build_preset, make_forward
from kair_tpu_torch.models import swinir as tsw
from tests.conftest import FIXTURES

FIXTURE_CASES = [
    ("swinir_classical", dict(upscale=4, in_chans=3, embed_dim=24, depths=(2, 2),
                              num_heads=(4, 4), window_size=8, mlp_ratio=2.0,
                              upsampler="pixelshuffle", img_size=16)),
    ("swinir_dn", dict(upscale=1, in_chans=1, embed_dim=24, depths=(2, 2),
                       num_heads=(4, 4), window_size=8, mlp_ratio=2.0,
                       upsampler="", img_size=32)),
    ("swinir_light", dict(upscale=4, in_chans=3, embed_dim=24, depths=(2, 2),
                          num_heads=(4, 4), window_size=8, mlp_ratio=2.0,
                          upsampler="pixelshuffledirect", img_size=16)),
    ("swinir_ape", dict(upscale=1, in_chans=1, embed_dim=24, depths=(2, 2),
                        num_heads=(4, 4), window_size=8, mlp_ratio=2.0,
                        upsampler="", ape=True, img_size=16)),
]


def nhwc(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("training", [False, True], ids=["fused", "composed"])
@pytest.mark.parametrize("name,cfg", FIXTURE_CASES, ids=[c[0] for c in FIXTURE_CASES])
def test_port_matches_kair_fixture(name, cfg, training):
    """Eval mode takes the kernels' route, training mode the composed one."""
    z = np.load(FIXTURES / f"model_{name}.npz")
    sd = {k[3:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("sd.")}
    model = tsw.SwinIR(**cfg).train(training)
    model.load_state_dict(sd)              # strict: KAIR's key set exactly
    with torch.no_grad():
        got = model(nhwc(z["in0"])).numpy()
    np.testing.assert_allclose(got, z["out"].transpose(0, 2, 3, 1), atol=2e-4)


SMALL = dict(upscale=4, in_chans=3, embed_dim=24, depths=(2, 2),
             num_heads=(4, 4), window_size=8, mlp_ratio=2.0,
             upsampler="pixelshuffle")


def _seeded_sd(cfg, img_size, seed=0):
    torch.manual_seed(seed)
    return tsw.SwinIR(img_size=img_size, **cfg).state_dict()


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _interpret(fn):
    return lambda *a, **kw: fn(*a, **{**kw, "interpret": True})


def _jax_forward(sd, cfg, x, fuse):
    variables = convert_swinir(_numpy_sd(sd), depths=cfg["depths"],
                               upsampler=cfg["upsampler"],
                               upscale=cfg["upscale"])
    if fuse:
        variables = {"params": fused_block_params(variables["params"])}
    with mock.patch.object(jsb, "swin_block_pallas_2d",
                           _interpret(jsb.swin_block_pallas_2d)), \
            mock.patch.object(jcb, "conv3x3_residual",
                              _interpret(jcb.conv3x3_residual)):
        return np.asarray(JaxSwinIR(fuse_block=fuse, **cfg).apply(
            variables, jnp.asarray(x)))


def _port_forward_counted(model, x):
    """The port's eval forward, counting the calls of the block wrapper and
    of the fused conv tails on the way."""
    calls = {"swin": 0, "conv": 0}
    blocks, convs = tsw.swin_block_2d, tsw.Conv.forward

    def swin_spy(*a, **kw):
        calls["swin"] += 1
        return blocks(*a, **kw)

    def conv_spy(self, x, residual=None, phase=0):
        calls["conv"] += residual is not None
        return convs(self, x, residual, phase)

    with mock.patch.object(tsw, "swin_block_2d", swin_spy), \
            mock.patch.object(tsw.Conv, "forward", conv_spy), torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    return got, calls


@pytest.mark.parametrize("jax_fuse", [True, False], ids=["jax_fused", "jax_xla"])
def test_port_matches_jax_same_weights(jax_fuse):
    sd = _seeded_sd(SMALL, 32)
    x = np.random.RandomState(3).rand(1, 32, 32, 3).astype(np.float32)
    want = _jax_forward(sd, SMALL, x, jax_fuse)

    model = tsw.SwinIR(img_size=32, **SMALL).eval()
    model.load_state_dict(sd)
    got, calls = _port_forward_counted(model, x)
    assert calls == {"swin": 4, "conv": 3}     # every block, 2 tails + body
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_swinir_from_jax_inverts_convert_swinir():
    sd = _seeded_sd(SWINIR_X4, 64)
    back = swinir_from_jax(convert_swinir(_numpy_sd(sd), depths=(6,) * 6,
                                          upsampler="pixelshuffle", upscale=4),
                           img_size=64, window_size=8)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_full_swinir_m_x4_port_matches_jax(tmp_path):
    sd = _seeded_sd(SWINIR_X4, 64, seed=1)
    path = tmp_path / "swinir_m_x4.pth"
    torch.save({"params": sd}, path)
    model, kind, n_ch = build_preset("swinir_classical_x4", str(path),
                                     device="cpu")
    assert (kind, n_ch) == ("sr4", 3)
    assert next(model.parameters()).dtype == torch.float32
    x = np.random.RandomState(4).rand(1, 16, 16, 3).astype(np.float32)

    variables = convert_swinir(_numpy_sd(sd), depths=(6,) * 6,
                               upsampler="pixelshuffle", upscale=4)
    jmodel = JaxSwinIR(fuse_block=False, **SWINIR_X4)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    got = make_forward(model)(x)
    assert got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_width_8_mod_16_takes_the_kernel_route():
    """W % 16 == 8 (what test_pad's modulo 8 leaves for many real widths):
    every block and tail goes through the kernel wrappers, and the result
    matches JAX (fuse_block=False) at atol 1e-4."""
    sd = _seeded_sd(SMALL, 24)
    x = np.random.RandomState(5).rand(1, 16, 24, 3).astype(np.float32)
    want = _jax_forward(sd, SMALL, x, False)
    model = tsw.SwinIR(img_size=24, **SMALL).eval()
    model.load_state_dict(sd)
    got, calls = _port_forward_counted(model, x)
    assert calls == {"swin": 4, "conv": 3}
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_geometry_off_the_kernel_takes_composed_path():
    """A window under 8: the block kernel is never called, the composed
    route matches JAX (fuse_block=False) at atol 1e-4, and the tails still
    go through the conv wrapper."""
    cfg = {**SMALL, "window_size": 4}
    sd = _seeded_sd(cfg, 16)
    x = np.random.RandomState(5).rand(1, 16, 24, 3).astype(np.float32)
    want = _jax_forward(sd, cfg, x, False)
    model = tsw.SwinIR(img_size=16, **cfg).eval()
    model.load_state_dict(sd)
    with mock.patch.object(tsw, "swin_block_2d",
                           side_effect=AssertionError("kernel path")):
        got, calls = _port_forward_counted(model, x)
    assert calls == {"swin": 0, "conv": 3}
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_cli_test_main_runs_sr4_on_cpu(tmp_path):
    """cli.test.main end to end on the CPU: .pth → build_preset → bicubic x4
    degradation → test_pad → PSNR/SSIM and the saved result."""
    import cv2
    from kair_tpu_torch.cli.test import main

    torch.save({"params": _seeded_sd(SWINIR_X4, 64, seed=2)}, tmp_path / "m.pth")
    hr = tmp_path / "hr"
    hr.mkdir()
    rng = np.random.RandomState(6)
    img = (rng.rand(60, 68, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(hr / "a.png"), img)
    out = tmp_path / "out"
    psnr, ssim = main(["--model_path", str(tmp_path / "m.pth"), "--testset_dir",
                       str(hr), "--device", "cpu", "--results", str(out)])
    assert np.isfinite(psnr) and -1.0 <= ssim <= 1.0
    assert cv2.imread(str(out / "a.png")).shape == (60, 68, 3)
