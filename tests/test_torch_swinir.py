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
(e) the JPEG-CAR geometry (upscale 1, img_range 255, window 7, gray and
    color) against JAX fuse_block=True, its window-pair kernel in
    interpret mode; the unfused route against JAX use_pallas=True (window
    8, the window-MSA kernel in interpret mode) and fuse_block=False
    (window 7); the 3conv tails and the nearest+conv head against JAX and
    through swinir_from_jax; atol 1e-4, with the kernel wrappers counted;
and the kernel route for a width of 8 mod 16, the window kernel for windows
under 8 (training there stays composed), the registry's route keys, and
cli.test.main with --x8 and --fuse.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kair_tpu.ops.pallas.conv_block as jcb
import kair_tpu.ops.pallas.swin_block as jsb
import kair_tpu.ops.pallas.window_msa as jwm
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


def _jax_forward(sd, cfg, x, fuse, use_pallas=False, train=False):
    variables = convert_swinir(
        _numpy_sd(sd), depths=cfg["depths"], upsampler=cfg["upsampler"],
        upscale=cfg["upscale"],
        resi_connection=cfg.get("resi_connection", "1conv"))
    if fuse:
        variables = {"params": fused_block_params(variables["params"])}
    with mock.patch.object(jsb, "swin_block_pallas_2d",
                           _interpret(jsb.swin_block_pallas_2d)), \
            mock.patch.object(jsb, "swin_block_pallas",
                              _interpret(jsb.swin_block_pallas)), \
            mock.patch.object(jwm, "window_msa_pallas",
                              _interpret(jwm.window_msa_pallas)), \
            mock.patch.object(jcb, "conv3x3_residual",
                              _interpret(jcb.conv3x3_residual)):
        return np.asarray(JaxSwinIR(fuse_block=fuse, use_pallas=use_pallas,
                                    **cfg).apply(variables, jnp.asarray(x),
                                                 train=train))


# wrapper name in models/swinir.py → count key
SPIES = {"swin_block_2d": "swin", "window_msa_win": "msa",
         "swin_block_train": "train"}


def _key(name, a, kw):
    """The count key of one wrapper call: swin_block_2d below window 8
    stands for kernel A ("win"), at 8 for kernel 1 ("swin")."""
    if name == "swin_block_2d" and kw.get("ws", a[5] if len(a) > 5 else 8) < 8:
        return "win"
    return SPIES[name]


def _port_forward_counted(model, x):
    """The port's forward (in the model's mode), counting the calls of each
    kernel wrapper and of the fused conv tails on the way."""
    calls = dict.fromkeys(list(SPIES.values()) + ["win", "conv"], 0)
    convs = tsw.Conv.forward

    def spy(name):
        fn = getattr(tsw, name)

        def counted(*a, **kw):
            calls[_key(name, a, kw)] += 1
            return fn(*a, **kw)
        return counted

    def conv_spy(self, x, residual=None, phase=0):
        calls["conv"] += residual is not None
        return convs(self, x, residual, phase)

    patches = [mock.patch.object(tsw, n, spy(n)) for n in SPIES]
    with mock.patch.object(tsw.Conv, "forward", conv_spy), torch.no_grad():
        for pt in patches:
            pt.start()
        try:
            got = model(torch.from_numpy(x)).numpy()
        finally:
            for pt in patches:
                pt.stop()
    return got, {k: v for k, v in calls.items() if v}


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


JPEG_CAR = dict(upscale=1, embed_dim=24, depths=(2, 2), num_heads=(4, 4),
                window_size=7, mlp_ratio=2.0, img_range=255.0, upsampler="",
                resi_connection="1conv")


@pytest.mark.parametrize("in_chans", [1, 3], ids=["gray", "color"])
def test_jpeg_car_shape_matches_jax_fused(in_chans):
    """KAIR's 006 JPEG-CAR geometry at tiny width: every block through the
    window kernel's wrapper (ws 7, shift 3 folded into its read), the tails
    through the conv wrapper, against JAX's fused route."""
    cfg = {**JPEG_CAR, "in_chans": in_chans}
    sd = _seeded_sd(cfg, 28)
    x = np.random.RandomState(7).rand(1, 28, 28, in_chans).astype(np.float32)
    want = _jax_forward(sd, cfg, x, True)
    model = tsw.SwinIR(img_size=28, **cfg).eval()
    model.load_state_dict(sd)
    got, calls = _port_forward_counted(model, x)
    assert calls == {"win": 4, "conv": 3}
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("ws", [8, 7])
def test_unfused_route_matches_jax(ws):
    """fuse_block=False: every block's attention through the window-MSA
    wrapper (window 8 against JAX's window_msa_pallas in interpret mode,
    window 7 against its XLA attention, which window_msa_pallas falls back
    to off 64-token windows), library LN/MLP and conv tails."""
    cfg = {**SMALL, "window_size": ws}
    size = 4 * ws
    sd = _seeded_sd(cfg, size)
    x = np.random.RandomState(8).rand(1, size, size, 3).astype(np.float32)
    want = _jax_forward(sd, cfg, x, False, use_pallas=True)
    model = tsw.SwinIR(img_size=size, fuse_block=False, **cfg).eval()
    model.load_state_dict(sd)
    got, calls = _port_forward_counted(model, x)
    assert calls == {"msa": 4}
    np.testing.assert_allclose(got, want, atol=1e-4)
    fused = tsw.SwinIR(img_size=size, **cfg).eval()
    fused.load_state_dict(sd)
    np.testing.assert_allclose(got, _port_forward_counted(fused, x)[0],
                               atol=1e-4)


REAL_SR = dict(upscale=4, in_chans=3, embed_dim=24, depths=(2, 2),
               num_heads=(4, 4), window_size=8, mlp_ratio=2.0,
               upsampler="nearest+conv", resi_connection="3conv")


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
def test_3conv_nearest_conv_matches_jax(fuse):
    """KAIR's real-world SR head and 3conv tails (SwinIR-L's) at tiny
    width: the port against JAX with the same fuse_block, the JAX tree
    carried back through swinir_from_jax."""
    sd = _seeded_sd(REAL_SR, 16)
    x = np.random.RandomState(9).rand(1, 16, 24, 3).astype(np.float32)
    want = _jax_forward(sd, REAL_SR, x, fuse)
    variables = convert_swinir(_numpy_sd(sd), depths=REAL_SR["depths"],
                               upsampler="nearest+conv", upscale=4,
                               resi_connection="3conv")
    if fuse:
        variables = {"params": fused_block_params(variables["params"])}
    model = tsw.SwinIR(img_size=16, fuse_block=fuse, **REAL_SR).eval()
    model.load_state_dict(swinir_from_jax(variables, img_size=16))
    got, calls = _port_forward_counted(model, x)
    assert got.shape == (1, 64, 96, 3)
    assert calls == ({"swin": 4} if fuse else {"msa": 4})   # no fused tails
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("fused_layout", [False, True])
def test_swinir_from_jax_inverts_convert_swinir_3conv(fused_layout):
    sd = _seeded_sd(REAL_SR, 16)
    variables = convert_swinir(_numpy_sd(sd), depths=REAL_SR["depths"],
                               upsampler="nearest+conv", upscale=4,
                               resi_connection="3conv")
    if fused_layout:
        variables = {"params": fused_block_params(variables["params"])}
    back = swinir_from_jax(variables, img_size=16, window_size=8)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("keys,fused", [({}, True), ({"fuse_block": True}, True),
                                        ({"fuse_block": False}, False),
                                        ({"fuse_block": False,
                                          "use_pallas": True}, False)])
def test_registry_reads_the_route_keys(keys, fused):
    from kair_tpu_torch.models.registry import define_g
    net = {"net_type": "swinir", "upscale": 1, "in_nc": 3, "img_size": 28,
           "window_size": 7, "img_range": 255.0, "depths": [2],
           "embed_dim": 24, "num_heads": [4], "mlp_ratio": 2,
           "upsampler": "", "resi_connection": "1conv", **keys}
    model = define_g({"netG": net})
    blk = model.layers[0].residual_group.blocks[1]
    assert (model.fused_tail, blk.fuse_block) == (fused, fused)
    assert blk.window_size == 7 and blk.shift_size == 3


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


def _small_window_forward(ws, training):
    """SMALL at window ws on a 4ws x 6ws map, port (counted) and JAX
    (fuse_block=False) on the same weights."""
    cfg = {**SMALL, "window_size": ws}
    sd = _seeded_sd(cfg, 4 * ws)
    x = np.random.RandomState(5).rand(1, 4 * ws, 6 * ws, 3).astype(np.float32)
    want = _jax_forward(sd, cfg, x, False, train=training)
    model = tsw.SwinIR(img_size=4 * ws, **cfg).train(training)
    model.load_state_dict(sd)
    got, calls = _port_forward_counted(model, x)
    return got, calls, want


@pytest.mark.parametrize("ws", [4, 7], ids=["ws4", "ws7"])
def test_windows_under_8_take_the_window_kernel(ws):
    """Inference at a window under 8: every block goes through the block
    wrapper at that window (kernel A), never at window 8 (kernel 1), the
    tails through the conv wrapper; matches JAX at atol 1e-4."""
    got, calls, want = _small_window_forward(ws, False)
    assert calls == {"win": 4, "conv": 3}
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("ws", [4, 7], ids=["ws4_training", "ws7_training"])
def test_geometry_off_the_kernel_takes_composed_path(ws):
    """Training at a window under 8, which no training kernel takes: no
    kernel wrapper at all — the composed route, as JAX's _flat_block_xla;
    matches JAX at atol 1e-4."""
    got, calls, want = _small_window_forward(ws, True)
    assert calls == {}
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


def test_cli_test_main_x8_and_unfused_on_cpu(tmp_path):
    """--x8 (mode 3 of test_mode) through the fused and the unfused route:
    the same weights give the same PSNR either way."""
    import cv2
    from kair_tpu_torch.cli.test import main

    torch.save({"params": _seeded_sd(SWINIR_X4, 64, seed=3)}, tmp_path / "m.pth")
    hr = tmp_path / "hr"
    hr.mkdir()
    img = (np.random.RandomState(10).rand(32, 40, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(hr / "a.png"), img)
    base = ["--model_path", str(tmp_path / "m.pth"), "--testset_dir", str(hr),
            "--device", "cpu", "--x8"]
    on = main(base + ["--fuse", "on"])
    off = main(base + ["--fuse", "off"])
    assert np.isfinite(on[0]) and abs(on[0] - off[0]) < 1e-3
