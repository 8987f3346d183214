"""The port's CNN zoo on the CPU, f32, against KAIR and the JAX package.

* (a) Every family at its fixture's configuration
  (tests/test_model_parity.py: FFDNet nb 6, USRNet n_iter 4 at sf 2),
  loaded ``strict=True`` from the fixture's KAIR state dict, against
  KAIR's own output in tests/fixtures/model_*.npz: atol 5e-5 (USRNet
  1e-4), the JAX test's limits.
* (b) The same inputs through the JAX model (``convert_*`` of the same
  state dict) against the port, at the same limits.
* (c) ``<family>_from_jax(convert_<family>(sd))`` equal to the fixture's
  state dict, key for key and exactly.
* (d) ``define_g`` on each shipped option file whose net is of the zoo:
  the option file's widths and the JAX model's parameter count.
* (e) ``utils/bnorm.merge_bn`` on a BN-trained ('BR') DnCNN: the merged
  net equal to the unmerged one in eval mode and to the JAX package's
  ``merge_bn_convblocks``; and USRNet's data step in f32 / complex64 in a
  bf16 model.
* ``ops/fft`` and ``utils/receptivefield`` against the JAX modules.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from kair_tpu.ckpt import torch_convert as tc
from kair_tpu.models import dncnn as jdn
from kair_tpu.models import drunet as jdr
from kair_tpu.models import ffdnet as jff
from kair_tpu.models import imdn as jim
from kair_tpu.models import rrdbnet as jrr
from kair_tpu.models import srresnet as jsr
from kair_tpu.models import usrnet as jus
from kair_tpu_torch.ckpt import torch_convert as tt
from kair_tpu_torch.models import dncnn, drunet, ffdnet, imdn, rrdbnet
from kair_tpu_torch.models import srresnet, usrnet
from tests.conftest import FIXTURES, REPO_ROOT


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads per test process: the suite runs six workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# name: (port model, JAX model, convert_*, *_from_jax, input kind)
CASES = {
    "ircnn": (lambda: dncnn.IRCNN(1, 1, 64), lambda: jdn.IRCNN(1, 1, 64),
              tc.convert_ircnn, tt.ircnn_from_jax, "plain"),
    "fdncnn": (lambda: dncnn.FDnCNN(2, 1, 64, 8),
               lambda: jdn.FDnCNN(2, 1, 64, 8),
               lambda sd: tc.convert_dncnn(sd, nb=8), tt.dncnn_from_jax,
               "plain"),
    "msrresnet0": (lambda: srresnet.MSRResNet0(3, 3, 32, 3, 4, "R", "upconv"),
                   lambda: jsr.MSRResNet0(3, 3, 32, 3, 4, "R", "upconv"),
                   lambda sd: tc.convert_msrresnet0(sd, nb=3, upscale=4),
                   tt.msrresnet0_from_jax, "plain"),
    "msrresnet0_ps": (
        lambda: srresnet.MSRResNet0(3, 3, 32, 2, 4, "R", "pixelshuffle"),
        lambda: jsr.MSRResNet0(3, 3, 32, 2, 4, "R", "pixelshuffle"),
        lambda sd: tc.convert_msrresnet0(sd, nb=2, upscale=4,
                                         upsample_mode="pixelshuffle"),
        lambda v: tt.msrresnet0_from_jax(v, upsample_mode="pixelshuffle"),
        "plain"),
    "msrresnet1": (lambda: srresnet.MSRResNet1(3, 3, 32, 3, 4),
                   lambda: jsr.MSRResNet1(3, 3, 32, 3, 4),
                   lambda sd: tc.convert_msrresnet1(sd, nb=3, upscale=4),
                   tt.msrresnet1_from_jax, "plain"),
    "dpsr": (lambda: srresnet.MSRResNet0(4, 3, 32, 3, 4, "R", "upconv"),
             lambda: jsr.MSRResNet0(4, 3, 32, 3, 4, "R", "upconv"),
             lambda sd: tc.convert_msrresnet0(sd, nb=3, upscale=4),
             tt.msrresnet0_from_jax, "plain"),
    "srmd": (lambda: srresnet.SRMD(19, 3, 32, 6, 4, "R", "pixelshuffle"),
             lambda: jsr.SRMD(19, 3, 32, 6, 4, "R", "pixelshuffle"),
             lambda sd: tc.convert_srmd(sd, nb=6), tt.srmd_from_jax, "plain"),
    "rrdbnet": (lambda: rrdbnet.RRDBNet(3, 3, 16, 2, 8, 4),
                lambda: jrr.RRDBNet(3, 3, 16, 2, 8, 4),
                lambda sd: tc.convert_rrdbnet(sd, nb=2, sf=4),
                tt.rrdbnet_from_jax, "plain"),
    "rrdbnet_noup": (lambda: rrdbnet.RRDBNetNoUp(3, 3, 16, 2, 8),
                     lambda: jrr.RRDBNetNoUp(3, 3, 16, 2, 8),
                     lambda sd: tc.convert_rrdbnet_noup(sd, nb=2),
                     tt.rrdbnet_from_jax, "plain"),
    # KAIR hard-codes gc=32 in the old RRDB's blocks (network_rrdb.py:30)
    "rrdb_old": (lambda: rrdbnet.RRDB(3, 3, 16, 2, 32, 4, "L", "upconv"),
                 lambda: jrr.RRDB(3, 3, 16, 2, 32, 4, "L", "upconv"),
                 lambda sd: tc.convert_rrdb_old(sd, nb=2, upscale=4),
                 tt.rrdb_from_jax, "plain"),
    "imdn": (lambda: imdn.IMDN(3, 3, 32, 3, 4, "L", "pixelshuffle"),
             lambda: jim.IMDN(3, 3, 32, 3, 4, "L", "pixelshuffle"),
             lambda sd: tc.convert_imdn(sd, nb=3), tt.imdn_from_jax, "plain"),
    "unetres": (lambda: drunet.UNetRes(3, 3, (16, 32, 64, 128), 2),
                lambda: jdr.UNetRes(3, 3, (16, 32, 64, 128), 2),
                lambda sd: tc.convert_unetres(sd, nb=2), tt.unetres_from_jax,
                "plain"),
    "ffdnet": (lambda: ffdnet.FFDNet(1, 1, 64, 6),
               lambda: jff.FFDNet(1, 1, 64, 6),
               lambda sd: tc.convert_ffdnet(sd, nb=6), tt.ffdnet_from_jax,
               "ffdnet"),
    "usrnet": (lambda: usrnet.USRNet(4, 16, 4, 3, (8, 16, 32, 64), 2),
               lambda: jus.USRNet(4, 16, 4, 3, (8, 16, 32, 64), 2),
               lambda sd: tc.convert_usrnet(sd, n_iter=4, nb=2),
               tt.usrnet_from_jax, "usrnet"),
}
NAMES = list(CASES)


def atol(name):
    return 1e-4 if name == "usrnet" else 5e-5


def nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def fixture(name):
    """(KAIR state dict as numpy, NHWC inputs, NHWC KAIR output)."""
    z = np.load(FIXTURES / f"model_{name}.npz")
    sd = {k[3:]: z[k] for k in z.files if k.startswith("sd.")}
    if CASES[name][4] == "usrnet":
        ins = [nhwc(z["x"]), nhwc(z["k"]), 2, nhwc(z["sigma"])]
    elif CASES[name][4] == "ffdnet":
        ins = [nhwc(z["in0"]), z["in1"]]
    else:
        ins = [nhwc(z["in0"])]
    return sd, ins, nhwc(z["out"])


def port_forward(model, ins):
    args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            for a in ins]
    with torch.no_grad():
        return model.eval()(*args).numpy()


def port_model(name, sd):
    model = CASES[name][0]()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return model


@pytest.mark.parametrize("name", NAMES)
def test_matches_kair_fixture(name):
    sd, ins, want = fixture(name)
    got = port_forward(port_model(name, sd), ins)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol(name), rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_matches_jax_model(name):
    sd, ins, _ = fixture(name)
    variables = CASES[name][2](sd)
    want = np.asarray(CASES[name][1]().apply(variables, *ins))
    got = port_forward(port_model(name, sd), ins)
    np.testing.assert_allclose(got, want, atol=atol(name), rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_from_jax_round_trips_the_state_dict(name):
    sd, _, _ = fixture(name)
    back = CASES[name][3](CASES[name][2](sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == torch.from_numpy(v).dtype, k
        assert np.array_equal(back[k].numpy(), v), k


def _jax_inputs(net_type, o):
    """Small inputs of the JAX model's ``init`` for one option tree."""
    c = o.get("in_nc", 3)
    if net_type == "usrnet":
        return [np.zeros((1, 8, 8, 3), np.float32),
                np.zeros((1, 7, 7, 1), np.float32), 4,
                np.zeros((1, 1, 1, 1), np.float32)]
    x = np.zeros((1, 16, 16, c), np.float32)
    if net_type == "ffdnet":
        return [x, np.zeros((1, 1, 1, 1), np.float32)]
    return [x]


OPTION_FILES = ["train_dncnn.json", "train_ffdnet.json",
                "train_msrresnet_psnr.json", "train_msrresnet_gan.json",
                "train_usrnet.json"]


@pytest.mark.parametrize("path", OPTION_FILES)
def test_define_g_builds_the_option_files(path):
    from kair_tpu.models.registry import define_g as jax_define_g
    from kair_tpu_torch.config import load_json_with_comments
    from kair_tpu_torch.models.registry import define_g

    opt = load_json_with_comments(str(REPO_ROOT / "options" / path))
    o = opt["netG"]
    model = define_g(opt)
    jmodel = jax_define_g(opt)
    ins = _jax_inputs(o["net_type"], o)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), *ins))["params"]
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    nc = o.get("nc", 64)
    assert convs[0].out_channels == (nc[0] if isinstance(nc, list) else nc)
    out = port_forward(model, ins)
    assert np.isfinite(out).all()


def _bn_dncnn_jax_variables():
    """A JAX 'BR' DnCNN's parameters and non-trivial running statistics."""
    model = jdn.DnCNN(1, 1, 16, 5, "BR")
    x = np.random.RandomState(0).rand(1, 12, 12, 1).astype(np.float32)
    v = jax.tree_util.tree_map(np.asarray,
                               model.init(jax.random.PRNGKey(1), x))
    rng = np.random.RandomState(2)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim else a, v["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(np.float32),
        v["params"])
    return {"params": params, "batch_stats": stats}, x


def test_merge_bn_folds_a_br_dncnn():
    from kair_tpu.utils.bnorm import merge_bn_convblocks
    from kair_tpu_torch.utils.bnorm import merge_bn

    variables, x = _bn_dncnn_jax_variables()
    net = dncnn.DnCNN(1, 1, 16, 5, "BR")
    net.load_state_dict(tt.dncnn_from_jax(variables, act_mode="BR"),
                        strict=True)
    want_br = np.asarray(jdn.DnCNN(1, 1, 16, 5, "BR").apply(variables, x))
    before = port_forward(net, [x])
    np.testing.assert_allclose(before, want_br, atol=1e-5, rtol=0)

    merge_bn(net)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    after = port_forward(net, [x])
    np.testing.assert_allclose(after, before, atol=1e-5, rtol=0)
    # the deploy form: loads into DnCNN(act_mode="R"), KAIR's released keys
    deploy = dncnn.DnCNN(1, 1, 16, 5, "R")
    deploy.load_state_dict(net.state_dict(), strict=True)
    merged = merge_bn_convblocks(variables["params"], variables["batch_stats"])
    want = np.asarray(jdn.DnCNN(1, 1, 16, 5, "R").apply({"params": merged}, x))
    np.testing.assert_allclose(port_forward(deploy, [x]), want, atol=1e-5,
                               rtol=0)


def test_usrnet_data_step_is_f32_in_a_bf16_model():
    """In a bf16 USRNet the data step sees f32 images and complex64
    spectra, the prior bf16 input; the output stays close to the f32
    model's."""
    sd, ins, want = fixture("usrnet")
    model = port_model("usrnet", sd)
    f32 = port_forward(model, ins)
    seen, prior_in = [], []
    step = usrnet.data_step

    def spy(x, FB, FBC, F2B, FBFy, alpha, sf):
        seen.append((x.dtype, FB.dtype, FBFy.dtype, alpha.dtype))
        out = step(x, FB, FBC, F2B, FBFy, alpha, sf)
        seen.append((out.dtype,))
        return out

    model = model.to(torch.bfloat16)
    model.p.register_forward_pre_hook(
        lambda m, a: prior_in.append(a[0].dtype))
    with mock.patch.object(usrnet, "data_step", spy):
        bf16 = port_forward(model, ins)
    assert len(seen) == 2 * 4
    assert all(s == (torch.float32, torch.complex64, torch.complex64,
                     torch.float32) for s in seen[::2])
    assert all(s == (torch.float32,) for s in seen[1::2])
    assert prior_in == [torch.bfloat16] * 4
    assert bf16.dtype == np.float32
    assert np.abs(bf16 - f32).max() <= 2e-2 * np.abs(f32).max()
    np.testing.assert_allclose(f32, want, atol=1e-4, rtol=0)


FFT_CASES = {
    "p2o": lambda m, a, k: m.p2o(k, (12, 16)),
    "upsample_zero": lambda m, a, k: m.upsample_zero(a, 2),
    "downsample_keep": lambda m, a, k: m.downsample_keep(a, 3),
    "splits_mean": lambda m, a, k: m.splits_mean(a, 2),
}


@pytest.mark.parametrize("name", list(FFT_CASES))
def test_fft_helpers_match_jax(name):
    import jax.numpy as jnp
    from kair_tpu.ops import fft as jfft
    from kair_tpu_torch.ops import fft

    rng = np.random.RandomState(4)
    a = rng.rand(2, 6, 8, 3).astype(np.float32)
    k = rng.rand(2, 5, 5, 1).astype(np.float32)
    got = FFT_CASES[name](fft, torch.from_numpy(a), torch.from_numpy(k))
    want = FFT_CASES[name](jfft, jnp.asarray(a), jnp.asarray(k))
    assert got.dtype == (torch.complex64 if name == "p2o" else torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_receptive_field_matches_jax():
    from kair_tpu.utils import receptivefield as jrf
    from kair_tpu_torch.utils import receptivefield as rf

    # IRCNN's dilated 3x3 stack as (effective kernel, stride, padding),
    # then a 2x2 stride-2 conv: 1 + 2·16 + 1 = 34 pixels
    convs = [(1 + 2 * d, 1, d) for d in (1, 2, 3, 4, 3, 2, 1)] + [(2, 2, 0)]
    assert rf.receptive_field(convs, 64) == jrf.receptive_field(convs, 64)
    assert rf.effective_receptive_field(convs) == \
        jrf.effective_receptive_field(convs) == 34
