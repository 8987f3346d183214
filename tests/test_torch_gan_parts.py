"""The GAN slice's parts in the port against the JAX package, on the CPU in
f32 (weights carried across by the ``*_from_jax`` converters, inputs
seeded with numpy).

* ``gan_loss``: the five types, both targets, within 1e-6 of the value.
* ``r1_penalty``, ``gradient_penalty_loss`` (the same interpolation
  weights) and their gradients with respect to D's parameters, on a
  PatchGAN, within 1e-4 of each value / tensor's scale; ``g_path_
  regularize`` (the same noise) on a tiny StyleGAN2 generator, within 1e-4.
* Each discriminator (seeded in the port, carried to JAX, and back by
  ``discriminator_from_jax`` exactly): its output in eval mode within 1e-4
  of max|ref|, and
  after two training-mode calls its output and every spectral ``u`` within
  1e-5; σ of the stored iteration within 2e-2 of the weight matrix's top
  singular value after 30 iterations (the power iteration's own
  convergence). The VGG-style D with BatchNorm in training mode against
  the JAX module applied by hand with ``mutable=["batch_stats"]`` (the JAX
  trainer itself cannot): the output within 1e-4, the running mean within
  1e-6, the running variance after its unbiased / biased factor within 1e-6.
* ``VGG19Features`` at (2, 7, 16, 25, 34), with each norm, within 1e-4 of
  each map's max; ``LPIPSAlex`` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu.models import discriminator as jd
from kair_tpu.models.lpips_jax import LPIPSAlex as JaxLPIPS
from kair_tpu.models.vgg import VGG19Features as JaxVGG
from kair_tpu.train import losses as jl
from kair_tpu_torch.ckpt.torch_convert import (discriminator_from_jax,
                                               vgg19_from_jax)
from kair_tpu_torch.models import discriminator as td
from kair_tpu_torch.models.lpips import LPIPSAlex, lpips_from_jax
from kair_tpu_torch.models.vgg import VGG19Features
from kair_tpu_torch.train import losses as tl

GAN_TYPES = ["gan", "ragan", "lsgan", "wgan", "softplusgan"]


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


@pytest.mark.parametrize("target", [True, False])
@pytest.mark.parametrize("gan_type", GAN_TYPES)
def test_gan_loss_matches_jax(gan_type, target):
    x = np.random.RandomState(0).randn(4, 8, 8, 1).astype(np.float32) * 3
    want = float(jl.gan_loss(jnp.asarray(x), target, gan_type))
    got = float(tl.gan_loss(torch.from_numpy(x), target, gan_type))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_get_loss_fn_gan_is_not_found_as_in_jax():
    with pytest.raises(NotImplementedError, match="not found"):
        jl.get_loss_fn("gan")
    with pytest.raises(NotImplementedError, match="not found"):
        tl.get_loss_fn("gan")


# ----------------------------------------------------------------------------
# discriminators
# ----------------------------------------------------------------------------

D_CASES = {
    "patchgan_spectral": (lambda: jd.PatchGAN(3, 8, 3, "spectral"),
                          lambda: td.PatchGAN(3, 8, 3, "spectral"), 32),
    "patchgan_instance": (lambda: jd.PatchGAN(3, 8, 2, "instance"),
                          lambda: td.PatchGAN(3, 8, 2, "instance"), 32),
    "unet": (lambda: jd.UNetDiscriminator(3, 8),
             lambda: td.UNetDiscriminator(3, 8), 32),
    "vgg_96": (lambda: jd.VGGStyleDiscriminator(96, 3, 4, "BL"),
               lambda: td.VGGStyleDiscriminator(96, 3, 4, "BL"), 96),
    "vgg_128_sn": (lambda: jd.VGG128SN(base_nc=4),
                   lambda: td.VGG128SN(base_nc=4), 128),
    "vgg_192": (lambda: jd.VGGStyleDiscriminator(192, 3, 4, "BL"),
                lambda: td.VGGStyleDiscriminator(192, 3, 4, "BL"), 192),
}


def _to_jax(tm) -> dict:
    """The port's discriminator as a JAX variables tree (HWIO kernels,
    dense (in, out), ``spectral`` u, BatchNorm scale/bias and statistics),
    copied: JAX may read a host array in place while it computes, and the
    port's training-mode calls update ``u`` and the statistics in place."""
    params, spectral, stats = {}, {}, {}
    arr = lambda t: t.detach().numpy().copy()
    for name, m in tm.named_children():
        if isinstance(m, (td.SNConv, td.SNDense)):
            w = arr(m.weight)
            leaf = {"kernel": w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T}
            if m.bias is not None:
                leaf["bias"] = arr(m.bias)
            params[name] = leaf
            if m.spectral:
                spectral[name] = {"u": arr(m.u)}
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            params[name] = {"scale": arr(m.weight), "bias": arr(m.bias)}
            stats[name] = {"mean": arr(m.running_mean),
                           "var": arr(m.running_var)}
    out = {"params": params}
    if spectral:
        out["spectral"] = spectral
    if stats:
        out["batch_stats"] = stats
    return out


def _pair(case, seed=0):
    """(JAX module, port module, the JAX variables, an input): the port's
    seeded weights carried to JAX, and ``discriminator_from_jax`` carrying
    them back exactly."""
    jmod, tmod, size = D_CASES[case]
    torch.manual_seed(seed)
    tm = tmod()
    variables = _to_jax(tm)
    back = discriminator_from_jax(variables)
    sd = tm.state_dict()
    assert set(back) == set(sd)
    for k, v in back.items():
        assert torch.equal(v, sd[k]) or k.endswith("num_batches_tracked"), k
    x = np.random.RandomState(seed).rand(2, size, size, 3).astype(np.float32)
    return jmod(), tm, variables, x


@pytest.mark.parametrize("case", list(D_CASES))
def test_discriminator_matches_jax(case):
    jm, tm, variables, x = _pair(case)
    xs = (x, x[::-1].copy())
    spectral = "spectral" in variables

    def run(v, a, b):
        # eval, then two training-mode calls, each storing its iteration
        # (sp1 -> sp2), as the D update does
        outs = [jm.apply(v, a, train=False)]
        if spectral:
            for xi in (a, b):
                o, mut = jm.apply(v, xi, train=True, mutable=["spectral"])
                v = {**v, "spectral": mut["spectral"]}
                outs.append((o, mut["spectral"]))
        return outs
    outs = jax.jit(run)(variables, *map(jnp.asarray, xs))
    want = np.asarray(outs[0])
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-4
    tm.train()
    for i, (out, sp) in enumerate(outs[1:]):
        with torch.no_grad():
            got = tm(torch.from_numpy(xs[i])).numpy()
        assert rel(got, np.asarray(out)) <= 1e-4, i
        mods = dict(tm.named_modules())
        for name, leaf in sp.items():
            d = np.abs(mods[name].u.numpy() - np.asarray(leaf["u"])).max()
            assert d <= 1e-5, (i, name, d)


def test_spectral_sigma_converges_to_the_top_singular_value():
    tm = td.PatchGAN(3, 8, 3, "spectral").train()
    x = torch.rand(1, 16, 16, 3)
    with torch.no_grad():
        for _ in range(30):
            tm(x)
    tm.eval()
    for name, m in tm.named_modules():
        if isinstance(m, td.SNConv):
            top = torch.linalg.svdvals(m.matrix().detach())[0].item()
            assert abs(float(m.sigma()) - top) <= 2e-2 * top, name
    # eval mode computes an iteration and stores nothing
    before = td.spectral_vectors(tm)
    with torch.no_grad():
        tm.eval()(x)
    assert all(torch.equal(before[k], v)
               for k, v in td.spectral_vectors(tm).items())


def test_vgg_style_d_batchnorm_training_mode_matches_jax_by_hand():
    jm, tm, variables, x = _pair("vgg_96", seed=3)
    out, mut = jax.jit(lambda v, a: jm.apply(
        v, a, train=True, mutable=["batch_stats"]))(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, jnp.asarray(x))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert rel(got, np.asarray(out)) <= 1e-4
    n = x.shape[0]
    for i in range(1, 10):
        bn = getattr(tm, f"bn{i}")
        st = mut["batch_stats"][f"bn{i}"]
        hw = {1: 48, 2: 48, 3: 24, 4: 24, 5: 12, 6: 12, 7: 6, 8: 6, 9: 3}[i]
        count = n * hw * hw
        assert np.abs(bn.running_mean.numpy() - np.asarray(st["mean"])).max() \
            <= 1e-6, i
        # torch updates the running variance with the unbiased batch
        # variance, flax with the biased one (0.9 of the batch's each)
        var_t = (bn.running_var.numpy() - 0.1 * 1.0) / 0.9 * (count - 1) / count
        var_j = (np.asarray(st["var"]) - 0.1 * 1.0) / 0.9
        assert np.abs(var_t - var_j).max() <= 1e-6 * max(1, np.abs(var_j).max()), i


# ----------------------------------------------------------------------------
# R1, GP, and the perceptual networks
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def patchgan():
    jm, tm, variables, x = _pair("patchgan_spectral", seed=5)
    return jm, tm.eval(), variables, x


def _value_and_grads_jax(fn, params):
    value, grads = jax.jit(jax.value_and_grad(fn))(params)
    return float(value), grads


def test_r1_penalty_matches_jax(patchgan):
    jm, tm, variables, x = patchgan

    def jloss(params):
        return jl.r1_penalty(lambda img: jm.apply(
            {"params": params, "spectral": variables["spectral"]}, img), x)
    want, jgrads = _value_and_grads_jax(jloss, variables["params"])
    tm.zero_grad()
    got = tl.r1_penalty(tm, torch.from_numpy(x))
    got.backward()
    assert float(got.detach()) == pytest.approx(want, rel=1e-4)
    kernel = np.asarray(jgrads["conv1"]["kernel"]).transpose(3, 2, 0, 1)
    assert rel(tm.conv1.weight.grad.numpy(), kernel) <= 1e-4


def test_gradient_penalty_matches_jax(patchgan):
    jm, tm, variables, x = patchgan
    fake = np.random.RandomState(6).rand(*x.shape).astype(np.float32)
    alpha = np.random.RandomState(7).rand(2, 1, 1, 1).astype(np.float32)

    def jloss(params):
        return jl.gradient_penalty_loss(lambda img: jm.apply(
            {"params": params, "spectral": variables["spectral"]}, img),
            x, fake, alpha=jnp.asarray(alpha))
    want, jgrads = _value_and_grads_jax(jloss, variables["params"])
    tm.zero_grad()
    got = tl.gradient_penalty_loss(tm, torch.from_numpy(x),
                                   torch.from_numpy(fake),
                                   alpha=torch.from_numpy(alpha))
    got.backward()
    assert float(got.detach()) == pytest.approx(want, rel=1e-4)
    kernel = np.asarray(jgrads["conv2"]["kernel"]).transpose(3, 2, 0, 1)
    assert rel(tm.conv2.weight.grad.numpy(), kernel) <= 1e-4
    # a generator draws the weights when none are given
    g = torch.Generator().manual_seed(0)
    a = tl.gradient_penalty_loss(tm, torch.from_numpy(x),
                                 torch.from_numpy(fake), generator=g)
    assert torch.isfinite(a)


@pytest.mark.parametrize("input_norm,range_norm", [(True, False), (False, True)])
def test_vgg19_features_match_jax(input_norm, range_norm):
    layers = (2, 7, 16, 25, 34)
    jm = JaxVGG(feature_layers=layers, use_input_norm=input_norm,
                use_range_norm=range_norm)
    x = np.random.RandomState(1).rand(1, 32, 32, 3).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = VGG19Features(layers, input_norm, range_norm)
    tm.load_state_dict(vgg19_from_jax(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel(g.numpy(), np.asarray(w)) <= 1e-4


def test_lpips_matches_jax():
    jm = JaxLPIPS()
    rng = np.random.RandomState(2)
    a = (rng.rand(2, 64, 64, 3) * 2 - 1).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*a.shape), -1, 1).astype(np.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(a),
                                 jnp.asarray(b))
    # non-trivial heads, some negative (clamped to 0 by both)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    params = dict(variables["params"])
    for i in range(5):
        params[f"lin{i}"] = rng.randn(*params[f"lin{i}"].shape).astype(np.float32)
    variables = {"params": params}
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(a),
                                        jnp.asarray(b)))
    tm = LPIPSAlex()
    tm.load_state_dict(lpips_from_jax(variables))
    with torch.no_grad():
        got = tm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == (2,)
    assert rel(got, want) <= 1e-5


def test_g_path_regularize_matches_jax():
    """On a tiny StyleGAN2 generator (size 8, style 8, one MLP layer) with
    the same per-layer noise maps and the same path noise; and a
    generator given no noise maps draws them from its explicit
    ``torch.Generator``."""
    from kair_tpu.models.gpen import StyleGANGenerator as JaxSG
    from kair_tpu_torch.ckpt.torch_convert import stylegan_from_jax
    from kair_tpu_torch.models.gpen import StyleGANGenerator

    rng = np.random.RandomState(3)
    b, n_latent = 2, 4
    noises = [rng.randn(b, r, r, 512).astype(np.float32) for r in (4, 8)]
    latent = rng.randn(b, 8).astype(np.float32)
    path_noise = (rng.randn(b, 8, 8, 3) / 8).astype(np.float32)
    jm = JaxSG(size=8, style_dim=8, n_mlp=1, channel_multiplier=1)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(latent),
                                 [jnp.asarray(n) for n in noises])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for k in params:                    # noise weights off zero
        if "noise_weight" in params[k]:
            params[k] = {**params[k], "noise_weight": np.float32([0.3])}

    def jg(lat):
        return jm.apply({"params": params}, lat[:, 0],
                        [jnp.asarray(n) for n in noises], input_is_latent=True)
    lat = np.repeat(latent[:, None], n_latent, 1)
    want = jax.jit(lambda l: jl.g_path_regularize(
        jg, l, 0.5, noise=jnp.asarray(path_noise)))(jnp.asarray(lat))

    tm = StyleGANGenerator(size=8, style_dim=8, n_mlp=1, channel_multiplier=1)
    tm.load_state_dict(stylegan_from_jax(params))
    tn = [torch.from_numpy(n) for n in noises]
    got = tl.g_path_regularize(
        lambda l: tm(l[:, 0], tn, input_is_latent=True),
        torch.from_numpy(lat), 0.5, noise=torch.from_numpy(path_noise))
    for g, w in zip(got, want):
        assert float(g.detach()) == pytest.approx(float(w), rel=1e-4)
    with torch.no_grad():
        a, c = (tm(torch.from_numpy(latent),
                   generator=torch.Generator().manual_seed(s)) for s in (1, 2))
        a2 = tm(torch.from_numpy(latent),
                generator=torch.Generator().manual_seed(1))
    assert a.shape == (b, 8, 8, 3)
    assert torch.equal(a, a2) and not torch.equal(a, c)

