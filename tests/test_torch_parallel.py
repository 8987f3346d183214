"""The port's scale-out (``kair_tpu_torch/parallel``) on the CPU, gloo
ranks spawned by ``launch.spawn``, against the JAX package on its virtual
CPU devices and against the port's single process.

* Data parallel at world 2: one DnCNN step (nc 8, nb 4, B=8 of 16²) —
  act "R": the loss within 1e-6 of the JAX mesh step's
  (``make_mesh(data=2)`` on two devices) and of one process's, the
  averaged gradient within 1e-6 × max|g| of one process's, the
  parameters after the step within 1e-5 of the JAX mesh step's; control:
  a rank's own gradient, not averaged, misses that limit. Act "BR": the
  global batch's BatchNorm statistics (``group_batchnorm``) give the JAX
  mesh's gradient (1e-4 of each tensor's max; a conv bias before
  BatchNorm, whose true gradient is 0, to 1e-5 of the model's largest,
  as ``test_torch_zoo_train``), its running statistics (the variance
  after flax's n/(n−1)), and its parameters wherever the gradient is not
  that noise (Adam turns noise into ±lr).
* A GAN step (MSRResNet0 against a VGG-style D with BatchNorm; ragan, R1
  and GP) and a ``VideoTrainer`` step inside ``fix_iter`` (the tiny VRT
  of ``test_torch_vrt_train``) at world 2 against one process on the
  whole batch: gradients within 1e-5 of each tensor's max (readings ≤
  6.3e-6; D's zero-gradient biases, noise under R1 and GP, within 1e-4
  of D's largest; the VRT's within 1e-4, readings ≤ 1.4e-5), losses
  within 1e-5, D's BatchNorm statistics, the frozen flow group bit-equal to its start and its Adam moments as one
  process's.
* Tensor parallel at world 2 (a ('model',) mesh): one SwinIR step with
  the qkv / fc1 / proj / fc2 weights stored as shards equals one process
  (rtol 1e-4, atol 1e-5, ``tests/test_parallel.py``'s); the rules shard
  the qkv and fc1 weights; an indivisible dimension replicates; a model
  on the card whose blocks run a kernel is refused.
* Tiled inference at world 4 against the JAX functions on four devices
  and the monolithic forward: overlap bands on a DnCNN (1e-5), a 2×2
  grid on a window-aligned SwinIR (C=16; 2e-5), the video grid on the
  tiny VRT against the port's host loop ``test_clip_grid`` (its
  ``clamped_window_starts``; the JAX VRT's compile alone would take a
  minute), and its geometry against the JAX video grid on a cheap
  window function; ``halo_exchange_rows`` against JAX's.
* ``first_slurm_hostname`` against the JAX function; the CLIs' mesh rule.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import tests.torch_parallel_ranks as ranks
from kair_tpu.models.dncnn import DnCNN as JDnCNN
from kair_tpu.models.swinir import SwinIR as JSwinIR
from kair_tpu.parallel import launch as jlaunch
from kair_tpu.parallel import mesh as jmesh
from kair_tpu.parallel import tiled as jtiled
from kair_tpu.ckpt.torch_convert import convert_dncnn, convert_swinir
from kair_tpu.train.trainer import PlainTrainer as JTrainer, TrainState
from kair_tpu_torch.ckpt.torch_convert import dncnn_from_jax
from kair_tpu_torch.parallel import launch, mesh as pm, tp
from kair_tpu_torch.train.select import define_trainer

ZERO_GRAD, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def dncnn_opt(act):
    return {"netG": {"net_type": "dncnn", "in_nc": 1, "out_nc": 1, "nc": 8,
                     "nb": 4, "act_mode": act},
            "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 1e-3,
                      "G_scheduler_milestones": [10000], "E_decay": 0}}


def dncnn_case(act):
    """The JAX trainer's initial state on a batch, carried to the port."""
    opt = dncnn_opt(act)
    jt = JTrainer(opt)
    rng = np.random.RandomState(0)
    batch = {"L": rng.rand(8, 16, 16, 1).astype(np.float32),
             "H": rng.rand(8, 16, 16, 1).astype(np.float32)}
    v = jax.jit(jt.model.init)(jax.random.PRNGKey(0), batch["L"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       opt_state=jt.tx.init(v["params"]),
                       batch_stats=v.get("batch_stats"))
    return {"opt": opt, "batch": batch, "act": act, "jax": (jt, state),
            "G": dncnn_from_jax({"params": _np(state.params), **(
                {"batch_stats": _np(state.batch_stats)}
                if state.batch_stats else {})}, act)}


def jax_mesh_step(case):
    """The JAX trainer's step on a ('data',) mesh of two devices, and the
    gradient that step takes (value_and_grad on the sharded batch)."""
    (jt, state), act, batch = case["jax"], case["act"], case["batch"]
    mesh = jmesh.make_mesh(data=2, devices=jax.devices()[:2])
    sb = jmesh.shard_batch(mesh, batch)
    sr = jmesh.replicate_state(mesh, state)
    new, metrics = jt.make_train_step(donate=False)(sr, sb)
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats

    def loss_of(p):
        v = dict(variables, params=p)
        e = jt.model.apply(v, sb["L"], train=True,
                           mutable=["batch_stats"] if act == "BR" else False)
        e = e[0] if act == "BR" else e
        return jnp.mean(jnp.abs(e.astype(jnp.float32) - sb["H"]))

    grads = jax.jit(jax.grad(loss_of))(sr.params)
    to_torch = lambda p, s: dncnn_from_jax(
        {"params": _np(p), **({"batch_stats": _np(s)} if s else {})}, act)
    return {"loss": float(metrics["G_loss"]),
            "grads": to_torch(grads, state.batch_stats),
            "after": to_torch(new.params, new.batch_stats)}


def spawn_in_background(fn, world, store, cases):
    """``launch.spawn`` in a thread, so that this process computes the
    references while the ranks run; ``join()`` returns their results."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = launch.spawn(fn, world, device="cpu",
                                      init_method=f"file://{store}",
                                      args=(cases,))
        except BaseException as e:
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["out"]
    return join


def single_step(case):
    t = ranks.trainer_from(case)
    kw = {"update_g": True} if case.get("D") is not None else {}
    return ranks.step_result(t, t.train_step(case["batch"], **kw))


def gan_case():
    rng = np.random.RandomState(1)
    opt = {"model": "gan", "scale": 2,
           "netG": {"net_type": "msrresnet0", "in_nc": 3, "out_nc": 3,
                    "nc": 8, "nb": 1, "upscale": 2, "scale": 2,
                    "upsample_mode": "pixelshuffle"},
           "netD": {"net_type": "discriminator_vgg_96", "in_nc": 3,
                    "base_nc": 4, "act_mode": "BL"},
           "train": {"G_lossfn_type": "l1", "G_lossfn_weight": 1e-2,
                     "F_lossfn_weight": 0, "gan_type": "ragan",
                     "D_lossfn_weight": 5e-3, "D_r1_weight": 0.5,
                     "D_gp_weight": 0.5, "D_reg_seed": 3, "E_decay": 0.999,
                     "G_optimizer_lr": 1e-4, "D_optimizer_lr": 1e-4}}
    torch.manual_seed(3)
    t = define_trainer(opt, dtype=torch.float32, device="cpu")
    return {"opt": opt, "G": t.model.state_dict(), "D": t.model_d.state_dict(),
            "batch": {"L": rng.rand(4, 48, 48, 3).astype(np.float32),
                      "H": rng.rand(4, 96, 96, 3).astype(np.float32)}}


def video_case():
    from tests.test_torch_vrt_train import seeded_state_dict, tiny_options
    rng = np.random.RandomState(9)
    return {"opt": tiny_options(), "G": seeded_state_dict(),
            "batch": {"L": rng.rand(2, 2, 64, 64, 3).astype(np.float32),
                      "H": rng.rand(2, 2, 256, 256, 3).astype(np.float32)}}


SWINIR = {"net_type": "swinir", "upscale": 2, "in_nc": 3, "embed_dim": 16,
          "depths": [2], "num_heads": [2], "window_size": 8,
          "mlp_ratio": 2.0, "upsampler": "pixelshuffledirect", "img_size": 16}


def tp_case():
    opt = {"netG": dict(SWINIR),
           "train": {"G_lossfn_type": "l1", "G_optimizer_lr": 1e-3,
                     "G_scheduler_milestones": [10000], "E_decay": 0.999}}
    rng = np.random.RandomState(0)
    torch.manual_seed(4)
    t = define_trainer(opt, dtype=torch.float32, device="cpu")
    return {"opt": opt, "G": t.model.state_dict(),
            "batch": {"L": rng.rand(8, 16, 16, 3).astype(np.float32),
                      "H": rng.rand(8, 32, 32, 3).astype(np.float32)}}


def tiled_cases():
    """World 4's inputs: seeded port weights (the JAX twins converted from
    them by the JAX package's ``convert_*``), images and clips."""
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.models.vrt import VRT
    from tests.test_torch_vrt_train import TINY
    rng = np.random.RandomState(1)
    torch.manual_seed(5)
    dn_net = {"net_type": "dncnn", "in_nc": 1, "out_nc": 1, "nc": 16,
              "nb": 4, "act_mode": "R"}
    sw_net = {"net_type": "swinir", "upscale": 1, "in_nc": 1,
              "embed_dim": 16, "depths": [2], "num_heads": [2],
              "window_size": 8, "mlp_ratio": 2.0, "upsampler": "",
              "img_size": 64}
    dn, sw, vrt = define_g({"netG": dn_net}), define_g({"netG": sw_net}), \
        VRT(**TINY).eval()
    with torch.no_grad():        # blocks far from the identity
        for n, p in sw.named_parameters():
            if ".blocks." in n:
                p.add_(0.1 * torch.randn_like(p))
    return {
        "band": {"net": dn_net, "sd": dn.state_dict(), "halo": 8, "sf": 1,
                 "x": rng.rand(1, 64, 48, 1).astype(np.float32)},
        "grid": {"net": sw_net, "sd": sw.state_dict(), "halo": 16, "sf": 1,
                 "x": rng.rand(1, 64, 64, 1).astype(np.float32)},
        "video": {"net": TINY, "sd": vrt.state_dict(), "halo": 8, "sf": 4,
                  "x": rng.rand(1, 2, 96, 96, 3).astype(np.float32)},
        "geometry": {"fn": ranks.geometry_fn, "halo": 4, "sf": 1,
                     "x": rng.rand(1, 2, 32, 48, 3).astype(np.float32)},
        "halo_rows": rng.rand(1, 16, 5, 2).astype(np.float32)}, vrt


def tiled_refs(cases, vrt) -> dict:
    """The JAX functions on four devices, the monolithic forwards and the
    port's host loop."""
    from kair_tpu_torch.eval.video_test import test_clip_grid
    npsd = lambda sd: {k: v.numpy() for k, v in sd.items()}
    dn = JDnCNN(1, 1, 16, 4, "R")
    v_dn = convert_dncnn(npsd(cases["band"]["sd"]), nb=4)
    sw = JSwinIR(upscale=1, in_chans=1, embed_dim=16, depths=(2,),
                 num_heads=(2,), window_size=8, mlp_ratio=2.0, upsampler="")
    v_sw = convert_swinir(npsd(cases["grid"]["sd"]), depths=(2,))
    fn_dn = lambda a: dn.apply(v_dn, a)
    fn_sw = lambda a: sw.apply(v_sw, a)
    jmesh4 = jmesh.make_mesh(data=1, tile=4, devices=jax.devices()[:4])
    jgrid = jmesh.make_grid_mesh(2, 2, jax.devices()[:4])
    x_band, x_grid, x_geo = (cases[k]["x"] for k in ("band", "grid",
                                                     "geometry"))
    ref = {
        "band": (np.asarray(jtiled.make_sharded_tiled_fn(
            fn_dn, jmesh4, halo=8)(x_band)), np.asarray(jax.jit(fn_dn)(x_band))),
        "grid": (np.asarray(jtiled.make_grid_sharded_fn(fn_sw, jgrid, halo=16)(
            jax.device_put(x_grid, jtiled.grid_sharding(jgrid)))),
                 np.asarray(jax.jit(fn_sw)(x_grid))),
        "geometry": np.asarray(jtiled.make_grid_sharded_video_fn(
            lambda w: w * 2.0 + w.mean(axis=(2, 3), keepdims=True)
            + w[:, :, :1].mean(axis=3, keepdims=True), jgrid, halo=4)(
                jax.device_put(x_geo, jtiled.video_grid_sharding(jgrid)))),
        "halo_rows": np.asarray(jax.jit(shard_map(
            lambda a: jtiled.halo_exchange_rows(a, 2, "tile"),
            mesh=JMesh(np.asarray(jax.devices()[:4]), ("tile",)),
            in_specs=(P(None, "tile"),), out_specs=P(None, "tile"),
            check_rep=False))(cases["halo_rows"]))}
    with torch.no_grad():
        ref["video"] = test_clip_grid(lambda a: vrt(torch.from_numpy(
            np.ascontiguousarray(a))), cases["video"]["x"], sf=4,
            tile=(48, 48), halo=8)
    return ref


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worlds' ranks started at once (2 + 4 processes, a thread each),
    the references computed here while they run."""
    cases = {"dp_R": dncnn_case("R"), "dp_BR": dncnn_case("BR"),
             "gan": gan_case(), "video": video_case(), "tp": tp_case()}
    sent = {k: {f: v for f, v in c.items() if f != "jax"}
            for k, c in cases.items()}
    join2 = spawn_in_background(
        ranks.world2, 2, tmp_path_factory.mktemp("rendezvous2") / "store",
        sent)
    cases4, vrt = tiled_cases()
    join4 = spawn_in_background(
        ranks.world4, 4, tmp_path_factory.mktemp("rendezvous4") / "store",
        cases4)
    for k in ("dp_R", "dp_BR"):
        cases[k].update(jax_mesh_step(cases[k]))
    single = {k: single_step(cases[k]) for k in ("dp_R", "dp_BR", "gan",
                                                  "video")}
    t = ranks.trainer_from(cases["tp"])
    single["tp"] = {"loss": float(t.train_step(cases["tp"]["batch"])[
        "G_loss"]), "G": {n: p.detach().numpy().copy()
                         for n, p in t.model.named_parameters()},
        "ema": {n: p.detach().numpy().copy()
                for n, p in t.ema.named_parameters()}}
    ref4 = tiled_refs(cases4, vrt)
    return (cases, join2(), single), (cases4, join4(), ref4)


@pytest.fixture(scope="module")
def world2(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def world4(spawned):
    return spawned[1]


def _close_grads(got, want, tol, noise=ZERO_GRAD):
    """Each gradient within tol of its tensor's max; one that is rounding
    noise (true gradient 0) within noise of the largest."""
    top = max(np.abs(w).max() for w in want.values())
    assert set(got) == set(want)
    for n, w in want.items():
        scale = np.abs(w).max() if np.abs(w).max() > noise * top \
            else noise * top / tol
        np.testing.assert_allclose(got[n], w, rtol=0, atol=tol * scale,
                                   err_msg=n)


def _ranks_agree(out, key):
    a, b = out[0][key], out[1][key]
    for part in ("G", "grads"):
        for n in a[part]:
            np.testing.assert_array_equal(a[part][n], b[part][n], err_msg=n)


def test_data_parallel_step_matches_the_jax_mesh_and_one_process(world2):
    cases, out, single = world2
    case, dp, one = cases["dp_R"], out[0]["dp_R"], single["dp_R"]
    _ranks_agree(out, "dp_R")
    for want in (case["loss"], one["metrics"]["G_loss"]):
        assert abs(dp["metrics"]["G_loss"] - want) <= 1e-6 * abs(want)
    top = max(np.abs(g).max() for g in one["grads"].values())
    for n, g in one["grads"].items():
        np.testing.assert_allclose(dp["grads"][n], g, rtol=0, atol=1e-6 * top,
                                   err_msg=n)
    for n, w in case["after"].items():
        np.testing.assert_allclose(dp["G"][n], w.numpy(), rtol=0, atol=1e-5,
                                   err_msg=n)


def test_a_ranks_own_gradient_misses_the_limit(world2):
    """The control: without the average, rank 0's gradient is off."""
    _, out, single = world2
    one = single["dp_R"]["grads"]
    top = max(np.abs(g).max() for g in one.values())
    err = max(np.abs(out[0]["dp_R_local"][n] - g).max()
              for n, g in one.items())
    assert err > 100 * 1e-6 * top, err


def test_data_parallel_batchnorm_matches_the_jax_mesh(world2):
    cases, out, single = world2
    case, dp = cases["dp_BR"], out[0]["dp_BR"]
    _ranks_agree(out, "dp_BR")
    assert abs(dp["metrics"]["G_loss"] - case["loss"]) <= 1e-6 * case["loss"]
    want = {n: case["grads"][n].numpy() for n in dp["grads"]}
    _close_grads(dp["grads"], want, GRAD_TOL)
    top = max(np.abs(w).max() for w in want.values())
    n_px, checked = 8 * 16 * 16, 0
    for k, v in dp["G"].items():
        w = case["after"][k].numpy()
        if k.endswith("running_mean"):
            np.testing.assert_allclose(v, w, rtol=0, atol=1e-5 * np.abs(w).max())
            checked += 1
        elif k.endswith("running_var"):
            old = case["G"][k].numpy()
            np.testing.assert_allclose(v - 0.1 * old,
                                       (w - 0.1 * old) * n_px / (n_px - 1),
                                       rtol=1e-4)
            checked += 1
        elif k in want and np.abs(want[k]).max() > ZERO_GRAD * top:
            np.testing.assert_allclose(v, w, rtol=0, atol=1e-5, err_msg=k)
    assert checked == 4
    # one process on the whole batch: the same step
    _close_grads(dp["grads"], single["dp_BR"]["grads"], 1e-5)


def test_gan_step_with_r1_and_gp_matches_one_process(world2):
    _, out, single = world2
    dp, one = out[0]["gan"], single["gan"]
    _ranks_agree(out, "gan")
    for k, v in one["metrics"].items():
        assert abs(dp["metrics"][k] - v) <= 1e-5 * max(abs(v), 1e-3), k
    _close_grads(dp["grads"], one["grads"], 1e-5)
    # D's conv biases before BatchNorm and ragan's last bias have a true
    # gradient of 0: R1 and GP leave f32 noise there of up to 4.8e-5 of D's
    # largest gradient (readings), held to 1e-4 of it
    _close_grads(dp["D_grads"], one["D_grads"], 1e-5, noise=1e-4)
    for k, v in one["D"].items():          # BatchNorm statistics, spectral u
        if "running" in k:
            np.testing.assert_allclose(dp["D"][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_video_step_in_fix_iter_matches_one_process(world2):
    cases, out, single = world2
    dp, one = out[0]["video"], single["video"]
    _ranks_agree(out, "video")
    assert abs(dp["metrics"]["G_loss"] - one["metrics"]["G_loss"]) <= \
        1e-6 * one["metrics"]["G_loss"]
    # Charbonnier at eps 1e-9 through the VRT: readings ≤ 1.4e-5
    _close_grads(dp["grads"], one["grads"], GRAD_TOL)
    keys = cases["video"]["opt"]["train"]["fix_keys"]
    flow = [n for n in one["moments"] if any(k in n for k in keys)]
    assert flow
    for n in flow:
        np.testing.assert_array_equal(dp["G"][n],
                                      cases["video"]["G"][n].numpy())
        np.testing.assert_allclose(dp["moments"][n], one["moments"][n],
                                   rtol=0, atol=1e-5 * max(
                                       np.abs(one["moments"][n]).max(), 1e-9))


def test_tensor_parallel_step_matches_one_process(world2):
    _, out, single = world2
    tp_out, one = out[0]["tp"], single["tp"]
    np.testing.assert_allclose(tp_out["loss"], one["loss"], rtol=1e-5)
    names = {n.replace("parametrizations.", "").replace(".original", ""): n
             for n in tp_out["params"]}
    assert set(names) == set(one["G"])
    for n, w in one["G"].items():
        np.testing.assert_allclose(tp_out["params"][names[n]], w, rtol=1e-4,
                                   atol=1e-5, err_msg=n)
        np.testing.assert_allclose(tp_out["ema"][names[n]], one["ema"][n],
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_tp_rules_shard_the_attention_and_mlp_weights(world2):
    _, out, single = world2
    sharded = out[0]["tp"]["sharded"]
    assert any(n.endswith("attn.qkv.weight") for n in sharded)
    assert any(n.endswith("mlp.fc1.weight") for n in sharded)
    assert any(n.endswith("attn.proj.weight") for n in sharded)
    for n, shape in out[0]["tp"]["local"].items():
        whole = single["tp"]["G"][n.replace("parametrizations.", "")
                                  .replace(".original", "")].shape
        assert np.prod(shape) * 2 == np.prod(whole), n


def test_tp_indivisible_dims_fall_back_to_replicated():
    from torch.distributed.tensor import Replicate, Shard
    mesh = pm.Mesh({"data": 2, "model": 2, "tile": 2})
    specs = tp.tp_state_shardings(mesh, {
        "blk.attn.qkv.weight": torch.zeros(18, 6),      # 18 % 2 == 0
        "blk.mlp.fc1.weight": torch.zeros(13, 6),       # 13 % 2 != 0
        "blk.mlp.fc11.weight": torch.zeros(12, 6)})     # no rule
    assert specs["blk.attn.qkv.weight"] == Shard(0)
    assert specs["blk.mlp.fc1.weight"] == Replicate()
    assert specs["blk.mlp.fc11.weight"] == Replicate()


def test_tp_on_the_card_refuses_a_kernel_route():
    from unittest import mock
    from kair_tpu_torch.models.registry import define_g
    model = define_g({"netG": dict(SWINIR)})
    mesh = pm.Mesh({"data": 1, "model": 2, "tile": 1})
    assert tp.kernel_refusal(model) is None             # the CPU: plain route
    with mock.patch.object(torch.Tensor, "is_cuda",
                           new_callable=mock.PropertyMock, return_value=True):
        with pytest.raises(NotImplementedError, match="whole weights"):
            tp.shard_state(mesh, model)


# ---------------------------------------------------------------------------
# tiled inference at world 4
# ---------------------------------------------------------------------------

def _stitch(parts, hdim):
    """A 2x2 grid's tiles, rank-major (row, column), into one array."""
    rows = [np.concatenate(parts[2 * i:2 * i + 2], axis=hdim + 1)
            for i in range(2)]
    return np.concatenate(rows, axis=hdim)


def test_overlap_band_dncnn_matches_jax_and_the_monolithic_forward(world4):
    _, out, ref = world4
    jax_tiled, whole = ref["band"]
    for r in range(4):
        np.testing.assert_allclose(out[r]["band"], jax_tiled, atol=1e-5)
        np.testing.assert_allclose(out[r]["band"], whole, atol=1e-5)


def test_grid_swinir_matches_jax_and_the_monolithic_forward(world4):
    _, out, ref = world4
    got = _stitch(out[0]["grid"], 1)
    jax_tiled, whole = ref["grid"]
    np.testing.assert_allclose(got, jax_tiled, atol=2e-5)
    np.testing.assert_allclose(got, whole, atol=2e-5)


def test_video_grid_matches_the_host_loop_and_the_jax_geometry(world4):
    _, out, ref = world4
    got = _stitch(out[0]["video"], 2)
    assert got.shape == (1, 2, 384, 384, 3)
    np.testing.assert_allclose(got, ref["video"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(_stitch(out[0]["geometry"], 2),
                               ref["geometry"], atol=1e-6)


def test_halo_exchange_rows_matches_jax(world4):
    _, out, ref = world4
    np.testing.assert_array_equal(np.concatenate(out[0]["halo_rows"], axis=1),
                                  ref["halo_rows"])


# ---------------------------------------------------------------------------
# launch and the CLIs' mesh rule, in this process
# ---------------------------------------------------------------------------

JAX_LISTS = ["node01", "node1,node2", "node[01-04]", "node[01-04,07],other[1-2]",
             "gpu-a[003-008]-ib", "host[7]"]


@pytest.mark.parametrize("nodelist", JAX_LISTS)
def test_first_slurm_hostname_matches_jax(nodelist):
    assert launch.first_slurm_hostname(nodelist) == \
        jlaunch.first_slurm_hostname(nodelist)


_name = st.text("abcxyz-", min_size=1, max_size=6)
_range = st.builds(lambda a, b, w: f"{a:0{w}d}-{a + b:0{w}d}",
                   st.integers(0, 50), st.integers(0, 9), st.integers(1, 3))
_entry = st.one_of(_name, st.builds(
    lambda p, rs, s: f"{p}[{','.join(rs)}]{s}", _name,
    st.lists(_range, min_size=1, max_size=3), st.text("-ib", max_size=3)))


@settings(max_examples=60, deadline=None, database=None)
@given(st.lists(_entry, min_size=1, max_size=3))
def test_first_slurm_hostname_matches_jax_on_drawn_lists(entries):
    nodelist = ",".join(entries)
    assert launch.first_slurm_hostname(nodelist) == \
        jlaunch.first_slurm_hostname(nodelist)


def test_data_parallel_mesh_rules():
    said = []
    batch = {"L": np.zeros((8, 4, 4, 1), np.float32), "path": ["a"] * 8}
    assert pm.data_parallel_mesh(1, 8, said.append, "cpu") is None
    assert pm.data_parallel_mesh(3, 8, said.append, "cpu") is None
    assert said == ["batch 8 not divisible by 3 devices; staying "
                    "single-device"]
    mesh = pm.data_parallel_mesh(4, 8, said.append, "cpu")
    assert mesh.shape == {"data": 4, "model": 1, "tile": 1}
    assert said[-1] == "data-parallel over 4 devices (2/device)"
    # rank r of n takes rows [r·B/n, (r+1)·B/n); one process keeps them all
    assert pm.shard_batch(pm.make_mesh(), batch) is batch
