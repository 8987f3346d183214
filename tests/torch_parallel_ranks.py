"""What the spawned ranks of ``tests/test_torch_parallel.py`` run: torch
and the port only (no JAX), so that each rank starts in seconds. Each
function takes the test's inputs (numpy arrays and state dicts, pickled)
and returns numpy results for the test to hold against the JAX package and
the port's single process."""

import torch
import torch.distributed as dist

from kair_tpu_torch.parallel import mesh as pm
from kair_tpu_torch.parallel import tiled


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters()
            if p.grad is not None}


def trainer_from(case: dict, device="cpu"):
    from kair_tpu_torch.train.select import define_trainer
    torch.manual_seed(0)
    t = define_trainer(case["opt"], dtype=torch.float32, device=device)
    t.model.load_state_dict(case["G"])
    if case.get("D") is not None:
        t.model_d.load_state_dict(case["D"])
    if t.ema is not None:
        t.ema.load_state_dict(case["G"])
    return t


def step_result(t, metrics) -> dict:
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": _grads(t.model),
           "G": {k: _np(v) for k, v in t.model.state_dict().items()}}
    if hasattr(t, "model_d"):
        out["D"] = {k: _np(v) for k, v in t.model_d.state_dict().items()}
        out["D_grads"] = _grads(t.model_d)
    out["moments"] = {n: _np(t.optimizer.state[p]["exp_avg"])
                      for n, p in t.model.named_parameters()
                      if p in t.optimizer.state}
    return out


def data_parallel_step(case: dict) -> dict:
    """One ``train_step`` of the case's trainer on this rank's rows of the
    global batch, under a ('data',) mesh over the group."""
    mesh = pm.make_mesh(data=dist.get_world_size())
    t = trainer_from(case)
    t.use_mesh(mesh)
    kw = {"update_g": True} if hasattr(t, "model_d") else {}
    return step_result(t, t.train_step(pm.shard_batch(mesh, case["batch"]),
                                       **kw))


def local_grads(case: dict) -> dict:
    """The control: this rank's gradient on its rows, not averaged."""
    mesh = pm.make_mesh(data=dist.get_world_size())
    t = trainer_from(case)
    t.compute_grads(pm.shard_batch(mesh, case["batch"]))
    return _grads(t.model)


def tensor_parallel_step(case: dict) -> dict:
    """One SwinIR step with its attention and MLP weights stored as
    shards over a ('model',) mesh of the group's ranks."""
    from kair_tpu_torch.parallel.tp import shard_state
    from kair_tpu_torch.train.trainer import build_optimizer
    mesh = pm.make_mesh(data=1, model=dist.get_world_size())
    t = trainer_from(case)
    placements = shard_state(mesh, t.model)
    shard_state(mesh, t.ema)
    t.optimizer = build_optimizer(t.model.parameters(), t.opt_train)
    loss = float(t.train_step(case["batch"])["G_loss"])
    local = {n: tuple(p.to_local().shape) for n, p in t.model.named_parameters()
             if hasattr(p, "to_local")}
    full = {n: _np(p.full_tensor() if hasattr(p, "full_tensor") else p)
            for n, p in t.model.named_parameters()}
    ema = {n: _np(p.full_tensor() if hasattr(p, "full_tensor") else p)
           for n, p in t.ema.named_parameters()}
    return {"loss": loss, "params": full, "ema": ema, "local": local,
            "sharded": sorted(n for n, p in placements.items()
                              if type(p).__name__ == "Shard")}


def world2(cases: dict) -> dict:
    torch.set_num_threads(1)
    return {"dp_R": data_parallel_step(cases["dp_R"]),
            "dp_R_local": local_grads(cases["dp_R"]),
            "dp_BR": data_parallel_step(cases["dp_BR"]),
            "gan": data_parallel_step(cases["gan"]),
            "video": data_parallel_step(cases["video"]),
            "tp": tensor_parallel_step(cases["tp"])}


def _model(kind: str, cfg: dict, sd: dict):
    if kind == "vrt":
        from kair_tpu_torch.models.vrt import VRT
        m = VRT(**cfg)
    else:
        from kair_tpu_torch.models.registry import define_g
        m = define_g({"netG": cfg})
    m.load_state_dict(sd)
    return m.eval()


def world4(cases: dict) -> dict:
    """The tiled forwards on 4 ranks; every rank's tiles gathered."""
    torch.set_num_threads(1)
    out = {}
    with torch.no_grad():
        c = cases["band"]
        m = _model("g", c["net"], c["sd"])
        mesh = pm.make_mesh(data=1, tile=4)
        fn = tiled.make_sharded_tiled_fn(m, mesh, halo=c["halo"], sf=c["sf"])
        out["band"] = _np(fn(torch.from_numpy(c["x"])))

        mesh = pm.make_grid_mesh(2, 2)
        for name, hdim, kind in (("grid", 1, "g"), ("video", 2, "vrt"),
                                 ("geometry", 2, None)):
            c = cases[name]
            fn = c["fn"] if kind is None else _model(kind, c["net"], c["sd"])
            make = (tiled.make_grid_sharded_fn if hdim == 1
                    else tiled.make_grid_sharded_video_fn)
            mine = make(fn, mesh, halo=c["halo"], sf=c["sf"])(
                tiled.grid_tile(mesh, torch.from_numpy(c["x"]), hdim=hdim))
            parts = [torch.empty_like(mine) for _ in range(4)]
            dist.all_gather(parts, mine.contiguous())
            out[name] = [_np(p) for p in parts]

        x = torch.from_numpy(cases["halo_rows"])
        mesh = pm.make_mesh(data=1, tile=4)
        rows = x.shape[1] // 4
        mine = x[:, mesh.index("tile") * rows:(mesh.index("tile") + 1) * rows]
        ext = tiled.halo_exchange_rows(mine, 2, mesh)
        parts = [torch.empty_like(ext) for _ in range(4)]
        dist.all_gather(parts, ext.contiguous())
        out["halo_rows"] = [_np(p) for p in parts]
    return out


def geometry_fn(win: torch.Tensor) -> torch.Tensor:
    """A cheap per-window function whose output shows where its window
    lay: each pixel plus the window's mean and its first row's."""
    return win * 2.0 + win.mean(dim=(2, 3), keepdim=True) \
        + win[:, :, :1].mean(dim=3, keepdim=True)
