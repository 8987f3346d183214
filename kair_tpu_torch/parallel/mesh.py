"""Meshes over the process group (counterpart of
``kair_tpu/parallel/mesh.py``; reference utils/utils_dist.py:13-200).

A :class:`Mesh` is a record of named axis sizes over the group's ranks,
rank r at the row-major coordinates of r (the JAX mesh's
``devices.reshape(data, model, tile)``):

  'data'  batch (data parallel: each rank's gradients are averaged over
          the axis between the backward and the optimizer step)
  'model' tensor parallel (``parallel/tp.py``)
  'tile'  spatial tiles of one image (``parallel/tiled.py``)

Without a process group the mesh has one rank and every collective here
is a no-op. JAX's XLA inserts the collectives itself; here they are
explicit: ``all_reduce_mean`` (the gradient psum), ``shard_batch`` (each
rank's rows of one seeded global batch), ``replicate_state`` (rank 0's
state broadcast), ``group_batchnorm`` (batch statistics over the axis, as
flax's BatchNorm takes them over the sharded global batch) and
``batch_mean`` (a differentiable mean over the global batch).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class Mesh:
    """Named axis sizes over the group's ranks, with one process group per
    axis that spans some but not all of them (the world group for an axis
    that spans every rank)."""

    def __init__(self, axes: Dict[str, int]):
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)
        self._groups: Dict[str, object] = {}
        world = math.prod(self.shape.values())
        if not dist.is_initialized() or world == 1:
            return
        if world != _world():
            raise ValueError(f"mesh {self.shape} over {_world()} ranks")
        grid = np.arange(world).reshape(tuple(self.shape.values()))
        for i, name in enumerate(self.axis_names):
            if 1 < self.shape[name] < world:
                lines = np.moveaxis(grid, i, -1).reshape(-1, self.shape[name])
                for ranks in lines:        # every rank makes every group
                    g = dist.new_group([int(r) for r in ranks])
                    if _rank() in ranks:
                        self._groups[name] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def __deepcopy__(self, memo):
        return self            # process groups are not copied with a model

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """A rank's index along each axis (this rank's by default)."""
        idx = np.unravel_index(_rank() if rank is None else rank,
                               tuple(self.shape.values()))
        return {n: int(i) for n, i in zip(self.axis_names, idx)}

    def index(self, axis: str) -> int:
        return self.coords()[axis]

    def rank_at(self, **coords: int) -> int:
        """The global rank at this rank's coordinates with ``coords``
        changed."""
        c = dict(self.coords(), **coords)
        return int(np.ravel_multi_index(tuple(c[n] for n in self.axis_names),
                                        tuple(self.shape.values())))

    def group(self, axis: str):
        """The process group along ``axis`` (None: the world group)."""
        return self._groups.get(axis)


def make_mesh(data: Optional[int] = None, tile: int = 1, model: int = 1
              ) -> Mesh:
    """A ('data', 'model', 'tile') mesh over the group's ranks (one rank
    without a group); 'data' defaults to what the other axes leave."""
    n = _world()
    if data is None:
        data = n // (tile * model)
    if data * tile * model != n:
        raise ValueError(f"mesh {data}x{model}x{tile} != {n} ranks")
    return Mesh({"data": data, "model": model, "tile": tile})


def make_grid_mesh(tileh: int, tilew: int) -> Mesh:
    """2-D spatial tile-grid mesh for ``parallel.tiled``'s grid-sharded
    forwards: axes ('tileh', 'tilew')."""
    if tileh * tilew != _world():
        raise ValueError(f"grid {tileh}x{tilew} != {_world()} ranks")
    return Mesh({"tileh": tileh, "tilew": tilew})


def _batch_rows(mesh: Mesh):
    """This rank's share of the batch axis (data x tile, as JAX's
    ``batch_sharding`` P(('data', 'tile'))): (index, count)."""
    c = mesh.coords()
    tile = mesh.shape.get("tile", 1)
    return c.get("data", 0) * tile + c.get("tile", 0), \
        mesh.shape.get("data", 1) * tile


def shard_rows(mesh: Mesh, t):
    """This rank's rows of an array or tensor drawn for the global batch:
    rank r of n takes rows [r·B/n, (r+1)·B/n)."""
    i, n = _batch_rows(mesh)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows over {n} ranks")
    b = t.shape[0] // n
    return t[i * b:(i + 1) * b]


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of every array of a global batch (the JAX
    ``shard_batch`` of one seeded global batch); other values pass as
    they are."""
    if _batch_rows(mesh)[1] == 1:
        return batch
    return {k: shard_rows(mesh, v) if getattr(v, "ndim", 0) >= 1 else v
            for k, v in batch.items()}


def _collective_tensor(t: torch.Tensor) -> torch.Tensor:
    """NCCL takes device tensors only; a CPU tensor (Adam's step count)
    goes through the card."""
    if dist.get_backend() == "nccl" and t.device.type == "cpu":
        return t.to(torch.device("cuda", torch.cuda.current_device()))
    return t


def _buckets(tensors: Iterable[torch.Tensor]) -> List[List[torch.Tensor]]:
    """The tensors grouped by dtype and device, for one collective each."""
    out: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return list(out.values())


def _unflatten(flat: torch.Tensor, ts: List[torch.Tensor]) -> None:
    flat = flat.to(ts[0].device)
    off = 0
    for t in ts:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def replicate_state(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Broadcast rank 0's tensors (parameters, buffers, optimizer state)
    to every rank, in place: one broadcast a dtype and device."""
    if _world() == 1:
        return
    for ts in _buckets(tensors):
        flat = _collective_tensor(torch.cat([t.reshape(-1) for t in ts]))
        dist.broadcast(flat, src=0)
        _unflatten(flat, ts)


@torch.no_grad()
def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor],
                    axis: str = "data") -> None:
    """Average ``tensors`` over the ranks of ``axis`` in place: one
    all-reduce a dtype and device, of the tensors flattened into one
    buffer (the gradient psum of the JAX data-parallel step). Nothing
    without a process group, or where the axis is this rank alone among
    several; a group of one rank reduces over itself."""
    n = mesh.shape.get(axis, 1)
    if not dist.is_initialized() or (n == 1 and _world() > 1):
        return
    for ts in _buckets(tensors):
        flat = _collective_tensor(torch.cat([t.reshape(-1) for t in ts]))
        dist.all_reduce(flat, group=mesh.group(axis))
        _unflatten(flat.div_(n), ts)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) whose backward sums the cotangents of every rank
    (itself an all-reduce, so it differentiates twice: R1 through a D with
    BatchNorm): the gradient of a term that every rank's loss reads."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = _collective_tensor(t.clone())
        dist.all_reduce(out, group=group)
        return out.to(t.device)

    @staticmethod
    def backward(ctx, grad):
        return _SumOver.apply(grad, ctx.group), None


def _sum_over(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    return _SumOver.apply(t, mesh.group(axis))


def batch_mean(mesh: Optional[Mesh], t: torch.Tensor, axis: str = "data"
               ) -> torch.Tensor:
    """``t.mean(0, keepdim=True)`` over the global batch (ragan's other
    side's mean), differentiable."""
    n = 1 if mesh is None else mesh.shape.get(axis, 1)
    if n == 1:
        return t.mean(0, keepdim=True)
    return _sum_over(mesh, t.sum(0, keepdim=True), axis) / (t.shape[0] * n)


class GroupBatchNorm(torch.nn.BatchNorm2d):
    """BatchNorm whose training-mode statistics are those of the global
    batch: each rank's per-channel sum and sum of squares all-reduced over
    the 'data' axis (flax's BatchNorm under the JAX mesh; ``nn.SyncBatchNorm``
    refuses CPU tensors). The running variance takes the unbiased global
    variance, as a single process does. ``channel_dim`` is 1 for NCHW, -1
    for the port's NHWC ``ops.blocks.BatchNorm``."""

    mesh: Mesh
    channel_dim = 1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c_dim = self.channel_dim % x.ndim
        if not self.training:
            if c_dim == 1:
                return super().forward(x)
            return super().forward(x.movedim(c_dim, 1)).movedim(1, c_dim)
        dims = [d for d in range(x.ndim) if d != c_dim]
        xf = x.float()
        count = torch.tensor([float(x.numel() // x.shape[c_dim])],
                             device=x.device)
        stats = _sum_over(self.mesh, torch.cat(
            [xf.sum(dims), (xf * xf).sum(dims), count]), "data")
        c = x.shape[c_dim]
        n = stats[-1]
        mean = stats[:c] / n
        var = stats[c:2 * c] / n - mean * mean
        with torch.no_grad():
            if self.track_running_stats:
                self.num_batches_tracked.add_(1)
                m = self.momentum if self.momentum is not None \
                    else 1.0 / float(self.num_batches_tracked)
                self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
                self.running_var.mul_(1 - m).add_(
                    var.detach() * n / (n - 1), alpha=m)
        shape = [1] * x.ndim
        shape[c_dim] = c
        y = (xf - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


def group_batchnorm(model: torch.nn.Module, mesh: Mesh) -> int:
    """Give every BatchNorm2d of ``model`` the global batch's statistics
    over the mesh's 'data' axis (the module keeps its parameters, buffers
    and state-dict keys); returns how many it changed."""
    from kair_tpu_torch.ops.blocks import BatchNorm as NHWCBatchNorm
    if mesh.shape.get("data", 1) == 1:
        return 0
    count = 0
    for m in model.modules():
        if type(m) is torch.nn.BatchNorm2d:
            m.__class__ = GroupBatchNorm
        elif type(m) is NHWCBatchNorm:
            m.__class__ = _NHWCGroupBatchNorm
        else:
            continue
        m.mesh = mesh
        count += 1
    return count


class _NHWCGroupBatchNorm(GroupBatchNorm):
    channel_dim = -1


def data_parallel_mesh(n_requested: int, batch_size: int, log=None,
                       device=None) -> Optional[Mesh]:
    """The training CLIs' mesh (the reference's torchrun + DDP entry,
    main_train_psnr.py:36-60) for a global batch of ``batch_size`` rows
    (the JAX function reads it from the first batch; the CLIs give the
    option file's, so no loader is built before the ranks are). In a
    process group (``launch.spawn``, torchrun, SLURM) the group is the
    'data' axis, and the batch must divide it. Without one, ``gpu_ids``
    with several entries asks for a ('data',) mesh of n = min(requested,
    what exists) ranks, for the caller to spawn:
    ``torch.cuda.device_count()`` cards on the card, the requested count
    on the CPU; a single process (None) when n ≤ 1 or the batch does not
    divide n, loudly."""
    say = log or (lambda *_: None)
    bs0 = int(batch_size)
    if dist.is_initialized():
        n = _world()
        if n == 1:
            return None
        if bs0 % n:
            raise ValueError(f"batch {bs0} not divisible by the group's {n} "
                             "ranks")
        say(f"data-parallel over {n} ranks ({bs0 // n}/rank)")
        return make_mesh(data=n)
    available = torch.cuda.device_count() \
        if torch.device(device or "cuda").type == "cuda" \
        else int(n_requested or 1)
    n_dev = min(int(n_requested or 1), available)
    if n_dev <= 1:
        return None
    if bs0 % n_dev:
        say(f"batch {bs0} not divisible by {n_dev} devices; "
            "staying single-device")
        return None
    say(f"data-parallel over {n_dev} devices ({bs0 // n_dev}/device)")
    return Mesh({"data": n_dev, "model": 1, "tile": 1})
