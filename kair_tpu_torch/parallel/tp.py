"""Parameter sharding over the mesh's 'model' axis (counterpart of
``kair_tpu/parallel/tp.py``): the Megatron pairing's placements,
column-parallel qkv and fc1 (the output rows of torch's (out, in)
weights, dim 0), row-parallel proj and fc2 (the input columns, dim 1).
The rules match by parameter name, so they place the model's parameters,
the EMA copy's and (through the parameters) Adam's moments alike.

``shard_state`` stores each rank's shard as a ``torch.distributed.tensor``
DTensor and the module reads the whole weight at use (an all-gather whose
backward hands each rank its shard of the gradient): the parameters and
their optimizer state take 1/model of the memory, the compute does not
shrink. The port's block kernels take whole weights, so on the card a
model whose route runs one is refused before any work: tensor
parallelism runs on the plain route, on the CPU, as the JAX test runs it.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.nn.utils import parametrize

from kair_tpu_torch.parallel.mesh import Mesh

# (name regex, sharded dim) — first match wins; other parameters replicate.
# SwinIR's and VRT's attention (qkv, qkv_self, qkv_mut, attn.proj) and the
# MLPs' fc1 / fc2 (VRT's GEGLU fc11 / fc12 replicate, as in JAX).
TP_RULES: List[Tuple[str, int]] = [
    (r"(^|\.)qkv(_self|_mut)?\.weight$", 0),   # column-parallel
    (r"(^|\.)qkv(_self|_mut)?\.bias$", 0),
    (r"(^|\.)attn\.proj\.weight$", 1),         # row-parallel
    (r"(^|\.)fc1\.weight$", 0),                # column-parallel
    (r"(^|\.)fc1\.bias$", 0),
    (r"(^|\.)fc2\.weight$", 1),                # row-parallel
]


def tp_state_shardings(mesh: Mesh, state, rules: Sequence = None
                       ) -> Dict[str, object]:
    """{name: Shard(dim) or Replicate()} for a module's parameters or a
    {name: tensor} dict: the first matching rule's placement, replicated
    where no rule matches or where the dimension does not divide the
    'model' axis (JAX's GSPMD needs even shards; so does this)."""
    rules = list(rules if rules is not None else TP_RULES)
    n = mesh.shape.get("model", 1)
    named = dict(state.named_parameters()) if isinstance(
        state, torch.nn.Module) else dict(state)
    out = {}
    for name, t in named.items():
        place = Replicate()
        for pat, dim in rules:
            if re.search(pat, name):
                if dim < t.ndim and t.shape[dim] % n == 0:
                    place = Shard(dim)
                break
        out[name] = place
    return out


class _WholeWeight(torch.nn.Module):
    """The whole weight of a sharded parameter, gathered where it is read."""

    def forward(self, w):
        return w.full_tensor() if isinstance(w, DTensor) else w


def kernel_refusal(model: torch.nn.Module):
    """Why ``model`` cannot be sharded where it lies (None: it can): on
    the card its hand-written kernels take whole weights."""
    from kair_tpu_torch.train.trainer import bf16_only_route
    if not any(p.is_cuda for p in model.parameters()):
        return None
    where = bf16_only_route(model) or next(
        (f"{name} ({type(m).__name__}) runs {m.card_kernel()}"
         for name, m in model.named_modules() if hasattr(m, "card_kernel")),
        None)
    return None if where is None else (
        f"{where}, a kernel that takes whole weights; tensor parallelism "
        "runs on the plain route, on the CPU")


def shard_state(mesh: Mesh, model: torch.nn.Module, rules: Sequence = None
                ) -> Dict[str, object]:
    """Store every parameter a rule shards as this rank's DTensor shard
    over the mesh's 'model' axis (the module reads the whole weight at
    use); returns the placements. Rebuild the optimizer over
    ``model.parameters()`` afterwards."""
    from torch.distributed.device_mesh import DeviceMesh
    why = kernel_refusal(model)
    if why:
        raise NotImplementedError(f"tensor parallelism on the card: {why}")
    placements = tp_state_shardings(mesh, model, rules)
    dev = next(model.parameters()).device.type
    ranks = np.arange(int(np.prod(list(mesh.shape.values())))).reshape(
        tuple(mesh.shape.values()))
    dmesh = DeviceMesh(dev, torch.as_tensor(ranks),
                       mesh_dim_names=mesh.axis_names)["model"]
    for name, place in placements.items():
        if not isinstance(place, Shard):
            continue
        owner_name, attr = name.rsplit(".", 1)
        owner = model.get_submodule(owner_name)
        param = getattr(owner, attr)
        sharded = torch.nn.Parameter(DTensor.from_local(
            param.detach().chunk(mesh.shape["model"], place.dim)[
                mesh.index("model")].clone(), dmesh, [place]))
        parametrize.register_parametrization(owner, attr, _WholeWeight())
        owner.parametrizations[attr].original = sharded
    return placements
