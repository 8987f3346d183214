"""Tagged checkpoints with KAIR's names (counterpart of
``kair_tpu/ckpt/checkpoint.py``; reference model_base.py:158-245).

Each file is one plain torch state dict: ``{iter}_G.pth`` loads with
``load_state_dict`` (and with ``cli.test``), as KAIR's own do, and
``config.find_last_checkpoint`` finds the newest. Writes go to a temporary
name and are moved into place with ``os.replace``, so a killed run never
leaves a half-written checkpoint. ``prune_old`` and ``save_best`` are the
fork's rolling retention (model_plain.py:149-176) and best-model tracking
(model_base.py:170-196). In a process group rank 0 alone writes: another
rank's write raises, since two ranks writing one file would race.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict

import torch


def save_state(state: Dict[str, Any], path: str) -> str:
    if torch.distributed.is_initialized() and torch.distributed.get_rank():
        raise RuntimeError(f"rank {torch.distributed.get_rank()} writing "
                           f"{path}: only rank 0 writes checkpoints")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load(path: str, map_location=None) -> Dict[str, Any]:
    """A state dict written by ``save_state`` (tensors and plain values
    only, so weights_only loading is enough)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def save_tagged(save_dir: str, step: int, tag: str, state: Dict[str, Any]) -> str:
    """Save ``{step}_{tag}.pth`` (reference naming: model_base.py:158)."""
    return save_state(state, os.path.join(save_dir, f"{step}_{tag}.pth"))


def prune_old(save_dir: str, tag: str, keep_step: int) -> None:
    """Delete every ``*_{tag}.pth`` but ``keep_step``'s."""
    for f in glob.glob(os.path.join(save_dir, f"*_{tag}.pth")):
        m = re.fullmatch(rf"(\d+)_{tag}\.pth", os.path.basename(f))
        if m and int(m.group(1)) != keep_step:
            os.remove(f)


def save_best(save_dir: str, metric_name: str, tag: str,
              state: Dict[str, Any]) -> str:
    """Save ``bestmodel/best_{metric}_{tag}.pth``, replacing the previous
    best."""
    return save_state(state, os.path.join(save_dir, "bestmodel",
                                          f"best_{metric_name}_{tag}.pth"))
