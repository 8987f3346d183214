"""Config / option system (counterpart of ``kair_tpu/config.py``; pure
Python, copied so that the port needs nothing of the JAX package).

Re-implements the semantics of the reference option layer
(`utils/utils_option.py:24-296` in KAIR): JSON with ``//`` comments,
defaults injection, per-dataset broadcast of top-level fields, derived
output directories, ``max_iter`` from ``max_epoch``, scheduler milestones
from percentages, perceptual-loss / optimizer / EMA / discriminator
defaults, a ``NoneDict`` view where missing keys read as ``None``, and a
timestamped resolved-config snapshot.

Differences from the reference (the same as the JAX package's):

* no ``CUDA_VISIBLE_DEVICES`` mutation (`utils_option.py:94-96`); the
  ``gpu_ids`` key is accepted and exposed as ``num_gpu``.
* checkpoint discovery understands the reference's ``{iter}_{tag}.pth``
  files (the port's own format) and the JAX package's ``.ckpt`` names.
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
from datetime import datetime
from typing import Any, Optional


class NoneDict(dict):
    """dict whose missing keys read as None (reference: utils_option.py:294)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt: Any) -> Any:
    """Recursively wrap dicts as NoneDict (reference: utils_option.py:282-291)."""
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def load_json_with_comments(path: str) -> dict:
    """Read JSON where everything after ``//`` on a line is a comment
    (reference: utils_option.py:29-38)."""
    lines = []
    with open(path, "r") as f:
        for line in f:
            lines.append(line.split("//")[0])
    return json.loads("\n".join(lines))


def get_timestamp() -> str:
    return datetime.now().strftime("_%y%m%d_%H%M%S")


def parse(opt_path: str, is_train: bool = True) -> NoneDict:
    """Parse an option file into a fully-defaulted NoneDict tree.

    Mirrors reference `utils_option.py:24-210` behaviour minus env-var side
    effects. The returned tree is already NoneDict-wrapped (the reference
    applies ``dict_to_nonedict`` at the call sites, e.g.
    `main_train_psnr.py:85`); we fold it in here since every consumer wants
    it.
    """
    opt = load_json_with_comments(opt_path)

    opt["opt_path"] = opt_path
    opt["is_train"] = is_train

    # defaults (reference :46-51)
    opt.setdefault("merge_bn", False)
    opt.setdefault("merge_bn_startpoint", -1)
    opt.setdefault("scale", 1)

    # dataset broadcast (reference :56-66)
    for phase, dataset in opt.get("datasets", {}).items():
        dataset["phase"] = phase.split("_")[0]
        dataset["scale"] = opt["scale"]
        for key in ("n_channels", "speed", "normalization"):
            if key in opt:
                dataset[key] = opt[key]
        for key in ("dataroot_H", "dataroot_L"):
            if dataset.get(key):
                dataset[key] = os.path.expanduser(dataset[key])

    # paths (reference :71-84)
    paths = opt.setdefault("path", {})
    for key, path in list(paths.items()):
        if path:
            paths[key] = os.path.expanduser(path)
    path_task = os.path.join(paths.get("root", "."), opt.get("task", "task"))
    paths["task"] = path_task
    paths["log"] = path_task
    paths["options"] = os.path.join(path_task, "options")
    if is_train:
        paths["models"] = os.path.join(path_task, "models")
        paths["images"] = os.path.join(path_task, "images")
    else:
        paths["images"] = os.path.join(path_task, "test_images")

    # network (reference :89)
    if "netG" in opt:
        opt["netG"]["scale"] = opt.get("scale", 1)

    # devices: expose count, do NOT mutate the environment (reference :94-96)
    opt["num_gpu"] = len(opt.get("gpu_ids", []) or [])
    opt.setdefault("find_unused_parameters", False)
    opt.setdefault("use_static_graph", False)
    opt.setdefault("dist", False)

    train = opt.setdefault("train", {})
    if is_train:
        # max_iter from max_epoch (fork addition, reference :113-135)
        if train.get("max_epoch") is not None:
            ds_train = opt.get("datasets", {}).get("train", {})
            if all(k in ds_train for k in ("start_index", "end_index", "dataloader_batch_size")):
                n_items = ds_train["end_index"] - ds_train["start_index"]
                bs = ds_train["dataloader_batch_size"]
                if bs and bs > 0:
                    train["max_iter"] = math.ceil(n_items / bs) * train["max_epoch"]
        # milestones from percentages (fork addition, reference :138-146)
        if train.get("G_scheduler_milestones_percent") is not None and train.get("max_iter") is not None:
            train["G_scheduler_milestones"] = [
                int(p * train["max_iter"]) for p in train["G_scheduler_milestones_percent"]
            ]

    # perceptual-loss defaults (reference :151-160)
    train.setdefault("F_feature_layer", 34)
    train.setdefault("F_weights", 1.0)
    train.setdefault("F_lossfn_type", "l1")
    train.setdefault("F_use_input_norm", True)
    train.setdefault("F_use_range_norm", False)

    # optimizer defaults (reference :165-176)
    train.setdefault("G_optimizer_type", "adam")
    train.setdefault("G_optimizer_betas", [0.9, 0.999])
    train.setdefault("G_scheduler_restart_weights", 1)
    train.setdefault("G_optimizer_wd", 0)
    train.setdefault("G_optimizer_reuse", False)
    if "netD" in opt:
        train.setdefault("D_optimizer_reuse", False)

    # strict-loading defaults (reference :181-186)
    train.setdefault("G_param_strict", True)
    train.setdefault("E_param_strict", True)
    if "netD" in opt:
        train.setdefault("D_param_strict", True)

    # EMA default (reference :191-192)
    train.setdefault("E_decay", 0)

    # discriminator defaults (reference :197-207)
    if "netD" in opt:
        netd = opt["netD"]
        netd.setdefault("net_type", "discriminator_patchgan")
        netd.setdefault("in_nc", 3)
        netd.setdefault("base_nc", 64)
        netd.setdefault("n_layers", 3)
        netd.setdefault("norm_type", "spectral")

    return dict_to_nonedict(opt)


_CKPT_EXTS = ("pth", "ckpt", "msgpack", "npz")


def find_last_checkpoint(save_dir: str, net_type: str = "G",
                         pretrained_path: Optional[str] = None):
    """Scan ``save_dir`` for ``{iter}_{net_type}.<ext>`` and return
    ``(init_iter, init_path)`` for the largest iter (reference:
    utils_option.py:213-235). Falls back to ``pretrained_path`` at iter 0.
    """
    best_iter, best_path = 0, pretrained_path
    for ext in _CKPT_EXTS:
        for file_ in glob.glob(os.path.join(save_dir, f"*_{net_type}.{ext}")):
            m = re.findall(rf"(\d+)_{net_type}\.{ext}", file_)
            if m and int(m[0]) >= best_iter:
                best_iter = int(m[0])
                best_path = os.path.join(save_dir, f"{best_iter}_{net_type}.{ext}")
    return best_iter, best_path


def save(opt: dict) -> str:
    """Snapshot the resolved config with a timestamp into the task options
    dir (reference: utils_option.py:245-252). Returns the dump path."""
    opt_path = opt["opt_path"]
    dump_dir = opt["path"]["options"]
    os.makedirs(dump_dir, exist_ok=True)
    filename, ext = os.path.splitext(os.path.basename(opt_path))
    dump_path = os.path.join(dump_dir, filename + get_timestamp() + ext)
    with open(dump_path, "w") as f:
        json.dump(opt, f, indent=2)
    return dump_path


def dict2str(opt: dict, indent_l: int = 1) -> str:
    """Pretty printer for logging (reference: utils_option.py:262-271)."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg
