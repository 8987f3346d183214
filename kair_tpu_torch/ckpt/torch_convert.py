"""Checkpoint loading for the port (counterpart of
``kair_tpu/ckpt/torch_convert.py``).

The port's modules carry KAIR's key names and layouts, so a released
``.pth`` loads with ``load_state_dict`` as it is; no conversion is needed in
that direction. ``swinir_from_jax`` goes the other way: it turns a JAX
SwinIR parameter tree (numpy leaves, the output of ``convert_swinir`` :353)
back into a KAIR state dict, so JAX parameters can be carried across.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from kair_tpu_torch.ops.window_attention import (relative_position_index,
                                                  shift_attn_mask)


def load_torch_state_dict(path: str, param_key: Optional[str] = None,
                          allow_pickle: bool = False) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint into a plain {name: np.ndarray} dict.

    weights_only=True by default: zoo checkpoints come from external URLs
    and a pickled ``.pth`` can execute arbitrary code on load. Pass
    allow_pickle=True only for trusted local files that need it."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except (OSError, EOFError):
        raise                      # missing/corrupt file — not a pickle issue
    except Exception as e:
        if not allow_pickle:
            raise RuntimeError(
                f"{path} is not a plain-tensor checkpoint (weights_only "
                "load failed). If the file is trusted, retry with "
                "allow_pickle=True — unpickling executes arbitrary "
                "code.") from e
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if param_key is not None and param_key in sd:
        sd = sd[param_key]
    elif isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in sd.items()}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))          # a copy: leaves may be shared


def _conv(sd: Dict[str, torch.Tensor], name: str, leaf: Dict[str, Any]) -> None:
    """flax HWIO kernel → torch OIHW weight."""
    sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in leaf:
        sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]))


def _ln(sd: Dict[str, torch.Tensor], name: str, leaf: Dict[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(leaf["scale"]))
    sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]))


def _dense(sd: Dict[str, torch.Tensor], name: str, leaf: Dict[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).T)
    sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]))


def _indexed(tree: Dict[str, Any], prefix: str):
    """[(i, subtree)] for keys prefix0, prefix1, … in numeric order."""
    items = [(int(m.group(1)), v) for k, v in tree.items()
             if (m := re.fullmatch(prefix + r"(\d+)", k))]
    return sorted(items, key=lambda kv: kv[0])


def _unflatten_fused_block(blk: Dict[str, Any]) -> Dict[str, Any]:
    """A fuse_block=True block (norm1_scale, fc1_kernel, …) in the standard
    nesting (norm1/{scale,bias}, fc1/{kernel,bias}, …): the inverse of
    ``kair_tpu.models.swinir.fused_block_params``."""
    out = {k: v for k, v in blk.items()
           if not k.startswith(("norm1_", "norm2_", "fc1_", "fc2_"))}
    for n in ("norm1", "norm2"):
        out[n] = {"scale": blk[f"{n}_scale"], "bias": blk[f"{n}_bias"]}
    for n in ("fc1", "fc2"):
        out[n] = {"kernel": blk[f"{n}_kernel"], "bias": blk[f"{n}_bias"]}
    return out


def swinir_from_jax(variables: Dict[str, Any], img_size: int = 64,
                    window_size: int = 8) -> Dict[str, torch.Tensor]:
    """Inverse of ``kair_tpu.ckpt.torch_convert.convert_swinir``: a JAX
    SwinIR parameter tree, in the standard layout or the fuse_block=True one
    that the JAX trainer builds, → KAIR state dict,
    including the ``relative_position_index`` and ``attn_mask`` buffers a
    KAIR model built with ``img_size`` holds. Supports the 1conv residual
    and the pixelshuffle, pixelshuffledirect and denoise heads."""
    p = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_first", p["conv_first"]["conv"])
    if "patch_norm" in p:
        _ln(sd, "patch_embed.norm", p["patch_norm"])
    if "absolute_pos_embed" in p:
        a = np.asarray(p["absolute_pos_embed"])
        sd["absolute_pos_embed"] = _t(a.reshape(1, -1, a.shape[-1]))
    ws, shift = window_size, window_size // 2
    if img_size <= window_size:
        ws, shift = img_size, 0
    for il, layer in _indexed(p, "layer"):
        for j, blk in _indexed(layer, "blk"):
            pre = f"layers.{il}.residual_group.blocks.{j}"
            if j % 2 == 1 and shift > 0:
                sd[f"{pre}.attn_mask"] = _t(shift_attn_mask(img_size, img_size,
                                                            ws, shift))
            if "norm1_scale" in blk:
                # fuse_block=True layout (kair_tpu/models/swinir.py:94-105):
                # LN and MLP parameters flat under the block
                blk = _unflatten_fused_block(blk)
            _ln(sd, f"{pre}.norm1", blk["norm1"])
            sd[f"{pre}.attn.relative_position_bias_table"] = _t(
                np.asarray(blk["rel_bias_table"]))
            sd[f"{pre}.attn.relative_position_index"] = _t(
                relative_position_index(ws, ws).astype(np.int64))
            sd[f"{pre}.attn.qkv.weight"] = _t(np.asarray(blk["qkv_kernel"]).T)
            if "qkv_bias" in blk:
                sd[f"{pre}.attn.qkv.bias"] = _t(np.asarray(blk["qkv_bias"]))
            sd[f"{pre}.attn.proj.weight"] = _t(np.asarray(blk["proj_kernel"]).T)
            sd[f"{pre}.attn.proj.bias"] = _t(np.asarray(blk["proj_bias"]))
            _ln(sd, f"{pre}.norm2", blk["norm2"])
            _dense(sd, f"{pre}.mlp.fc1", blk["fc1"])
            _dense(sd, f"{pre}.mlp.fc2", blk["fc2"])
        if "conv" not in layer:
            raise NotImplementedError("only resi_connection='1conv' is ported")
        _conv(sd, f"layers.{il}.conv", layer["conv"]["conv"])
    _ln(sd, "norm", p["norm"])
    _conv(sd, "conv_after_body", p["conv_after_body"]["conv"])
    if "conv_before_upsample" in p:                  # pixelshuffle
        _conv(sd, "conv_before_upsample.0", p["conv_before_upsample"]["conv"])
        for i, up in _indexed(p, "upsample"):
            _conv(sd, f"upsample.{2 * i}", up["conv"])
        _conv(sd, "conv_last", p["conv_last"]["conv"])
    elif "upsample_direct" in p:                     # pixelshuffledirect
        _conv(sd, "upsample.0", p["upsample_direct"]["conv"])
    else:                                            # denoise / JPEG CAR
        _conv(sd, "conv_last", p["conv_last"]["conv"])
    return sd
