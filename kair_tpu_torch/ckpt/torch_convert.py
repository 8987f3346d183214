"""Checkpoint loading for the port (counterpart of
``kair_tpu/ckpt/torch_convert.py``).

The port's modules carry KAIR's key names and layouts, so a released
``.pth`` loads with ``load_state_dict`` as it is; no conversion is needed in
that direction. ``swinir_from_jax``, ``vrt_from_jax``, ``rvrt_from_jax``
and ``spynet_from_jax`` go the other way: they turn a JAX parameter tree
(numpy leaves, the output of ``convert_swinir`` :353, ``convert_vrt`` :486,
``convert_rvrt`` :602 or ``convert_spynet`` :426, or a tree the JAX package
initialised) back into a KAIR state dict, so JAX parameters can be carried
across. The CNN zoo's ``dncnn_from_jax`` … ``usrnet_from_jax`` invert
``convert_dncnn`` … ``convert_usrnet`` (:94-345) the same way, and
``block_from_jax`` carries the blocks no model builds (CALayer, RCABlock,
RCAGroup, ESA, CFRB, NonLocalBlock2D) across. The GAN and face slice's
``discriminator_from_jax`` (parameters, spectral vectors, BatchNorm
statistics), ``vgg19_from_jax``, ``stylegan_from_jax``, ``gpen_from_jax``
(inverse of ``convert_gpen`` :681) and ``retinaface_from_jax`` (of
``convert_retinaface`` :724) complete the set.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from kair_tpu_torch.ops.window3d import (rel_position_index_3d,
                                         sine_position_encoding)
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
    KAIR model built with ``img_size`` holds. Supports the 1conv and 3conv
    residuals and the pixelshuffle, pixelshuffledirect, nearest+conv and
    denoise heads."""
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
        if "conv" in layer:                          # 1conv
            _conv(sd, f"layers.{il}.conv", layer["conv"]["conv"])
        else:                                        # 3conv: Sequential 0/2/4
            for i, nm in enumerate(("conv_a", "conv_b", "conv_c")):
                _conv(sd, f"layers.{il}.conv.{2 * i}", layer[nm]["conv"])
    _ln(sd, "norm", p["norm"])
    if "conv_after_body" in p:
        _conv(sd, "conv_after_body", p["conv_after_body"]["conv"])
    else:
        for i, nm in enumerate(("cab_a", "cab_b", "cab_c")):
            _conv(sd, f"conv_after_body.{2 * i}", p[nm]["conv"])
    if "conv_up1" in p:                              # nearest+conv
        _conv(sd, "conv_before_upsample.0", p["conv_before_upsample"]["conv"])
        for nm in ("conv_up1", "conv_up2", "conv_hr", "conv_last"):
            _conv(sd, nm, p[nm]["conv"])
    elif "conv_before_upsample" in p:                # pixelshuffle
        _conv(sd, "conv_before_upsample.0", p["conv_before_upsample"]["conv"])
        for i, up in _indexed(p, "upsample"):
            _conv(sd, f"upsample.{2 * i}", up["conv"])
        _conv(sd, "conv_last", p["conv_last"]["conv"])
    elif "upsample_direct" in p:                     # pixelshuffledirect
        _conv(sd, "upsample.0", p["upsample_direct"]["conv"])
    else:                                            # denoise / JPEG CAR
        _conv(sd, "conv_last", p["conv_last"]["conv"])
    return sd


# ---------------------------------------------------------------------------
# SpyNet and VRT
# ---------------------------------------------------------------------------

def _conv3d(sd: Dict[str, torch.Tensor], name: str, leaf: Dict[str, Any]) -> None:
    """flax HWIO kernel of a per-frame conv → KAIR's Conv3d (O, I, 1, kh, kw)."""
    sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)[
        :, :, None])
    sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]))


def spynet_from_jax(variables: Dict[str, Any], prefix: str = ""
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_spynet``: ``basic{i}/conv{j}`` →
    ``basic_module.{i}.basic_module.{2j}``, with the mean/std buffers."""
    p = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {
        f"{prefix}mean": torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1),
        f"{prefix}std": torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)}
    for i in range(6):
        for j in range(5):
            _conv(sd, f"{prefix}basic_module.{i}.basic_module.{2 * j}",
                  p[f"basic{i}"][f"conv{j}"]["conv"])
    return sd


def _index_tree(tree: Any, i: int) -> Any:
    """Leaf i along the leading (scan) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _tmsag_blocks(group: Dict[str, Any]):
    """A JAX TMSAG subtree → its blocks in order: the scanned ``pairs/{a,b}``
    (leaves stacked over depth/2) unstacked into blocks 2i and 2i+1, or the
    per-block ``blk{j}`` of an odd depth."""
    if "pairs" in group:
        a, b = group["pairs"]["a"], group["pairs"]["b"]
        n = np.asarray(a["norm1"]["scale"]).shape[0]
        out = []
        for i in range(n):
            out += [_index_tree(a, i), _index_tree(b, i)]
        return out
    return [v for _, v in _indexed(group, "blk")]


def _vrt_group(sd, pre: str, group: Dict[str, Any], ws, mut: bool) -> None:
    for j, blk in enumerate(_tmsag_blocks(group)):
        q = f"{pre}.blocks.{j}"
        a = blk["attn"]
        _ln(sd, f"{q}.norm1", blk["norm1"])
        _ln(sd, f"{q}.norm2", blk["norm2"])
        sd[f"{q}.attn.relative_position_bias_table"] = _t(
            np.asarray(a["rel_bias_table"]))
        sd[f"{q}.attn.relative_position_index"] = _t(
            rel_position_index_3d(*ws).astype(np.int64))
        names = ("qkv_self", "qkv_mut") if mut else ("qkv_self",)
        for nm in names:
            sd[f"{q}.attn.{nm}.weight"] = _t(np.asarray(a[f"{nm}_kernel"]).T)
            if f"{nm}_bias" in a:
                sd[f"{q}.attn.{nm}.bias"] = _t(np.asarray(a[f"{nm}_bias"]))
        sd[f"{q}.attn.proj.weight"] = _t(np.asarray(a["proj_kernel"]).T)
        sd[f"{q}.attn.proj.bias"] = _t(np.asarray(a["proj_bias"]))
        if mut:
            c = np.asarray(a["proj_bias"]).shape[0]
            sd[f"{q}.attn.position_bias"] = _t(
                sine_position_encoding(ws[1], ws[2], c // 2)[None])
        for nm in ("fc11", "fc12", "fc2"):
            _dense(sd, f"{q}.mlp.{nm}", blk["mlp"][nm])


def vrt_from_jax(variables: Dict[str, Any], window_size=(6, 8, 8),
                 indep_reconsts: Optional[tuple] = None
                 ) -> Dict[str, torch.Tensor]:
    """Inverse of ``kair_tpu.ckpt.torch_convert.convert_vrt``: a JAX VRT
    parameter tree (scanned TMSAG pairs or per-block leaves) → KAIR state
    dict with its buffers (``relative_position_index``, ``position_bias``,
    SpyNet's ``mean``/``std``). ``window_size`` and ``indep_reconsts`` are
    the model's (None: the last two stage-8 groups use per-frame windows)."""
    p = variables.get("params", variables)
    ws = tuple(window_size)
    sd: Dict[str, torch.Tensor] = {}
    _conv3d(sd, "conv_first", p["conv_first"]["conv"])
    if "spynet" in p:
        sd.update(spynet_from_jax(p["spynet"], "spynet."))
    for i in range(1, 8):
        st, pre = p[f"stage{i}"], f"stage{i}"
        _ln(sd, f"{pre}.reshape.1", st["resh_norm"])
        if "resh_linear" in st:
            _dense(sd, f"{pre}.reshape.2", st["resh_linear"])
        _vrt_group(sd, f"{pre}.residual_group1", st["group1"],
                   (2,) + ws[1:], True)
        _vrt_group(sd, f"{pre}.residual_group2", st["group2"], ws, False)
        _dense(sd, f"{pre}.linear1", st["linear1"])
        _dense(sd, f"{pre}.linear2", st["linear2"])
        if "pa_deform" in st:
            d = st["pa_deform"]
            sd[f"{pre}.pa_deform.weight"] = _t(
                np.asarray(d["dcn_kernel"]).transpose(3, 2, 0, 1))
            sd[f"{pre}.pa_deform.bias"] = _t(np.asarray(d["dcn_bias"]))
            for j in range(3):
                _conv(sd, f"{pre}.pa_deform.conv_offset.{2 * j}",
                      d[f"off{j}"]["conv"])
            _conv(sd, f"{pre}.pa_deform.conv_offset.6", d["off3"])
            for nm in ("fc11", "fc12", "fc2"):
                _dense(sd, f"{pre}.pa_fuse.{nm}", st["pa_fuse"][nm])
    _ln(sd, "stage8.0.1", p["stage8_norm"])
    _dense(sd, "stage8.0.2", p["stage8_linear"])
    tail = [v for _, v in _indexed(p, "stage8_")]
    n_depths = 7 + len(tail)
    indep = (tuple(range(n_depths - 2, n_depths)) if indep_reconsts is None
             else tuple(indep_reconsts))
    for k, blk in enumerate(tail):
        w8 = (1,) + ws[1:] if 7 + k in indep else ws
        _vrt_group(sd, f"stage8.{k + 1}.residual_group", blk["group"], w8,
                   False)
        _dense(sd, f"stage8.{k + 1}.linear", blk["linear"])
    _ln(sd, "norm", p["norm"])
    _dense(sd, "conv_after_body", p["conv_after_body"])
    if "linear_fuse" in p:                       # frame interpolation
        _conv(sd, "linear_fuse", p["linear_fuse"]["conv"])
        _conv(sd, "conv_last", p["conv_last"]["conv"])
        return sd
    if "conv_before_upsample" in p:              # video SR
        _conv3d(sd, "conv_before_upsample.0", p["conv_before_upsample"]["conv"])
        ups = _indexed(p, "upsample")
        for u, up in ups:
            _conv3d(sd, f"upsample.{5 * u}", up["conv"])
        _conv3d(sd, f"upsample.{5 * len(ups)}", p["upsample_tail"]["conv"])
    _conv3d(sd, "conv_last", p["conv_last"]["conv"])
    return sd


# ---------------------------------------------------------------------------
# RVRT
# ---------------------------------------------------------------------------

def _rvrt_input_conv(sd, pre: str, tree: Dict[str, Any], ws) -> None:
    """A JAX RSTBWithInputConv (``conv_in``, ``norm_in``, ``rstb{i}``,
    ``norm_out``) → KAIR's ``main.{1,3,5.i,7}``; its STL blocks carry the
    plain MLP (``mlp.fc1``, ``mlp.fc2``)."""
    _conv3d(sd, f"{pre}.main.1", tree["conv_in"]["conv"])
    _ln(sd, f"{pre}.main.3", tree["norm_in"])
    _ln(sd, f"{pre}.main.7", tree["norm_out"])
    for i, rstb in _indexed(tree, "rstb"):
        q = f"{pre}.main.5.{i}"
        for j, blk in enumerate(_tmsag_blocks(rstb["group"])):
            b = f"{q}.residual_group.blocks.{j}"
            a = blk["attn"]
            _ln(sd, f"{b}.norm1", blk["norm1"])
            _ln(sd, f"{b}.norm2", blk["norm2"])
            sd[f"{b}.attn.relative_position_bias_table"] = _t(
                np.asarray(a["rel_bias_table"]))
            sd[f"{b}.attn.relative_position_index"] = _t(
                rel_position_index_3d(*ws).astype(np.int64))
            sd[f"{b}.attn.qkv_self.weight"] = _t(np.asarray(a["qkv_self_kernel"]).T)
            if "qkv_self_bias" in a:
                sd[f"{b}.attn.qkv_self.bias"] = _t(np.asarray(a["qkv_self_bias"]))
            sd[f"{b}.attn.proj.weight"] = _t(np.asarray(a["proj_kernel"]).T)
            sd[f"{b}.attn.proj.bias"] = _t(np.asarray(a["proj_bias"]))
            _dense(sd, f"{b}.mlp.fc1", blk["mlp_fc1"])
            _dense(sd, f"{b}.mlp.fc2", blk["mlp_fc2"])
        _dense(sd, f"{q}.linear", rstb["linear"])


def rvrt_from_jax(variables: Dict[str, Any], window_size=(2, 8, 8)
                  ) -> Dict[str, torch.Tensor]:
    """Inverse of ``kair_tpu.ckpt.torch_convert.convert_rvrt`` (:602): a
    JAX RVRT parameter tree (scanned STL pairs or per-block leaves) → KAIR
    state dict with its buffers (``relative_position_index``, SpyNet's
    ``mean``/``std``). ``window_size`` is the model's; the feature
    extraction and the reconstruction use its (1, h, w) slice."""
    p = variables.get("params", variables)
    ws = tuple(window_size)
    ws1 = (1,) + ws[1:]
    sd: Dict[str, torch.Tensor] = {}
    sd.update(spynet_from_jax(p["spynet"], "spynet."))
    if "down0" in p:                             # deblurring / denoising head
        _conv3d(sd, "feat_extract.1", p["down0"]["conv"])
        _conv3d(sd, "feat_extract.3", p["down1"]["conv"])
        _rvrt_input_conv(sd, "feat_extract.6", p["feat_extract"], ws1)
    else:
        _rvrt_input_conv(sd, "feat_extract", p["feat_extract"], ws1)
    for module in ("backward_1", "forward_1", "backward_2", "forward_2"):
        d, pre = p[f"deform_{module}"], f"deform_align.{module}"
        for i in range(5):
            _conv3d(sd, f"{pre}.conv_offset.{2 * i}", d[f"off{i}"]["conv"])
        _conv3d(sd, f"{pre}.conv_offset.10", d["off5"])
        for ours, theirs in (("proj_q", "proj_q.1"), ("proj_k", "proj_k.1"),
                             ("proj_v", "proj_v.1"), ("proj", "proj.1"),
                             ("mlp_fc1", "mlp.1.fc1"), ("mlp_fc2", "mlp.1.fc2")):
            _dense(sd, f"{pre}.{theirs}", d[ours])
        _rvrt_input_conv(sd, f"backbone.{module}", p[f"backbone_{module}"], ws)
    _rvrt_input_conv(sd, "reconstruction", p["reconstruction"], ws1)
    _conv3d(sd, "conv_before_upsampler.0", p["conv_before_upsampler"]["conv"])
    ups = _indexed(p, "upsampler")
    for u, up in ups:
        _conv3d(sd, f"upsampler.{5 * u}", up["conv"])
    _conv3d(sd, f"upsampler.{5 * len(ups)}", p["upsampler_tail"]["conv"])
    _conv3d(sd, "conv_last", p["conv_last"]["conv"])
    return sd


# ---------------------------------------------------------------------------
# CNN zoo (inverses of kair_tpu/ckpt/torch_convert.py:94-345)
# ---------------------------------------------------------------------------

def _convT(sd: Dict[str, torch.Tensor], name: str, leaf: Dict[str, Any]) -> None:
    """The JAX ConvT kernel (k, k, I, O) → torch ConvTranspose2d (I, O, k, k)."""
    sd[f"{name}.weight"] = _t(np.asarray(leaf["kernel"]).transpose(2, 3, 0, 1))
    if "bias" in leaf:
        sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]))


def _convblock(sd: Dict[str, torch.Tensor], key, sub: Dict[str, Any],
               stats: Optional[Dict[str, Any]], mode: str) -> None:
    """A JAX ConvBlock (one ``mNN`` slot a mode char) → KAIR keys, the
    char j's module named ``key(j)``; BatchNorm's running statistics (from
    ``batch_stats``) go to buffers."""
    for j, t in enumerate(mode):
        slot = sub.get(f"m{j:02d}")
        if t == "C":
            _conv(sd, key(j), slot["conv"])
        elif t == "T":
            _convT(sd, key(j), slot)
        elif t == "B":
            bn, st = slot["bn"], stats[f"m{j:02d}"]["bn"]
            sd[f"{key(j)}.weight"] = _t(np.asarray(bn["scale"]))
            sd[f"{key(j)}.bias"] = _t(np.asarray(bn["bias"]))
            sd[f"{key(j)}.running_mean"] = _t(np.asarray(st["mean"]))
            sd[f"{key(j)}.running_var"] = _t(np.asarray(st["var"]))
            sd[f"{key(j)}.num_batches_tracked"] = torch.tensor(0)


class _Slots:
    """KAIR's flattened ``sequential``: the next free slot of ``prefix``."""

    def __init__(self, sd: Dict[str, torch.Tensor], prefix: str,
                 start: int = 0):
        self.sd, self.prefix, self.i = sd, prefix, start

    def block(self, sub: Dict[str, Any], mode: str,
              stats: Optional[Dict[str, Any]] = None) -> None:
        i = self.i
        _convblock(self.sd, lambda j: f"{self.prefix}.{i + j}", sub, stats,
                   mode)
        self.i += len(mode)

    def conv(self, leaf: Dict[str, Any]) -> None:
        _conv(self.sd, f"{self.prefix}.{self.i}", leaf)
        self.i += 1


def _up_mode(upsample_mode: str, scale: int, act: str) -> str:
    """The mode string of the JAX package's upsampler blocks."""
    return {"upconv": {2: "U", 3: "u", 4: "v"}[scale] + "C" + act,
            "pixelshuffle": "C" + str(scale) + act,
            "convtranspose": "T" + act}[upsample_mode]


def _count(p: Dict[str, Any], pattern: str) -> int:
    return sum(1 for k in p if re.fullmatch(pattern, k))


def _split(variables: Dict[str, Any]):
    return (variables.get("params", variables),
            variables.get("batch_stats", {}))


def _plain_stack(sd, p, s, act_mode: str, prefix: str = "model") -> _Slots:
    """head / bodyNN / tail of DnCNN, FDnCNN, FFDNet and SRMD's body."""
    seq = _Slots(sd, prefix)
    seq.block(p["head"], "C" + act_mode[-1], s.get("head"))
    for i in range(_count(p, r"body\d+")):
        seq.block(p[f"body{i:02d}"], "C" + act_mode, s.get(f"body{i:02d}"))
    return seq


def dncnn_from_jax(variables: Dict[str, Any], act_mode: str = "R"
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_dncnn`` (DnCNN and FDnCNN), and of a JAX tree
    with BatchNorm (act_mode 'BR', ``batch_stats`` beside ``params``)."""
    p, s = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _plain_stack(sd, p, s, act_mode).conv(p["tail"]["conv"])
    return sd


def ffdnet_from_jax(variables: Dict[str, Any], act_mode: str = "R"
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_ffdnet``."""
    return dncnn_from_jax(variables, act_mode)


def ircnn_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_ircnn``: ``conv{i}`` → ``model.{2i}``."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    for i in range(7):
        _conv(sd, f"model.{2 * i}", p[f"conv{i}"]["conv"])
    return sd


def srmd_from_jax(variables: Dict[str, Any], upscale: int = 4,
                  act_mode: str = "R", upsample_mode: str = "pixelshuffle"
                  ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_srmd``."""
    p, s = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _plain_stack(sd, p, s, act_mode).block(
        p["tail"]["up"], _up_mode(upsample_mode, upscale, ""))
    return sd


def _shortcut_tail(sd, p, nb: int, upscale: int, act_mode: str,
                   upsample_mode: str, tail_act: str) -> None:
    """model.1.sub.{nb} (the body's last conv), then the upsamplers, the
    HR conv and the last conv from slot 2 on: MSRResNet0 and old RRDB."""
    _conv(sd, f"model.1.sub.{nb}", p["body_tail"]["conv"])
    seq = _Slots(sd, "model", 2)
    for u in range(_count(p, r"up\d+")):
        seq.block(p[f"up{u}"]["up"],
                  _up_mode(upsample_mode, 3 if upscale == 3 else 2, act_mode))
    seq.block(p["hr"], "C" + tail_act)
    seq.block(p["tail"], "C")


def msrresnet0_from_jax(variables: Dict[str, Any], upscale: int = 4,
                        act_mode: str = "R", upsample_mode: str = "upconv"
                        ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_msrresnet0`` (MSRResNet0, DPSR)."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "model.0", p["head"]["conv"])
    nb = _count(p, r"body\d+")
    for i in range(nb):
        _convblock(sd, lambda j: f"model.1.sub.{i}.res.{j}",
                   p[f"body{i:02d}"]["res"], None, "C" + act_mode + "C")
    _shortcut_tail(sd, p, nb, upscale, act_mode, upsample_mode, act_mode)
    return sd


def msrresnet1_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_msrresnet1``: KAIR's named modules."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_first", p["conv_first"]["conv"])
    for i in range(_count(p, r"trunk\d+_conv1")):
        for c in ("conv1", "conv2"):
            _conv(sd, f"recon_trunk.{i}.{c}", p[f"trunk{i:02d}_{c}"]["conv"])
    for name in ("upconv1", "upconv2", "HRconv", "conv_last"):
        if name in p:
            _conv(sd, name, p[name]["conv"])
    return sd


def rrdb_from_jax(variables: Dict[str, Any], upscale: int = 4,
                  act_mode: str = "L", upsample_mode: str = "upconv"
                  ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_rrdb_old``: the blocks' convs ``conv{j}.0``
    (conv + leaky) and ``conv5``."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "model.0", p["head"]["conv"])
    nb = _count(p, r"body\d+")
    for i in range(nb):
        for k in (1, 2, 3):
            rdb = p[f"body{i:02d}"][f"rdb{k}"]
            pre = f"model.1.sub.{i}.RDB{k}"
            for j in range(1, 5):
                _conv(sd, f"{pre}.conv{j}.0", rdb[f"conv{j}"]["conv"])
            _conv(sd, f"{pre}.conv5", rdb["conv5"]["conv"])
    _shortcut_tail(sd, p, nb, upscale, act_mode, upsample_mode, act_mode)
    return sd


def rrdbnet_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_rrdbnet`` and ``convert_rrdbnet_noup``."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv_first", p["conv_first"]["conv"])
    for i in range(_count(p, r"rrdb\d+")):
        for k in (1, 2, 3):
            for j in range(1, 6):
                _conv(sd, f"RRDB_trunk.{i}.RDB{k}.conv{j}",
                      p[f"rrdb{i:02d}"][f"rdb{k}"][f"conv{j}"]["conv"])
    for name in ("trunk_conv", "upconv1", "upconv2", "HRconv", "conv_last"):
        if name in p:
            _conv(sd, name, p[name]["conv"])
    return sd


def imdn_from_jax(variables: Dict[str, Any], upscale: int = 4,
                  upsample_mode: str = "pixelshuffle"
                  ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_imdn``."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "model.0", p["head"]["conv"])
    nb = _count(p, r"body\d+")
    for i in range(nb):
        blk, pre = p[f"body{i:02d}"], f"model.1.sub.{i}"
        for c in ("conv1", "conv2", "conv3"):
            _conv(sd, f"{pre}.{c}.0", blk[c]["conv"])
        for c in ("conv4", "conv1x1"):
            _conv(sd, f"{pre}.{c}", blk[c]["conv"])
    _conv(sd, f"model.1.sub.{nb}", p["body_tail"]["conv"])
    _Slots(sd, "model", 2).block(p["tail"]["up"],
                                 _up_mode(upsample_mode, upscale, ""))
    return sd


def unetres_from_jax(variables: Dict[str, Any], act_mode: str = "R",
                     downsample_mode: str = "strideconv",
                     upsample_mode: str = "convtranspose", prefix: str = ""
                     ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_unetres`` (DRUNet), at any of the JAX package's
    down/up modes; bias-free trees give bias-free state dicts."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}
    nb = _count(p, r"body_b\d+")
    res = "C" + act_mode + "C"

    def res_blocks(seq: str, name: str, start: int) -> None:
        for i in range(nb):
            # KAIR's sequential returns a lone module as it is: m_body of
            # one block has no index
            at = "" if seq == "m_body" and nb == 1 else f".{start + i}"
            _convblock(sd, lambda j: f"{prefix}{seq}{at}.res.{j}",
                       p[f"{name}_b{i:02d}"]["res"], None, res)

    _conv(sd, f"{prefix}m_head", p["head"]["conv"])
    pool = int(downsample_mode != "strideconv")
    for d in (1, 2, 3):
        res_blocks(f"m_down{d}", f"down{d}", 0)
        _Slots(sd, f"{prefix}m_down{d}", nb + pool).block(
            p[f"down{d}_pool"]["down"], "C")
    res_blocks("m_body", "body", 0)
    up = _up_mode(upsample_mode, 2, "")
    for u in (3, 2, 1):
        _Slots(sd, f"{prefix}m_up{u}").block(p[f"up{u}_up"]["up"], up)
        res_blocks(f"m_up{u}", f"up{u}", len(up))
    _conv(sd, f"{prefix}m_tail", p["tail"]["conv"])
    return sd


def usrnet_from_jax(variables: Dict[str, Any], act_mode: str = "R",
                    downsample_mode: str = "strideconv",
                    upsample_mode: str = "convtranspose"
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_usrnet``: the prior under ``p.``, HyPaNet's
    ``fc1-3`` → ``h.mlp.{0,2,4}``."""
    p, _ = _split(variables)
    sd = unetres_from_jax({"params": p["p"]}, act_mode, downsample_mode,
                          upsample_mode, prefix="p.")
    for i, name in enumerate(("fc1", "fc2", "fc3")):
        _conv(sd, f"h.mlp.{2 * i}", p["h"][name]["conv"])
    return sd


def block_from_jax(variables: Dict[str, Any], kind: str, mode: str = "CRC"
                   ) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree of one of the blocks no model builds —
    ``kind`` "calayer", "rcablock", "rcagroup", "esa", "cfrb" or
    "nonlocal" (``kair_tpu/ops/blocks.py:273-321, 381-448``) — as the
    state dict of the port's block of the same name (KAIR's keys,
    basicblock.py:271-391, 543-591); ``mode`` is the RCA blocks' conv
    mode."""
    p, _ = _split(variables)
    sd: Dict[str, torch.Tensor] = {}

    def convs(pre: str, tree: Dict[str, Any], names) -> None:
        for n in names:
            _conv(sd, f"{pre}{n}", tree[n]["conv"])

    def ca(pre: str, tree: Dict[str, Any]) -> None:
        _conv(sd, f"{pre}conv_fc.0", tree["fc1"]["conv"])
        _conv(sd, f"{pre}conv_fc.2", tree["fc2"]["conv"])

    def rcab(pre: str, tree: Dict[str, Any]) -> None:
        _convblock(sd, lambda j: f"{pre}res.{j}", tree["res"], None, mode)
        ca(f"{pre}ca.", tree["ca"])

    def esa(pre: str, tree: Dict[str, Any]) -> None:
        convs(pre, tree, ("conv1", "conv21", "conv2", "conv3", "conv4",
                          "conv5", "conv6"))

    if kind == "calayer":
        ca("", p)
    elif kind == "rcablock":
        rcab("", p)
    elif kind == "rcagroup":
        nb = _count(p, r"b\d+")
        for i in range(nb):
            rcab(f"rg.{i}.", p[f"b{i:02d}"])
        _conv(sd, f"rg.{nb}", p["tail"]["conv"])
    elif kind == "esa":
        esa("", p)
    elif kind == "cfrb":
        convs("", p, ("conv1_d", "conv1_r", "conv2_d", "conv2_r", "conv3_d",
                      "conv3_r", "conv4_d", "conv1x1"))
        esa("esa.", p["esa"])
    elif kind == "nonlocal":
        convs("", p, ("g", "theta", "phi"))
        _conv(sd, "W", p["w"]["conv"])
    else:
        raise ValueError(f"no block [{kind}]")
    return sd


# ----------------------------------------------------------------------------
# GAN slice: discriminators and VGG19 features
# ----------------------------------------------------------------------------

def discriminator_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX discriminator's variables (``params``, ``spectral``,
    ``batch_stats`` where present) → the port's state dict
    (``models/discriminator.py``: the same module names; HWIO kernels →
    OIHW, dense (in, out) → (out, in), each spectral layer's ``u``,
    BatchNorm's scale/bias and running mean/var)."""
    sd: Dict[str, torch.Tensor] = {}
    spectral = variables.get("spectral") or {}
    stats = variables.get("batch_stats") or {}
    for name, leaf in variables["params"].items():
        if "kernel" in leaf:
            k = np.asarray(leaf["kernel"])
            sd[f"{name}.weight"] = _t(k.transpose(3, 2, 0, 1) if k.ndim == 4
                                      else k.T)
            if "bias" in leaf:
                sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]))
            if name in spectral:
                sd[f"{name}.u"] = _t(np.asarray(spectral[name]["u"]))
        else:                                           # BatchNorm
            _ln(sd, name, leaf)
            st = stats[name]
            sd[f"{name}.running_mean"] = _t(np.asarray(st["mean"]))
            sd[f"{name}.running_var"] = _t(np.asarray(st["var"]))
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd


def vgg19_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``convert_vgg19_features``' tree (``conv{N}/conv``) → torchvision's
    ``features.N.weight`` / ``.bias``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in variables["params"].items():
        _conv(sd, f"features.{int(name[4:])}", leaf["conv"])
    return sd


# ----------------------------------------------------------------------------
# Face slice: GPEN and RetinaFace
# ----------------------------------------------------------------------------

def _eql(sd, name: str, leaf) -> None:
    """EqualLinear: JAX (in, out) → KAIR (out, in)."""
    sd[f"{name}.weight"] = _t(np.asarray(leaf["weight"]).T)
    sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]))


def _modconv(sd, name: str, leaf) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(leaf["weight"]).transpose(3, 2, 0, 1)[None])
    _eql(sd, f"{name}.modulation", leaf["modulation"])


def stylegan_from_jax(g: Dict[str, Any], prefix: str = "",
                      blur_kernel=(1, 3, 3, 1)) -> Dict[str, torch.Tensor]:
    """A JAX ``StyleGANGenerator`` tree → ``models/gpen.StyleGANGenerator``'s
    state dict (names under ``prefix``), with the blur and upsample
    kernels' buffers."""
    from kair_tpu_torch.ops.stylegan import make_kernel
    k = make_kernel(blur_kernel)
    sd: Dict[str, torch.Tensor] = {}
    for i, leaf in _indexed(g, "style"):
        _eql(sd, f"{prefix}style.{i + 1}", leaf)
    sd[f"{prefix}input.input"] = _t(np.asarray(g["const_input"])
                                    .transpose(0, 3, 1, 2))

    def styled(name, leaf, up):
        _modconv(sd, f"{name}.conv", leaf["conv"])
        sd[f"{name}.noise.weight"] = _t(np.asarray(leaf["noise_weight"]))
        sd[f"{name}.activate.bias"] = _t(np.asarray(leaf["act_bias"]))
        if up:
            sd[f"{name}.conv.blur.kernel"] = k * 4

    def torgb(name, leaf, up):
        _modconv(sd, f"{name}.conv", leaf["conv"])
        sd[f"{name}.bias"] = _t(np.asarray(leaf["bias"]).reshape(1, 3, 1, 1))
        if up:
            sd[f"{name}.upsample.kernel"] = k * 4

    styled(f"{prefix}conv1", g["conv1"], False)
    torgb(f"{prefix}to_rgb1", g["to_rgb1"], False)
    for j, _ in _indexed(g, "conv_up"):
        styled(f"{prefix}convs.{2 * j}", g[f"conv_up{j}"], True)
        styled(f"{prefix}convs.{2 * j + 1}", g[f"conv_same{j}"], False)
        torgb(f"{prefix}to_rgbs.{j}", g[f"to_rgbs{j}"], True)
    return sd


def gpen_from_jax(variables: Dict[str, Any], blur_kernel=(1, 3, 3, 1)
                  ) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_gpen``: a JAX ``FullGenerator`` tree → KAIR's
    GPEN state dict (``models/gpen.FullGenerator``), with the blur and
    upsample kernels' buffers."""
    from kair_tpu_torch.ops.stylegan import make_kernel
    p = variables.get("params", variables)
    sd = stylegan_from_jax(p["generator"], "generator.", blur_kernel)
    for i, leaf in _indexed(p, "ecd"):
        conv = "ecd0.0.0" if i == 0 else f"ecd{i}.0.1"
        act = "ecd0.0.1" if i == 0 else f"ecd{i}.0.2"
        sd[f"{conv}.weight"] = _t(np.asarray(leaf["conv"]["weight"])
                                  .transpose(3, 2, 0, 1))
        sd[f"{act}.bias"] = _t(np.asarray(leaf["act_bias"]))
        if i:
            sd[f"ecd{i}.0.0.kernel"] = make_kernel(blur_kernel)
    w = np.asarray(p["final_linear"]["weight"])          # (4·4·C NHWC, out)
    c = w.shape[0] // 16
    sd["final_linear.0.weight"] = _t(w.reshape(4, 4, c, -1).transpose(3, 2, 0, 1)
                                     .reshape(w.shape[1], -1))
    sd["final_linear.0.bias"] = _t(np.asarray(p["final_linear"]["bias"]))
    return sd


def _convbn(sd, name: str, conv: str, bn: str, leaf, stats) -> None:
    sd[f"{name}.{conv}.weight"] = _t(np.asarray(leaf["conv"]["kernel"])
                                     .transpose(3, 2, 0, 1))
    _ln(sd, f"{name}.{bn}", leaf["bn"])
    sd[f"{name}.{bn}.running_mean"] = _t(np.asarray(stats["bn"]["mean"]))
    sd[f"{name}.{bn}.running_var"] = _t(np.asarray(stats["bn"]["var"]))
    sd[f"{name}.{bn}.num_batches_tracked"] = torch.tensor(0)


def retinaface_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Inverse of ``convert_retinaface``: a JAX RetinaFace tree (params and
    batch_stats) → the RetinaFace-R50 state dict (``models/retinaface``)."""
    p, st = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    body, bst = p["body"], st["body"]
    sd["body.conv1.weight"] = _t(np.asarray(body["conv1"]["kernel"])
                                 .transpose(3, 2, 0, 1))
    _convbn(sd, "body", "conv1", "bn1", {"conv": body["conv1"], "bn": body["bn1"]},
            {"bn": bst["bn1"]})
    for li, blocks in enumerate([3, 4, 6, 3]):
        for bi in range(blocks):
            t, key = f"body.layer{li + 1}.{bi}", f"layer{li + 1}_b{bi}"
            for ci in range(1, 4):
                _convbn(sd, t, f"conv{ci}", f"bn{ci}", body[key][f"c{ci}"],
                        bst[key][f"c{ci}"])
            if "down" in body[key]:
                _convbn(sd, f"{t}.downsample", "0", "1", body[key]["down"],
                        bst[key]["down"])
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        _convbn(sd, f"fpn.{name}", "0", "1", p["fpn"][name], st["fpn"][name])
    for i in (1, 2, 3):
        for leaf in ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2",
                     "conv7x7_3"):
            _convbn(sd, f"ssh{i}.{leaf}", "0", "1", p[f"ssh{i}"][leaf],
                    st[f"ssh{i}"][leaf])
    for i in range(3):
        for head, src in (("BboxHead", "bbox"), ("ClassHead", "class"),
                          ("LandmarkHead", "ldm")):
            _conv(sd, f"{head}.{i}.conv1x1", p[f"{src}{i}"])
    return sd
