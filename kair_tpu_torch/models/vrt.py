"""VRT — Video Restoration Transformer, in PyTorch, (B, D, H, W, C), on the
port's kernels.

Counterpart of ``kair_tpu/models/vrt.py`` (KAIR ``models/network_vrt.py:
1231-1620``). The modules carry KAIR's names and layouts
(``stageN.reshape.{1,2}``, ``residual_group{1,2}.blocks.N.attn.{qkv_self,
qkv_mut,proj,relative_position_bias_table,relative_position_index,
position_bias}``, ``pa_deform.conv_offset.{0,2,4,6}``, ``stage8.{0..}``,
``upsample.{0,5,10}``, the Conv3d weights of the per-frame convs), so a
released ``.pth`` loads with ``load_state_dict(strict=True)``.

Inference with ``fuse_block`` (the default) mirrors the JAX package's
``TMSA.__call__`` dispatch: a mutual block on (2, 8, 8) windows that tile
the clip runs ``tmsa_block``; a self-only block on (wd, 8, 8) windows with
wd dividing D runs ``self6_block``; RVRT's self-only blocks with a plain
MLP (``geglu=False``) run ``stl2_block`` on (2, 8, 8) windows and the 2-D
``swin_block_2d`` on (1, 8, 8) ones (per-frame windows: the frames fold
into the batch); each with its cyclic shift folded into the kernel's
indices. On a CUDA tensor those are the hand-written kernels, on a CPU
tensor their plain versions. Any other geometry (or ``fuse_block=False``)
takes the composed block of ``ops/window3d.py``; on the card each such call
adds one to ``TMSA.composed_calls``. The flow-guided deformable alignment
runs ``ops/warp.modulated_deform_conv`` with ``deform_impl`` ("auto": the
DCN kernel on the card; "mxu": the bilinear sampler kernels).

Training takes VRT's kernel routes too, as the JAX package does
(``kair_tpu/models/vrt.py:316-330``): with grad enabled the TMSA and self
blocks run ``tmsa_block_train`` / ``self6_block_train`` and the DCN
``dcn_train`` (the kernel forward, the composed route's backward). RVRT's
STL blocks have no training route yet and take the composed block in
training. ``remat`` (KAIR's ``use_checkpoint_attn``) recomputes each pair
of blocks of every TMSAG in the backward (``torch.utils.checkpoint``,
non-reentrant; each block alone when the depth is odd), the units of the
JAX package's ``nn.remat`` (:598-642).

SpyNet, the flows and the deformable offsets stay in f32 whatever the
model's type (``cast_for_inference``): a bf16 flow of 20 px is off by up to
1/16 px. The output adds the bilinearly upscaled input in f32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from kair_tpu_torch.models.spynet import SpyNet
from kair_tpu_torch.ops.blocks import pixel_shuffle, resize_bilinear
from kair_tpu_torch.ops.kernels.dcn_block import pack_dcn_weight
from kair_tpu_torch.ops.kernels.self6_block import (self6_block,
                                                    self6_block_train)
from kair_tpu_torch.ops.kernels.stl2_block import stl2_block
from kair_tpu_torch.ops.kernels.swin_block import (SwinBlockParams,
                                                    pack_swin_block,
                                                    swin_block_2d)
from kair_tpu_torch.ops.kernels.tmsa_block import tmsa_block, tmsa_block_train
from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
from kair_tpu_torch.ops.kernels.win3d import pack_win3d
from kair_tpu_torch.ops.warp import flow_warp, modulated_deform_conv
from kair_tpu_torch.ops.window3d import (Tmsa3dParams, compute_mask_3d,
                                         compute_mask_labels_3d, geglu,
                                         get_window_size, rel_position_index_3d,
                                         sine_position_encoding, tmsa_composed,
                                         window_partition_3d, window_reverse_3d)

__all__ = ["VRT", "TMSA", "TMSAG", "RTMSA", "Stage", "DCNv2PackFlowGuided",
           "cast_for_inference", "get_window_size", "compute_mask_3d",
           "compute_mask_labels_3d", "rel_position_index_3d",
           "sine_position_encoding", "window_partition_3d",
           "window_reverse_3d"]


def nhwc_conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FrameConv(nn.Conv3d):
    """KAIR's Conv3d with a (1, kh, kw) kernel: a 2-D conv on every frame of
    (B, D, H, W, C); the weight keeps its (O, I/groups, 1, kh, kw) shape."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1,
                 groups: int = 1):
        super().__init__(cin, cout, (1, k, k), (1, stride, stride),
                         padding=(0, k // 2, k // 2), groups=groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        y = F.conv2d(x.reshape(b * d, h, w, c).permute(0, 3, 1, 2),
                     self.weight[:, :, 0], self.bias, self.stride[1:],
                     self.padding[1:], 1, self.groups)
        return y.permute(0, 2, 3, 1).reshape(b, d, *y.shape[2:], -1)


class _Packed:
    """Caches a module's kernel operands, rebuilt when a parameter changes."""

    _pack_key: Optional[tuple] = None
    _pack = None

    @torch.no_grad()
    def packed(self, make):
        key = tuple((t.data_ptr(), t._version) for t in self.parameters())
        if key != self._pack_key:
            self._pack, self._pack_key = make(), key
        return self._pack


class GEGLU(nn.Module):
    """KAIR Mlp_GEGLU (:560-586)."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc11 = nn.Linear(cin, hidden)
        self.fc12 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return geglu(x, self.fc11.weight, self.fc11.bias, self.fc12.weight,
                     self.fc12.bias, self.fc2.weight, self.fc2.bias)


class Mlp(nn.Module):
    """KAIR Mlp (``network_rvrt.py:443-463``): fc2(GELU(fc1(x)))."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.fc1 = nn.Linear(cin, hidden)
        self.fc2 = nn.Linear(hidden, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class WindowAttention3D(nn.Module):
    """KAIR WindowAttention (:588-686): parameters and buffers only; the
    computation is ``ops/window3d.window_attention_3d`` or a kernel."""

    def __init__(self, dim: int, window_size, num_heads: int,
                 qkv_bias: bool = True, mut_attn: bool = True):
        super().__init__()
        wd, wh, ww = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            rel_position_index_3d(wd, wh, ww).astype(np.int64)))
        self.qkv_self = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(2 * dim if mut_attn else dim, dim)
        if mut_attn:
            self.register_buffer("position_bias", torch.from_numpy(
                sine_position_encoding(wh, ww, dim // 2))[None])
            self.qkv_mut = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)


class TMSA(_Packed, nn.Module):
    """One (shifted) 3-D window block (KAIR :728-850); ``geglu=False`` is
    RVRT's STL, self-only with KAIR's plain Mlp (``network_rvrt.py:
    337-358``)."""

    composed_calls = 0          # card calls of the composed route

    def __init__(self, dim: int, num_heads: int, window_size=(6, 8, 8),
                 shift_size=(0, 0, 0), mut_attn: bool = True,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 fuse_block: bool = True, geglu: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.mut_attn = mut_attn
        self.fuse_block = fuse_block
        self.geglu = geglu
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention3D(dim, window_size, num_heads, qkv_bias,
                                      mut_attn)
        self.norm2 = nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = GEGLU(dim, hidden, dim) if geglu else Mlp(dim, hidden, dim)

    def params(self) -> Tmsa3dParams:
        a, m = self.attn, self.mlp
        mut = self.mut_attn
        fc1, fc12 = (m.fc11, m.fc12) if self.geglu else (m.fc1, None)
        return Tmsa3dParams(
            a.qkv_self.weight, a.qkv_self.bias,
            a.qkv_mut.weight if mut else None, a.qkv_mut.bias if mut else None,
            a.proj.weight, a.proj.bias, a.relative_position_bias_table,
            a.position_bias[0] if mut else None,
            self.norm1.weight, self.norm1.bias, self.norm2.weight,
            self.norm2.bias, fc1.weight, fc1.bias,
            None if fc12 is None else fc12.weight,
            None if fc12 is None else fc12.bias, m.fc2.weight, m.fc2.bias)

    def kernel_route(self, d: int, h: int, w: int, ws, ss=(0, 0, 0)
                     ) -> Optional[str]:
        """The kernel that takes this geometry ("tmsa", "self6", "stl2",
        "stl1") or None, as ``kair_tpu/models/vrt.py TMSA.__call__``
        (:318-352) decides. The JAX package's (1, 8, 8) conditions W%16 == 0
        and W <= strip_w_max(C) are the TPU strip kernel's VMEM limits and
        have no counterpart here; the 2-D kernel takes one shift for both
        axes, so (1, 8, 8) needs the h and w shifts equal, and one 8x8
        table, so a block whose own window is one frame deep. In training
        VRT's blocks keep their routes; RVRT's STL blocks (no training
        route yet) take the composed block."""
        if not self.fuse_block or h % 8 or w % 8:
            return None
        if self.mut_attn:
            return "tmsa" if self.geglu and tuple(ws) == (2, 8, 8) \
                and d % 2 == 0 else None
        if self.geglu:
            return "self6" if tuple(ws[1:]) == (8, 8) and d % ws[0] == 0 \
                else None
        if self.training:
            return None
        if tuple(ws) == (2, 8, 8) and d % 2 == 0:
            return "stl2"
        if self.window_size == (1, 8, 8) and tuple(ws) == (1, 8, 8) \
                and ss[1] == ss[2]:
            return "stl1"
        return None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, ss = get_window_size((d, h, w), self.window_size, self.shift_size)
        p = self.params()
        route = self.kernel_route(d, h, w, ws, ss)
        if route == "stl1":
            return self._stl1(x, p, ss[1])
        pk = (self.packed(lambda: pack_win3d(p, self.num_heads))
              if route and x.is_cuda else None)
        grad = torch.is_grad_enabled()
        if route == "tmsa":
            fn = tmsa_block_train if grad else tmsa_block
            return fn(x.contiguous(), p, self.num_heads, ss, packed=pk)
        if route == "self6":
            fn = self6_block_train if grad else self6_block
            return fn(x.contiguous(), p, self.num_heads, ws[0], ss, packed=pk)
        if route == "stl2":
            return stl2_block(x.contiguous(), p, self.num_heads, ss, packed=pk)
        if x.is_cuda:
            TMSA.composed_calls += 1
        return tmsa_composed(x, p, self.num_heads, ws, ss)

    def _stl1(self, x: torch.Tensor, p: Tmsa3dParams, shift: int
              ) -> torch.Tensor:
        """A (1, 8, 8) STL block as the 2-D Swin block on (B·D, H, W, C), at
        phase = the (h, w) shift, with the block's 3-D table:
        ``rel_position_index_3d(1, 8, 8)`` is the 2-D index. The kernel
        writes the block in its rolled coordinates; one roll puts it
        back."""
        b, d, h, w, c = x.shape
        sp = SwinBlockParams(
            p.qkv_self_weight, p.qkv_self_bias, p.proj_weight, p.proj_bias,
            p.rel_table, p.norm1_weight, p.norm1_bias, p.norm2_weight,
            p.norm2_bias, p.fc11_weight, p.fc11_bias, p.fc2_weight, p.fc2_bias)
        pk = (self.packed(lambda: pack_swin_block(sp, self.num_heads))
              if x.is_cuda else None)
        mask = shift_mask_tensor(h, w, 8, shift, x.device)
        y = swin_block_2d(x.reshape(b * d, h, w, c).contiguous(), sp,
                          self.num_heads, mask, shift, packed=pk)
        if shift:
            y = torch.roll(y, (shift, shift), (1, 2))
        return y.reshape(b, d, h, w, c)


class TMSAG(nn.Module):
    """Blocks alternating no shift / shift (KAIR :855-948), a Python loop
    over ``blocks.N``; with ``remat``, in training each pair of blocks (each
    block when the depth is odd) is recomputed in the backward."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size,
                 shift_size=None, mut_attn: bool = True, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True, fuse_block: bool = True,
                 geglu: bool = True, remat: bool = False):
        super().__init__()
        self.remat = remat
        ss = (tuple(i // 2 for i in window_size) if shift_size is None
              else tuple(shift_size))
        self.blocks = nn.ModuleList([
            TMSA(dim, num_heads, window_size, (0, 0, 0) if i % 2 == 0 else ss,
                 mut_attn, mlp_ratio, qkv_bias, fuse_block, geglu)
            for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            for blk in self.blocks:
                x = blk(x)
            return x
        n = 2 if len(self.blocks) % 2 == 0 else 1
        for i in range(0, len(self.blocks), n):
            x = torch.utils.checkpoint.checkpoint(
                self._run, x, i, i + n, use_reentrant=False)
        return x

    def _run(self, x: torch.Tensor, i: int, j: int) -> torch.Tensor:
        for blk in self.blocks[i:j]:
            x = blk(x)
        return x


class RTMSA(nn.Module):
    """x + linear(TMSAG_self(x)), stage 8's tail (KAIR :952-995)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 fuse_block: bool = True, remat: bool = False):
        super().__init__()
        self.residual_group = TMSAG(dim, depth, num_heads, window_size,
                                    mut_attn=False, mlp_ratio=mlp_ratio,
                                    qkv_bias=qkv_bias, fuse_block=fuse_block,
                                    remat=remat)
        self.linear = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.linear(self.residual_group(x))


class DCNv2PackFlowGuided(_Packed, nn.Module):
    """Flow-guided deformable alignment (KAIR :267-338): an offset net of
    four cuDNN convs over [warped features, current, flows], offsets =
    max_residue·tanh(·) + flow (y, x) per tap, mask = sigmoid(·), then the
    modulated deformable conv. Offsets and mask are f32."""

    def __init__(self, dim: int, deformable_groups: int = 16,
                 max_residue_magnitude: float = 10.0, pa_frames: int = 2,
                 deform_impl: str = "auto"):
        super().__init__()
        self.dg = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.pa_frames = pa_frames
        self.deform_impl = deform_impl
        cin = dim * pa_frames // 2
        self.weight = nn.Parameter(torch.empty(dim, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(dim))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        act = lambda: nn.LeakyReLU(0.1)
        self.conv_offset = nn.Sequential(
            nn.Conv2d((1 + pa_frames // 2) * dim + pa_frames, dim, 3, 1, 1), act(),
            nn.Conv2d(dim, dim, 3, 1, 1), act(),
            nn.Conv2d(dim, dim, 3, 1, 1), act(),
            nn.Conv2d(dim, 3 * 9 * deformable_groups, 3, 1, 1))
        nn.init.zeros_(self.conv_offset[-1].weight)
        nn.init.zeros_(self.conv_offset[-1].bias)

    def forward(self, x: torch.Tensor, x_flow_warpeds: List[torch.Tensor],
                x_current: torch.Tensor, flows: List[torch.Tensor]
                ) -> torch.Tensor:
        dt = x.dtype
        feat = torch.cat(list(x_flow_warpeds) + [x_current]
                         + [f.to(dt) for f in flows], -1)
        out = nhwc_conv(self.conv_offset, feat).float()
        o1, o2, mask = torch.chunk(out, 3, -1)
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], -1))
        chunks = torch.chunk(offset, self.pa_frames // 2, -1)
        offset = torch.cat([
            o + flow.float().flip(-1).repeat(1, 1, 1, o.shape[-1] // 2)
            for o, flow in zip(chunks, flows)], -1).contiguous()
        mask = torch.sigmoid(mask).contiguous()
        pk = (self.packed(lambda: pack_dcn_weight(self.weight, self.dg))
              if x.is_cuda else None)
        return modulated_deform_conv(x.contiguous(), offset, mask, self.weight,
                                     self.bias, 1, 1, 1, self.dg,
                                     self.deform_impl, packed=pk)


class Stage(nn.Module):
    """reshape + TMSAG(mutual) + TMSAG(self) + parallel warping (KAIR
    :998-1105), on (B, D, H, W, C)."""

    def __init__(self, in_dim: int, dim: int, depth: int, num_heads: int,
                 window_size, mul_attn_ratio: float = 0.75,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 pa_frames: int = 2, deformable_groups: int = 16,
                 reshape: str = "none", max_residue_magnitude: float = 10.0,
                 fuse_block: bool = True, deform_impl: str = "auto",
                 remat: bool = False):
        super().__init__()
        self.mode = reshape
        self.pa_frames = pa_frames
        if reshape == "none":
            self.reshape = nn.Sequential(nn.Identity(), nn.LayerNorm(dim),
                                         nn.Identity())
        elif reshape == "down":
            self.reshape = nn.Sequential(nn.Identity(), nn.LayerNorm(4 * in_dim),
                                         nn.Linear(4 * in_dim, dim), nn.Identity())
        else:
            self.reshape = nn.Sequential(nn.Identity(), nn.LayerNorm(in_dim // 4),
                                         nn.Linear(in_dim // 4, dim), nn.Identity())
        d1 = int(depth * mul_attn_ratio)
        self.residual_group1 = TMSAG(dim, d1, num_heads,
                                     (2, window_size[1], window_size[2]),
                                     mut_attn=True, mlp_ratio=mlp_ratio,
                                     qkv_bias=qkv_bias, fuse_block=fuse_block,
                                     remat=remat)
        self.linear1 = nn.Linear(dim, dim)
        self.residual_group2 = TMSAG(dim, depth - d1, num_heads, window_size,
                                     mut_attn=False, mlp_ratio=mlp_ratio,
                                     qkv_bias=qkv_bias, fuse_block=fuse_block,
                                     remat=remat)
        self.linear2 = nn.Linear(dim, dim)
        if pa_frames:
            self.pa_deform = DCNv2PackFlowGuided(
                dim, deformable_groups, max_residue_magnitude, pa_frames,
                deform_impl)
            self.pa_fuse = GEGLU(dim * 3, dim * 3, dim)

    def forward(self, x, flows_backward, flows_forward):
        b, d, h, w, c = x.shape
        if self.mode == "down":       # 'n c d (h neih) (w neiw) -> n d h w (neiw neih c)'
            x = x.reshape(b, d, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 5, 3, 6)
            x = x.reshape(b, d, h // 2, w // 2, 4 * c)
        elif self.mode == "up":       # 'n (neiw neih c) d h w -> n d (h neih) (w neiw) c'
            x = x.reshape(b, d, h, w, 2, 2, c // 4).permute(0, 1, 2, 5, 3, 4, 6)
            x = x.reshape(b, d, 2 * h, 2 * w, c // 4)
        for m in self.reshape:
            x = m(x)
        x = self.linear1(self.residual_group1(x)) + x
        x = self.linear2(self.residual_group2(x)) + x
        if self.pa_frames:
            aligner = {2: aligned_2frames, 4: aligned_4frames,
                       6: aligned_6frames}[self.pa_frames]
            xb, xf = aligner(x, flows_backward, flows_forward, self.pa_deform)
            x = self.pa_fuse(torch.cat([x, xb, xf], -1))
        return x


# ---------------------------------------------------------------------------
# parallel warping (KAIR :1107-1228); frame loops are Python
# ---------------------------------------------------------------------------

def aligned_2frames(x, flows_backward, flows_forward, pa_deform):
    n = x.shape[1]
    fb, ff = flows_backward[0], flows_forward[0]
    x_backward = [torch.zeros_like(x[:, -1])]
    for i in range(n - 1, 0, -1):
        x_i, flow = x[:, i], fb[:, i - 1]
        x_backward.insert(0, pa_deform(x_i, [flow_warp(x_i, flow, "bilinear")],
                                       x[:, i - 1], [flow]))
    x_forward = [torch.zeros_like(x[:, 0])]
    for i in range(0, n - 1):
        x_i, flow = x[:, i], ff[:, i]
        x_forward.append(pa_deform(x_i, [flow_warp(x_i, flow, "bilinear")],
                                   x[:, i + 1], [flow]))
    return torch.stack(x_backward, 1), torch.stack(x_forward, 1)


def aligned_4frames(x, flows_backward, flows_forward, pa_deform):
    """KAIR get_aligned_feature_4frames (:1129-1167)."""
    n = x.shape[1]
    z = torch.zeros_like
    x_backward = [z(x[:, -1])]
    for i in range(n, 1, -1):
        x_i, flow1 = x[:, i - 1], flows_backward[0][:, i - 2]
        if i == n:
            x_ii, flow2 = z(x[:, n - 2]), z(flows_backward[1][:, n - 3])
        else:
            x_ii, flow2 = x[:, i], flows_backward[1][:, i - 2]
        ws = [flow_warp(x_i, flow1, "bilinear"), flow_warp(x_ii, flow2, "bilinear")]
        x_backward.insert(0, pa_deform(torch.cat([x_i, x_ii], -1), ws,
                                       x[:, i - 2], [flow1, flow2]))
    x_forward = [z(x[:, 0])]
    for i in range(-1, n - 2):
        x_i, flow1 = x[:, i + 1], flows_forward[0][:, i + 1]
        if i == -1:
            x_ii, flow2 = z(x[:, 1]), z(flows_forward[1][:, 0])
        else:
            x_ii, flow2 = x[:, i], flows_forward[1][:, i]
        ws = [flow_warp(x_i, flow1, "bilinear"), flow_warp(x_ii, flow2, "bilinear")]
        x_forward.append(pa_deform(torch.cat([x_i, x_ii], -1), ws,
                                   x[:, i + 2], [flow1, flow2]))
    return torch.stack(x_backward, 1), torch.stack(x_forward, 1)


def aligned_6frames(x, flows_backward, flows_forward, pa_deform):
    """KAIR get_aligned_feature_6frames (:1169-1228)."""
    n = x.shape[1]
    z = torch.zeros_like
    fb, ff = flows_backward, flows_forward
    x_backward = [z(x[:, -1])]
    for i in range(n + 1, 2, -1):
        x_i, flow1 = x[:, i - 2], fb[0][:, i - 3]
        if i == n + 1:
            x_ii, flow2 = z(x[:, -1]), z(fb[1][:, -1])
            x_iii, flow3 = z(x[:, -1]), z(fb[2][:, -1])
        elif i == n:
            x_ii, flow2 = x[:, i - 1], fb[1][:, i - 3]
            x_iii, flow3 = z(x[:, -1]), z(fb[2][:, -1])
        else:
            x_ii, flow2 = x[:, i - 1], fb[1][:, i - 3]
            x_iii, flow3 = x[:, i], fb[2][:, i - 3]
        ws = [flow_warp(a, f, "bilinear") for a, f in
              ((x_i, flow1), (x_ii, flow2), (x_iii, flow3))]
        x_backward.insert(0, pa_deform(torch.cat([x_i, x_ii, x_iii], -1), ws,
                                       x[:, i - 3], [flow1, flow2, flow3]))
    x_forward = [z(x[:, 0])]
    for i in range(0, n - 1):
        x_i, flow1 = x[:, i], ff[0][:, i]
        if i == 0:
            x_ii, flow2 = z(x[:, 0]), z(ff[1][:, 0])
            x_iii, flow3 = z(x[:, 0]), z(ff[2][:, 0])
        elif i == 1:
            x_ii, flow2 = x[:, i - 1], ff[1][:, i - 1]
            x_iii, flow3 = z(x[:, 0]), z(ff[2][:, 0])
        else:
            x_ii, flow2 = x[:, i - 1], ff[1][:, i - 1]
            x_iii, flow3 = x[:, i - 2], ff[2][:, i - 2]
        ws = [flow_warp(a, f, "bilinear") for a, f in
              ((x_i, flow1), (x_ii, flow2), (x_iii, flow3))]
        x_forward.append(pa_deform(torch.cat([x_i, x_ii, x_iii], -1), ws,
                                   x[:, i + 1], [flow1, flow2, flow3]))
    return torch.stack(x_backward, 1), torch.stack(x_forward, 1)


class VRT(nn.Module):
    """KAIR network_vrt.py:1231-1620 on (B, D, H, W, C) clips; ``img_size``
    is (frames, H, W) as in KAIR (the frame count sizes the frame-
    interpolation head's ``linear_fuse``)."""

    def __init__(self, upscale: int = 4, in_chans: int = 3, out_chans: int = 3,
                 img_size: Sequence[int] = (6, 64, 64),
                 window_size: Sequence[int] = (6, 8, 8),
                 depths: Sequence[int] = (8,) * 7 + (4,) * 6,
                 indep_reconsts: Optional[Sequence[int]] = None,
                 embed_dims: Sequence[int] = (120,) * 7 + (180,) * 6,
                 num_heads: Sequence[int] = (6,) * 13,
                 mul_attn_ratio: float = 0.75, mlp_ratio: float = 2.0,
                 qkv_bias: bool = True, num_feat: int = 64,
                 pa_frames: int = 2, deformable_groups: int = 16,
                 nonblind_denoising: bool = False, fuse_block: bool = True,
                 deform_impl: str = "auto", remat: bool = False):
        super().__init__()
        self.upscale = upscale
        self.in_chans = in_chans
        self.pa_frames = pa_frames
        self.nonblind_denoising = nonblind_denoising
        window_size = tuple(window_size)
        e = tuple(embed_dims)
        if pa_frames:
            cin = in_chans * (1 + 2 * 4) + (1 if nonblind_denoising else 0)
            self.conv_first = FrameConv(cin, e[0])
            self.spynet = SpyNet((2, 3, 4, 5))
        else:
            self.conv_first = FrameConv(in_chans, e[0])
        reshapes = ["none", "down", "down", "down", "up", "up", "up"]
        scales = [1, 2, 4, 8, 4, 2, 1]
        for i in range(7):
            setattr(self, f"stage{i + 1}", Stage(
                e[i - 1] if i else e[0], e[i], depths[i], num_heads[i],
                window_size, mul_attn_ratio, mlp_ratio, qkv_bias, pa_frames,
                deformable_groups, reshapes[i], 10.0 / scales[i], fuse_block,
                deform_impl, remat))
        indep = (tuple(range(len(depths) - 2, len(depths)))
                 if indep_reconsts is None else tuple(indep_reconsts))
        self.stage8 = nn.ModuleList([nn.Sequential(
            nn.Identity(), nn.LayerNorm(e[6]), nn.Linear(e[6], e[7]),
            nn.Identity())])
        for j in range(7, len(depths)):
            ws8 = (1,) + window_size[1:] if j in indep else window_size
            self.stage8.append(RTMSA(e[j], depths[j], num_heads[j], ws8,
                                     mlp_ratio, qkv_bias, fuse_block, remat))
        self.norm = nn.LayerNorm(e[-1])
        self.conv_after_body = nn.Linear(e[-1], e[0])
        if not pa_frames:
            self.linear_fuse = nn.Conv2d(e[0] * img_size[0], num_feat, 1, 1)
            self.conv_last = nn.Conv2d(num_feat, out_chans, 7, 1, 0)
        elif upscale == 1:
            self.conv_last = FrameConv(e[0], out_chans)
        else:
            self.conv_before_upsample = nn.Sequential(FrameConv(e[0], num_feat),
                                                      nn.LeakyReLU(0.01))
            ups: List[nn.Module] = []
            s = upscale
            while s > 1:
                r = 3 if s % 3 == 0 else 2
                ups += [FrameConv(num_feat, r * r * num_feat)] + [
                    nn.Identity() for _ in range(4)]
                s //= r
            self.upsample = nn.Sequential(*ups, FrameConv(num_feat, num_feat))
            self.conv_last = FrameConv(num_feat, out_chans)

    # ------------------------------------------------------------------
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, D, H, W, C) [+ 1 noise-level channel when non-blind]."""
        b, d, h, w, _ = x.shape
        dt = self.conv_first.weight.dtype
        x = x.float()
        if not self.pa_frames:
            return self._interpolate(x, dt)
        if self.nonblind_denoising:
            x, noise = x[..., :self.in_chans], x[..., self.in_chans:]
        x_lq = x
        fb, ff = self.get_flows(x)
        xb, xf = self.aligned_image_2frames(x, fb[0], ff[0])
        feat = torch.cat([x, xb, xf] + ([noise] if self.nonblind_denoising
                                        else []), -1).to(dt)
        feat = self.conv_first(feat)
        feat = feat + self.conv_after_body(self.forward_features(feat, fb, ff))
        if self.upscale == 1:
            return self.conv_last(feat).float() + x_lq
        feat = self.conv_before_upsample(feat)
        for m in self.upsample:
            if isinstance(m, FrameConv):
                feat = m(feat)
                if m.out_channels != m.in_channels:       # conv → shuffle → lrelu
                    r = round(math.sqrt(m.out_channels // m.in_channels))
                    bb, dd = feat.shape[:2]
                    feat = pixel_shuffle(feat.reshape(bb * dd, *feat.shape[2:]), r)
                    feat = F.leaky_relu(feat.reshape(bb, dd, *feat.shape[1:]), 0.1)
        out = self.conv_last(feat).float()
        base = resize_bilinear(x_lq.reshape(b * d, h, w, -1),
                               (h * self.upscale, w * self.upscale))
        return out + base.reshape(b, d, *base.shape[1:])

    def _interpolate(self, x: torch.Tensor, dt) -> torch.Tensor:
        """Frame interpolation, pa_frames 0 (KAIR :1454-1467): no flows,
        mean-subtracted, all frames fused, a 7x7 reflection-padded head."""
        b, d, h, w, _ = x.shape
        x_mean = x.mean((1, 2, 3), keepdim=True)
        feat = self.conv_first((x - x_mean).to(dt))
        feat = feat + self.conv_after_body(self.forward_features(feat, [], []))
        fused = feat.permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
        fused = F.leaky_relu(nhwc_conv(self.linear_fuse, fused), 0.2)
        fused = F.pad(fused.permute(0, 3, 1, 2), (3, 3, 3, 3), mode="reflect")
        out = self.conv_last(fused).permute(0, 2, 3, 1).float()
        return out.reshape(b, h, w, -1, 3).permute(0, 3, 1, 2, 4) + x_mean

    def forward_features(self, x, fb, ff):
        """7-stage U-shape + the RTMSA tail (KAIR :1580-1620)."""
        x1 = self.stage1(x, fb[0::4], ff[0::4])
        x2 = self.stage2(x1, fb[1::4], ff[1::4])
        x3 = self.stage3(x2, fb[2::4], ff[2::4])
        x4 = self.stage4(x3, fb[3::4], ff[3::4])
        y = self.stage5(x4, fb[2::4], ff[2::4])
        y = self.stage6(y + x3, fb[1::4], ff[1::4])
        y = self.stage7(y + x2, fb[0::4], ff[0::4])
        y = y + x1
        head = self.stage8[0]
        y = head[2](head[1](y))
        for blk in self.stage8[1:]:
            y = blk(y)
        return self.norm(y)

    # ------------------------------------------------------------------
    def get_flows(self, x: torch.Tensor):
        """The 2/4/6-frame flow sets in f32 (KAIR get_flows :1457-1556); both
        directions in one SpyNet call."""
        b, d, h, w, c = x.shape
        x1 = x[:, :-1].reshape(-1, h, w, c)
        x2 = x[:, 1:].reshape(-1, h, w, c)
        m = x1.shape[0]
        both = self.spynet(torch.cat([x1, x2]), torch.cat([x2, x1]))
        both = [f.float() for f in both]
        fb = [f[:m].reshape(b, d - 1, h // 2 ** i, w // 2 ** i, 2)
              for i, f in enumerate(both)]
        ff = [f[m:].reshape(b, d - 1, h // 2 ** i, w // 2 ** i, 2)
              for i, f in enumerate(both)]
        if self.pa_frames == 2:
            return fb, ff
        fb2, ff2 = self._flows_4frames(ff, fb)
        if self.pa_frames == 4:
            return fb + fb2, ff + ff2
        fb3, ff3 = self._flows_6frames(ff, fb, ff2, fb2)
        return fb + fb2 + fb3, ff + ff2 + ff3

    @staticmethod
    def _flows_4frames(flows_forward, flows_backward):
        """(t, t+2) flow composition (KAIR get_flow_4frames :1508-1532)."""
        d = flows_forward[0].shape[1]
        fb2, ff2 = [], []
        for flows in flows_backward:
            lst = []
            for i in range(d - 1, 0, -1):
                fn1, fn2 = flows[:, i - 1], flows[:, i]
                lst.insert(0, fn1 + flow_warp(fn2, fn1))
            fb2.append(torch.stack(lst, 1))
        for flows in flows_forward:
            lst = []
            for i in range(1, d):
                fn1, fn2 = flows[:, i], flows[:, i - 1]
                lst.append(fn1 + flow_warp(fn2, fn1))
            ff2.append(torch.stack(lst, 1))
        return fb2, ff2

    @staticmethod
    def _flows_6frames(ff, fb, ff2, fb2):
        """(t, t+3) composition (KAIR get_flow_6frames :1534-1558)."""
        d = ff2[0].shape[1]
        fb3, ff3 = [], []
        for flows, flows2 in zip(fb, fb2):
            lst = []
            for i in range(d - 1, 0, -1):
                fn1, fn2 = flows2[:, i - 1], flows[:, i + 1]
                lst.insert(0, fn1 + flow_warp(fn2, fn1))
            fb3.append(torch.stack(lst, 1))
        for flows, flows2 in zip(ff, ff2):
            lst = []
            for i in range(2, d + 1):
                fn1, fn2 = flows2[:, i - 1], flows[:, i - 2]
                lst.append(fn1 + flow_warp(fn2, fn1))
            ff3.append(torch.stack(lst, 1))
        return fb3, ff3

    @staticmethod
    def aligned_image_2frames(x, fb, ff):
        """nearest4 pre-warping of the input frames (KAIR :1560-1578)."""
        n = x.shape[1]
        zero = torch.zeros_like(x[:, -1]).repeat(1, 1, 1, 4)
        xb = [zero]
        for i in range(n - 1, 0, -1):
            xb.insert(0, flow_warp(x[:, i], fb[:, i - 1], "nearest4"))
        xf = [zero]
        for i in range(0, n - 1):
            xf.append(flow_warp(x[:, i], ff[:, i], "nearest4"))
        return torch.stack(xb, 1), torch.stack(xf, 1)


def cast_for_inference(model: nn.Module, device, dtype: torch.dtype
                       ) -> nn.Module:
    """Move a VRT or RVRT to ``device`` in ``dtype`` for inference, SpyNet
    in f32: its weights go straight to f32 on the device, never through
    ``dtype`` (bf16-rounded SpyNet weights moved the flows by up to 3e-3
    px, enough to flip the nearest-pixel pre-warp where a flow is near an
    integer)."""
    for name, child in model.named_children():
        child.to(device=device,
                 dtype=torch.float32 if name == "spynet" else dtype)
    return model.to(device=device).eval()
