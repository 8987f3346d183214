"""RVRT — Recurrent Video Restoration Transformer, in PyTorch, (B, D, H, W,
C), on the port's kernels.

Counterpart of ``kair_tpu/models/rvrt.py`` (KAIR ``models/network_rvrt.py:
640-1180``). The modules carry KAIR's names and layouts
(``feat_extract.main.{1,3,5.i,7}``, ``backbone.<branch>.main.*``,
``deform_align.<branch>.conv_offset.{0,2,4,6,8,10}`` as Conv3d (1, k, k),
``proj_q/k/v.1``, ``proj.1``, ``mlp.1.fc{1,2}``, ``reconstruction.main.*``,
``conv_before_upsampler.0``, ``upsampler.{0,5,10}``, ``conv_last``,
``spynet.*``), so a released ``.pth`` loads with
``load_state_dict(strict=True)``.

  feat_extract    RSTBWithInputConv on (1, 8, 8) windows (video SR), or two
                  stride-2 convs and one (deblurring, denoising)
  4 branches      backward_1, forward_1, backward_2, forward_2: a Python
                  loop over clips; each clip after the first warps the
                  propagated clip by composed flows and refines it with
                  guided deformable attention against the previous clip,
                  then a RSTBWithInputConv on (2, 8, 8) windows
  reconstruction  RSTBWithInputConv over the five feature sets, the x4
                  pixel-shuffle head, plus the bilinearly resized input

With ``fuse_block`` (the default) the (2, 8, 8) STL blocks run the
``stl2_block`` kernel and the (1, 8, 8) ones the 2-D Swin block kernel;
``deform_impl`` "auto" runs the GDA kernel (``ops/deform_attn``): on a CPU
tensor their plain versions. SpyNet, the flows, their composition, the GDA
offsets (10·tanh(·) + the flipped flow) and the updated flows that the
``_2`` branches reuse stay in f32 whatever the model's type: offsets reach
tens of pixels, where bf16 keeps 1/8 px.

``propagate`` takes where the produced clips live (``keep``) and how a clip
comes back (``fetch``): the forward keeps them on the device;
``eval/rvrt_stream`` keeps them on the host, as KAIR's CPU cache
(:1115-1155) does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kair_tpu_torch.models.spynet import SpyNet
from kair_tpu_torch.models.vrt import TMSAG, FrameConv, Mlp
from kair_tpu_torch.ops.blocks import pixel_shuffle, resize_bilinear
from kair_tpu_torch.ops.deform_attn import deform_attention
from kair_tpu_torch.ops.warp import flow_warp

ORDER = ("backward_1", "forward_1", "backward_2", "forward_2")


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class RSTB(nn.Module):
    """x + linear(STG_self(x)) (KAIR :640-656): self-only STL blocks with
    the plain MLP."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 fuse_block: bool = True):
        super().__init__()
        self.residual_group = TMSAG(dim, depth, num_heads, window_size,
                                    mut_attn=False, mlp_ratio=mlp_ratio,
                                    qkv_bias=qkv_bias, fuse_block=fuse_block,
                                    geglu=False)
        self.linear = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.linear(self.residual_group(x))


class RSTBWithInputConv(nn.Module):
    """conv (1,3,3) + LN + num_blocks RSTBs + LN (KAIR :658-707); ``main``
    keeps KAIR's indices (the Rearranges are identities here)."""

    def __init__(self, in_channels: int, dim: int, depth: int, num_heads: int,
                 window_size, num_blocks: int = 2, groups: int = 1,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 fuse_block: bool = True):
        super().__init__()
        self.main = nn.Sequential(
            nn.Identity(), FrameConv(in_channels, dim, 3, groups=groups),
            nn.Identity(), nn.LayerNorm(dim), nn.Identity(),
            nn.Sequential(*[RSTB(dim, depth, num_heads, window_size,
                                 mlp_ratio, qkv_bias, fuse_block)
                            for _ in range(num_blocks)]),
            nn.Identity(), nn.LayerNorm(dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


class GuidedDeformAttnPack(nn.Module):
    """Guided deformable attention (KAIR :179-260): an offset net of six
    convs over [q, the warped propagated clip, the flows], offsets
    10·tanh(·) + the flipped flow per tap (f32), q/k/v projections to 2C,
    the attention (``deform_attention``), proj and a residual MLP."""

    def __init__(self, dim: int, attention_window=(3, 3),
                 attention_heads: int = 12, deformable_groups: int = 12,
                 clip_size: int = 2, max_residue_magnitude: float = 10.0,
                 deform_impl: str = "auto"):
        super().__init__()
        self.window = tuple(attention_window)
        self.heads = attention_heads
        self.dg = deformable_groups
        self.clip_size = clip_size
        self.max_residue_magnitude = max_residue_magnitude
        self.deform_impl = deform_impl
        k = self.window[0] * self.window[1]
        act = lambda: nn.LeakyReLU(0.1)
        self.conv_offset = nn.Sequential(
            FrameConv(dim * (1 + clip_size) + 2 * clip_size, 64, 1), act(),
            FrameConv(64, 64), act(), FrameConv(64, 64), act(),
            FrameConv(64, 64), act(), FrameConv(64, 64), act(),
            FrameConv(64, clip_size * deformable_groups * k * 2, 1))
        nn.init.zeros_(self.conv_offset[-1].weight)
        nn.init.zeros_(self.conv_offset[-1].bias)
        pc = 2 * dim
        self.proj_q = nn.Sequential(nn.Identity(), nn.Linear(dim, pc))
        self.proj_k = nn.Sequential(nn.Identity(), nn.Linear(dim, pc))
        self.proj_v = nn.Sequential(nn.Identity(), nn.Linear(dim, pc))
        self.proj = nn.Sequential(nn.Identity(), nn.Linear(pc, dim))
        self.mlp = nn.Sequential(nn.Identity(), Mlp(dim, 2 * dim, dim))

    def forward(self, q, k, v, v_prop_warped: List[torch.Tensor],
                flows: List[torch.Tensor], return_updateflow: bool = False):
        """q, k, v and the warped clips (B, clip, H, W, C); flows (B, clip,
        H, W, 2) f32. Returns the aligned clip, and with
        ``return_updateflow`` the tap-mean offsets as two flows (f32)."""
        b, t, h, w, c = q.shape
        feat = torch.cat([q, *v_prop_warped, *(f.to(q.dtype) for f in flows)],
                         -1)
        offset = self.max_residue_magnitude * torch.tanh(
            self.conv_offset(feat).float())
        o1, o2 = torch.chunk(offset, 2, -1)
        o1 = o1 + flows[0].float().flip(-1).repeat(1, 1, 1, 1, o1.shape[-1] // 2)
        o2 = o2 + flows[1].float().flip(-1).repeat(1, 1, 1, 1, o2.shape[-1] // 2)
        off = torch.cat([o1, o2], -1).reshape(b, t, h, w, self.clip_size, -1)
        off = off.permute(0, 1, 4, 2, 3, 5).reshape(b * t, self.clip_size, h,
                                                    w, -1).contiguous()
        q_p = self.proj_q(q)
        out = deform_attention(
            q_p.reshape(b * t, h, w, -1).contiguous(),
            self.proj_k(k).contiguous(), self.proj_v(v).contiguous(), off,
            self.window, self.heads, self.dg, self.deform_impl)
        out = self.proj(out.reshape(b, t, h, w, -1))
        out = out + self.mlp(out)
        if not return_updateflow:
            return out
        u1 = o1.reshape(b, t, h, w, -1, 2).mean(4).flip(-1)
        u2 = o2.reshape(b, t, h, w, -1, 2).mean(4).flip(-1)
        return out, u1, u2


class RVRT(nn.Module):
    """KAIR network_rvrt.py:742-1180 on (B, D, H, W, C) clips, D a multiple
    of ``clip_size``; a non-blind denoiser takes a fourth, noise-level
    channel."""

    def __init__(self, upscale: int = 4, clip_size: int = 2,
                 window_size: Sequence[int] = (2, 8, 8),
                 num_blocks: Sequence[int] = (1, 2, 1),
                 depths: Sequence[int] = (2, 2, 2),
                 embed_dims: Sequence[int] = (144, 144, 144),
                 num_heads: Sequence[int] = (6, 6, 6), mlp_ratio: float = 2.0,
                 qkv_bias: bool = True,
                 inputconv_groups: Sequence[int] = (1, 1, 1, 1, 1, 1),
                 max_residue_magnitude: float = 10.0,
                 deformable_groups: int = 12, attention_heads: int = 12,
                 attention_window: Sequence[int] = (3, 3),
                 nonblind_denoising: bool = False, fuse_block: bool = True,
                 deform_impl: str = "auto"):
        super().__init__()
        self.upscale = upscale
        self.clip_size = clip_size
        ws = tuple(window_size)
        ws1 = (1,) + ws[1:]
        e, g = tuple(embed_dims), tuple(inputconv_groups)
        common = dict(mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                      fuse_block=fuse_block)
        self.spynet = SpyNet((5,))
        if upscale == 4:
            self.feat_extract = RSTBWithInputConv(
                3, e[0], depths[0], num_heads[0], ws1, num_blocks[0], g[0],
                **common)
        else:
            act = lambda: nn.LeakyReLU(0.1)
            self.feat_extract = nn.Sequential(
                nn.Identity(),
                FrameConv(4 if nonblind_denoising else 3, e[0], 3, stride=2),
                act(), FrameConv(e[0], e[0], 3, stride=2), act(), nn.Identity(),
                RSTBWithInputConv(e[0], e[0], depths[0], num_heads[0], ws1,
                                  num_blocks[0], g[0], **common))
        self.backbone = nn.ModuleDict()
        self.deform_align = nn.ModuleDict()
        for i, module in enumerate(ORDER):
            self.deform_align[module] = GuidedDeformAttnPack(
                e[1], attention_window, attention_heads, deformable_groups,
                clip_size, max_residue_magnitude, deform_impl)
            self.backbone[module] = RSTBWithInputConv(
                e[0] + (i + 1) * e[1], e[1], depths[1], num_heads[1], ws,
                num_blocks[1], g[i + 1], **common)
        self.reconstruction = RSTBWithInputConv(
            e[0] + 4 * e[1], e[2], depths[2], num_heads[2], ws1, num_blocks[2],
            g[5], **common)
        self.conv_before_upsampler = nn.Sequential(FrameConv(e[2], 64, 1),
                                                   nn.LeakyReLU(0.1))
        ups: List[nn.Module] = []
        for _ in range(2):
            ups += [FrameConv(64, 256)] + [nn.Identity() for _ in range(4)]
        self.upsampler = nn.Sequential(*ups, FrameConv(64, 64))
        self.conv_last = FrameConv(64, 3)

    # ------------------------------------------------------------------
    # the stages, shared by the forward and eval/rvrt_stream
    # ------------------------------------------------------------------
    def shallow(self, x: torch.Tensor) -> torch.Tensor:
        """Per-frame shallow features of f32 frames (B, D, H, W, Cin)."""
        return self.feat_extract(x.to(self.conv_last.weight.dtype))

    def flow_frames(self, x: torch.Tensor) -> torch.Tensor:
        """The frames SpyNet sees: the input, or for the x1 models the
        input's colour channels resized to the features' quarter size."""
        if self.upscale == 4:
            return x
        b, d, h, w, _ = x.shape
        y = resize_bilinear(x[..., :3].reshape(b * d, h, w, 3), (h // 4, w // 4))
        return y.reshape(b, d, h // 4, w // 4, 3)

    def flows(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        """SpyNet flows (N, H, W, 2) f32 from ``ref`` to ``supp``."""
        return self.spynet(ref.float(), supp.float()).float()

    def reconstruct(self, cat: torch.Tensor, lqs: torch.Tensor
                    ) -> torch.Tensor:
        """The five feature sets (B, D, H', W', 5C) → the restored clip
        (B, D, H, W, 3) f32, plus the bilinearly resized input (KAIR
        :1073-1105)."""
        hr = self.conv_before_upsampler(self.reconstruction(cat))
        for m in self.upsampler:
            if isinstance(m, FrameConv):
                hr = m(hr)
                if m.out_channels != m.in_channels:       # conv → shuffle → lrelu
                    b, d = hr.shape[:2]
                    hr = pixel_shuffle(hr.reshape(b * d, *hr.shape[2:]), 2)
                    hr = F.leaky_relu(hr.reshape(b, d, *hr.shape[1:]), 0.1)
        hr = self.conv_last(hr).float()
        b, d, h, w, _ = lqs.shape
        base = resize_bilinear(lqs[..., :3].float().reshape(b * d, h, w, 3),
                               hr.shape[2:4])
        return hr + base.reshape(b, d, *base.shape[1:])

    def propagate(self, feats: Dict[str, List[torch.Tensor]],
                  flows_backward: List[torch.Tensor],
                  flows_forward: List[torch.Tensor],
                  keep: Callable = _same, fetch: Callable = _same) -> None:
        """The four branches in KAIR's order; ``feats["shallow"]`` holds the
        clips' shallow features, the flows one (N, H, W, 2) tensor per pair
        of neighbouring frames. Adds each branch's clips to ``feats``."""
        updated: Dict[str, List[torch.Tensor]] = {}
        for module in ORDER:
            flows = flows_backward if "backward" in module else flows_forward
            self._propagate(feats, flows, module, updated, keep, fetch)

    def forward(self, lqs: torch.Tensor) -> torch.Tensor:
        """lqs (B, D, H, W, C) → (B, D, upscale·H, upscale·W, 3) f32."""
        x = lqs.float()
        n, t = x.shape[:2]
        clip = self.clip_size
        if t % clip:
            raise ValueError(f"{t} frames do not divide into clips of {clip}")
        feat = self.shallow(x)
        xs = self.flow_frames(x)
        m = n * (t - 1)
        ref = xs[:, :-1].reshape(m, *xs.shape[2:])
        supp = xs[:, 1:].reshape(m, *xs.shape[2:])
        # both directions in one SpyNet call
        both = self.flows(torch.cat([ref, supp]), torch.cat([supp, ref]))
        fb = both[:m].reshape(n, t - 1, *both.shape[1:])
        ff = both[m:].reshape(n, t - 1, *both.shape[1:])
        feats = {"shallow": [feat[:, i * clip:(i + 1) * clip]
                             for i in range(t // clip)]}
        self.propagate(feats, list(fb.unbind(1)), list(ff.unbind(1)))
        cat = torch.cat([torch.cat(feats[k], 1) for k in ("shallow",) + ORDER],
                        -1)
        return self.reconstruct(cat, x)

    @staticmethod
    def query_branch(feats: Dict[str, List[torch.Tensor]]) -> str:
        """The features whose clips are a branch's attention queries and
        keys: the branch before it, or the shallow features for the first
        (KAIR :975 takes ``list(feats)[-2]`` once the new branch is in)."""
        return list(feats)[-1]

    def _propagate(self, feats, flows, module: str, updated, keep, fetch):
        """One branch, clip by clip (KAIR :963-1071)."""
        t = len(flows) + 1
        clip = self.clip_size
        backward = "backward" in module
        first = "_1" in module
        if backward:
            flow_idx = list(range(t))[::-1]
            clip_idx = list(range(t // clip))[::-1]
        else:
            flow_idx = list(range(-1, t - 1))
            clip_idx = list(range(t // clip))
        if first:
            updated[f"{module}_n1"], updated[f"{module}_n2"] = [], []
        order = (lambda a: a.flip(1)) if backward else _same
        get = lambda key, i: order(fetch(feats[key][i]))
        last_key = self.query_branch(feats)
        keys_before = list(feats)
        feats[module] = []
        feat_prop = torch.zeros_like(fetch(feats["shallow"][0]))
        deform, backbone = self.deform_align[module], self.backbone[module]
        for i, idx_c in enumerate(clip_idx):
            if i > 0:
                if first:
                    f01, f12, f23 = (fetch(flows[flow_idx[clip * i + o]])
                                     for o in (-1, 0, 1))
                    f02 = f12 + flow_warp(f01, f12)
                    f13 = f23 + flow_warp(f12, f23)
                    f03 = f23 + flow_warp(f02, f23)
                    flow_n1 = torch.stack([f02, f13], 1)
                    flow_n2 = torch.stack([f12, f03], 1)
                else:
                    old = module.replace("_2", "_1")
                    flow_n1 = fetch(updated[f"{old}_n1"][i - 1])
                    flow_n2 = fetch(updated[f"{old}_n2"][i - 1])
                feat_q = get(last_key, idx_c)
                feat_k = get(last_key, clip_idx[i - 1])
                warped = [_warp_clip(feat_prop, flow_n1),
                          _warp_clip(feat_prop.flip(1), flow_n2)]
                if first:
                    feat_prop, u1, u2 = deform(feat_q, feat_k, feat_prop, warped,
                                               [flow_n1, flow_n2], True)
                    updated[f"{module}_n1"].append(keep(u1))
                    updated[f"{module}_n2"].append(keep(u2))
                else:
                    feat_prop = deform(feat_q, feat_k, feat_prop, warped,
                                       [flow_n1, flow_n2])
            cat = torch.cat([get(k, idx_c) for k in keys_before] + [feat_prop],
                            -1)
            feat_prop = feat_prop + backbone(cat)
            feats[module].append(keep(feat_prop))
        if backward:
            feats[module] = [f.flip(1) for f in feats[module][::-1]]


def _warp_clip(fp: torch.Tensor, fl: torch.Tensor) -> torch.Tensor:
    """flow_warp of every frame of a clip (B, T, H, W, C) by (B, T, H, W, 2)."""
    flat = fl.reshape(-1, *fl.shape[2:])
    return flow_warp(fp.reshape(-1, *fp.shape[2:]), flat).reshape(fp.shape)
