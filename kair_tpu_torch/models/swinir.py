"""SwinIR in PyTorch, NHWC, on the port's kernels.

Counterpart of ``kair_tpu/models/swinir.py`` (reference: KAIR
``models/network_swinir.py:618-852``). The modules carry KAIR's names and
parameter layouts (``layers.0.residual_group.blocks.0.attn.qkv.weight``, the
``relative_position_index`` and ``attn_mask`` buffers, ``conv.0/2/4`` of a
``3conv`` tail, …), so a released ``.pth`` loads with ``load_state_dict``.

Inference, ``fuse_block`` True (the default, as KAIR's option files carry
no such key): every Swin block whose window ws ≤ 8 tiles the map (H and W
are multiples of it after ``pad_input``) runs as ONE fused block kernel
with the cyclic shift folded into its read — ``swin_block_2d``, kernel 1
at ws 8, kernel A below it (ws 7 is the JPEG-CAR geometry) — and each
``1conv`` RSTB tail (un-roll + conv3x3 + residual) plus ``conv_after_body``
as ONE conv kernel: ``ops/kernels/swin_block.py`` and ``conv_block.py``.
``fuse_block`` False is the unfused route (JAX ``fuse_block=False,
use_pallas=True``): LN1 → the window-attention kernel ``window_msa_win``
with the shift folded into its read and write → residual → LN2 → MLP
(cuBLAS), and library conv tails. On a CUDA tensor those are the
hand-written kernels, on a CPU tensor their plain versions.

In training mode a block with an 8x8 window runs as one autograd node
(``swin_block_train``: the block kernel forward, the backward kernel
``swin_block_2d_bwd`` backward, both reading x at the block's shift, where
JAX rolls before the block, ``kair_tpu/models/swinir.py:124-137``) and its
output is rolled back, whatever ``fuse_block`` says; the RSTB tail is ``F.conv2d`` + residual, as the JAX
package leaves it to XLA in training. ``use_checkpoint`` recomputes each
RSTB in the backward (``torch.utils.checkpoint``, non-reentrant; JAX's
``nn.remat``). The kernels run in the block's working dtype: bf16 under a
bf16 autocast, else the input's own (an f32 model on the card gets the f32
kernels, inference and training alike). A window that no kernel takes
(training at a window other than 8, e.g. JPEG-CAR's 7, or any window above
8) runs the block kernels' plain version, composed PyTorch under autograd,
where the JAX package runs ``_flat_block_xla`` through XLA
(``kair_tpu/models/swinir.py:162-177``): no Pallas kernel is skipped there.
It says so once and adds one to ``SwinBlock.composed_calls``.

The head's normalisation and the final ``x + conv_last(res)`` (denoising,
JPEG-CAR) or ``/ img_range + mean`` stay in f32 whatever the weights'
type: at ``img_range`` 255 a bf16 step is one gray level.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from kair_tpu_torch.ops.blocks import Conv, pixel_shuffle, upsample_nearest
from kair_tpu_torch.ops.kernels.swin_block import (WS, SwinBlockParams,
                                                    kernel_dtype,
                                                    pack_swin_block,
                                                    pack_swin_block_f32,
                                                    swin_block_2d,
                                                    swin_block_train,
                                                    swin_block_win_reference)
from kair_tpu_torch.ops.kernels.window_msa import (pack_window_msa,
                                                   shift_mask_tensor,
                                                   window_msa_win)
from kair_tpu_torch.ops.window_attention import (relative_position_index,
                                                  shift_attn_mask)
from kair_tpu_torch.utils.logger import warn_once


def kernel_ok(ws: int, h: int, w: int) -> bool:
    """Geometry that the inference window kernels take: windows of at most
    8x8 tiling the map (``ops/kernels/swin_block.py``, ``window_msa.py``)."""
    return ws <= WS and h % ws == 0 and w % ws == 0


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size, window_size).astype(np.int64)))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)


class SwinBlock(nn.Module):
    """One Swin transformer block (KAIR SwinTransformerBlock,
    network_swinir.py:164-277) on (B, H, W, C)."""

    composed_calls = 0      # forwards on the composed route, all blocks

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 fuse_block: bool = True):
        super().__init__()
        self.fuse_block = fuse_block
        if min(input_resolution) <= window_size:
            shift_size, window_size = 0, min(input_resolution)
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = None
        if shift_size > 0:
            mask = torch.from_numpy(shift_attn_mask(
                input_resolution[0], input_resolution[1], window_size,
                shift_size).copy())
        # kept for KAIR state-dict compatibility; forward builds the mask
        # for the actual input size (identical at the training resolution)
        self.register_buffer("attn_mask", mask)
        self._pack_key: Optional[tuple] = None
        self._packs: dict = {}

    def card_kernel(self) -> str:
        """The hand-written kernels of this block's route on the card, in
        bf16 and f32 alike; they take whole weights (``parallel/tp``)."""
        return "swin_block_2d and swin_block_2d_bwd"

    def params(self) -> SwinBlockParams:
        a, m = self.attn, self.mlp
        return SwinBlockParams(
            a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
            a.relative_position_bias_table, self.norm1.weight, self.norm1.bias,
            self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
            m.fc2.weight, m.fc2.bias)

    @torch.no_grad()
    def _packed(self, kind: str = "fwd", dtype: torch.dtype = torch.bfloat16):
        """Kernel operands of the kernels that take ``dtype`` — the block's
        forward pack ("fwd"), the backward's ("bwd") or the attention
        kernel's ("msa"); in f32 all three share one (the attention-only
        mode reads the block pack's attention fields) — rebuilt only when a parameter changes: an optimizer step bumps the
        parameters' versions, so each step packs anew."""
        key = tuple((t.data_ptr(), t._version) for t in self.parameters())
        if key != self._pack_key:
            self._packs, self._pack_key = {}, key
        f32 = dtype == torch.float32
        slot = ("blk" if f32 else kind, f32)
        if slot not in self._packs:
            a = self.attn
            if f32:
                self._packs[slot] = pack_swin_block_f32(self.params(),
                                                        self.num_heads)
            elif kind == "msa":
                self._packs[slot] = pack_window_msa(
                    a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
                    a.relative_position_bias_table, self.num_heads)
            else:
                self._packs[slot] = pack_swin_block(
                    self.params(), self.num_heads, folded=kind == "fwd")
        return self._packs[slot]

    def forward(self, x: torch.Tensor, phase_in: int = 0) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        if ws != self.window_size:
            raise ValueError(f"input {h}x{w} is smaller than the block's "
                             f"window {self.window_size}")
        mask = shift_mask_tensor(h, w, ws, shift, x.device)
        cuda = x.is_cuda
        if not self.training and kernel_ok(ws, h, w):
            if not self.fuse_block:
                if phase_in:
                    raise ValueError("phase threading requires fuse_block")
                return self._unfused(x, mask, ws, shift)
            # the cyclic shift is folded into the kernel's read
            # (phase = shift − phase_in); the output stays in this block's
            # phase and RSTB threads it to the next block
            if cuda:
                x = x.to(kernel_dtype(x))
            return swin_block_2d(x, self.params(), self.num_heads, mask,
                                 shift - phase_in, ws,
                                 packed=self._packed("fwd", x.dtype)
                                 if cuda else None)
        if phase_in:
            raise ValueError("phase threading requires the fused block kernel")
        if self.training and ws == WS and kernel_ok(ws, h, w):
            # training: the shift is folded into both kernels' reads of x
            # (the forward's and the backward's); the output comes back in
            # the block's coordinates and one roll returns it
            kdt = kernel_dtype(x)
            x = swin_block_train(
                x, self.params(), self.num_heads, mask,
                packed=self._packed("fwd", kdt) if cuda else None,
                packed_bwd=self._packed("bwd", kdt)
                if cuda and torch.is_grad_enabled() else None, phase=shift)
            return torch.roll(x, (shift, shift), (1, 2)) if shift else x
        # the counterpart of the JAX package's XLA route (_flat_block_xla):
        # no Pallas kernel runs there either
        warn_once(f"swin-composed-fallback-{h}x{w}x{ws}-{self.training}",
                  f"SwinIR fuse_block=True fell back to the composed PyTorch "
                  f"path at {h}x{w}, window {ws}, train={self.training}: "
                  + ("training requires ws=8 with H%8==0 and W%8==0"
                     if self.training else
                     f"the block kernels take windows of at most {WS} that "
                     "tile the map"))
        SwinBlock.composed_calls += 1
        x = swin_block_win_reference(x, self.params(), self.num_heads, mask,
                                     phase=shift, ws=ws)
        return torch.roll(x, (shift, shift), (1, 2)) if shift else x

    def _unfused(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                 ws: int, shift: int) -> torch.Tensor:
        """The unfused inference block: LN1, the window-attention kernel
        (shift folded into its read and write), residual, LN2 → MLP."""
        a, m = self.attn, self.mlp
        y = self.norm1(x)
        if y.is_cuda:
            y = y.to(kernel_dtype(y))
        x = x + window_msa_win(
            y, a.qkv.weight, a.qkv.bias, a.proj.weight,
            a.proj.bias, a.relative_position_bias_table, self.num_heads, mask,
            shift, ws, packed=self._packed("msa", y.dtype)
            if y.is_cuda else None)
        return x + m.fc2(F.gelu(m.fc1(self.norm2(x))))


class BasicLayer(nn.Module):
    """Holds the blocks under KAIR's ``residual_group.blocks`` names."""

    def __init__(self, blocks: Sequence[SwinBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


def residual_conv(dim: int, resi_connection: str) -> nn.Module:
    """The conv at the end of an RSTB and after the body: one 3x3 conv
    ("1conv"), or KAIR's 3x3 → 1x1 → 3x3 bottleneck at dim/4 with
    LeakyReLU(0.2) ("3conv", network_swinir.py:469-473)."""
    if resi_connection == "1conv":
        return Conv(dim, dim, 3, 1, 1)
    if resi_connection == "3conv":
        return nn.Sequential(
            Conv(dim, dim // 4, 3, 1, 1), nn.LeakyReLU(0.2, inplace=True),
            Conv(dim // 4, dim // 4, 1, 1, 0), nn.LeakyReLU(0.2, inplace=True),
            Conv(dim // 4, dim, 3, 1, 1))
    raise ValueError(f"resi_connection={resi_connection!r}")


class RSTB(nn.Module):
    """Residual Swin Transformer Block: depth SwinBlocks (alternating shift
    0, ws//2) + conv + residual (reference network_swinir.py:419-494)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 resi_connection: str = "1conv", fuse_block: bool = True):
        super().__init__()
        self.window_size = window_size
        self.fuse_block = fuse_block
        self.fused_tail = fuse_block and resi_connection == "1conv"
        self.residual_group = BasicLayer([
            SwinBlock(dim, input_resolution, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                      fuse_block=fuse_block)
            for i in range(depth)])
        self.conv = residual_conv(dim, resi_connection)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = min(h, w) if min(h, w) <= self.window_size else self.window_size
        # phase threading: each block's output stays in that block's shift
        # phase; the tail un-rolls once, inside the conv kernel's read (or
        # with one roll before a 3conv tail)
        use_phase = (not self.training and self.fuse_block
                     and kernel_ok(ws, h, w))
        res, phase = x, 0
        for blk in self.residual_group.blocks:
            res = blk(res, phase_in=phase)
            if use_phase:
                phase = blk.shift_size if min(h, w) > self.window_size else 0
        if self.fused_tail and not self.training:
            return self.conv(res, residual=x, phase=phase)
        if phase:
            res = torch.roll(res, (phase, phase), (1, 2))
        return self.conv(res) + x


class PatchEmbed(nn.Module):
    """Holds the patch norm under KAIR's ``patch_embed.norm`` name."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)


class SwinIR(nn.Module):
    """KAIR SwinIR (network_swinir.py:618-852). Input and output NHWC, H and
    W multiples of the window (``pad_input`` below)."""

    def __init__(self, img_size: int = 64, in_chans: int = 3,
                 embed_dim: int = 96, depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6), window_size: int = 7,
                 mlp_ratio: float = 4.0, upscale: int = 2,
                 img_range: float = 1.0, upsampler: str = "",
                 resi_connection: str = "1conv", ape: bool = False,
                 patch_norm: bool = True, num_feat: int = 64,
                 use_checkpoint: bool = False, fuse_block: bool = True):
        super().__init__()
        if upsampler not in ("pixelshuffle", "pixelshuffledirect",
                             "nearest+conv", ""):
            raise ValueError(f"upsampler={upsampler!r}")
        self.in_chans = in_chans
        self.window_size = window_size
        self.upscale = upscale
        self.img_range = img_range
        self.upsampler = upsampler
        self.img_size = img_size
        self.use_checkpoint = use_checkpoint
        self.fused_tail = fuse_block and resi_connection == "1conv"
        mean = (0.4488, 0.4371, 0.4040) if in_chans == 3 else (0.0,) * in_chans
        self.register_buffer("mean", torch.tensor(mean), persistent=False)

        self.conv_first = Conv(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = PatchEmbed(embed_dim) if patch_norm else None
        self.absolute_pos_embed = None
        if ape:
            self.absolute_pos_embed = nn.Parameter(
                torch.zeros(1, img_size * img_size, embed_dim))
            nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02)
        res = (img_size, img_size)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, res, d, nh, window_size, mlp_ratio,
                 resi_connection, fuse_block)
            for d, nh in zip(depths, num_heads)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = residual_conv(embed_dim, resi_connection)

        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(
                Conv(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(inplace=True))
            ups = []
            if upscale & (upscale - 1) == 0:
                for _ in range(int(math.log2(upscale))):
                    ups += [Conv(num_feat, 4 * num_feat, 3, 1, 1),
                            nn.PixelShuffle(2)]
            elif upscale == 3:
                ups += [Conv(num_feat, 9 * num_feat, 3, 1, 1), nn.PixelShuffle(3)]
            else:
                raise ValueError(f"scale {upscale} is not supported")
            self.upsample = nn.Sequential(*ups)
            self.conv_last = Conv(num_feat, in_chans, 3, 1, 1)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(
                Conv(embed_dim, in_chans * upscale ** 2, 3, 1, 1),
                nn.PixelShuffle(upscale))
        elif upsampler == "nearest+conv":
            # real-world SR (network_swinir.py:763-771)
            if upscale != 4:
                raise ValueError("upsampler 'nearest+conv' supports x4 only, "
                                 "as KAIR's")
            self.conv_before_upsample = nn.Sequential(
                Conv(embed_dim, num_feat, 3, 1, 1), nn.LeakyReLU(inplace=True))
            self.conv_up1 = Conv(num_feat, num_feat, 3, 1, 1)
            self.conv_up2 = Conv(num_feat, num_feat, 3, 1, 1)
            self.conv_hr = Conv(num_feat, num_feat, 3, 1, 1)
            self.conv_last = Conv(num_feat, in_chans, 3, 1, 1)
        else:
            self.conv_last = Conv(embed_dim, in_chans, 3, 1, 1)
        self.apply(self._init_weights)

    @staticmethod
    def _init_weights(m: nn.Module) -> None:
        # KAIR SwinIR._init_weights: Linear trunc-normal(0.02), LN (1, 0)
        if isinstance(m, nn.Linear):
            nn.init.trunc_normal_(m.weight, std=0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)

    def _features(self, feat: torch.Tensor) -> torch.Tensor:
        """body(feat) + feat; the residual is folded into the fused
        conv_after_body tail when it runs."""
        feat0 = feat
        if self.patch_embed is not None:
            feat = self.patch_embed.norm(feat)
        if self.absolute_pos_embed is not None:
            fh, fw = feat.shape[1:3]
            if (fh, fw) != (self.img_size, self.img_size):
                raise ValueError(
                    f"ape=True requires {self.img_size}x{self.img_size} "
                    f"inputs (got {fh}x{fw}), as in the reference")
            feat = feat + self.absolute_pos_embed.reshape(
                1, fh, fw, -1).to(feat.dtype)
        for layer in self.layers:
            if self.use_checkpoint and self.training:
                feat = torch.utils.checkpoint.checkpoint(layer, feat,
                                                         use_reentrant=False)
            else:
                feat = layer(feat)
        feat = self.norm(feat)
        if self.fused_tail and not self.training:
            return self.conv_after_body(feat, residual=feat0)
        return self.conv_after_body(feat) + feat0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC in (any float type), NHWC f32 out; the body runs in the
        weights' type."""
        n, h, w, c = x.shape
        if h % self.window_size or w % self.window_size:
            raise ValueError("pad the input to window multiples first "
                             "(swinir.pad_input)")
        mean = self.mean.float()
        x = (x.float() - mean) * self.img_range
        feat = self._features(self.conv_first(
            x.to(self.conv_first.weight.dtype)))
        if self.upsampler == "pixelshuffle":
            y = F.leaky_relu(self.conv_before_upsample[0](feat), 0.01)
            for m in self.upsample:
                y = (pixel_shuffle(y, m.upscale_factor)
                     if isinstance(m, nn.PixelShuffle) else m(y))
            y = self.conv_last(y).float()
        elif self.upsampler == "pixelshuffledirect":
            y = pixel_shuffle(self.upsample[0](feat), self.upscale).float()
        elif self.upsampler == "nearest+conv":
            y = F.leaky_relu(self.conv_before_upsample[0](feat), 0.01)
            y = F.leaky_relu(self.conv_up1(upsample_nearest(y, 2)), 0.2)
            y = F.leaky_relu(self.conv_up2(upsample_nearest(y, 2)), 0.2)
            y = self.conv_last(F.leaky_relu(self.conv_hr(y), 0.2)).float()
        else:  # denoise / JPEG CAR: the image residual in f32
            y = x + self.conv_last(feat).float()
        return y / self.img_range + mean


def pad_input(x: np.ndarray, window_size: int) -> Tuple[np.ndarray, int, int]:
    """Reflect-pad NHWC to window multiples (reference check_image_size,
    network_swinir.py:783-788); crop the output to (H*scale, W*scale)."""
    _, h, w, _ = x.shape
    ph = (window_size - h % window_size) % window_size
    pw = (window_size - w % window_size) % window_size
    if ph or pw:
        x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    return x, h, w
