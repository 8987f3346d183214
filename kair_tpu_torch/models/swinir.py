"""SwinIR in PyTorch, NHWC, on the port's kernels.

Counterpart of ``kair_tpu/models/swinir.py`` (reference: KAIR
``models/network_swinir.py:618-852``). The modules carry KAIR's names and
parameter layouts (``layers.0.residual_group.blocks.0.attn.qkv.weight``, the
``relative_position_index`` and ``attn_mask`` buffers, …), so a released
``.pth`` loads with ``load_state_dict``.

In eval mode every Swin block whose window is 8 (H and W are multiples of
it after ``pad_input``) runs as ONE fused block kernel with the cyclic shift
folded into its read, and each RSTB tail (un-roll + conv3x3 + residual) plus
``conv_after_body`` as ONE conv kernel: ``ops/kernels/swin_block.py`` and
``conv_block.py``. On a CUDA tensor those are the hand-written kernels, on a
CPU tensor their plain versions.

In training mode a block with an 8x8 window is rolled explicitly, runs as
one autograd node (``swin_block_train``: the block kernel forward, the
backward kernel ``swin_block_2d_bwd`` backward, at phase 0, as JAX trains,
``kair_tpu/models/swinir.py:124-137``) and is rolled back; the RSTB tail is
``F.conv2d`` + residual, as the JAX package leaves it to XLA in training.
``use_checkpoint`` recomputes each RSTB in the backward
(``torch.utils.checkpoint``, non-reentrant; JAX's ``nn.remat``). A window
under 8 takes the composed PyTorch route (the block kernel's plain version,
then the roll back) and says so once.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from kair_tpu_torch.ops.blocks import Conv, pixel_shuffle
from kair_tpu_torch.ops.kernels.swin_block import (WS, SwinBlockParams,
                                                    pack_swin_block,
                                                    swin_block_2d,
                                                    swin_block_2d_reference,
                                                    swin_block_train)
from kair_tpu_torch.ops.kernels.window_msa import shift_mask_tensor
from kair_tpu_torch.ops.window_attention import (relative_position_index,
                                                  shift_attn_mask)
from kair_tpu_torch.utils.logger import warn_once


def kernel_ok(ws: int, h: int, w: int) -> bool:
    """Geometry that the fused block kernel takes: 8x8 windows tiling the
    map (``ops/kernels/swin_block.py``)."""
    return ws == WS and h % WS == 0 and w % WS == 0


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

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True):
        super().__init__()
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

    def params(self) -> SwinBlockParams:
        a, m = self.attn, self.mlp
        return SwinBlockParams(
            a.qkv.weight, a.qkv.bias, a.proj.weight, a.proj.bias,
            a.relative_position_bias_table, self.norm1.weight, self.norm1.bias,
            self.norm2.weight, self.norm2.bias, m.fc1.weight, m.fc1.bias,
            m.fc2.weight, m.fc2.bias)

    @torch.no_grad()
    def _packed(self, folded: bool = True):
        """Kernel operands (the forward's folded pack, or the backward's),
        rebuilt only when a parameter changes: an optimizer step bumps the
        parameters' versions, so each step packs anew."""
        key = tuple((t.data_ptr(), t._version) for t in self.parameters())
        if key != self._pack_key:
            self._packs, self._pack_key = {}, key
        if folded not in self._packs:
            self._packs[folded] = pack_swin_block(self.params(), self.num_heads,
                                                  folded=folded)
        return self._packs[folded]

    def forward(self, x: torch.Tensor, phase_in: int = 0) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(h, w) <= ws:
            ws, shift = min(h, w), 0
        if ws != self.window_size:
            raise ValueError(f"input {h}x{w} is smaller than the block's "
                             f"window {self.window_size}")
        mask = shift_mask_tensor(h, w, ws, shift, x.device)
        if not self.training and kernel_ok(ws, h, w):
            # the cyclic shift is folded into the kernel's read
            # (phase = shift − phase_in); the output stays in this block's
            # phase and RSTB threads it to the next block
            return swin_block_2d(x, self.params(), self.num_heads, mask,
                                 phase=shift - phase_in,
                                 packed=self._packed() if x.is_cuda else None)
        if phase_in:
            raise ValueError("phase threading requires the fused block kernel")
        if kernel_ok(ws, h, w):
            # training: explicit rolls around the differentiable block
            if shift:
                x = torch.roll(x, (-shift, -shift), (1, 2))
            cuda = x.is_cuda
            x = swin_block_train(
                x, self.params(), self.num_heads, mask,
                packed=self._packed() if cuda else None,
                packed_bwd=self._packed(False) if cuda and torch.is_grad_enabled()
                else None)
            return torch.roll(x, (shift, shift), (1, 2)) if shift else x
        warn_once(f"swin-composed-fallback-{h}x{w}x{ws}-{self.training}",
                  f"SwinIR fused block kernels not used at {h}x{w}, window "
                  f"{ws}, training={self.training} (they need window {WS}): "
                  "composed PyTorch path")
        x = swin_block_2d_reference(x, self.params(), self.num_heads, mask,
                                    phase=shift, window=ws)
        return torch.roll(x, (shift, shift), (1, 2)) if shift else x


class BasicLayer(nn.Module):
    """Holds the blocks under KAIR's ``residual_group.blocks`` names."""

    def __init__(self, blocks: Sequence[SwinBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: depth SwinBlocks (alternating shift
    0, ws//2) + conv + residual (reference network_swinir.py:419-494)."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 resi_connection: str = "1conv"):
        super().__init__()
        if resi_connection != "1conv":
            raise NotImplementedError(
                f"resi_connection={resi_connection!r} is not ported yet "
                "(later slice); the port has '1conv'")
        self.window_size = window_size
        self.residual_group = BasicLayer([
            SwinBlock(dim, input_resolution, num_heads, window_size,
                      0 if i % 2 == 0 else window_size // 2, mlp_ratio)
            for i in range(depth)])
        self.conv = Conv(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws = min(h, w) if min(h, w) <= self.window_size else self.window_size
        # phase threading: each block's output stays in that block's shift
        # phase; the tail un-rolls once, inside the conv kernel's read
        use_phase = not self.training and kernel_ok(ws, h, w)
        res, phase = x, 0
        for blk in self.residual_group.blocks:
            res = blk(res, phase_in=phase)
            if use_phase:
                phase = blk.shift_size if min(h, w) > self.window_size else 0
        if not self.training:
            return self.conv(res, residual=x, phase=phase)
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
                 use_checkpoint: bool = False):
        super().__init__()
        if upsampler not in ("pixelshuffle", "pixelshuffledirect", ""):
            raise NotImplementedError(
                f"upsampler={upsampler!r} is not ported yet (later slice)")
        self.in_chans = in_chans
        self.window_size = window_size
        self.upscale = upscale
        self.img_range = img_range
        self.upsampler = upsampler
        self.img_size = img_size
        self.use_checkpoint = use_checkpoint
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
                 resi_connection)
            for d, nh in zip(depths, num_heads)])
        self.norm = nn.LayerNorm(embed_dim)
        self.conv_after_body = Conv(embed_dim, embed_dim, 3, 1, 1)

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
        if not self.training:
            return self.conv_after_body(feat, residual=feat0)
        return self.conv_after_body(feat) + feat0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        if h % self.window_size or w % self.window_size:
            raise ValueError("pad the input to window multiples first "
                             "(swinir.pad_input)")
        mean = self.mean.to(x.dtype)
        x = (x - mean) * self.img_range
        if self.upsampler == "pixelshuffle":
            x = self._features(self.conv_first(x))
            x = F.leaky_relu(self.conv_before_upsample[0](x), 0.01)
            for m in self.upsample:
                x = (pixel_shuffle(x, m.upscale_factor)
                     if isinstance(m, nn.PixelShuffle) else m(x))
            x = self.conv_last(x)
        elif self.upsampler == "pixelshuffledirect":
            x = self._features(self.conv_first(x))
            x = pixel_shuffle(self.upsample[0](x), self.upscale)
        else:  # denoise / JPEG CAR
            x = x + self.conv_last(self._features(self.conv_first(x)))
        return x / self.img_range + mean


def pad_input(x: np.ndarray, window_size: int) -> Tuple[np.ndarray, int, int]:
    """Reflect-pad NHWC to window multiples (reference check_image_size,
    network_swinir.py:783-788); crop the output to (H*scale, W*scale)."""
    _, h, w, _ = x.shape
    ph = (window_size - h % window_size) % window_size
    pw = (window_size - w % window_size) % window_size
    if ph or pw:
        x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    return x, h, w
