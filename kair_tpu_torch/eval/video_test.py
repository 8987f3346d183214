"""Tiled video inference: temporal clip tiling and spatial patch tiling
with mask-weighted overlap blending (counterpart of
``kair_tpu/eval/video_test.py``; KAIR models/model_vrt.py:82-223 and
main_test_vrt.py:268-335).

Host-orchestrated in numpy over a per-clip forward ``fn`` (numpy in, a
numpy array or a tensor out): each patch's output is accumulated once, on
the host. The functions are named ``test_*`` after KAIR's; a test file
imports the module, not the names, so that pytest does not collect them.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np


def _host(y) -> np.ndarray:
    """fn's output on the host as f32 numpy (a tensor may be on the card)."""
    if hasattr(y, "detach"):
        y = y.detach().float().cpu().numpy()
    return np.asarray(y, np.float32)


def test_clip(fn: Callable, lq: np.ndarray, sf: int,
              window_size: Sequence[int] = (6, 8, 8),
              size_patch_testing: int = 0,
              overlap_size: int = 20) -> np.ndarray:
    """Spatial patch tiling of one clip (reference _test_clip :158-223).
    lq: (B, D, H, W, C) NDHWC."""
    b, d, h, w, c = lq.shape

    if size_patch_testing:
        assert size_patch_testing % window_size[-1] == 0
        stride = size_patch_testing - overlap_size
        h_idx = list(range(0, h - size_patch_testing, stride)) + [max(0, h - size_patch_testing)]
        w_idx = list(range(0, w - size_patch_testing, stride)) + [max(0, w - size_patch_testing)]
        E = None
        W = None
        for hi in h_idx:
            for wi in w_idx:
                patch = lq[:, :, hi: hi + size_patch_testing,
                           wi: wi + size_patch_testing, :]
                out = _host(fn(patch))
                mask = np.ones_like(out)
                # zero overlap borders (reference :192-204)
                ov = overlap_size // 2
                if hi < h_idx[-1]:
                    out[:, :, -ov:, :, :] = 0
                    mask[:, :, -ov:, :, :] = 0
                if wi < w_idx[-1]:
                    out[:, :, :, -ov:, :] = 0
                    mask[:, :, :, -ov:, :] = 0
                if hi > h_idx[0]:
                    out[:, :, :ov, :, :] = 0
                    mask[:, :, :ov, :, :] = 0
                if wi > w_idx[0]:
                    out[:, :, :, :ov, :] = 0
                    mask[:, :, :, :ov, :] = 0
                if E is None:
                    E = np.zeros((b, d, h * sf, w * sf, out.shape[-1]), np.float32)
                    W = np.zeros_like(E)
                E[:, :, hi * sf:(hi + size_patch_testing) * sf,
                  wi * sf:(wi + size_patch_testing) * sf, :] += out
                W[:, :, hi * sf:(hi + size_patch_testing) * sf,
                  wi * sf:(wi + size_patch_testing) * sf, :] += mask
        return E / W

    # whole clip with reflect padding to window multiples; no pad when
    # already a multiple (reference main_test_vrt.py:360-368)
    h_pad = (window_size[1] - h % window_size[1]) % window_size[1]
    w_pad = (window_size[2] - w % window_size[2]) % window_size[2]
    x = lq
    if h_pad:
        x = np.concatenate([x, x[:, :, -h_pad:, :, :][:, :, ::-1]], axis=2)
    if w_pad:
        x = np.concatenate([x, x[:, :, :, -w_pad:, :][:, :, :, ::-1]], axis=3)
    out = _host(fn(x))
    return out[:, :, : h * sf, : w * sf, :]


def test_video(fn: Callable, lq: np.ndarray, sf: int,
               window_size: Sequence[int] = (6, 8, 8),
               num_frame_testing: int = 0, num_frame_overlapping: int = 2,
               size_patch_testing: int = 0,
               patch_overlap: int = 20) -> np.ndarray:
    """Temporal clip tiling (reference _test_video :114-156)."""
    b, d, h, w, c = lq.shape
    if size_patch_testing:
        assert patch_overlap < size_patch_testing, \
            "patch_overlap must be smaller than size_patch_testing"
    clip_fn = lambda x: test_clip(fn, x, sf, window_size, size_patch_testing,
                                  patch_overlap)

    if num_frame_testing:
        stride = num_frame_testing - num_frame_overlapping
        assert stride > 0, (
            f"num_frame_testing ({num_frame_testing}) must exceed "
            f"num_frame_overlapping ({num_frame_overlapping})")
        d_idx = list(range(0, d - num_frame_testing, stride)) + [max(0, d - num_frame_testing)]
        E = None
        W = np.zeros((b, d, 1, 1, 1), np.float32)
        for di in d_idx:
            clip = lq[:, di: di + num_frame_testing]
            out = clip_fn(clip)
            if E is None:
                E = np.zeros((b, d, h * sf, w * sf, out.shape[-1]), np.float32)
            E[:, di: di + num_frame_testing] += out
            W[:, di: di + num_frame_testing] += 1.0
        return E / W

    # pad frames to a window-multiple by reflecting the tail; no pad when
    # already a multiple (reference main_test_vrt.py:303-306)
    d_pad = (window_size[0] - d % window_size[0]) % window_size[0]
    x = np.concatenate([lq, lq[:, -d_pad:][:, ::-1]], axis=1) if d_pad else lq
    out = clip_fn(x)
    return out[:, :d]


def test_video_ensembled(fn: Callable, lq: np.ndarray, sf: int,
                         pad_seq: bool = False, flip_seq: bool = False,
                         center_frame_only: bool = False, **kw) -> np.ndarray:
    """pad/flip temporal self-ensemble wrapper (reference test :82-112)."""
    n = lq.shape[1]
    if pad_seq:
        n += 1
        lq = np.concatenate([lq, lq[:, -1:]], axis=1)
    if flip_seq:
        lq = np.concatenate([lq, lq[:, ::-1]], axis=1)
    E = test_video(fn, lq, sf, **kw)
    if flip_seq:
        E = 0.5 * (E[:, :n] + E[:, n:][:, ::-1])
    if pad_seq:
        n -= 1
        E = E[:, :n]
    if center_frame_only:
        E = E[:, n // 2]
    return E


def clamped_window_starts(extent: int, tile: int, halo: int):
    """Per-tile clamped window starts of the grid-sharded tiling: tile i
    processes [start, start+band) with band = min(tile+2*halo, extent) and
    start = clip(i*tile - halo, 0, extent - band) — every window lies fully
    inside the image (the reference's quadrant-split rule that tiles
    include the true border, utils_model.py:127-151)."""
    n = extent // tile
    band = min(tile + 2 * halo, extent)
    return [min(max(i * tile - halo, 0), extent - band) for i in range(n)], band


def test_clip_grid(fn: Callable, lq: np.ndarray, sf: int,
                   tile: Tuple[int, int], halo: int) -> np.ndarray:
    """Grid tiling with clamped windows (``clamped_window_starts``): each
    tile runs on its window with a halo and keeps its own region — the
    JAX package's single-device reference for its mesh-sharded video
    tiling. lq: (B, D, H, W, C)."""
    b, d, h, w, c = lq.shape
    th, tw = tile
    assert h % th == 0 and w % tw == 0
    hstarts, band_h = clamped_window_starts(h, th, halo)
    wstarts, band_w = clamped_window_starts(w, tw, halo)
    out = None
    for i, sh in enumerate(hstarts):
        for j, sw in enumerate(wstarts):
            win = lq[:, :, sh:sh + band_h, sw:sw + band_w, :]
            y = _host(fn(win))
            if out is None:
                out = np.zeros((b, d, h * sf, w * sf, y.shape[-1]),
                               np.float32)
            oh = (i * th - sh) * sf
            ow = (j * tw - sw) * sf
            out[:, :, i * th * sf:(i + 1) * th * sf,
                j * tw * sf:(j + 1) * tw * sf, :] = \
                y[:, :, oh:oh + th * sf, ow:ow + tw * sf, :]
    return out
