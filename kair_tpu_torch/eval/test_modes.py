"""Padded, split, self-ensembled and tiled inference (counterpart of
``kair_tpu/eval/test_modes.py``; reference utils/utils_model.py:51-230 and
main_test_swinir.py:256-284). ``fn`` maps an NHWC float32 numpy batch to an
NHWC numpy batch. Modes of ``test_mode``:

  0 normal | 1 pad-to-modulo | 2 recursive quadrant split | 3 x8 geometric
  self-ensemble | 4 split + x8

with the reference's split geometry and overlap-crop rules, so tiled
outputs give the checkpoints' published PSNR. ``tile_overlap`` is
SwinIR's flat tiling with uniform-weight blending, for large images.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from kair_tpu_torch.utils import image as im


def _pad_edge(x: np.ndarray, bottom: int, right: int) -> np.ndarray:
    """torch ReplicationPad2d equivalent (edge padding), NHWC."""
    if bottom == 0 and right == 0:
        return x
    return np.pad(x, ((0, 0), (0, bottom), (0, right), (0, 0)), mode="edge")


def test_pad(fn: Callable, L: np.ndarray, modulo: int = 16, sf: int = 1
             ) -> np.ndarray:
    """Mode 1: pad bottom/right to ``modulo``, run, crop to (h*sf, w*sf)
    (reference utils_model.py:110-118)."""
    h, w = L.shape[1:3]
    pb = int(math.ceil(h / modulo) * modulo - h)
    pr = int(math.ceil(w / modulo) * modulo - w)
    E = np.asarray(fn(_pad_edge(L, pb, pr)))
    return E[:, : h * sf, : w * sf, :]


def test_split_fn(fn: Callable, L: np.ndarray, refield: int = 32,
                  min_size: int = 256, sf: int = 1, modulo: int = 1
                  ) -> np.ndarray:
    """Mode 2: recursive quadrant split with receptive-field-aligned overlap
    (reference utils_model.py:127-164)."""
    h, w = L.shape[1:3]
    if h * w <= min_size ** 2:
        return test_pad(fn, L, modulo, sf)

    top = slice(0, (h // 2 // refield + 1) * refield)
    bottom = slice(h - (h // 2 // refield + 1) * refield, h)
    left = slice(0, (w // 2 // refield + 1) * refield)
    right = slice(w - (w // 2 // refield + 1) * refield, w)
    Ls = [L[:, top, left], L[:, top, right], L[:, bottom, left],
          L[:, bottom, right]]

    if h * w <= 4 * (min_size ** 2):
        Es = [np.asarray(fn(l)) for l in Ls]
    else:
        Es = [test_split_fn(fn, l, refield, min_size, sf, modulo) for l in Ls]

    b, c = Es[0].shape[0], Es[0].shape[3]
    E = np.zeros((b, sf * h, sf * w, c), Es[0].dtype)
    h2, w2 = h // 2, w // 2
    E[:, : h2 * sf, : w2 * sf] = Es[0][:, : h2 * sf, : w2 * sf]
    E[:, : h2 * sf, w2 * sf:] = Es[1][:, : h2 * sf, (-w + w2) * sf:]
    E[:, h2 * sf:, : w2 * sf] = Es[2][:, (-h + h2) * sf:, : w2 * sf]
    E[:, h2 * sf:, w2 * sf:] = Es[3][:, (-h + h2) * sf:, (-w + w2) * sf:]
    return E


def _x8(run: Callable, L: np.ndarray) -> np.ndarray:
    """The 8-fold geometric self-ensemble around ``run`` (reference
    utils_model.py:186-199, including its mode 8-i for i = 3, 5)."""
    outs = []
    for i in range(8):
        a = np.ascontiguousarray(np.stack([im.augment_img(L[n], i)
                                           for n in range(L.shape[0])]))
        E = run(a)
        inv = (8 - i) if i in (3, 5) else i
        outs.append(np.stack([im.augment_img(E[n], inv)
                              for n in range(E.shape[0])]))
    return np.mean(np.stack(outs, 0), axis=0)


def test_x8(fn: Callable, L: np.ndarray, modulo: int = 1, sf: int = 1
            ) -> np.ndarray:
    """Mode 3: x8 self-ensemble of the padded run."""
    return _x8(lambda a: test_pad(fn, a, modulo=modulo, sf=sf), L)


def test_split_x8(fn: Callable, L: np.ndarray, refield: int = 32,
                  min_size: int = 256, sf: int = 1, modulo: int = 1
                  ) -> np.ndarray:
    """Mode 4: x8 self-ensemble of the split run."""
    return _x8(lambda a: test_split_fn(fn, a, refield, min_size, sf, modulo),
               L)


def test_mode(fn: Callable, L: np.ndarray, mode: int = 0, refield: int = 32,
              min_size: int = 256, sf: int = 1, modulo: int = 1
              ) -> np.ndarray:
    """Dispatch (reference utils_model.py:51-88)."""
    if mode == 0:
        return np.asarray(fn(L))
    if mode == 1:
        return test_pad(fn, L, modulo, sf)
    if mode == 2:
        return test_split_fn(fn, L, refield, min_size, sf, modulo)
    if mode == 3:
        return test_x8(fn, L, modulo, sf)
    if mode == 4:
        return test_split_x8(fn, L, refield, min_size, sf, modulo)
    raise ValueError(mode)


def tile_overlap(fn: Callable, L: np.ndarray, tile: int, overlap: int,
                 sf: int = 1, window: int = 8) -> np.ndarray:
    """SwinIR-style flat tiling with uniform-weight blending (reference
    main_test_swinir.py:256-284): stride tile − overlap, accumulate E and a
    weight map W, return E / W."""
    b, h, w, _ = L.shape
    tile = min(tile, h, w)
    if tile % window:
        raise ValueError("tile size should be a multiple of window_size")
    stride = tile - overlap
    h_idx = list(range(0, h - tile, stride)) + [h - tile]
    w_idx = list(range(0, w - tile, stride)) + [w - tile]
    E = W = None
    for hi in h_idx:
        for wi in w_idx:
            out = np.asarray(fn(L[:, hi: hi + tile, wi: wi + tile, :]))
            if E is None:
                E = np.zeros((b, h * sf, w * sf, out.shape[3]), np.float32)
                W = np.zeros_like(E)
            E[:, hi * sf:(hi + tile) * sf, wi * sf:(wi + tile) * sf] += out
            W[:, hi * sf:(hi + tile) * sf, wi * sf:(wi + tile) * sf] += 1.0
    return E / W


# library functions, not pytest tests
for _f in (test_pad, test_split_fn, test_x8, test_split_x8, test_mode):
    _f.__test__ = False
