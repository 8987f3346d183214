"""Padded inference (counterpart of ``kair_tpu/eval/test_modes.py:26-40``;
reference utils/utils_model.py:110-118). ``fn`` maps an NHWC float32 numpy
batch to an NHWC numpy batch. Split, x8 and overlap tiling are a later
slice."""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def _pad_edge(x: np.ndarray, bottom: int, right: int) -> np.ndarray:
    """torch ReplicationPad2d equivalent (edge padding), NHWC."""
    if bottom == 0 and right == 0:
        return x
    return np.pad(x, ((0, 0), (0, bottom), (0, right), (0, 0)), mode="edge")


def test_pad(fn: Callable, L: np.ndarray, modulo: int = 16, sf: int = 1
             ) -> np.ndarray:
    """Mode 1: pad bottom/right to ``modulo``, run, crop to (h*sf, w*sf)."""
    h, w = L.shape[1:3]
    pb = int(math.ceil(h / modulo) * modulo - h)
    pr = int(math.ceil(w / modulo) * modulo - w)
    E = np.asarray(fn(_pad_edge(L, pb, pr)))
    return E[:, : h * sf, : w * sf, :]


test_pad.__test__ = False      # a library function, not a pytest test
