"""Receptive-field calculator (a copy of ``kair_tpu/utils/receptivefield.py``;
reference utils/utils_receptivefield.py:20-60)."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def out_from_in(conv: Sequence[float], layer_in: Tuple[float, float, float, float]):
    """conv = (kernel, stride, padding); layer = (n, jump, rf, start)."""
    n_in, j_in, r_in, start_in = layer_in
    k, s, p = conv
    n_out = (n_in - k + 2 * p) // s + 1
    pad_actual = (n_out - 1) * s - n_in + k
    p_right = pad_actual - pad_actual // 2
    j_out = j_in * s
    r_out = r_in + (k - 1) * j_in
    start_out = start_in + ((k - 1) / 2 - pad_actual // 2) * j_in
    return n_out, j_out, r_out, start_out


def receptive_field(convs: Sequence[Sequence[float]], img_size: int = 1024):
    """Layer-by-layer (n, jump, rf, start) for a conv stack."""
    layers = [(img_size, 1, 1, 0.5)]
    for conv in convs:
        layers.append(out_from_in(conv, layers[-1]))
    return layers


def effective_receptive_field(convs: Sequence[Sequence[float]]) -> int:
    return int(receptive_field(convs)[-1][2])
