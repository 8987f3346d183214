"""Weight regularisers applied every N steps (counterpart of
``kair_tpu/train/regularizers.py``; reference
utils/utils_regularizers.py:16-96, invoked from model_plain.py:303-310).

In place on a module's parameters, under ``no_grad``. ``regularizer_orth``
takes every 4-D weight (the conv kernels, OIHW) as the (kh·kw·c_in, c_out)
matrix the reference and the JAX package (HWIO) use.
"""

from __future__ import annotations

import torch
import torch.nn as nn


@torch.no_grad()
def regularizer_orth(model: nn.Module) -> None:
    """SVD orthogonalisation: singular values above 1.5 or below 0.5 move
    1e-4 toward [0.5, 1.5] (reference utils_regularizers.py:16-41)."""
    for w in model.parameters():
        if w.dim() != 4:
            continue
        co, ci, f1, f2 = w.shape
        mat = w.permute(2, 3, 1, 0).reshape(f1 * f2 * ci, co).float()
        u, s, vt = torch.linalg.svd(mat, full_matrices=False)
        s = torch.where(s > 1.5, s - 1e-4, s)
        s = torch.where(s < 0.5, s + 1e-4, s)
        new = (u @ torch.diag(s) @ vt).reshape(f1, f2, ci, co)
        w.copy_(new.permute(3, 2, 0, 1))


@torch.no_grad()
def regularizer_clip(model: nn.Module) -> None:
    """Values outside [−1.5, 1.5] move back by 1e-4, every parameter
    (reference utils_regularizers.py:74-96)."""
    eps, c_min, c_max = 1e-4, -1.5, 1.5
    for w in model.parameters():
        w.copy_(torch.where(w > c_max, w - eps, w))
        w.copy_(torch.where(w < c_min, w + eps, w))
