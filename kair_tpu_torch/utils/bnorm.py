"""BatchNorm folding into the conv before it (counterpart of
``kair_tpu/utils/bnorm.py``'s ``merge_bn_convblocks``; reference
utils/utils_bnorm.py:32-91).

In every ``nn.Sequential`` of a module, a conv directly followed by a
BatchNorm becomes one conv: w' = w·γ/√(σ²+ε), b' = (b−μ)·γ/√(σ²+ε)+β,
computed in f64, and the BatchNorm is dropped with the remaining slots
renumbered. A BN-trained DnCNN (act_mode 'BR') so becomes its released
'R' form, whose state dict loads into ``DnCNN(act_mode="R")``
(main_test_dncnn.py:118-121).
"""

from __future__ import annotations

import torch
import torch.nn as nn


@torch.no_grad()
def fold_bn(conv: nn.Module, bn: nn.BatchNorm2d) -> None:
    """Fold ``bn``'s running statistics and affine pair into ``conv`` in
    place (a Conv2d, or a ConvTranspose2d with its (I, O, k, k) weight)."""
    w = conv.weight.double()
    b = (conv.bias.double() if conv.bias is not None
         else torch.zeros(bn.num_features, dtype=torch.float64,
                          device=w.device))
    scale = bn.weight.double() * (bn.running_var.double() + bn.eps).rsqrt()
    shape = (1, -1, 1, 1) if isinstance(conv, nn.ConvTranspose2d) else \
        (-1, 1, 1, 1)
    conv.weight.copy_(w * scale.view(shape))
    b = (b - bn.running_mean.double()) * scale + bn.bias.double()
    if conv.bias is None:
        conv.bias = nn.Parameter(b.to(conv.weight.dtype))
    else:
        conv.bias.copy_(b)


def merge_bn(model: nn.Module) -> nn.Module:
    """Fold every conv + BatchNorm pair of ``model``'s Sequentials, in
    place; returns ``model``."""
    for child in model.children():
        merge_bn(child)
    if isinstance(model, nn.Sequential):
        kept = []
        for m in model.children():
            if (isinstance(m, nn.BatchNorm2d) and kept
                    and isinstance(kept[-1], (nn.Conv2d, nn.ConvTranspose2d))):
                fold_bn(kept[-1], m)
                continue
            kept.append(m)
        if len(kept) != len(model):
            model._modules.clear()
            for i, m in enumerate(kept):
                model.add_module(str(i), m)
    return model
