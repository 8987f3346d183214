"""VGG19 feature extractor for the perceptual loss, NHWC (counterpart of
``kair_tpu/models/vgg.py``; reference models/loss.py:55-133
VGGFeatureExtractor).

torchvision's ``vgg19().features`` up to the deepest requested index, in
its own keys (``features.N.weight``), so a torchvision ``vgg19`` state dict
loads as it is (``vgg19_features_state`` takes the ``features.*`` entries
the model needs; ``cli/train_gan --vgg`` reads the file from a local
path). Feature maps come out at the given Sequential indices (34 =
conv5_4 before its ReLU; KAIR's list mode taps (2, 7, 16, 25, 34)), NHWC
like the input. There are no default weights: the perceptual loss refuses
random features (``train/gan.GanTrainer``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch
import torch.nn as nn

# torchvision vgg19 features: conv widths, 'M' a 2x2 max pool
_VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]


def vgg19_module_table() -> List[Tuple[int, str, int]]:
    """[(Sequential index, kind, channels)] of torchvision's vgg19
    features: conv, relu, pool."""
    table, idx = [], 0
    for v in _VGG19_CFG:
        if v == "M":
            table.append((idx, "pool", 0))
            idx += 1
        else:
            table += [(idx, "conv", v), (idx + 1, "relu", 0)]
            idx += 2
    return table


class VGG19Features(nn.Module):
    """Feature maps of an NHWC image batch at ``feature_layers``; one map,
    or a list when several are asked for."""

    def __init__(self, feature_layers: Union[int, Sequence[int]] = (34,),
                 use_input_norm: bool = True, use_range_norm: bool = False):
        super().__init__()
        if isinstance(feature_layers, int):
            feature_layers = (feature_layers,)
        self.feature_layers = tuple(feature_layers)
        self.use_input_norm, self.use_range_norm = use_input_norm, use_range_norm
        layers, prev = [], 3
        for idx, kind, ch in vgg19_module_table():
            if idx > max(self.feature_layers):
                break
            if kind == "conv":
                layers.append(nn.Conv2d(prev, ch, 3, 1, 1))
                prev = ch
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]),
                             persistent=False)
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]),
                             persistent=False)

    def forward(self, x: torch.Tensor):
        if self.use_range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean) / self.std
        x = x.permute(0, 3, 1, 2)
        outs = []
        for idx, layer in enumerate(self.features):
            x = layer(x)
            if idx in self.feature_layers:
                outs.append(x.permute(0, 2, 3, 1))
        return outs if len(outs) > 1 else outs[0]


def vgg19_features_state(sd: Dict[str, torch.Tensor],
                         model: VGG19Features) -> Dict[str, torch.Tensor]:
    """The entries of a torchvision vgg19 state dict that ``model`` holds
    (its ``features.N`` up to its deepest layer); raises if one is
    missing."""
    want = model.state_dict().keys()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"not a torchvision vgg19 state dict: missing {missing[:4]}")
    return {k: torch.as_tensor(sd[k]) for k in want}
