"""LPIPS perceptual metric, AlexNet-linear (counterpart of
``kair_tpu/models/lpips_jax.py``; reference utils_image.py:784-827
``calculate_lpips`` with the ``lpips`` package's alex model).

AlexNet feature trunk → each layer's features unit-normalised over the
channels (x / (‖x‖ + 1e-10), lpips' ``normalize_tensor``) → squared
difference → a learned non-negative 1×1 head → spatial mean → sum over
the five layers. NHWC in, RGB in [-1, 1]. The trunk carries torchvision's
``features.N`` keys and the heads lpips' ``lin{i}.model.1.weight``, so the
two released files load as they are (``load_lpips``, local paths only:
LPIPS with random weights is refused).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision AlexNet features: (Sequential index, out, kernel, stride,
# padding) of its convs, each followed by a ReLU; a 3x3 stride-2 max pool
# after the first two
_ALEX_CONVS = [(0, 64, 11, 4, 2), (3, 192, 5, 1, 2), (6, 384, 3, 1, 1),
               (8, 256, 3, 1, 1), (10, 256, 3, 1, 1)]
_POOL_AFTER = {0, 1}


class AlexFeatures(nn.Module):
    """The five ReLU outputs of torchvision's AlexNet ``features``, NHWC."""

    def __init__(self):
        super().__init__()
        self.features = nn.ModuleDict()
        prev = 3
        for idx, ch, k, s, p in _ALEX_CONVS:
            self.features[str(idx)] = nn.Conv2d(prev, ch, k, s, p)
            prev = ch

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)
        outs = []
        for i, (idx, *_rest) in enumerate(_ALEX_CONVS):
            x = F.relu(self.features[str(idx)](x))
            outs.append(x.permute(0, 2, 3, 1))
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return outs


class _Lin(nn.Module):
    """lpips' NetLinLayer: ``model.1`` a bias-free 1x1 conv (1, C, 1, 1)."""

    def __init__(self, c: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(c, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)


class LPIPSAlex(nn.Module):
    """lpips.LPIPS(net='alex'): distance of two NHWC RGB batches in
    [-1, 1], one value a pair."""

    def __init__(self):
        super().__init__()
        self.net = AlexFeatures()
        for i, (_, ch, *_rest) in enumerate(_ALEX_CONVS):
            setattr(self, f"lin{i}", _Lin(ch))
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]),
                             persistent=False)
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]),
                             persistent=False)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        f0 = self.net((x0 - self.shift) / self.scale)
        f1 = self.net((x1 - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / (a.pow(2).sum(-1, keepdim=True).sqrt() + 1e-10)
            b = b / (b.pow(2).sum(-1, keepdim=True).sqrt() + 1e-10)
            w = getattr(self, f"lin{i}").model[1].weight[:, :, 0, 0]   # (1, C)
            d = (a - b).pow(2) @ w.clamp(min=0).t().to(a.dtype)
            total = total + d.mean((1, 2))
        return total[:, 0]


def lpips_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``convert_lpips_alex``' tree → the port's state dict."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i, (idx, *_rest) in enumerate(_ALEX_CONVS):
        leaf = p["net"][f"conv{i}"]
        sd[f"net.features.{idx}.weight"] = torch.from_numpy(np.array(
            np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"net.features.{idx}.bias"] = torch.from_numpy(np.array(leaf["bias"]))
        lin = np.asarray(p[f"lin{i}"])                          # (C, 1)
        sd[f"lin{i}.model.1.weight"] = torch.from_numpy(np.array(
            lin.T[:, :, None, None]))
    return sd


def load_lpips(alexnet_path: Optional[str], lpips_path: Optional[str]
               ) -> LPIPSAlex:
    """LPIPSAlex from a torchvision alexnet state dict and the lpips
    package's alex.pth, local paths; raises when either is absent."""
    if not (alexnet_path and lpips_path and os.path.exists(alexnet_path)
            and os.path.exists(lpips_path)):
        raise FileNotFoundError(
            "LPIPS needs local weights: torchvision alexnet .pth and the "
            "lpips package's alex.pth. Pass their paths; refusing "
            "random-weight LPIPS.")
    alex = torch.load(alexnet_path, map_location="cpu", weights_only=True)
    lin = torch.load(lpips_path, map_location="cpu", weights_only=True)
    model = LPIPSAlex()
    sd = {f"net.features.{idx}.{w}": alex[f"features.{idx}.{w}"]
          for idx, *_r in _ALEX_CONVS for w in ("weight", "bias")}
    sd.update({k: v for k, v in lin.items() if k.startswith("lin")})
    model.load_state_dict(sd)
    return model.eval()


def make_lpips_fn(model: LPIPSAlex, device=None) -> Callable:
    """``calculate_lpips``: fn(img1, img2, border=0) on uint8 or float RGB
    [0, 255] HWC images (gray HW1 / HW repeated to 3 channels)."""
    dev = next(model.parameters()).device if device is None \
        else torch.device(device)
    model = model.to(dev).eval()

    def prep(im: np.ndarray) -> torch.Tensor:
        im = im.astype(np.float32) / 255.0
        if im.ndim == 2:
            im = im[:, :, None]
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, axis=-1)
        return torch.from_numpy(im[None] * 2.0 - 1.0).to(dev)

    def fn(img1: np.ndarray, img2: np.ndarray, border: int = 0) -> float:
        if img1.shape != img2.shape:
            raise ValueError("Input images must have the same dimensions.")
        h, w = img1.shape[:2]
        img1 = img1[border:h - border or None, border:w - border or None]
        img2 = img2[border:h - border or None, border:w - border or None]
        with torch.inference_mode():
            return float(model(prep(img1), prep(img2))[0])

    return fn


def load_lpips_default(weights_dir: Optional[str] = None, device=None):
    """(model, state dict, lpips_fn) from the conventional weights
    location, or None when the files are absent (counterpart of
    ``kair_tpu/models/lpips_jax.load_lpips_default``). The folder is
    ``weights_dir``, else ``$KAIR_LPIPS_DIR``, else
    ``<cwd>/model_zoo/lpips``; it must hold
      alexnet.pth  torchvision's AlexNet IMAGENET1K_V1 state dict
      alex.pth     the ``lpips`` package's v0.1 alex linear heads.
    Nothing is downloaded. ``lpips_fn`` runs on ``device``: the card unless
    the caller asks for the CPU."""
    from kair_tpu_torch import default_device

    d = weights_dir or os.environ.get("KAIR_LPIPS_DIR") \
        or os.path.join(os.getcwd(), "model_zoo", "lpips")
    alex_path = os.path.join(d, "alexnet.pth")
    lin_path = os.path.join(d, "alex.pth")
    if not (os.path.exists(alex_path) and os.path.exists(lin_path)):
        return None
    model = load_lpips(alex_path, lin_path).to(default_device(device))
    return model, model.state_dict(), make_lpips_fn(model)
