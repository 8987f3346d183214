"""Trainer registry (counterpart of ``kair_tpu/train/select.py``; reference
models/select_model.py:9-33): plain | plain2 | plain4 | vrt | gan."""

from __future__ import annotations

from typing import Optional

import torch

FEED_KEYS = {
    # plain feeds L; plain2 (L, C) for FFDNet (model_plain2.py:9-19);
    # plain4 (L, k, sf, sigma) for USRNet (model_plain4.py:8-23)
    "plain": (),
    "plain2": ("C",),
    "plain4": ("k", "sf", "sigma"),
}


def define_trainer(opt: dict, dtype: Optional[torch.dtype] = None,
                   device=None, vgg_state=None):
    """The trainer of ``opt['model']``; ``vgg_state`` (a torchvision vgg19
    state dict) feeds the GAN trainer's perceptual loss."""
    model = (opt.get("model") or "plain").lower()
    if model in FEED_KEYS:
        from kair_tpu_torch.train.trainer import PlainTrainer
        return PlainTrainer(opt, extra_keys=FEED_KEYS[model], dtype=dtype,
                            device=device)
    if model == "vrt":
        from kair_tpu_torch.train.video import VideoTrainer
        return VideoTrainer(opt, dtype=dtype, device=device)
    if model == "gan":
        from kair_tpu_torch.train.gan import GanTrainer
        return GanTrainer(opt, dtype=dtype, device=device, vgg_state=vgg_state)
    raise NotImplementedError(f"model [{model}] is not defined")
