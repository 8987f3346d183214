"""kair_tpu_torch — the PyTorch/CUDA port of kair_tpu for NVIDIA Hopper.

Module names follow the JAX package (``kair_tpu``) one for one, so every
module here has an obvious counterpart there. The port imports torch and
numpy only; nothing of JAX, flax or ``kair_tpu``.

Entry points run on the card: ``default_device()`` resolves to ``cuda`` and
raises when there is none, unless the caller asks for the CPU, where every
hand-written kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` or ``"cuda"`` → the current CUDA device; raises RuntimeError
    when no card is visible. ``"cpu"`` is honoured only when passed
    explicitly (tests, reference runs)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kair_tpu_torch runs on an NVIDIA GPU and none is visible "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
