"""kair_tpu_torch — the PyTorch/CUDA port of kair_tpu for NVIDIA Hopper.

Module names follow the JAX package (``kair_tpu``) one for one, so every
module here has an obvious counterpart there. The port imports torch and
numpy only; nothing of JAX, flax or ``kair_tpu``.

Entry points run on the card: ``default_device()`` resolves to ``cuda`` and
raises when there is none, unless the caller asks for the CPU, where every
hand-written kernel is replaced by its plain PyTorch version.
``exact_f32`` is what the CLIs call for ``--dtype f32`` on the card.
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


def exact_f32(device: Optional[Union[str, torch.device]],
              dtype: Optional[torch.dtype]) -> None:
    """f32 on the card means f32: turn TF32 off for cuBLAS and cuDNN when
    ``device`` (None: the card) is a CUDA device and ``dtype`` is f32, so
    the convolutions and matrix products around the f32 kernels keep f32's
    precision too (cuDNN runs f32 convolutions in TF32 by default). Does
    nothing otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
