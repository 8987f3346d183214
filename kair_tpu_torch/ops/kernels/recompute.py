"""The backward of a kernel whose JAX counterpart is a ``jax.custom_vjp``
with a Pallas forward and the composed route's VJP as its backward
(``tmsa_block.py:365-392``, ``self6_block.py:301-325``,
``dcn_block.py:166-190`` of ``kair_tpu/ops/pallas``): the composed route is
run again from the saved inputs and differentiated by autograd. That
backward is XLA code in the JAX package, not a kernel; its counterpart here
is this autograd."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def composed_vjp(fn: Callable[..., torch.Tensor],
                 saved: Sequence[Optional[torch.Tensor]],
                 needs: Sequence[bool], dy: torch.Tensor
                 ) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of fn(*saved) against dy for each saved tensor whose
    ``needs`` is set (None for the others)."""
    inputs = [None if t is None else t.detach().requires_grad_(bool(n))
              for t, n in zip(saved, needs)]
    wrt = [t for t in inputs if t is not None and t.requires_grad]
    if not wrt:
        return (None,) * len(inputs)
    with torch.enable_grad():
        out = fn(*inputs)
        grads = iter(torch.autograd.grad(out, wrt, dy.to(out.dtype)))
    return tuple(next(grads) if t is not None and t.requires_grad else None
                 for t in inputs)
