"""The backward of a kernel whose JAX counterpart is a ``jax.custom_vjp``
with a Pallas forward and the composed route's VJP as its backward
(``tmsa_block.py:365-392``, ``self6_block.py:301-325``,
``stl_block.py:187-201``, ``dcn_block.py:166-190``, ``gda_block.py:210-224``
of ``kair_tpu/ops/pallas``): the composed route is run again from the saved
inputs and differentiated by autograd. That backward is XLA code in the JAX
package, not a kernel; its counterpart here is this autograd.
``Win3dBlockFunction`` is the training function of the three 3-D window
block kernels."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from kair_tpu_torch.ops import window3d
from kair_tpu_torch.ops.window3d import Tmsa3dParams


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


class Win3dBlockFunction(torch.autograd.Function):
    """A 3-D window block kernel's forward, ``kernel(x, p)`` (VRT's TMSA
    and self blocks, RVRT's STL2 block); backward by autograd through
    ``window3d.tmsa_composed`` at window ``ws`` and shift ``shift``,
    recomputed from the saved x and parameters under the forward's
    autocast state (the JAX remat profile: only x is saved). On the card x
    runs in bf16 whatever it arrives in (the kernels take bf16; the f32
    parameters get f32 grads) and dx goes back in x's type. Nothing but
    ``ctx`` holds state, so a checkpoint's recompute may run it again."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, kernel, num_heads, ws, shift, *params):
        ctx.num_heads, ctx.ws, ctx.shift = num_heads, tuple(ws), tuple(shift)
        ctx.x_dtype = x.dtype
        xin = x.to(torch.bfloat16).contiguous() if x.is_cuda else x
        ctx.save_for_backward(xin, *params)
        return kernel(xin, Tmsa3dParams(*params))

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        needs = ctx.needs_input_grad[:1] + ctx.needs_input_grad[5:]
        dx, *grads = composed_vjp(
            lambda x, *p: window3d.tmsa_composed(
                x, Tmsa3dParams(*p), ctx.num_heads, ctx.ws, ctx.shift),
            ctx.saved_tensors, needs, dy)
        return (None if dx is None else dx.to(ctx.x_dtype), None, None, None,
                None, *grads)


def win3d_train(kernel: Callable[[torch.Tensor, Tmsa3dParams], torch.Tensor],
                x: torch.Tensor, p: Tmsa3dParams, num_heads: int,
                ws: Sequence[int], shift: Sequence[int]) -> torch.Tensor:
    """Differentiable ``kernel(x, p)``: ``Win3dBlockFunction``."""
    return Win3dBlockFunction.apply(x, kernel, num_heads, tuple(ws),
                                    tuple(shift), *p)
