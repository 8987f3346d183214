"""The plain (supervised pixel-loss) trainer (counterpart of
``kair_tpu/train/trainer.py``; reference ModelPlain / ModelPlain2 /
ModelPlain4, model_plain.py:16-341).

One object holds the model (f32 master parameters), the optimizer, the EMA
copy and the update count. ``train_step`` = ``compute_grads`` (forward,
loss, backward) + ``apply_update`` (lr from the schedule, optional global-
norm clipping, Adam/AdamW, EMA), the same sequence as the JAX package's
jitted step:

* ``dtype=torch.bfloat16`` runs the forward under
  ``torch.autocast(..., bfloat16)`` over f32 parameters, the counterpart of
  flax ``dtype=bf16`` with f32 params; the Swin blocks go through the
  bf16 kernels and return f32 parameter grads. f32 (the JAX training CLI's
  default dtype) runs the CNN zoo on the card (cuDNN and cuFFT) and
  SwinIR's blocks on the f32 kernels. A model whose training route reaches
  a kernel that takes bf16 only (VRT's TMSA and self blocks, the DCN
  kernel, RVRT's STL blocks and the GDA kernel: :func:`bf16_only_route`)
  raises NotImplementedError in f32 on the card before any work, naming
  the module, rather than running composed PyTorch; on the CPU the
  kernels' plain versions run in f32.
* ``extra_keys`` feed the model after 'L'; USRNet's ``sf`` goes in as one
  Python int read from the host batch (no copy to the card, no sync), and
  a batch whose items disagree on it raises.
* the lr of update n is ``schedule(n)``, n updates made before it: the
  count at which optax evaluates the JAX schedule.
* clipping matches ``optax.clip_by_global_norm`` (no epsilon on the norm,
  unlike ``torch.nn.utils.clip_grad_norm_``).
* EMA after the update: ema·d + p·(1−d); the EMA copy's BatchNorm running
  statistics are the model's (the JAX package keeps one ``batch_stats``
  for both). BatchNorm's running variance is PyTorch's and KAIR's, from
  the unbiased batch variance; flax updates it with the biased one
  (ROADMAP Queue 3).
* data parallel (``use_mesh``): each rank steps on its rows of the global
  batch (``parallel.mesh.shard_batch``); between the backward and the
  update every gradient, and the logged losses, are averaged over the
  mesh's 'data' axis, before clipping, as XLA's all-reduce comes before
  optax in the JAX step; BatchNorm takes the global batch's statistics
  (``parallel.mesh.group_batchnorm``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from kair_tpu_torch import default_device
from kair_tpu_torch.train.losses import get_loss_fn
from kair_tpu_torch.train.regularizers import regularizer_clip, regularizer_orth
from kair_tpu_torch.train.schedulers import get_schedule


def bf16_only_route(model: torch.nn.Module) -> Optional[str]:
    """The first module whose training route on the card runs a kernel
    that takes bfloat16 only, with the kernel's name, or None (the CNN zoo:
    cuDNN and cuFFT; SwinIR: its blocks' f32 kernels). Each such module
    says so by its ``bf16_only_kernel()``."""
    for name, m in model.named_modules():
        kernel = m.bf16_only_kernel() if hasattr(m, "bf16_only_kernel") \
            else None
        if kernel:
            return f"{name} ({type(m).__name__}) runs {kernel}"
    return None


def scale_factor(v) -> int:
    """USRNet's ``sf`` as one Python int, from the host batch (the items'
    ints, as ``collate`` lists them, or one int)."""
    vals = sorted({int(x) for x in np.ravel(np.asarray(v))})
    if len(vals) != 1:
        raise ValueError(f"the batch's items disagree on sf: {vals}; USRNet "
                         "takes one scale factor a batch")
    return vals[0]


def build_optimizer(params, opt_train: dict) -> torch.optim.Optimizer:
    """Adam, or AdamW when G_optimizer_wd > 0, with the options' betas
    (reference model_plain.py:210-240; optax's eps 1e-8). The lr is set by
    the trainer before every update."""
    wd = opt_train.get("G_optimizer_wd") or 0
    betas = tuple(opt_train.get("G_optimizer_betas") or (0.9, 0.999))
    lr = opt_train["G_optimizer_lr"]
    if wd > 0:
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                 weight_decay=wd)
    return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g·max/‖g‖ when ‖g‖ ≥ max, the
    global norm over all grads, no epsilon, no host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))


def _tensor(v, device) -> torch.Tensor:
    """A batch array on ``device``. Host arrays bound for the card go
    through pinned memory: a copy from pageable memory first waits for the
    card to finish its queue, which would stall the host each step."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class PlainTrainer:
    """Config-driven supervised trainer.

    opt        parsed option tree (kair_tpu_torch.config.parse)
    extra_keys batch keys fed to the model after 'L': () plain, ('C',)
               plain2, ('k', 'sf', 'sigma') plain4 (select_model.py:9-33)
    dtype      torch.bfloat16 (autocast) or torch.float32; None picks bf16
               on the card and f32 on the CPU
    device     None or "cuda" → the card (raises without one); "cpu"
    """

    def __init__(self, opt: dict, extra_keys: Sequence[str] = (),
                 dtype: Optional[torch.dtype] = None, device=None):
        self._init_g(opt, dtype, device)
        self.loss_fn = get_loss_fn(self.opt_train["G_lossfn_type"] or "l1",
                                   self.opt_train)
        self.loss_weight = self.opt_train.get("G_lossfn_weight") or 1.0
        self.schedule = get_schedule(self.opt_train)
        self.optimizer = build_optimizer(self.model.parameters(), self.opt_train)
        self.clip = self.opt_train.get("G_optimizer_clipgrad") or 0
        self._init_ema()
        self.extra_keys = tuple(extra_keys)
        self.step = 0                     # optimizer updates made
        self.mesh = None

    def _init_g(self, opt: dict, dtype: Optional[torch.dtype], device) -> None:
        """The device, the type (None: bf16 on the card, f32 on the CPU)
        and G on the device in training mode. A G whose training route runs
        a bf16-only kernel raises here, before any work, in f32 on the
        card."""
        from kair_tpu_torch.models.registry import define_g

        self.device = default_device(device)
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        model = define_g(opt)
        where = bf16_only_route(model) if self.device.type == "cuda" \
            and dtype != torch.bfloat16 else None
        if where:
            raise NotImplementedError(
                f"training in {dtype} on the card: {where}, which takes "
                "bfloat16 only (an f32 kernel is a ROADMAP item); use "
                "--dtype bf16, or device='cpu' for f32")
        self.dtype = dtype
        self.opt = opt
        self.opt_train = opt["train"]
        self.model = model.to(self.device).train()

    def _init_ema(self) -> None:
        """The EMA copy of G when ``E_decay`` > 0; BatchNorm buffers are
        copied, not averaged."""
        self.ema_decay = self.opt_train.get("E_decay") or 0
        self.ema = None
        self._ema_buffers = []
        if self.ema_decay > 0:
            self.ema = copy.deepcopy(self.model).eval().requires_grad_(False)
            self._ema_buffers = [
                (e, b) for me, mm in zip(self.ema.modules(), self.model.modules())
                if isinstance(mm, torch.nn.modules.batchnorm._BatchNorm)
                for e, b in zip(me.buffers(), mm.buffers())]

    @torch.no_grad()
    def _update_ema(self) -> None:
        # one foreach a tensor type: a model sharded by parallel.tp mixes
        # DTensors and tensors, which one foreach call refuses
        kinds: Dict[type, tuple] = {}
        for e, p in zip(self.ema.parameters(), self.model.parameters()):
            pair = kinds.setdefault(type(e), ([], []))
            pair[0].append(e)
            pair[1].append(p)
        for ema, params in kinds.values():
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, params, alpha=1 - self.ema_decay)
        for e, b in self._ema_buffers:
            e.copy_(b)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.dtype == torch.bfloat16)

    def _args(self, batch: Dict[str, Any]):
        return [scale_factor(batch[k]) if k == "sf" else
                _tensor(batch[k], self.device)
                for k in ("L",) + self.extra_keys]

    # ------------------------------------------------------------------
    def compute_grads(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Forward, loss (f32), backward into the parameters' .grad."""
        self.optimizer.zero_grad(set_to_none=True)
        with self._autocast():
            e = self.model(*self._args(batch))
        loss = self.loss_weight * self.loss_fn(
            e.float(), _tensor(batch["H"], self.device).float())
        loss.backward()
        return loss.detach()

    def group_lr(self, group: dict) -> float:
        """The lr of a parameter group for the next update."""
        return self.schedule(self.step)

    @torch.no_grad()
    def apply_update(self) -> None:
        """lr from the schedule, clipping, the optimizer step, EMA."""
        for group in self.optimizer.param_groups:
            group["lr"] = self.group_lr(group)
        if self.clip > 0:
            clip_by_global_norm([p.grad for p in self.model.parameters()
                                 if p.grad is not None], self.clip)
        self.optimizer.step()
        self.step += 1
        if self.ema is not None:
            self._update_ema()

    def train_step(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """One update; the loss stays on the device (no host sync)."""
        loss = self.compute_grads(batch)
        self.average_grads([loss])
        self.apply_update()
        return {"G_loss": loss}

    # ------------------------------------------------------------------
    def nets(self) -> list:
        """The networks that train (their BatchNorm statistics are global
        under a mesh)."""
        return [self.model]

    def optimizers(self) -> list:
        return [self.optimizer]

    def state_tensors(self):
        """Every tensor of the training state: the networks' and the EMA
        copy's parameters and buffers, the optimizers' state."""
        for net in self.nets() + ([self.ema] if self.ema is not None else []):
            yield from net.parameters()
            yield from net.buffers()
        for opt in self.optimizers():
            for group in opt.param_groups:
                for p in group["params"]:
                    st = opt.state.get(p, {})
                    yield from (st[k] for k in sorted(st)
                                if torch.is_tensor(st[k]))

    def use_mesh(self, mesh) -> None:
        """Train data-parallel over ``mesh`` (``parallel.mesh``): rank 0's
        state broadcast, BatchNorm over the global batch, gradients
        averaged a step."""
        from kair_tpu_torch.parallel.mesh import group_batchnorm, replicate_state
        self.mesh = mesh
        for net in self.nets():
            group_batchnorm(net, mesh)
        replicate_state(mesh, list(self.state_tensors()))

    @torch.no_grad()
    def average_grads(self, values=()) -> None:
        """Average the networks' gradients and ``values`` (the step's
        losses) over the mesh's 'data' axis; nothing without a mesh."""
        if self.mesh is None:
            return
        from kair_tpu_torch.parallel.mesh import all_reduce_mean
        all_reduce_mean(self.mesh, [p.grad for net in self.nets()
                                    for p in net.parameters()
                                    if p.grad is not None] + list(values))

    # ------------------------------------------------------------------
    def eval_step(self, batch: Dict[str, Any], use_ema: bool = False
                  ) -> torch.Tensor:
        """Inference on a batch with the parameters or the EMA copy, in the
        trainer's type: a bf16 trainer on the card evaluates a bf16 copy of
        the model (the bf16 inference kernels, as cli.test runs them), an
        f32 trainer the f32 model as it is (the f32 kernels)."""
        model = self.ema if (use_ema and self.ema is not None) else self.model
        if self.device.type == "cuda" and self.dtype == torch.bfloat16:
            model = copy.deepcopy(model).to(torch.bfloat16)
        was_training = model.training
        model.eval()
        p = next(model.parameters())
        with torch.inference_mode():
            out = model(*[a.to(p.dtype) if torch.is_tensor(a)
                          and a.is_floating_point() else a
                          for a in self._args(batch)]).float()
        model.train(was_training)
        return out

    def apply_regularizers(self, current_step: int) -> None:
        """Periodic orth/clip weight regularisation, skipped on save steps
        (reference model_plain.py:300-310)."""
        ot = self.opt_train
        save_every = ot.get("checkpoint_save") or 0
        orth = ot.get("G_regularizer_orthstep") or 0
        clip = ot.get("G_regularizer_clipstep") or 0
        not_save = save_every == 0 or current_step % save_every != 0
        if orth > 0 and current_step % orth == 0 and not_save:
            regularizer_orth(self.model)
        if clip > 0 and current_step % clip == 0 and not_save:
            regularizer_clip(self.model)

    def current_lr(self, step: int) -> float:
        return float(self.schedule(step))

    # ------------------------------------------------------------------
    def save(self, save_dir: str, step: int):
        """KAIR's tagged files: <step>_G.pth, <step>_E.pth (with EMA) and
        <step>_optimizerG.pth, each a plain state dict."""
        from kair_tpu_torch.ckpt import checkpoint as ck
        paths = [ck.save_tagged(save_dir, step, "G", self.model.state_dict())]
        if self.ema is not None:
            paths.append(ck.save_tagged(save_dir, step, "E",
                                        self.ema.state_dict()))
        paths.append(ck.save_tagged(save_dir, step, "optimizerG",
                                    self.optimizer.state_dict()))
        return paths

    def resume(self, g_path: str, step: int) -> None:
        """Load <step>_G.pth and, beside it, <step>_E.pth and (with
        G_optimizer_reuse) <step>_optimizerG.pth; continue at ``step``.
        A pretrained G alone (step 0) also seeds the EMA copy."""
        import os
        from kair_tpu_torch.ckpt import checkpoint as ck
        ot = self.opt_train
        self.model.load_state_dict(ck.load(g_path, self.device),
                                   strict=bool(ot.get("G_param_strict", True)))
        base = os.path.join(os.path.dirname(g_path), f"{step}_")
        if self.ema is not None:
            e_path = base + "E.pth"
            src = ck.load(e_path, self.device) if os.path.exists(e_path) \
                else self.model.state_dict()
            self.ema.load_state_dict(src, strict=bool(ot.get("E_param_strict",
                                                             True)))
        o_path = base + "optimizerG.pth"
        if ot.get("G_optimizer_reuse") and os.path.exists(o_path):
            self.optimizer.load_state_dict(ck.load(o_path, self.device))
        self.step = int(step)
