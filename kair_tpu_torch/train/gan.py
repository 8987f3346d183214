"""GAN trainer (counterpart of ``kair_tpu/train/gan.py``; reference ModelGAN,
model_gan.py:13-374): G and D (and VGG19 features for the perceptual
loss) in alternating updates with the gan, ragan, lsgan, wgan and
softplusgan objectives.

One step, as the JAX package's jitted step:

* the G update (when ``should_update_g``): pixel + perceptual +
  adversarial loss against a frozen D (its parameters take no gradient).
  D scores in ``set_frozen_mode``: spectral layers in eval (one power
  iteration, ``u`` kept, the JAX ``train=False``), BatchNorm in training
  mode (batch statistics, running statistics updated), as KAIR's netD.
  The JAX trainer cannot train a D with BatchNorm (ROADMAP Queue 3).
  A D-only step still runs G's training-mode forward for E, without
  gradients;
* the D update: a real forward, then a fake forward on the detached E,
  both in training mode, each storing its spectral ``u`` in turn; ragan's
  relativised logits with the other side's mean detached; R1 and GP when
  ``D_r1_weight`` / ``D_gp_weight`` are set, on D with the spectral
  vectors of before the step (the JAX ``state.spectral_d``) in frozen
  mode. GP's interpolation weights come from ``gp_alpha``;
* EMA of G after G updates only.
* data parallel (``use_mesh``): G's and D's gradients and the losses
  averaged over the mesh's 'data' axis before the updates; ragan's other
  side's mean and GP's interpolation weights are the global batch's
  (``parallel.mesh.batch_mean``, ``shard_rows``), BatchNorm in D the
  global batch's statistics, as under the JAX mesh.

Each network has its own Adam (optax's defaults: betas (0.9, 0.999), eps
1e-8) and MultiStepLR schedule over its own update count. ``dtype``
bfloat16 runs G, D and VGG under autocast over f32 parameters, the
losses in f32; f32 runs a SwinIR G on the f32 kernels, and a G whose
training route runs a bf16-only kernel raises in f32 on the card
(``trainer.bf16_only_route``).

Checkpoints are KAIR's tagged state dicts: ``<step>_G.pth``, ``_D.pth``,
``_E.pth``, ``_optimizerG.pth``, ``_optimizerD.pth``; D's carries its
spectral vectors and BatchNorm statistics.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from kair_tpu_torch.models.discriminator import (load_spectral_vectors,
                                                 set_frozen_mode,
                                                 spectral_vectors)
from kair_tpu_torch.parallel.mesh import batch_mean, shard_rows
from kair_tpu_torch.train.losses import (gan_loss, get_loss_fn,
                                         gradient_penalty_loss, r1_penalty)
from kair_tpu_torch.train.schedulers import multistep
from kair_tpu_torch.train.trainer import (PlainTrainer, _tensor,
                                          clip_by_global_norm)

PAIRWISE = ("gan", "lsgan", "wgan", "softplusgan")


class GanTrainer(PlainTrainer):
    """opt        parsed option tree (``model: "gan"``, ``netG``, ``netD``)
    dtype      torch.bfloat16 (autocast) or torch.float32; None: bf16 on
               the card, f32 on the CPU
    device     None or "cuda" → the card; "cpu"
    vgg_state  a torchvision vgg19 state dict, required when
               ``F_lossfn_weight`` > 0 (random features are refused)"""

    def __init__(self, opt: dict, dtype: Optional[torch.dtype] = None,
                 device=None, vgg_state: Optional[Dict[str, Any]] = None):
        from kair_tpu_torch.models.registry import define_d

        self._init_g(opt, dtype, device)
        ot = self.opt_train
        self.model_d = define_d(opt).to(self.device).train()
        self.extra_keys = ()

        self.pixel_weight = ot.get("G_lossfn_weight") or 0
        self.pixel_loss = get_loss_fn(ot.get("G_lossfn_type") or "l1", ot) \
            if self.pixel_weight > 0 else None
        self.feature_weight = ot.get("F_lossfn_weight") or 0
        self.vgg = None
        if self.feature_weight > 0:
            from kair_tpu_torch.models.vgg import (VGG19Features,
                                                   vgg19_features_state)
            if vgg_state is None:
                raise ValueError(
                    "F_lossfn_weight > 0 requires VGG19 weights (a local "
                    "torchvision vgg19 state dict: cli.train_gan --vgg); "
                    "refusing random features")
            fl = ot.get("F_feature_layer") or 34
            self.vgg = VGG19Features(
                tuple(fl) if isinstance(fl, (list, tuple)) else (fl,),
                use_input_norm=bool(ot.get("F_use_input_norm", True)),
                use_range_norm=bool(ot.get("F_use_range_norm", False)))
            self.vgg.load_state_dict(vgg19_features_state(vgg_state, self.vgg))
            self.vgg = self.vgg.to(self.device).eval().requires_grad_(False)
            self.f_weights = ot.get("F_weights") or 1.0
            self.f_lossfn = get_loss_fn(ot.get("F_lossfn_type") or "l1", ot)

        self.gan_type = (ot.get("gan_type") or "gan").lower()
        self.d_weight = ot.get("D_lossfn_weight") or 1.0
        self.d_update_ratio = ot.get("D_update_ratio") or 1
        self.d_init_iters = ot.get("D_init_iters") or 0
        self.r1_weight = ot.get("D_r1_weight") or 0
        self.gp_weight = ot.get("D_gp_weight") or 0
        self.reg_seed = int(ot.get("D_reg_seed") or 0)

        self.schedule = multistep(ot.get("G_optimizer_lr") or 1e-4,
                                  ot.get("G_scheduler_milestones") or [],
                                  ot.get("G_scheduler_gamma") or 0.5)
        self.schedule_d = multistep(ot.get("D_optimizer_lr") or 1e-4,
                                    ot.get("D_scheduler_milestones") or [],
                                    ot.get("D_scheduler_gamma") or 0.5)
        # the lr is set from the schedules before every update
        self.optimizer = torch.optim.Adam(self.model.parameters(), eps=1e-8)
        self.optimizer_d = torch.optim.Adam(self.model_d.parameters(), eps=1e-8)
        self.clip = ot.get("G_optimizer_clipgrad") or 0
        self._init_ema()
        self.step = 0                     # steps made (G + D or D only)
        self.g_updates = 0                # G optimizer updates made
        self.mesh = None

    def nets(self) -> list:
        return [self.model, self.model_d]

    def optimizers(self) -> list:
        return [self.optimizer, self.optimizer_d]

    # ------------------------------------------------------------------
    def should_update_g(self, current_step: int) -> bool:
        """reference model_gan.py:234."""
        return (current_step % self.d_update_ratio == 0
                and current_step > self.d_init_iters)

    def gp_alpha(self, step: int, shape, device) -> torch.Tensor:
        """GP's interpolation weights at ``step`` (uniform, from a
        generator seeded by ``D_reg_seed`` and the step), drawn for the
        global batch; this rank's rows of them under a mesh."""
        gen = torch.Generator().manual_seed(self.reg_seed * 1_000_003 + step)
        if self.mesh is None:
            return torch.rand(shape, generator=gen).to(device)
        n = self.mesh.shape["data"] * self.mesh.shape.get("tile", 1)
        alpha = torch.rand((shape[0] * n,) + tuple(shape[1:]), generator=gen)
        return shard_rows(self.mesh, alpha).to(device)

    def _d(self, x: torch.Tensor) -> torch.Tensor:
        with self._autocast():
            return self.model_d(x).float()

    def _g_loss(self, e: torch.Tensor, h: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The G objective's terms (f32) against the frozen D."""
        logs: Dict[str, torch.Tensor] = {}
        e32 = e.float()
        if self.pixel_weight > 0:
            logs["G_loss"] = self.pixel_weight * self.pixel_loss(e32, h)
        if self.feature_weight > 0:
            with self._autocast():
                fe = self.vgg(e32)
                with torch.no_grad():
                    fh = self.vgg(h)
            if not isinstance(fe, (list, tuple)):
                fe, fh = [fe], [fh]
            ws = self.f_weights if isinstance(self.f_weights, (list, tuple)) \
                else [self.f_weights] * len(fe)
            logs["F_loss"] = self.feature_weight * sum(
                w * self.f_lossfn(a.float(), b.float())
                for w, a, b in zip(ws, fe, fh))
        set_frozen_mode(self.model_d)
        pred_fake = self._d(e)
        if self.gan_type in PAIRWISE:
            dl = gan_loss(pred_fake, True, self.gan_type)
        else:                             # ragan (model_gan.py:246-251)
            pred_real = self._d(h).detach()
            dl = 0.5 * (gan_loss(pred_real - batch_mean(self.mesh, pred_fake),
                                 False, self.gan_type)
                        + gan_loss(pred_fake - batch_mean(self.mesh, pred_real),
                                   True, self.gan_type))
        logs["D_loss"] = self.d_weight * dl
        return logs

    def _d_loss(self, h: torch.Tensor, e_det: torch.Tensor):
        d = self.model_d
        before = spectral_vectors(d) if self.r1_weight or self.gp_weight else None
        d.train()
        pred_real = self._d(h)
        pred_fake = self._d(e_det)
        if self.gan_type in PAIRWISE:
            loss = gan_loss(pred_real, True, self.gan_type) + \
                gan_loss(pred_fake, False, self.gan_type)
        else:                             # ragan (model_gan.py:279-288)
            loss = 0.5 * gan_loss(
                pred_real - batch_mean(self.mesh, pred_fake).detach(), True,
                self.gan_type) + 0.5 * gan_loss(
                pred_fake - batch_mean(self.mesh, pred_real).detach(), False,
                self.gan_type)
        if before is not None:
            after = spectral_vectors(d)
            load_spectral_vectors(d, before)
            set_frozen_mode(d)
            if self.r1_weight > 0:
                loss = loss + self.r1_weight * r1_penalty(self._d, h)
            if self.gp_weight > 0:
                alpha = self.gp_alpha(self.step, (h.shape[0],) + (1,) * (h.ndim - 1),
                                      h.device)
                loss = loss + self.gp_weight * gradient_penalty_loss(
                    self._d, h, e_det, alpha=alpha)
            load_spectral_vectors(d, after)
            d.train()
        return loss, pred_real.detach().mean(), pred_fake.detach().mean()

    def compute_grads(self, batch: Dict[str, Any], update_g: bool = True
                      ) -> Dict[str, torch.Tensor]:
        """The step's backward passes: G's (when ``update_g``) into G's
        ``.grad`` against the frozen D, then D's into D's ``.grad``; the
        losses, detached, on the device."""
        l_in = self._args(batch)
        h = _tensor(batch["H"], self.device).float()
        metrics: Dict[str, torch.Tensor] = {}
        self.optimizer.zero_grad(set_to_none=True)
        if update_g:
            self.model_d.requires_grad_(False)
            with self._autocast():
                e = self.model(*l_in)
            logs = self._g_loss(e, h)
            sum(logs.values()).backward()
            self.model_d.requires_grad_(True)
            metrics.update({k: v.detach() for k, v in logs.items()})
        else:
            with torch.no_grad(), self._autocast():
                e = self.model(*l_in)
        self.optimizer_d.zero_grad(set_to_none=True)
        d_total, d_real, d_fake = self._d_loss(h, e.detach())
        d_total.backward()
        metrics.update(D_total=d_total.detach(), D_real=d_real, D_fake=d_fake)
        return metrics

    @torch.no_grad()
    def apply_updates(self, update_g: bool = True) -> None:
        """G's Adam step (lr of its own update count, optional clipping)
        and EMA when ``update_g``; D's Adam step; the step count."""
        if update_g:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.g_updates)
            if self.clip > 0:
                clip_by_global_norm([p.grad for p in self.model.parameters()
                                     if p.grad is not None], self.clip)
            self.optimizer.step()
            self.g_updates += 1
        for group in self.optimizer_d.param_groups:
            group["lr"] = self.schedule_d(self.step)
        self.optimizer_d.step()
        self.step += 1
        if self.ema is not None and update_g:
            self._update_ema()

    def train_step(self, batch: Dict[str, Any],
                   update_g: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """One step: the G update (by default when ``should_update_g`` of
        the step's number says so), then the D update. Metrics stay on the
        device."""
        if update_g is None:
            update_g = self.should_update_g(self.step + 1)
        metrics = self.compute_grads(batch, update_g)
        self.average_grads(list(metrics.values()))
        self.apply_updates(update_g)
        return metrics

    # ------------------------------------------------------------------
    def save(self, save_dir: str, step: int):
        """``<step>_G/D/E/optimizerG/optimizerD.pth`` (model_gan.py:96-103)."""
        from kair_tpu_torch.ckpt import checkpoint as ck
        states = {"G": self.model.state_dict(), "D": self.model_d.state_dict(),
                  "optimizerG": self.optimizer.state_dict(),
                  "optimizerD": self.optimizer_d.state_dict()}
        if self.ema is not None:
            states["E"] = self.ema.state_dict()
        return [ck.save_tagged(save_dir, step, tag, sd)
                for tag, sd in states.items()]

    def resume(self, g_path: str, step: int) -> None:
        """Load ``<step>_G.pth`` and, beside it, ``_D``, ``_E`` and the two
        optimizers' files where they exist (a pretrained G alone, step 0,
        also seeds the EMA copy); continue at ``step`` with the G update
        count that the cadence gives."""
        from kair_tpu_torch.ckpt import checkpoint as ck
        ot = self.opt_train
        self.model.load_state_dict(ck.load(g_path, self.device),
                                   strict=bool(ot.get("G_param_strict", True)))
        base = os.path.join(os.path.dirname(g_path), f"{step}_")
        if self.ema is not None:
            e_path = base + "E.pth"
            self.ema.load_state_dict(ck.load(e_path, self.device)
                                     if os.path.exists(e_path)
                                     else self.model.state_dict())
        for tag, target in (("D", self.model_d), ("optimizerG", self.optimizer),
                            ("optimizerD", self.optimizer_d)):
            if os.path.exists(base + tag + ".pth"):
                target.load_state_dict(ck.load(base + tag + ".pth", self.device))
        self.step = int(step)
        self.g_updates = sum(self.should_update_g(s) for s in range(1, step + 1))
