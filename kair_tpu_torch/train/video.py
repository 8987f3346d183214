"""The video trainer (counterpart of ``kair_tpu/train/video.py``; KAIR
ModelVRT, model_vrt.py:16-77): the plain trainer with two parameter groups.

* "flow": every parameter whose name contains one of ``fix_keys`` (VRT-001:
  ``spynet.*`` and ``stageN.pa_deform.*``), at lr × ``fix_lr_mul``;
* "normal": the rest, at the schedule's lr.

While Adam's step count (the updates made, this one included) is at most
``fix_iter``, the flow group's updates are multiplied by 0 and its moments
still accumulate, as the JAX package's ``frozen_then_scaled`` gates only
the update (:57-63): here its lr is 0 for those updates, so Adam updates
the moments and leaves the parameters bit-equal. Both groups are Adam with
the options' betas and no weight decay (the JAX package's ``optax.adam``);
global-norm clipping, when set, comes before both (:72-75). KAIR flips
``requires_grad`` instead, so its flow moments start at the first update
after ``fix_iter`` (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from kair_tpu_torch.train.trainer import PlainTrainer


class VideoTrainer(PlainTrainer):
    """PlainTrainer + fix_keys / fix_iter / fix_lr_mul."""

    def __init__(self, opt: dict, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(opt, extra_keys=(), dtype=dtype, device=device)
        ot = self.opt_train
        self.fix_iter = ot.get("fix_iter") or 0
        self.fix_keys = tuple(ot.get("fix_keys") or ())
        self.fix_lr_mul = ot.get("fix_lr_mul") or 1.0
        if self.fix_iter and self.fix_keys:
            groups = {"normal": [], "flow": []}
            for name, p in self.model.named_parameters():
                flow = any(k in name for k in self.fix_keys)
                groups["flow" if flow else "normal"].append(p)
            betas = tuple(ot.get("G_optimizer_betas") or (0.9, 0.999))
            self.optimizer = torch.optim.Adam(
                [{"params": v, "name": k} for k, v in groups.items() if v],
                lr=ot["G_optimizer_lr"], betas=betas, eps=1e-8)

    def group_lr(self, group: dict) -> float:
        lr = self.schedule(self.step)
        if group.get("name") != "flow":
            return lr
        # the update made now is number self.step + 1
        return lr * self.fix_lr_mul if self.step + 1 > self.fix_iter else 0.0
