"""SPECT training entry (counterpart of ``kair_tpu/cli/train_spect.py``;
the fork's main_train_spect_psnr.py:204-708): every ``test*`` / ``val*``
dataset evaluated by ``eval/harness`` (clean and, with ``eval_repoisson``,
re-Poissoned, the local LPIPS over ``train.lpips_local_repeat_n`` draws),
the best-PSNR / best-SSIM models on the first of them kept, a CSV metric
history with correlation plots redrawn at every evaluation, and
``--restart`` to wipe the task folder first (fork :226-241).

    python -m kair_tpu_torch.cli.config_generator \
        --template options/spect/base_template.json \
        --networks options/spect/network_configs.json \
        --experiments options/spect/experiment_configs.json --out generated/
    python -m kair_tpu_torch.cli.train_spect \
        --opt generated/swinir_psnr_8x_linear.json

Runs on the card, bf16 by default; ``--dtype f32`` runs the CNNs and the
SwinIR in f32 (the f32 kernels), with TF32 off for cuBLAS and cuDNN
(``cli/train.prepare``, ``exact_f32``); ``--device cpu`` runs the kernels'
plain versions on the CPU. Checkpoints are the
port trainer's (``<iter>_G.pth``, ``<iter>_E.pth``,
``<iter>_optimizerG.pth``, older ones pruned at each save, the newest
resumed; ``path.pretrained_netG`` seeds a fresh run), the best models
``bestmodel/best_{psnr,ssim}_{G,E}.pth``.

Each evaluation denormalises with the normalisation its dataset object
applied (``DatasetSPECT.normalization``). The JAX CLI hands the harness
the option block's ``normalization`` instead, which denormalises "linear"
where the block has none while the dataset normalised "log"; parsed
option files broadcast the top-level block into every dataset, so the
shipped templates do not meet that case. The ``*_loss`` columns are
the trainer's loss on E against H (``eval_loss``); the JAX CLI hands the
harness no loss, so its columns read 0.

The setup, the step loop, the checkpoints and data parallelism over
``gpu_ids`` are ``cli/train``'s ``prepare`` and ``train_loop``; this CLI
adds the evaluations, the best models and the metric history (rank 0's).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kair_tpu_torch.ckpt import checkpoint as ck
from kair_tpu_torch.cli import train as train_cli
from kair_tpu_torch.data.base import Loader
from kair_tpu_torch.data.datasets import define_dataset
from kair_tpu_torch.eval.harness import evaluate_model
from kair_tpu_torch.models.lpips import load_lpips_default
from kair_tpu_torch.utils.metrics_log import MetricsLogger


def _arrays(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def eval_loss(trainer):
    """``loss_fn(E, H)`` for the harness: the trainer's weighted training
    loss on the normalised host arrays, as ``G_loss`` is logged (the fork's
    _collect_test_data). The JAX CLI hands the harness none, so its
    ``*_loss`` columns read 0."""
    def loss(e: np.ndarray, h: np.ndarray) -> float:
        with torch.no_grad():
            return trainer.loss_weight * float(trainer.loss_fn(
                torch.from_numpy(e), torch.from_numpy(
                    np.asarray(h, np.float32))))
    return loss


def run_evals(trainer, val_loaders: dict, lpips_fn, lpips_repeat: int,
              use_ema: bool, logger) -> dict:
    """``{<set>[_poisson]_<metric>: value}`` over every validation set, the
    finite values only (nan LPIPS without weights is left out, as the JAX
    CLI does). "loss" is ``eval_loss`` on E against H before any
    re-Poissoning, so the clean and re-Poissoned columns agree."""
    all_metrics = {}
    loss_fn = eval_loss(trainer)
    for name, (ds_opt, loader) in val_loaders.items():
        norm = getattr(loader.dataset, "normalization",
                       ds_opt.get("normalization"))
        for poisson in ((False, True) if ds_opt.get("eval_repoisson")
                        else (False,)):
            m = evaluate_model(
                lambda batch: trainer.eval_step(_arrays(batch),
                                                use_ema=use_ema),
                loader, norm, lpips_fn=lpips_fn, add_poisson_noise=poisson,
                lpips_local_repeat_n=lpips_repeat, loss_fn=loss_fn)
            tag = f"{name}{'_poisson' if poisson else ''}"
            for k, v in m.items():
                if np.isfinite(v):
                    all_metrics[f"{tag}_{k}"] = v
            logger.info(f"[{tag}] " + " ".join(
                f"{k}:{v:.4f}" for k, v in m.items() if np.isfinite(v)))
    return all_metrics


def main(json_path: Optional[str] = None, argv=None):
    parser = train_cli.make_parser(json_path)
    parser.add_argument("--restart", action="store_true",
                        help="wipe the task dir and start fresh (fork :226)")
    args = parser.parse_args(argv)
    run = train_cli.prepare(args, "train_spect", default_seed=1234,
                            restart=args.restart)
    if run.trainer is None:
        train_cli.spawn_ranks(main, run.mesh, args.device, json_path, argv)
        return None
    opt, trainer, logger = run.opt, run.trainer, run.logger
    mlog = MetricsLogger(opt["path"]["log"])
    val_loaders = {
        phase: (ds_opt, Loader(define_dataset(ds_opt), 1, shuffle=False,
                               drop_last=False))
        for phase, ds_opt in opt["datasets"].items()
        if phase.startswith(("test", "val"))}

    ot = opt["train"]
    lpips_repeat = ot.get("lpips_local_repeat_n") or 1
    use_ema = (ot.get("E_decay") or 0) > 0
    models = opt["path"]["models"]
    best = {"psnr": -1.0, "ssim": -1.0}

    lp = load_lpips_default(device=trainer.device)
    lpips_fn = lp[2] if lp else None
    if lp:
        logger.info("LPIPS weights found - global/local LPIPS enabled")
    else:
        logger.info("LPIPS weights absent (KAIR_LPIPS_DIR / model_zoo/lpips)"
                    " - LPIPS metrics reported as nan")

    def save_best(metric: str) -> None:
        ck.save_best(models, metric, "G", trainer.model.state_dict())
        if trainer.ema is not None:
            ck.save_best(models, metric, "E", trainer.ema.state_dict())

    def on_test(step: int, epoch: int) -> None:
        metrics = run_evals(trainer, val_loaders, lpips_fn, lpips_repeat,
                            use_ema, logger)
        mlog.log(step, metrics)
        mlog.plot_correlations([(a, b) for a in metrics for b in metrics
                                if a < b][:6])
        first = next(iter(val_loaders))
        for metric in ("psnr", "ssim"):
            value = metrics.get(f"{first}_{metric}", -1)
            if value > best[metric]:
                best[metric] = value
                save_best(metric)

    return train_cli.train_loop(
        run, save_every=ot.get("checkpoint_save") or 500,
        test_every=ot.get("checkpoint_test") or 500, prune=True,
        on_test=on_test if val_loaders else None)


if __name__ == "__main__":
    main()
