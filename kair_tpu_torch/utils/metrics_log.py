"""Experiment metric logging (a copy of ``kair_tpu/utils/metrics_log.py``,
which imports nothing of JAX): CSV history + correlation scatter plots —
the wandb-equivalent observability of the fork (main_train_spect_psnr.py:
138-201 `log_and_plot_correlations`, CSV regenerated every eval; standalone
replot_correlations.py)."""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence


class MetricsLogger:
    """Append step metrics to a CSV and regenerate correlation plots."""

    def __init__(self, log_dir: str, filename: str = "metrics.csv"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, filename)
        self.rows: List[Dict[str, float]] = []
        self._fields: List[str] = []
        if os.path.exists(self.csv_path):
            with open(self.csv_path) as f:
                for row in csv.DictReader(f):
                    self.rows.append({k: float(v) for k, v in row.items()
                                      if v != ""})
            if self.rows:
                self._fields = list(self.rows[-1].keys())

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": float(step)}
        row.update({k: float(v) for k, v in metrics.items()})
        self.rows.append(row)
        for k in row:
            if k not in self._fields:
                self._fields.append(k)
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields)
            w.writeheader()
            for r in self.rows:
                w.writerow(r)

    def best(self, metric: str, mode: str = "max") -> Optional[Dict[str, float]]:
        rows = [r for r in self.rows if metric in r]
        if not rows:
            return None
        key = (lambda r: r[metric]) if mode == "max" else (lambda r: -r[metric])
        return max(rows, key=key)

    def plot_correlations(self, pairs: Sequence[Sequence[str]] = (
            ("psnr", "ssim"), ("psnr", "lpips"), ("loss", "psnr"))) -> List[str]:
        """Scatter plots of metric pairs (reference :138-201). Returns paths."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        paths = []
        for a, b in pairs:
            xs = [r[a] for r in self.rows if a in r and b in r]
            ys = [r[b] for r in self.rows if a in r and b in r]
            if len(xs) < 2:
                continue
            fig, ax = plt.subplots(figsize=(5, 4))
            ax.scatter(xs, ys, s=10, alpha=0.7)
            ax.set_xlabel(a)
            ax.set_ylabel(b)
            import numpy as np
            corr = float(np.corrcoef(xs, ys)[0, 1]) if len(xs) > 2 else float("nan")
            ax.set_title(f"{a} vs {b} (r={corr:.3f})")
            path = os.path.join(self.log_dir, f"corr_{a}_{b}.png")
            fig.tight_layout()
            fig.savefig(path, dpi=100)
            plt.close(fig)
            paths.append(path)
        return paths
