"""Experiment metric logging (counterpart of ``kair_tpu/utils/metrics_log.py``,
the plots drawn without matplotlib): CSV history + correlation scatter plots —
the wandb-equivalent observability of the fork (main_train_spect_psnr.py:
138-201 `log_and_plot_correlations`, CSV regenerated every eval; standalone
replot_correlations.py)."""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_log = logging.getLogger(__name__)


class MetricsLogger:
    """Append step metrics to a CSV and regenerate correlation plots."""

    def __init__(self, log_dir: str, filename: str = "metrics.csv"):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, filename)
        self.rows: List[Dict[str, float]] = []
        self._fields: List[str] = []
        self.correlations: Dict[Tuple[str, str], float] = {}
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
        """Scatter plots of metric pairs (reference :138-201), drawn with
        numpy (``scatter_canvas``) and written as ``corr_{a}_{b}.png`` by
        ``utils/png``: no matplotlib, which the card does not have. The
        correlation r that the JAX package puts in each plot's title (nan
        with fewer than three points) is logged and kept in
        ``self.correlations[(a, b)]``. Returns the paths."""
        from kair_tpu_torch.utils.png import write_png

        paths = []
        for a, b in pairs:
            xs = [r[a] for r in self.rows if a in r and b in r]
            ys = [r[b] for r in self.rows if a in r and b in r]
            if len(xs) < 2:
                continue
            corr = float(np.corrcoef(xs, ys)[0, 1]) if len(xs) > 2 else float("nan")
            self.correlations[(a, b)] = corr
            _log.info(f"{a} vs {b} (r={corr:.3f}, {len(xs)} points)")
            path = os.path.join(self.log_dir, f"corr_{a}_{b}.png")
            write_png(path, scatter_canvas(xs, ys))
            paths.append(path)
        return paths


# the canvas: 400 x 500 pixels (matplotlib's 5 x 4 inches at 100 dpi), the
# axes box inset by MARGIN, points as 5 x 5 squares
CANVAS_HW = (400, 500)
MARGIN = 40
POINT = 2


def scatter_canvas(xs: Sequence[float], ys: Sequence[float]) -> np.ndarray:
    """(400, 500, 3) uint8: white, a black axes box, and each finite (x, y)
    a blue square placed linearly between the values' min and max (y up);
    a constant coordinate sits mid-axis."""
    h, w = CANVAS_HW
    img = np.full((h, w, 3), 255, np.uint8)
    top, left, bottom, right = MARGIN, MARGIN, h - MARGIN, w - MARGIN
    img[top, left:right + 1] = img[bottom, left:right + 1] = 0
    img[top:bottom + 1, left] = img[top:bottom + 1, right] = 0
    x, y = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
    keep = np.isfinite(x) & np.isfinite(y)
    x, y = x[keep], y[keep]
    if not len(x):
        return img

    def unit(v):
        span = v.max() - v.min()
        return (v - v.min()) / span if span > 0 else np.full_like(v, 0.5)
    inset = POINT + 2
    cx = np.rint(left + inset + unit(x) * (right - left - 2 * inset)).astype(int)
    cy = np.rint(bottom - inset - unit(y) * (bottom - top - 2 * inset)).astype(int)
    for px, py in zip(cx, cy):
        img[py - POINT:py + POINT + 1, px - POINT:px + POINT + 1] = (31, 119, 180)
    return img
