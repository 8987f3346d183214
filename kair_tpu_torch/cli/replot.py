"""Regenerate metric-correlation plots from a training run's CSV
(counterpart of ``kair_tpu/cli/replot.py``; the fork's standalone
replot_correlations.py), drawn without matplotlib.

    python -m kair_tpu_torch.cli.replot --log_dir runs/SPECTdenoising/<task>
"""

from __future__ import annotations

import argparse

from kair_tpu_torch.utils.metrics_log import MetricsLogger


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--log_dir", required=True)
    p.add_argument("--pairs", nargs="*", default=None,
                   help="metric pairs as a:b, e.g. psnr:ssim loss:psnr")
    args = p.parse_args(argv)
    ml = MetricsLogger(args.log_dir)
    if args.pairs:
        pairs = [tuple(s.split(":")) for s in args.pairs]
    else:
        keys = [k for k in (ml.rows[-1] if ml.rows else {}) if k != "step"]
        pairs = [(a, b) for i, a in enumerate(keys) for b in keys[i + 1:]][:8]
    paths = ml.plot_correlations(pairs)
    for pth in paths:
        print("wrote", pth)
    return paths


if __name__ == "__main__":
    main()
