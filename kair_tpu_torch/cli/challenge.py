"""Model benchmark report (counterpart of ``kair_tpu/cli/challenge.py``;
reference ``main_challenge_sr.py``:99-171): per-forward runtime, FLOPs,
parameters, activations and peak memory of a zoo network.

    python -m kair_tpu_torch.cli.challenge --net msrresnet0 --scale 4 \
        --input 256 256 --batch 1 --dtype bf16

Prints one JSON line with the JAX package's keys: ``params`` (parameter
count), ``flops_G`` (``torch.utils.flop_counter.FlopCounterMode`` over one
forward), ``activations_M`` (the output elements of every conv and
transposed conv, by forward hooks, as KAIR's ``get_model_activation``
counts), ``runtime_ms`` (median of ``--iters`` launches after a warm-up,
``utils/timing``), ``throughput_MP_per_s`` and ``device`` (the card's
name); ``bytes_accessed_MB`` is null, for PyTorch has no counterpart of
XLA's cost model. It adds ``peak_memory_MB`` (``max_memory_allocated``),
``value`` (the throughput again) and ``mfu`` (FLOP/s over the card's dense
peak for ``--dtype``, null on an unknown card or the CPU). ``--dtype``
defaults to bf16 on the card, f32 on the CPU.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def count_flops(model: nn.Module, *args) -> int:
    """FLOP (a multiply-add is 2) of one forward, by FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        model(*args)
    return counter.get_total_flops()


def count_activations(model: nn.Module, *args) -> int:
    """Output elements of every conv and transposed conv in one forward
    (KAIR utils_modelsummary.get_model_activation)."""
    total = [0]

    def hook(_m, _inp, out):
        total[0] += out.numel()

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.inference_mode():
            model(*args)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def main(argv=None, build: Optional[Callable[[dict], nn.Module]] = None
         ) -> dict:
    """``build``: option tree → module (default ``models/registry.define_g``)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--net", type=str, default="msrresnet0")
    parser.add_argument("--scale", type=int, default=4)
    parser.add_argument("--in_nc", type=int, default=3)
    parser.add_argument("--nc", type=int, default=64)
    parser.add_argument("--nb", type=int, default=16)
    parser.add_argument("--input", type=int, nargs=2, default=[256, 256])
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["f32", "bf16"],
                        help="bf16 on the card, f32 on the CPU by default")
    parser.add_argument("--iters", type=int, default=8)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from kair_tpu_torch import default_device
    from kair_tpu_torch.models.registry import define_g
    from kair_tpu_torch.utils.summary import PEAKS, card_for_device_name
    from kair_tpu_torch.utils.timing import per_iter_seconds

    dev = default_device(args.device)
    cuda = dev.type == "cuda"
    dt = args.dtype or ("bf16" if cuda else "f32")
    opt = {"netG": {"net_type": args.net, "in_nc": args.in_nc,
                    "out_nc": args.in_nc, "nc": args.nc, "nb": args.nb,
                    "scale": args.scale, "upscale": args.scale}}
    torch.manual_seed(0)
    model = (build or define_g)(opt).eval().to(
        dev, torch.bfloat16 if dt == "bf16" else torch.float32)
    h, w = args.input
    x = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch, h, w, args.in_nc).astype(np.float32)).to(dev)

    flops = count_flops(model, x)
    n_act = count_activations(model, x)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        t = per_iter_seconds(model, x, k_long=args.iters)
    mp_s = args.batch * h * w / t / 1e6
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    card = card_for_device_name(name) if cuda else None
    peak = PEAKS[card]["bf16_tflops" if dt == "bf16" else "fp32_tflops"] \
        if card else None
    report = {
        "net": args.net,
        "input": [args.batch, h, w, args.in_nc],
        "params": count_params(model),
        "flops_G": round(flops / 1e9, 3),
        "activations_M": round(n_act / 1e6, 3),
        "bytes_accessed_MB": None,
        "runtime_ms": round(t * 1e3, 3),
        "throughput_MP_per_s": round(mp_s, 3),
        "device": name,
        "dtype": dt,
        "peak_memory_MB": round(torch.cuda.max_memory_allocated(dev) / 2 ** 20,
                                1) if cuda else None,
        "value": round(mp_s, 3),
        "unit": "MP/s",
        "mfu": round(flops / t / 1e12 / peak, 4) if peak else None,
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
