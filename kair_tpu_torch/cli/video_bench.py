"""VRT / RVRT video-SR throughput on one card (counterpart of
``kair_tpu/cli/video_bench.py``).

    python -m kair_tpu_torch.cli.video_bench --net vrt --frames 6 --size 64
    python -m kair_tpu_torch.cli.video_bench --net rvrt --compare --profile

Builds the released 001 network (``cli/test_video``'s
``001_VRT_videosr_bi_REDS_6frames`` / ``001_RVRT_videosr_bi_REDS_30frames``
presets) with seeded weights in bf16 (SpyNet in f32), and times ``--k``
forwards of a seeded (batch, frames, size, size, 3) clip with CUDA events
after two warm-ups (``utils/timing``). ``--fuse`` (auto: on where a card
is present; a bare ``--fuse`` is on) runs the TMSA / self / STL2 block
kernels; ``--deform``: ``fused`` (the DCN or GDA kernel on the card; the
port's "auto"), ``mxu`` (the bilinear sampler kernels, VRT) or
``gather`` (the composed route); ``--compare`` times all three in turns in
one process. Prints one JSON line per route with the JAX package's keys:
``metric``, ``value`` (LR frame-MP/s), ``unit``, ``vs_baseline`` (null),
``ms_per_clip`` (the median of the 3 rounds' launches; ``ms_min`` the
least), ``tflops`` and ``mfu`` (the analytic FLOP of
``utils/summary.vrt_flops_per_clip`` / ``rvrt_flops_per_clip`` over the
card's dense bf16 peak; null on an unknown card or the CPU).
``--profile`` adds ``profile``: device ms by kernel and the idle share of
one clip, from torch.profiler; ``--profile DIR`` also writes a Chrome
trace of one clip a route into DIR (``utils/profiling``) and prints its
top operators to stderr. ``--device cpu`` runs the plain versions in
f32 (a CPU time).
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

TASKS = {"vrt": "001_VRT_videosr_bi_REDS_6frames",
         "rvrt": "001_RVRT_videosr_bi_REDS_30frames"}
DEFORM = {"fused": "auto", "mxu": "mxu", "gather": "gather"}


def build_clip_model(net: str, deform: str, fuse: bool) -> nn.Module:
    """The 001 preset's network, seeded, f32 on the CPU."""
    from kair_tpu_torch.cli.test_video import RVRT_TASKS, VRT_TASKS
    from kair_tpu_torch.models.rvrt import RVRT
    from kair_tpu_torch.models.vrt import VRT
    torch.manual_seed(0)
    if net == "rvrt":
        return RVRT(**RVRT_TASKS[TASKS[net]], fuse_block=fuse,
                    deform_impl=deform)
    return VRT(**VRT_TASKS[TASKS[net]], fuse_block=fuse, deform_impl=deform)


def main(argv=None,
         build: Optional[Callable[[str, str, bool], nn.Module]] = None
         ) -> list:
    """``build``: (net, deform_impl, fuse) → module (default
    :func:`build_clip_model`)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--net", choices=["vrt", "rvrt"], default="vrt")
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--fuse", nargs="?", const="on", default="auto",
                        choices=["auto", "on", "off"],
                        help="the block kernels: auto = on where a card is "
                             "present")
    parser.add_argument("--deform", choices=list(DEFORM), default="fused")
    parser.add_argument("--compare", action="store_true",
                        help="time every deform route in turns in one "
                             "process")
    parser.add_argument("--k", type=int, default=4,
                        help="timed forwards a route a round (3 rounds)")
    parser.add_argument("--profile", nargs="?", const=True, default=None,
                        metavar="DIR",
                        help="device ms by kernel and the idle share of "
                             "one clip (torch.profiler); with DIR also a "
                             "Chrome trace of one clip a route there and "
                             "its top operators on stderr")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from kair_tpu_torch import default_device
    from kair_tpu_torch.models.vrt import cast_for_inference
    from kair_tpu_torch.utils.summary import (peak_bf16_tflops,
                                              rvrt_flops_per_clip,
                                              vrt_flops_per_clip)
    from kair_tpu_torch.utils.timing import device_profile, launch_ms

    dev = default_device(args.device)
    cuda = dev.type == "cuda"
    fuse = args.fuse == "on" or (args.fuse == "auto" and cuda)
    dtype = torch.bfloat16 if cuda else torch.float32
    x = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch, args.frames, args.size, args.size, 3).astype(
            np.float32)).to(dev)
    deforms = list(DEFORM) if args.compare else [args.deform]
    models = {d: cast_for_inference(
        (build or build_clip_model)(args.net, DEFORM[d], fuse), dev, dtype)
        for d in deforms}
    times = {d: [] for d in deforms}
    with torch.inference_mode():
        for r in range(3):
            for d, m in models.items():        # in turns: one process's A/B
                times[d] += launch_ms(lambda m=m: m(x), args.k,
                                      2 if r == 0 else 0, cuda)

    flops_fn = rvrt_flops_per_clip if args.net == "rvrt" else vrt_flops_per_clip
    flops = flops_fn(frames=args.frames, h=args.size, w=args.size) * args.batch
    peak = peak_bf16_tflops(torch.cuda.get_device_name(dev)) if cuda else None
    mp = args.batch * args.frames * args.size * args.size / 1e6
    out = []
    for d, ts in times.items():
        ms = float(np.median(ts))
        tflops = flops / (ms / 1e3) / 1e12
        report = {
            "metric": f"{args.net.upper()} x4 video SR throughput "
                      f"({args.frames}x{args.size}px, "
                      f"{'bf16' if cuda else 'f32'}"
                      f"{', fused blocks' if fuse else ''}, deform={d})",
            "value": round(mp / (ms / 1e3), 4),
            "unit": "MP/s/chip" if cuda else "MP/s (cpu)",
            "vs_baseline": None,
            "ms_per_clip": round(ms, 3),
            "ms_min": round(min(ts), 3),
            "tflops": round(tflops, 3),
            "mfu": round(tflops / peak, 4) if peak else None,
        }
        if args.profile and cuda:
            m = models[d]
            with torch.inference_mode():
                report["profile"] = device_profile(lambda: m(x), 1, ms)
        print(json.dumps(report))
        out.append(report)
    if isinstance(args.profile, str):
        import sys
        from kair_tpu_torch.utils.profiling import print_trace_summary, trace
        with torch.inference_mode(), trace(args.profile):
            for m in models.values():
                m(x)
        print_trace_summary(args.profile,
                            printer=lambda *a: print(*a, file=sys.stderr))
    return out


if __name__ == "__main__":
    main()
