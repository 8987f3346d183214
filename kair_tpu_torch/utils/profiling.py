"""torch.profiler trace capture (counterpart of
``kair_tpu/utils/profiling.py``, which wraps jax.profiler).

    from kair_tpu_torch.utils.profiling import trace, print_trace_summary
    with trace("prof/"):            # nothing when the folder is falsy
        run_the_hot_thing()
    print_trace_summary("prof/")

``trace`` records CPU activity, and the card's where there is one, and
writes a Chrome trace (``trace.<time>.<pid>.json``, for chrome://tracing
or Perfetto) into the folder. ``summarize_trace`` reads the newest one:
(name, total µs, count) rows by time, the device's kernels and copies
where the trace has any, else the CPU's operators (whose times nest).
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace into ``log_dir``; no-op if falsy."""
    if not log_dir:
        yield None
        return
    import torch
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace.{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}.json"))


def find_traces(log_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(log_dir, "trace.*.json")),
                  key=os.path.getmtime)


def summarize_trace(log_dir: str, top: int = 25
                    ) -> Optional[List[Tuple[str, float, int]]]:
    """(name, total µs, count) of the newest trace's events, the longest
    first: the device's where it has any, else the CPU's; None without a
    trace."""
    paths = find_traces(log_dir)
    if not paths:
        return None
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    chosen = device or [e for e in events if e.get("cat") == "cpu_op"]
    totals: dict = {}
    for e in chosen:
        t, c = totals.get(e["name"], (0.0, 0))
        totals[e["name"]] = (t + float(e["dur"]), c + 1)
    rows = [(name, t, c) for name, (t, c) in totals.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def print_trace_summary(log_dir: str, top: int = 25, printer=print) -> None:
    rows = summarize_trace(log_dir, top)
    if not rows:
        printer(f"profile: no trace in {log_dir}")
        return
    printer(f"profile: top {len(rows)} ops by time ({log_dir})")
    for name, us, count in rows:
        printer(f"  {us:12.1f} us  x{count:<6d} {name[:90]}")
