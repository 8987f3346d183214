"""Process-group launch (counterpart of ``kair_tpu/parallel/launch.py``;
reference utils/utils_dist.py:13-108): ``torch.distributed`` over NCCL on
the cards, gloo on the CPU.

Three ways in, the first that applies:

* ``initialize_multihost(address, n, rank)`` with its arguments;
* SLURM's variables (``SLURM_PROCID``, ``SLURM_NTASKS``,
  ``SLURM_STEP_NODELIST``, ``SLURM_LOCALID``; the head node's
  ``MASTER_PORT``, 29500 by default), as the JAX function reads them;
* the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` /
  ``LOCAL_RANK`` that ``torchrun`` sets.

Each rank takes ``cuda:<local rank>``. ``spawn`` starts ``world`` ranks
of a function on this host (``torch.multiprocessing``, spawn start), each
in its group; the training CLIs use it when ``gpu_ids`` lists several
cards, the tests with a ``file://`` rendezvous under their own folder.
"""

from __future__ import annotations

import functools
import os
import queue
import re
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def first_slurm_hostname(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, handling compressed range
    syntax (``node[01-04,07],other5``). Prefers ``scontrol show hostname``
    (the reference's method, utils_dist.py:38-42) and falls back to a
    local parser when scontrol isn't on PATH."""
    import subprocess

    try:
        out = subprocess.run(["scontrol", "show", "hostname", nodelist],
                             capture_output=True, text=True, check=True,
                             timeout=10).stdout
        if out.split():
            return out.split()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    # take the first top-level comma-separated entry (commas inside
    # brackets are range separators, not entry separators)
    depth, first = 0, []
    for ch in nodelist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            break
        first.append(ch)
    entry = "".join(first)
    m = re.match(r"^([^\[]*)\[([^\]]+)\](.*)$", entry)
    if not m:
        return entry
    prefix, body, suffix = m.groups()
    # first range element, keeping zero padding: "01-04" -> "01"
    return prefix + body.split(",")[0].split("-")[0] + suffix


def backend_for(device) -> str:
    """NCCL for the cards, gloo for the CPU."""
    return "nccl" if torch.device(device or "cuda").type == "cuda" else "gloo"


def launched_world() -> int:
    """The number of processes a launcher (SLURM or torchrun) started this
    one among; 1 when none did."""
    if "SLURM_PROCID" in os.environ:
        return int(os.environ.get("SLURM_NTASKS", "1"))
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> torch.device:
    """Join the process group from the arguments, else SLURM's variables,
    else torchrun's; returns this rank's device (``cuda:<local rank>``, or
    the CPU when ``device`` is "cpu")."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if coordinator_address is None and "SLURM_PROCID" in os.environ:
        process_id = int(os.environ["SLURM_PROCID"])
        num_processes = int(os.environ["SLURM_NTASKS"])
        local_rank = int(os.environ.get("SLURM_LOCALID", "0"))
        head = first_slurm_hostname(
            os.environ.get("SLURM_STEP_NODELIST", "localhost"))
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{head}:{port}"
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    if coordinator_address is not None:
        dist.init_process_group(backend_for(dev),
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend_for(dev), init_method="env://")
    return dev


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def master_only(fn):
    """Decorator: run only on process 0 (reference utils_dist.py:100-108)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    """Wait for every rank of the group (nothing without one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


# seconds between two looks at the ranks while none reports
POLL_S = 1.0


def _rank_main(rank: int, world: int, backend: str, device: str,
               init_method: str, fn: Callable, args: Sequence,
               results) -> None:
    """One spawned rank: join the group, run ``fn(*args)``, report."""
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, world: int, backend: Optional[str] = None,
          device: Optional[str] = None, init_method: Optional[str] = None,
          args: Sequence = ()) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` new processes of this host, rank r in
    a group of ``world`` (``backend``: NCCL on the card, gloo on the CPU
    by default; two ranks on one card need gloo); rank r sets
    ``cuda:<r mod cards>`` when ``device`` is the card. ``fn`` and its
    arguments are pickled (``fn`` by import path), and so are the results:
    return numpy arrays and plain values, not tensors, which would be
    shared through the memory of a process that has exited. The rendezvous is
    ``init_method``, by default a file store in a fresh temporary folder.
    Waits for the ranks however long they run (a training run takes days),
    and returns every rank's result, in rank order. The first rank to raise
    or to exit without a result ends the others, and its fault is raised
    here."""
    device = device or "cuda"
    backend = backend or backend_for(device)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="kair_rendezvous_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, device, init_method, fn,
                               tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    out: List[Any] = [None] * world
    pending = set(range(world))
    try:
        while pending:
            try:
                rank, ok, value = results.get(timeout=POLL_S)
            except queue.Empty:
                gone = [r for r in sorted(pending) if not procs[r].is_alive()]
                if not gone:
                    continue
                try:            # a rank's last report may still be in flight
                    rank, ok, value = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"rank {gone[0]} of {world} exited with code "
                        f"{procs[gone[0]].exitcode} without a result")
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
            pending.discard(rank)
    finally:
        for p in procs:
            if pending:
                p.terminate()
            p.join(timeout=30)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return out
