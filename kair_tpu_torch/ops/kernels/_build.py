"""Build the port's CUDA kernels with plain ``nvcc`` calls, bind with ctypes.

Every source under ``kair_tpu_torch/csrc/`` compiles in its own ``nvcc``
process, all of them started together, each under its own timeout:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas=-v -c -o <build>/obj.<hash>/<src>.o csrc/<src>.cu

then one link puts the objects into one library:

    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o <build>/libkair_kernels.<hash>.so <build>/obj.<hash>/*.o

so the build takes as long as its slowest source, not the sum of all.
The sources have a plain C interface and include only the CUDA toolkit's
headers (no PyTorch headers, no CUTLASS, no ninja or ``cpp_extension``).
The library goes to ``kair_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the sources; it is linked under a temporary name and
moved into place with ``os.replace``, so a killed build never leaves a
half-written library behind. A missing ``nvcc`` or a failed build raises
with the compiler's output; nothing falls back. ``build_seconds`` holds
each compile's, the link's and the whole build's wall seconds.

Nothing here runs at import time: the first kernel launch builds and loads.
``library(profile=True)`` builds the same sources with ``-DKAIR_PROFILE``
into a library of its own, for ``cli/profile_swin_block.py``,
``cli/profile_swin_bwd.py``, ``cli/profile_conv.py`` and
``cli/profile_dcn.py`` only.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BUILD_TIMEOUT_S = 300       # each compile, and the link


def round16(v: int) -> int:
    """Pad a matrix dimension to the 16 of a tensor-core tile."""
    return (v + 15) // 16 * 16


# H100 opt-in shared memory per thread block
SMEM_LIMIT = 232448


def align128(v: int) -> int:
    """A shared-memory offset aligned as the kernels align their buffers."""
    return (v + 127) // 128 * 128


_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: (argument types, return type). Pointers and the stream
# are c_void_p, sizes and phase c_int; a launch returns its cudaError_t.
SIGNATURES = {
    # x, out, stages, bqkv, bp, b1, b2, relbias, mask,
    # B, H, W, C, NH, HP, phase, ws, stream
    "kair_swin_block": ([_P] * 9 + [_I] * 8 + [_P], _I),
    # y, out, stages, bqkv, bp, relbias, mask, B, H, W, C, NH, phase, ws,
    # stream
    "kair_window_msa": ([_P] * 7 + [_I] * 7 + [_P], _I),
    # x, dy, stages, bqkv, bp, b1, ln, relbias, mask, scratch, ops,
    # part_bias, part_ln, part_w, dx, dw, dln, dbias, B, H, W, C, NH, hidden,
    # phase, sms, splits, scale, stream
    "kair_swin_block_2d_bwd": ([_P] * 18 + [_I] * 9 + [ctypes.c_float, _P],
                               _I),
    # y, res, w, bias, out, B, H, W, C, phase, stream
    "kair_conv3x3_residual": ([_P] * 5 + [_I] * 5 + [_P], _I),
    # x, out, wqkv, bqkv, wp, bp, ln, w1, b1, w2, b2, relbias, mask,
    # B, H, W, C, NH, HDP, hidden, phase, ws, mode, scale, stream
    "kair_swin_block_f32": ([_P] * 13 + [_I] * 10 + [ctypes.c_float, _P], _I),
    # x, dy, wqkv, bqkv, wp, bp, ln, w1, b1, w2, b2, relbias, mask, ops,
    # part_bias, part_ln, part_w, dx, dw, dln, dbias, B, H, W, C, NH, HDP,
    # hidden, phase, grid, splits, scale, stream
    "kair_swin_block_2d_bwd_f32": ([_P] * 21 + [_I] * 10
                                   + [ctypes.c_float, _P], _I),
    # y, res, w, bias, out, B, H, W, C, phase, stream
    "kair_conv3x3_residual_f32": ([_P] * 5 + [_I] * 5 + [_P], _I),
    # kind, x, out, qkv, att, st1, bq, st3, pos, ln1, ln2, bp, b11, b12,
    # b2, rel_table, labels, B, D, H, W, C, NH, hidden, wd, twd, sd, sh, sw,
    # stream
    "kair_win3d_block": ([_I] + [_P] * 16 + [_I] * 12 + [_P], _I),
    # x, off, mask, w, bias, out, part, N, H, W, Cin, Cout, DG, splits, stream
    "kair_dcn": ([_P] * 7 + [_I] * 7 + [_P], _I),
    # q, k, v, off, out, Bq, frames, clip, H, W, C, DG, kh, kw, stream
    "kair_gda": ([_P] * 5 + [_I] * 9 + [_P], _I),
    # feat, fy, fx, out, G, H, W, Cs, R, bf16, vec, stream
    "kair_bilin_fwd": ([_P] * 4 + [_I] * 7 + [_P], _I),
    # feat, fy, fx, dout, dfeat, dfy, dfx, scratch, G, H, W, Cs, R, bf16, vec,
    # th, tw, tc, stream
    "kair_bilin_bwd": ([_P] * 8 + [_I] * 10 + [_P], _I),
    # G, H, W, Cs, R, bf16, vec, th, tw, tc
    "kair_bilin_bwd_scratch_bytes": ([_I] * 10, ctypes.c_longlong),
    "kair_bilin_bwd_shared_bytes": ([_I] * 10, ctypes.c_longlong),  # the same
    "kair_swin_block_shared_bytes": ([_I] * 3, _I),      # C, NH, HP
    "kair_swin_block_plan": ([_I] * 3 + [_P], _I),       # C, NH, HP, dst (i32[5])
    "kair_swin_bwd_plan": ([_I] * 3 + [_P], _I),          # C, NH, hidden, dst (i32[10])
    "kair_conv3x3_shared_bytes": ([_I], _I),             # C
    "kair_conv3x3_f32_shared_bytes": ([_I], _I),         # C
    "kair_swin_f32_plan": ([_I] * 4 + [_P], _I),          # C, NH, HDP, ws, dst (i32[4])
    "kair_swin_bwd_f32_plan": ([_I] * 4 + [_P], _I),      # C, NH, HDP, hidden, dst (i32[4])
    "kair_conv3x3_plan": ([_I, _P], _I),                 # C, dst (host i32[4])
    # kind, C, NH, hidden, wd, twd, dst (host i32[17])
    "kair_win3d_plan": ([_I] * 6 + [_P], _I),
    "kair_dcn_plan": ([_I] * 3 + [_P], _I),               # Cin, Cout, DG, dst (i32[8])
    "kair_gda_plan": ([_I] * 7 + [_P], _I),               # C, DG, K, clip, H, W, align, dst (i32[7])
    "kair_error_string": ([_I], ctypes.c_char_p),
}
PROFILE_SIGNATURES = {
    "kair_swin_wg_cycles": ([_P, _I], _I),               # dst (host u64[8]), mode
    "kair_conv_stage_cycles": ([_P, _I], _I),    # dst (host u64[4]), products_only
    "kair_swin_bwd_cycles": ([_P], _I),                  # dst (host u64[10])
    "kair_dcn_stage_cycles": ([_P], _I),                 # dst (host u64[6])
}

_lock = threading.Lock()
_libs: Dict[bool, ctypes.CDLL] = {}
# wall seconds of the last build in this process: each source's compile, the
# link, and the whole build ("total")
build_seconds: Dict[str, float] = {}


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source and header under csrc/ (names and bytes)."""
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(profile: bool = False) -> Path:
    name = "libkair_kernels_profile" if profile else "libkair_kernels"
    return BUILD_DIR / f"{name}.{source_hash()}.so"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the port's CUDA kernels are built on first use "
        "and need the CUDA toolkit")


def _flags(profile: bool) -> List[str]:
    return ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                         "-Xptxas=-v"] + (["-DKAIR_PROFILE"] if profile else [])


def object_dir(profile: bool = False) -> Path:
    """Where this source hash's objects are compiled."""
    return BUILD_DIR / f"obj{'_profile' if profile else ''}.{source_hash()}"


def nvcc_commands(nvcc: str, out_path: Path, profile: bool = False
                  ) -> Tuple[List[List[str]], List[str]]:
    """The compile command of each source and the link command (a dry run:
    nothing is executed)."""
    objs = object_dir(profile)
    compiles = [[nvcc] + _flags(profile)
                + ["-c", "-o", str(objs / f"{src.stem}.o"), str(src)]
                for src in sources()]
    link = ([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(out_path)]
            + [str(objs / f"{src.stem}.o") for src in sources()])
    return compiles, link


def _run_all(cmds: List[List[str]], timeout: float
             ) -> List[Tuple[int, str, float]]:
    """Run every command at once, each in its own process under its own
    ``timeout``; returns each one's (exit code, output, wall seconds). A
    command past its timeout is killed and raises RuntimeError."""
    def run(cmd: List[str]) -> Tuple[int, str, float]:
        t0 = time.monotonic()
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"nvcc timed out after {timeout}s: "
                               f"{' '.join(cmd)}") from e
        return proc.returncode, proc.stdout, time.monotonic() - t0

    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        return list(pool.map(run, cmds))


def build(profile: bool = False) -> Path:
    """Compile the library unless this source hash is already built: every
    source in its own process, all at once, then one link."""
    out = library_path(profile)
    if out.exists():
        return out
    nvcc = find_nvcc()
    t0 = time.monotonic()
    object_dir(profile).mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    compiles, link = nvcc_commands(nvcc, tmp, profile)
    results = _run_all(compiles, BUILD_TIMEOUT_S)
    secs = {Path(c[-1]).name: r[2] for c, r in zip(compiles, results)}
    # ptxas -v reports registers, shared memory and spills
    log = "".join(r[1] for r in results)
    for c, (rc, text, _) in zip(compiles, results):
        if rc != 0:
            out.with_suffix(".log").write_text(log)
            raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(c)}\n{text}")
    t1 = time.monotonic()
    (rc, text, _), = _run_all([link], BUILD_TIMEOUT_S)
    out.with_suffix(".log").write_text(log + text)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc link failed (exit {rc}): {' '.join(link)}"
                           f"\n{text}")
    os.replace(tmp, out)
    build_seconds.clear()
    build_seconds.update(secs, link=time.monotonic() - t1,
                         total=time.monotonic() - t0)
    return out


def build_log() -> str:
    """The compiler's output for the current sources ('' before a build)."""
    p = library_path().with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(profile: bool = False) -> ctypes.CDLL:
    """Build (first call) and load the kernel library, with typed entries."""
    with _lock:
        if profile not in _libs:
            lib = ctypes.CDLL(str(build(profile)))
            sigs = {**SIGNATURES, **(PROFILE_SIGNATURES if profile else {})}
            for name, (argtypes, restype) in sigs.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[profile] = lib
    return _libs[profile]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = library().kair_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
