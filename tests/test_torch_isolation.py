"""The port stands alone: no JAX, flax or kair_tpu in kair_tpu_torch/ or
chip_smoke.py, no heavy import at module level, the plain-nvcc build, the
card-first default device, and chip_smoke.py failing where it must."""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

import kair_tpu_torch
from kair_tpu_torch.ops.kernels import _build

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "kair_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "ab_kernels.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "kair_tpu")
LAZY_ONLY = ("cv2", "triton", "torch.utils.cpp_extension")


def _imports(tree):
    """(module name, at module level?) for every import in the tree."""
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_and_no_module_level_heavy_imports(path):
    for name, top_level in _imports(ast.parse(path.read_text())):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path}: imports {name}"
        assert not name.startswith("torch.utils.cpp_extension"), \
            f"{path}: the build is plain nvcc, not cpp_extension"
        if top_level:
            assert not any(name == m or name.startswith(m + ".")
                           for m in LAZY_ONLY), f"{path}: module-level {name}"


def test_cuda_sources_include_only_toolkit_headers():
    allowed = {"cuda_bf16.h", "cuda_runtime.h", "mma.h", "common.cuh"}
    srcs = sorted((REPO / "kair_tpu_torch" / "csrc").glob("*.cu*"))
    assert srcs
    for src in srcs:
        for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', src.read_text()):
            assert inc in allowed, f"{src.name} includes {inc}"


def test_port_imports_with_jax_blocked():
    code = ("import sys, importlib, pkgutil\n"
            "for m in ('jax', 'jaxlib', 'flax', 'kair_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import kair_tpu_torch\n"
            "for info in pkgutil.walk_packages(kair_tpu_torch.__path__, "
            "'kair_tpu_torch.'):\n"
            "    importlib.import_module(info.name)\n"
            "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kair_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        kair_tpu_torch.default_device("cuda")
    assert kair_tpu_torch.default_device("cpu") == torch.device("cpu")


def test_build_preset_without_card_raises(monkeypatch, tmp_path):
    from kair_tpu_torch.cli.test import build_preset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_preset("swinir_classical_x4", str(tmp_path / "absent.pth"))


def test_nvcc_command_is_one_plain_call():
    """One plain nvcc call for each source (compile only, sm_90a, no
    PyTorch headers), all started together, then one plain nvcc link of
    their objects into the library."""
    out = pathlib.Path("/nonexistent/libkair_kernels.so")
    compiles, link = _build.nvcc_commands("nvcc", out)
    srcs = []
    for cmd in compiles:
        assert cmd[0] == "nvcc"
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        assert "-c" in cmd and "-shared" not in cmd
        cu = [a for a in cmd if a.endswith(".cu")]
        assert len(cu) == 1
        srcs.append(pathlib.Path(cu[0]).name)
        obj = pathlib.Path(cmd[cmd.index("-o") + 1])
        assert obj.parent == _build.object_dir()
        assert obj.name == pathlib.Path(cu[0]).stem + ".o"
    assert set(srcs) == {"swin_block_wgmma.cu", "conv_block.cu",
                         "swin_block_bwd_wgmma.cu", "window3d_wgmma.cu",
                         "dcn_block.cu", "gda_block.cu", "bilin_sample.cu"}
    assert len(srcs) == len(set(srcs))
    assert link[0] == "nvcc" and "-shared" in link and str(out) in link
    assert link[link.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert sorted(a for a in link if a.endswith(".o")) == sorted(
        str(_build.object_dir() / f"{pathlib.Path(s).stem}.o") for s in srcs)
    torch_inc = os.path.dirname(torch.__file__)
    for cmd in compiles + [link]:
        assert not any(a.startswith("-I") or torch_inc in a for a in cmd), cmd
    assert _build.BUILD_DIR == REPO / "kair_tpu_torch" / "_build"
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.object_dir().parent == _build.BUILD_DIR


def test_profile_build_is_its_own_library():
    """-DKAIR_PROFILE (the stage-cycle marks) goes only into the profile
    library; the kernels' own build has no marks."""
    out = pathlib.Path("/nonexistent/lib.so")
    compiles, link = _build.nvcc_commands("nvcc", out)
    assert not any("-DKAIR_PROFILE" in c for c in compiles + [link])
    prof, plink = _build.nvcc_commands("nvcc", out, profile=True)
    for c in prof:
        assert "-DKAIR_PROFILE" in c
        assert c[c.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert _build.library_path(True) != _build.library_path()
    assert _build.library_path(True).parent == _build.BUILD_DIR
    assert _build.object_dir(True) != _build.object_dir()
    assert all(str(_build.object_dir(True)) in a
               for a in plink if a.endswith(".o"))


def test_parallel_build_runs_every_command_and_times_it(tmp_path):
    """``_run_all`` starts the commands together (each waits until all of
    them have started, which commands run one after another never do),
    returns each one's exit code, output and seconds in order, and raises
    on one past its timeout."""
    wait = (f"import pathlib, time\nd = pathlib.Path(r'{tmp_path}')\n"
            "(d / '{i}').touch()\nt = time.monotonic()\n"
            "while len(list(d.iterdir())) < 3 and time.monotonic() - t < 50:\n"
            "    time.sleep(0.01)\n"
            "print(len(list(d.iterdir())), {i})\nraise SystemExit({i} % 2)\n")
    cmds = [[sys.executable, "-c", wait.replace("{i}", str(i))]
            for i in range(3)]
    res = _build._run_all(cmds, 60)
    assert [(rc, out.split()) for rc, out, _ in res] == [
        (0, ["3", "0"]), (1, ["3", "1"]), (0, ["3", "2"])]
    assert all(0 < sec < 50 for _, _, sec in res)
    with pytest.raises(RuntimeError, match="timed out"):
        _build._run_all([[sys.executable, "-c", "import time; "
                          "time.sleep(5)"]], 0.3)


def test_gitignore_lists_build_dir():
    lines = (REPO / ".gitignore").read_text().split()
    assert "kair_tpu_torch/_build/" in lines


def test_chip_smoke_fails_alone_and_without_card(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(nvcc)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'error: no sm_90a here' >&2\nexit 1\n"))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build()
    assert not any(p.suffix == ".so" or ".tmp" in p.name
                   for p in (tmp_path / "build").iterdir())


def test_build_moves_the_library_into_place(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # writes the file named after -o, as nvcc would
    monkeypatch.setattr(_build, "find_nvcc", lambda: _fake_nvcc(
        tmp_path, 'while [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n'))
    out = _build.build()
    assert out == _build.library_path() and out.read_text() == "lib\n"
    assert [p.name for p in out.parent.iterdir() if ".tmp" in p.name] == []
    assert _build.build() == out          # built once per source hash


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
