"""The port's tools on the CPU: ``utils/profiling`` (a trace of a small
model written, its operators summarised by time, a falsy folder a no-op),
``cli/device_check --device cpu``, ``cli/download_models`` (its ``ZOO``
the JAX table; a ``file://`` source copied once, then "already exists";
no network), and ``--profile DIR`` of ``cli/train_bench`` and
``cli/video_bench``."""

import os

import pytest
import torch

from kair_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_and_summarises_it(tmp_path):
    model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.ReLU(),
                                torch.nn.Conv2d(8, 3, 3))
    x = torch.rand(2, 3, 32, 32)
    with profiling.trace(str(tmp_path)):
        model(x)
    traces = profiling.find_traces(str(tmp_path))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    rows = profiling.summarize_trace(str(tmp_path), top=50)
    names = [r[0] for r in rows]
    assert "aten::conv2d" in names
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    assert dict((n, c) for n, _, c in rows)["aten::conv2d"] == 2
    lines = []
    profiling.print_trace_summary(str(tmp_path), printer=lines.append)
    assert lines[0].startswith("profile: top") and len(lines) > 1


@pytest.mark.parametrize("folder", [None, ""])
def test_trace_without_a_folder_does_nothing(folder, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with profiling.trace(folder) as where:
        torch.ones(2) + 1
    assert where is None and os.listdir(tmp_path) == []
    assert profiling.summarize_trace(str(tmp_path)) is None


def test_device_check_on_the_cpu(capsys):
    from kair_tpu_torch.cli import device_check
    device_check.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert f"torch {torch.__version__}" in out
    assert "tensor round-trip: OK" in out
    assert "mesh: {'data': 1, 'model': 1, 'tile': 1}" in out
    assert out.strip().endswith("OK")


def test_download_models_table_and_a_file_url(tmp_path, monkeypatch, capsys):
    from kair_tpu.cli import download_models as jdm
    from kair_tpu_torch.cli import download_models as dm
    assert dm.ZOO == jdm.ZOO
    src = tmp_path / "src"
    src.mkdir()
    (src / "tiny.pth").write_bytes(b"weights")
    monkeypatch.setitem(dm.ZOO, "tiny", ("tiny.pth",
                                         src.as_uri() + "/{}"))
    dest = str(tmp_path / "zoo")
    got = dm.download("tiny", dest)
    assert got == os.path.join(dest, "tiny.pth")
    assert open(got, "rb").read() == b"weights"
    assert dm.download("tiny", dest) == got
    out = capsys.readouterr().out
    assert "downloading" in out and f"{got} already exists" in out
    # an unreachable source: the URL and where to put the file
    monkeypatch.setitem(dm.ZOO, "gone", ("gone.pth",
                                         (src / "missing").as_uri() + "/{}"))
    url = dm.download("gone", dest)
    out = capsys.readouterr().out
    assert url.endswith("missing/gone.pth") and "fetch manually" in out
    with pytest.raises(KeyError):
        dm.download("no_such_model", dest)


def test_train_bench_profile_writes_a_trace(tmp_path, capsys):
    from kair_tpu_torch.cli import train_bench
    rep = train_bench.main(["--batch", "2", "--patch", "16", "--nc", "8",
                            "--nb", "3", "--steps", "1", "--device", "cpu",
                            "--profile", str(tmp_path)])
    assert rep["step_ms"] > 0
    assert len(profiling.find_traces(str(tmp_path))) == 1
    err = capsys.readouterr().err
    assert err.startswith("profile: top") and "aten::" in err


def test_video_bench_profile_dir_writes_a_trace(tmp_path, capsys):
    from kair_tpu_torch.cli import video_bench
    from tests.test_torch_cnn_cli import _tiny_clip_model
    reps = video_bench.main(["--net", "rvrt", "--frames", "2", "--size", "64",
                             "--k", "1", "--device", "cpu", "--profile",
                             str(tmp_path)], build=_tiny_clip_model)
    assert len(reps) == 1 and "profile" not in reps[0]   # the CPU: no device
    assert len(profiling.find_traces(str(tmp_path))) == 1
    assert "profile: top" in capsys.readouterr().err
