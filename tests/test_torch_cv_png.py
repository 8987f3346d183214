"""The port's cv2-free image helpers against cv2 itself.

* ``utils/cv_ops.resize_linear`` by cv2's ``fx``, ``fy`` (dsize (0, 0)),
  as ``cli/test_face --sr`` calls it: the output size and every sample
  against ``cv2.resize(u, (0, 0), fx=f, fy=f)``; uint8 within cv2's own
  one-level rounding of its fixed-point vertical pass, float32 within 1e-5.
* ``utils/png.read_png`` on PNGs built here by hand (raw scanlines with
  chosen filter bytes, zlib, chunks with CRCs): one per filter, a
  mixed-filter image, palette images (8 and 4 bits, with a tRNS chunk that
  IMREAD_COLOR ignores), 16-bit RGB and gray, each equal to
  ``cv2.imread(path, IMREAD_COLOR)[..., ::-1]`` exactly; a 768 x 1024
  all-Paeth RGB image decoded in under 1.0 s of this process's CPU time
  (the least of three decodes, so that other processes' load does not
  count); and on a 768 x 1024 image of filters 0-2 the row-at-a-time path
  at least 4x quicker than the anti-diagonal one, which is why both stay.
* ``utils/metrics_log.plot_correlations`` without matplotlib: r against
  ``np.corrcoef``, the written file against ``scatter_canvas`` through
  ``read_png``, the JAX package's file names and pairs.
"""

import os
import struct
import sys
import time
import zlib

import cv2
import numpy as np
import pytest

from kair_tpu_torch.utils import cv_ops, png
from kair_tpu_torch.utils.metrics_log import MetricsLogger, scatter_canvas

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------------------------
# R1: resize by fx, fy
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("hw,f", [((77, 101), 1.5), ((45, 33), 1.3),
                                  ((80, 100), 2.0)])
def test_resize_linear_by_factor_matches_cv2(hw, f):
    rng = np.random.RandomState(3)
    u = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    want = cv2.resize(u, (0, 0), fx=f, fy=f)
    got = cv_ops.resize_linear(u, (0, 0), fx=f, fy=f)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1
    x = rng.rand(*hw, 3).astype(np.float32)
    want = cv2.resize(x, (0, 0), fx=f, fy=f)
    got = cv_ops.resize_linear(x, (0, 0), fx=f, fy=f)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5


def test_resize_linear_needs_a_size_or_factors():
    with pytest.raises(ValueError, match="fx"):
        cv_ops.resize_linear(np.zeros((4, 4), np.float32), (0, 0))


def test_test_face_sr_resizes_like_cv2(tmp_path, monkeypatch):
    """``cli/test_face --sr 1.5`` on a 101 x 77 image feeds the pipeline
    cv2's resize (the detector and enhancer stubbed: only the resize is
    under test here)."""
    from kair_tpu_torch.cli import test_face
    from kair_tpu_torch.eval import face_pipeline
    rng = np.random.RandomState(4)
    img = (rng.rand(77, 101, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "in.png")
    png.write_png(path, img)
    for name in ("r.pth", "g.pth"):
        (tmp_path / name).write_bytes(b"")
    seen = []
    monkeypatch.setattr(test_face, "build_enhancer",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(face_pipeline, "enhance_faces",
                        lambda im, *a, **k: (seen.append(im) or im, [], []))
    test_face.main(["--input", path, "--output", str(tmp_path / "out"),
                    "--retinaface", str(tmp_path / "r.pth"),
                    "--gpen", str(tmp_path / "g.pth"), "--sr", "1.5",
                    "--device", "cpu"])
    want = cv2.resize(img, (0, 0), fx=1.5, fy=1.5)
    assert seen[0].shape == want.shape == (116, 152, 3)
    assert np.abs(seen[0].astype(int) - want).max() <= 1


# ----------------------------------------------------------------------------
# R2: PNG decode
# ----------------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_row(cur: np.ndarray, prev: np.ndarray, f: int, bpp: int) -> bytes:
    """One scanline's bytes under filter ``f`` (the encoder's side)."""
    cur, prev = cur.astype(np.int32), prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    b = prev
    if f == 0:
        pred = 0
    elif f == 1:
        pred = a
    elif f == 2:
        pred = b
    elif f == 3:
        pred = (a + b) >> 1
    else:
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([f]) + ((cur - pred) & 255).astype(np.uint8).tobytes()


def _write(path, rows: np.ndarray, w: int, depth: int, ctype: int, filters,
           bpp: int, extra=b""):
    """``rows`` (h, stride) uint8: the raw scanline bytes."""
    prev = np.zeros(rows.shape[1], np.uint8)
    raw = b""
    for y, row in enumerate(rows):
        raw += _filter_row(row, prev, filters[y % len(filters)], bpp)
        prev = row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, rows.shape[0],
                                              depth, ctype, 0, 0, 0))
                + extra + _chunk(b"IDAT", zlib.compress(raw, 9))
                + _chunk(b"IEND", b""))


def _cv2_rgb(path):
    return cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]


def _rgb(img):
    return np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img


def _smooth_rgb(h, w, seed):
    """Smooth content with noise, so that every predictor is exercised."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(yy / 7.0 + c) * np.cos(xx / 5.0 - c)
                     for c in range(3)], -1) * 100 + 128
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 0, 3, 1, 2, 3, 4, 4, 1)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("ctype", [2, 6], ids=["rgb", "rgba"])
def test_read_png_filters_equal_cv2(tmp_path, filters, ctype):
    img = _smooth_rgb(23, 31, 5)
    ch = 3
    if ctype == 6:
        alpha = np.random.RandomState(6).randint(0, 256, img.shape[:2] + (1,))
        img = np.concatenate([img, alpha.astype(np.uint8)], -1)
        ch = 4
    path = str(tmp_path / "f.png")
    _write(path, img.reshape(img.shape[0], -1), img.shape[1], 8, ctype,
           filters, ch)
    np.testing.assert_array_equal(png.read_png(path), _cv2_rgb(path))


@pytest.mark.parametrize("depth", [8, 4])
def test_read_png_palette_equals_cv2(tmp_path, depth):
    rng = np.random.RandomState(7)
    n = 1 << depth
    pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    h, w = 19, 27
    idx = rng.randint(0, n, (h, w)).astype(np.uint8)
    if depth == 8:
        rows = idx
    else:
        padded = np.zeros((h, w + (w % 2)), np.uint8)
        padded[:, :w] = idx
        rows = (padded[:, 0::2] << 4) | padded[:, 1::2]
    extra = _chunk(b"PLTE", pal.tobytes()) + _chunk(
        b"tRNS", bytes(range(0, 256, 256 // n))[:n])
    path = str(tmp_path / "p.png")
    _write(path, rows, w, depth, 3, (4, 1, 3, 0, 2), 1, extra)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, pal[idx])
    np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.mark.parametrize("ctype", [2, 0], ids=["rgb", "gray"])
def test_read_png_16bit_takes_the_high_byte_as_cv2(tmp_path, ctype):
    rng = np.random.RandomState(8)
    ch = 3 if ctype == 2 else 1
    img = rng.randint(0, 65536, (17, 21, ch)).astype(">u2")
    rows = np.frombuffer(img.tobytes(), np.uint8).reshape(17, -1)
    path = str(tmp_path / "s.png")
    _write(path, rows, 21, 16, ctype, (3, 4, 1, 2, 0), 2 * ch)
    got = png.read_png(path)
    np.testing.assert_array_equal(got, (img >> 8).astype(np.uint8))
    np.testing.assert_array_equal(_rgb(got), _cv2_rgb(path))


def test_read_png_round_trips_write_png(tmp_path):
    img = _smooth_rgb(13, 17, 9)
    path = str(tmp_path / "w.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(png.read_png(path), _cv2_rgb(path))


def _least_cpu_seconds(fn, n=3):
    """The least of ``n`` runs' CPU time of this process, and fn's result."""
    best = float("inf")
    for _ in range(n):
        t0 = time.process_time()
        out = fn()
        best = min(best, time.process_time() - t0)
    return best, out


def test_read_png_paeth_768x1024_under_a_second(tmp_path):
    """15.0 s a pixel at a time before; the anti-diagonal decode took
    0.32-0.43 s of wall time on an 8-core x86 CPU."""
    img = _smooth_rgb(768, 1024, 10)
    path = str(tmp_path / "big.png")
    _write(path, img.reshape(768, -1), 1024, 8, 2, (4,), 3)
    dt, got = _least_cpu_seconds(lambda: png.read_png(path))
    np.testing.assert_array_equal(got, img)
    assert dt < 1.0, f"decode took {dt:.2f} s of CPU time"


def test_rows_of_filters_0_to_2_decode_quicker_a_row_at_a_time():
    """The anti-diagonal path decodes every filter, so the row path earns
    its place only by speed on images without Average or Paeth rows."""
    rng = np.random.RandomState(12)
    lines = rng.randint(0, 256, (768, 1024 * 3)).astype(np.uint8)
    filters = rng.randint(0, 3, 768).astype(np.uint8)
    rows_s, by_rows = _least_cpu_seconds(
        lambda: png._unfilter_rows(lines, filters, 3))
    diag_s, by_diag = _least_cpu_seconds(
        lambda: png._unfilter_diagonal(lines, filters, 3))
    np.testing.assert_array_equal(by_rows, by_diag)
    assert 4 * rows_s < diag_s, (
        f"rows {rows_s * 1e3:.1f} ms, anti-diagonals {diag_s * 1e3:.1f} ms")
    print(f"768x1024 RGB, filters 0-2: rows {rows_s * 1e3:.1f} ms, "
          f"anti-diagonals {diag_s * 1e3:.1f} ms of CPU time (least of 3)")


# ----------------------------------------------------------------------------
# the correlation plots without matplotlib
# ----------------------------------------------------------------------------

def test_plot_correlations_without_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    rng = np.random.RandomState(11)
    ml = MetricsLogger(str(tmp_path))
    for step in range(1, 6):
        ml.log(step, {"psnr": 30 + rng.rand(), "ssim": 0.8 + 0.1 * rng.rand(),
                      "loss": rng.rand()})
    paths = ml.plot_correlations([("psnr", "ssim"), ("loss", "psnr"),
                                  ("psnr", "absent")])
    assert [os.path.basename(p) for p in paths] == ["corr_psnr_ssim.png",
                                                    "corr_loss_psnr.png"]
    for (a, b), path in zip([("psnr", "ssim"), ("loss", "psnr")], paths):
        xs = [r[a] for r in ml.rows]
        ys = [r[b] for r in ml.rows]
        assert ml.correlations[(a, b)] == pytest.approx(
            np.corrcoef(xs, ys)[0, 1], abs=1e-12)
        canvas = scatter_canvas(xs, ys)
        np.testing.assert_array_equal(png.read_png(path), canvas)
        # five points drawn (blue squares), a black axes box
        blue = np.all(canvas == (31, 119, 180), axis=-1)
        assert 5 * 9 <= blue.sum() <= 5 * 25
        assert (canvas == 0).all(-1).sum() > 1000
    # two points: plotted, r nan as in the JAX title; one point: skipped
    ml2 = MetricsLogger(str(tmp_path / "two"))
    ml2.log(1, {"a": 1.0, "b": 2.0})
    assert ml2.plot_correlations([("a", "b")]) == []
    ml2.log(2, {"a": 2.0, "b": 1.0})
    assert len(ml2.plot_correlations([("a", "b")])) == 1
    assert np.isnan(ml2.correlations[("a", "b")])


def test_the_port_imports_no_matplotlib():
    root = os.path.join(REPO, "kair_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f), encoding="utf-8").read()
                assert "import matplotlib" not in text, f
                assert "from matplotlib" not in text, f
