"""The rest of the port's video data path on the CPU against the JAX
package, on seeded PNG clips in a temporary folder.

* ``VideoRecurrentTrainNonblindDenoisingDataset``,
  ``VideoRecurrentTrainVimeoDataset`` (mirrored and padded sequences) and
  ``VideoRecurrentTrainVimeoVFIDataset`` (with the colour jitter) against
  the JAX classes through each package's Loader, batch for batch over two
  epochs from one seed: equal arrays and keys; ``color_jitter_frames``
  alone, to 1e-6;
* the frame-interpolation test sets ``VFI_DAVIS``, ``VFI_UCF101`` and
  ``VFI_Vid4`` example for example, as ``define_dataset`` and
  ``cli/test_video`` build them;
* a framepack written by the port's ``cli/make_framepack`` reads back
  equal through both packages (their readers and a training set on the
  'framepack' backend); ``cli/make_meta_info`` writes the JAX CLI's lines;
* ``utils/videoio`` round-trips frames through a video file as the JAX
  module does; ``ops/warp.grid_sample`` against the JAX op.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kair_tpu_torch.utils import image as im

EPOCHS = 2


def _png(path, rng, h, w):
    path.parent.mkdir(parents=True, exist_ok=True)
    im.imsave((rng.rand(h, w, 3) * 255).astype(np.uint8), str(path))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """REDS-style GT clips, Vimeo-style clip/sequence septuplets (GT and a
    x4 LQ) and UCF101-style triplet folders, seeded."""
    root = tmp_path_factory.mktemp("clips")
    rng = np.random.RandomState(41)
    for c in ("000", "001"):
        for f in range(6):
            _png(root / "reds" / c / f"{f:08d}.png", rng, 40, 44)
    for seq in ("00001/0001", "00001/0002", "00002/0001"):
        for n in range(1, 8):
            _png(root / "vimeo_gt" / seq / f"im{n}.png", rng, 32, 36)
            _png(root / "vimeo_lq" / seq / f"im{n}.png", rng, 8, 9)
    for t in ("a", "b"):
        for n in ("frame0", "frame1", "frame2", "frame3", "framet"):
            _png(root / "ucf101" / t / f"{n}.png", rng, 230, 228)
    for c, n in (("calendar", 5), ("city", 6)):
        for f in range(n):
            _png(root / "vid4" / c / f"{f:08d}.png", rng, 12, 16)
    return root


def _compare(port_ds, jax_ds, batch, n_batches, seed=4):
    from kair_tpu.data.base import Loader as JLoader
    from kair_tpu_torch.data.base import Loader
    got, want = Loader(port_ds, batch, seed=seed), JLoader(jax_ds, batch,
                                                           seed=seed)
    for epoch in range(EPOCHS):
        pairs = list(zip(got.epoch(epoch), want.epoch(epoch)))
        assert len(pairs) == n_batches
        for a, b in pairs:
            assert a.keys() == b.keys() and a["key"] == b["key"]
            for k in ("L", "H"):
                assert a[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k])
    return a


def test_nonblind_denoising_dataset_matches_jax(clips):
    from kair_tpu.data import dataset_video as jdv
    from kair_tpu_torch.data.datasets import define_dataset
    opt = {"dataset_type": "VideoRecurrentTrainNonblindDenoisingDataset",
           "dataroot_gt": str(clips / "reds"), "dataroot_lq": str(clips / "reds"),
           "gt_size": 16, "num_frame": 3, "interval_list": [1, 2],
           "random_reverse": True, "sigma_min": 5, "sigma_max": 40}
    last = _compare(define_dataset(dict(opt)),
                    jdv.VideoRecurrentTrainNonblindDenoisingDataset(dict(opt)),
                    4, 3)
    assert last["L"].shape == (4, 3, 16, 16, 4)


@pytest.mark.parametrize("extra", [{"mirror_sequence": True},
                                   {"pad_sequence": True, "temporal_scale": 2}])
def test_vimeo_dataset_matches_jax(clips, extra):
    from kair_tpu.data import dataset_video as jdv
    from kair_tpu_torch.data.datasets import define_dataset
    opt = {"dataset_type": "VideoRecurrentTrainVimeoDataset",
           "dataroot_gt": str(clips / "vimeo_gt"),
           "dataroot_lq": str(clips / "vimeo_lq"), "gt_size": 16,
           "random_reverse": True, **extra}
    last = _compare(define_dataset(dict(opt)),
                    jdv.VideoRecurrentTrainVimeoDataset(dict(opt)), 1, 3)
    frames = 14 if extra.get("mirror_sequence") else 5
    assert last["L"].shape == (1, frames, 4, 4, 3)


def test_vimeo_vfi_dataset_matches_jax(clips):
    from kair_tpu.data import dataset_video as jdv
    from kair_tpu_torch.data.datasets import define_dataset
    opt = {"dataset_type": "video_train_vimeo_vfi",
           "dataroot_gt": str(clips / "vimeo_gt"),
           "dataroot_lq": str(clips / "vimeo_gt"), "gt_size": 16, "scale": 1,
           "num_frame": 4, "temporal_scale": 2, "color_jitter": True}
    last = _compare(define_dataset(dict(opt)),
                    jdv.VideoRecurrentTrainVimeoVFIDataset(dict(opt)), 1, 3)
    assert last["L"].shape == (1, 2, 16, 16, 3)
    assert last["H"].shape == (1, 1, 16, 16, 3)


def test_color_jitter_matches_jax():
    from kair_tpu.data.dataset_video import color_jitter_frames as j_jitter
    from kair_tpu_torch.data.dataset_video import color_jitter_frames
    x = np.random.RandomState(5).rand(3, 8, 8, 3).astype(np.float32)
    for s in (5, 6):
        got = color_jitter_frames(x, 0.3, np.random.default_rng(s))
        want = j_jitter(x, 0.3, np.random.default_rng(s))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert np.abs(got - x).max() > 1e-2


def _vfi_args(task, folder):
    return argparse.Namespace(task=task, folder_lq=str(folder),
                              folder_gt=str(folder), meta_info_file=None,
                              sigma=0)


@pytest.mark.parametrize("name", ["davis", "ucf101", "vid4"])
def test_vfi_test_sets_match_jax(clips, tmp_path, name):
    """As ``define_dataset`` builds them (from ``dataroot_lq``) and as
    ``cli/test_video.select_dataset`` builds them for a "videofi" task, one
    example after another equal to the JAX class's."""
    from kair_tpu.cli import test_video as jtv
    from kair_tpu_torch.cli import test_video as tv
    from kair_tpu_torch.data.datasets import define_dataset
    if name == "davis":         # the 480x840 crop needs larger frames
        rng = np.random.RandomState(43)
        for f in range(8):
            _png(tmp_path / "davis" / "bear" / f"{f:05d}.png", rng, 482, 842)
        folder = tmp_path / "davis"
    else:
        folder = clips / name
    task = "009_VRT_videofi_Vimeo_4frames"
    got = tv.select_dataset(_vfi_args(task, folder))
    want = jtv.select_dataset(_vfi_args(task, folder))
    ds = define_dataset({"dataset_type": f"vfi_{name}",
                         "dataroot_lq": str(folder)})
    assert type(got).__name__ == type(want).__name__ == type(ds).__name__
    assert len(got) == len(want) == len(ds) > 0
    for i in range(len(want)):
        a, b, c = got.get_example(i, None), want.get_example(i, None), \
            ds.get_example(i, None)
        assert a.keys() == b.keys()
        for k in a:
            if k in ("L", "H"):
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(c[k], b[k])
            else:
                assert a[k] == b[k], k
    assert a["L"].shape[0] == 4 and a["H"].shape[0] == 1


def test_framepack_round_trip_through_both_packages(clips, tmp_path):
    from kair_tpu.data.dataset_video import \
        VideoRecurrentTrainDataset as JDataset
    from kair_tpu.data.framepack import FramePackReader as JReader
    from kair_tpu_torch.cli import make_framepack, make_meta_info
    from kair_tpu_torch.data.datasets import define_dataset
    from kair_tpu_torch.data.framepack import FramePackReader, imfrombytes
    pack = tmp_path / "reds.fpk"
    make_framepack.main(["--data_path", str(clips / "reds"), "--pack_path",
                         str(pack), "--n_thread", "2"])
    mine, theirs = FramePackReader(str(pack)), JReader(str(pack))
    assert len(mine) == len(theirs) == 12 and "001/00000005" in mine
    for key in ("000/00000000", "001/00000005"):
        assert mine.get(key) == theirs.get(key)
        np.testing.assert_array_equal(
            imfrombytes(mine.get(key)),
            im.imread_uint(str(clips / "reds" / f"{key}.png"), 3))
    meta = tmp_path / "meta.txt"
    make_meta_info.main(["--data_path", str(clips / "reds"), "--out",
                         str(meta), "--with_start"])
    opt = {"dataset_type": "VideoRecurrentTrainDataset",
           "dataroot_gt": str(pack), "dataroot_lq": str(pack),
           "meta_info_file": str(meta), "io_backend": {"type": "framepack"},
           "scale": 1, "gt_size": 16, "num_frame": 2, "random_reverse": True}
    ds = define_dataset(dict(opt))
    assert ds.backend == "framepack" and len(ds) == 12
    _compare(ds, JDataset(dict(opt)), 4, 3)
    with pytest.raises(ValueError, match="meta_info_file"):
        define_dataset({**opt, "meta_info_file": None})


def test_make_meta_info_writes_the_jax_lines(clips, tmp_path):
    from kair_tpu.cli import make_meta_info as jmeta
    from kair_tpu_torch.cli import make_meta_info
    for root, flag in (("reds", ["--with_start"]), ("vimeo_gt", [])):
        a, b = tmp_path / f"{root}_port.txt", tmp_path / f"{root}_jax.txt"
        make_meta_info.main(["--data_path", str(clips / root), "--out",
                             str(a)] + flag)
        jmeta.main(["--data_path", str(clips / root), "--out", str(b)] + flag)
        assert a.read_text() == b.read_text() and a.read_text()
    assert (tmp_path / "reds_port.txt").read_text().splitlines()[0] == \
        "000 6 (40,44,3) 0"


def test_videoio_round_trip_matches_jax(clips, tmp_path):
    from kair_tpu.utils import videoio as jvio
    from kair_tpu_torch.utils import videoio
    video = tmp_path / "clip.mp4"
    assert videoio.images2video(str(clips / "vid4" / "city"), str(video),
                                fps=10) == 6
    assert videoio.video2images(str(video), str(tmp_path / "port")) == 6
    assert jvio.video2images(str(video), str(tmp_path / "jax")) == 6
    reader = videoio.VideoReader(str(video))
    assert (reader.width, reader.height, len(reader)) == (16, 12, 6)
    for f in range(6):
        name = f"{f:08d}.png"
        a = im.imread_uint(str(tmp_path / "port" / name), 3)
        np.testing.assert_array_equal(
            a, im.imread_uint(str(tmp_path / "jax" / name), 3))
        # a lossy codec: near the source frame, not equal to it
        src = im.imread_uint(str(clips / "vid4" / "city" / name), 3)
        assert a.shape == src.shape
    rng = np.random.default_rng(0)
    frames = [np.full((16, 16, 3), v, np.float32) for v in (0.2, 0.5, 0.8)]
    out = videoio.add_video_compression(frames, rng)
    assert len(out) == 3
    assert all(np.abs(o - f).max() < 0.05 for o, f in zip(out, frames))
    assert [p for p in videoio.scandir(str(clips / "vid4"), ".png",
                                       recursive=True)] == \
        list(jvio.scandir(str(clips / "vid4"), ".png", recursive=True))


@pytest.mark.parametrize("mode,padding,align", [
    ("bilinear", "zeros", True), ("bilinear", "border", False),
    ("nearest", "zeros", False), ("nearest", "border", True)])
def test_grid_sample_matches_jax(mode, padding, align):
    from kair_tpu.ops.warp import grid_sample as j_grid_sample
    from kair_tpu_torch.ops.warp import grid_sample
    rng = np.random.RandomState(7)
    x = rng.rand(2, 9, 11, 5).astype(np.float32)
    grid = (rng.rand(2, 6, 7, 2) * 2.6 - 1.3).astype(np.float32)
    want = np.asarray(j_grid_sample(jnp.asarray(x), jnp.asarray(grid), mode,
                                    padding, align))
    got = grid_sample(torch.from_numpy(x), torch.from_numpy(grid), mode,
                      padding, align).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
