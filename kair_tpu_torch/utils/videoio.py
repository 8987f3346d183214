"""Video IO utilities (counterpart of ``kair_tpu/utils/videoio.py``; KAIR
utils/utils_videoio.py): frame-accurate video reading with OpenCV, frames
to video and back, and the compression augmentation.

KAIR's ``add_video_compression`` uses PyAV; here, as in the JAX package,
the frames round-trip through cv2's VideoWriter (mp4v), the same codec
degradation, with a clear error where no codec is available. ``cv2`` is
imported inside the functions."""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence

import numpy as np


def scandir(dir_path: str, suffix=None, recursive: bool = False):
    """Generator of relative file paths (reference utils_videoio.py:61-101)."""
    for root, _, files in os.walk(dir_path):
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), dir_path)
            if suffix is None or rel.endswith(tuple([suffix] if isinstance(suffix, str) else suffix)):
                yield rel
        if not recursive:
            break


class VideoReader:
    """List-like frame-accurate reader (reference utils_videoio.py:131-300).
    cv2 seeking can be inexact; we read sequentially and cache."""

    def __init__(self, filename: str, cache_capacity: int = 10):
        import cv2

        self._vcap = cv2.VideoCapture(filename)
        assert self._vcap.isOpened(), f"cannot open {filename}"
        self._cache: dict = {}
        self._cache_cap = cache_capacity
        self._position = 0
        self.width = int(self._vcap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._vcap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = self._vcap.get(cv2.CAP_PROP_FPS)
        self.frame_cnt = int(self._vcap.get(cv2.CAP_PROP_FRAME_COUNT))

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self._vcap.read()
        if not ok:
            return None
        if len(self._cache) >= self._cache_cap:
            self._cache.pop(next(iter(self._cache)))
        self._cache[self._position] = frame
        self._position += 1
        return frame

    def get_frame(self, idx: int) -> Optional[np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        if idx < self._position:  # restart (cv2 seek is unreliable)
            import cv2
            self._vcap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            self._position = 0
        frame = None
        while self._position <= idx:
            frame = self.read()
            if frame is None:
                return None
        return frame

    def __len__(self):
        return self.frame_cnt

    def __getitem__(self, idx):
        return self.get_frame(idx)

    def __iter__(self):
        import cv2
        self._vcap.set(cv2.CAP_PROP_POS_FRAMES, 0)
        self._position = 0
        while True:
            f = self.read()
            if f is None:
                return
            yield f


def video2images(video_path: str, output_dir: str, ext: str = "png") -> int:
    """reference utils_videoio.py video2images."""
    import cv2

    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for frame in VideoReader(video_path):
        cv2.imwrite(os.path.join(output_dir, f"{n:08d}.{ext}"), frame)
        n += 1
    return n


def images2video(image_dir: str, video_path: str, fps: int = 24,
                 image_ext: str = "png") -> int:
    """reference utils_videoio.py images2video."""
    import cv2

    names = sorted(f for f in os.listdir(image_dir) if f.endswith(image_ext))
    assert names, f"no .{image_ext} frames in {image_dir}"
    first = cv2.imread(os.path.join(image_dir, names[0]))
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(video_path, fourcc, fps, (w, h))
    for nme in names:
        writer.write(cv2.imread(os.path.join(image_dir, nme)))
    writer.release()
    return len(names)


def add_video_compression(imgs: Sequence[np.ndarray],
                          rng: Optional[np.random.Generator] = None,
                          crf_bitrate: Optional[int] = None) -> List[np.ndarray]:
    """Round-trip frames through a lossy video codec (reference
    utils_videoio.py:460-497 with PyAV; here cv2 VideoWriter mp4v)."""
    import cv2

    rng = rng or np.random.default_rng()
    h, w = imgs[0].shape[:2]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "clip.mp4")
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        writer = cv2.VideoWriter(path, fourcc, 25, (w, h))
        if not writer.isOpened():
            raise RuntimeError("no mp4 codec available in this cv2 build")
        for img in imgs:
            u8 = np.uint8((np.clip(img, 0, 1) * 255.0).round())
            writer.write(cv2.cvtColor(u8, cv2.COLOR_RGB2BGR))
        writer.release()
        out = []
        for frame in VideoReader(path):
            out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)
    return out
