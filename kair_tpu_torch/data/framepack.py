"""Packed-frame store and storage backends (counterpart of
``kair_tpu/data/framepack.py``; KAIR's LMDB tooling, utils/utils_lmdb.py:
9-205, and FileClient backends, utils/utils_video.py:309-473).

Video training reads immutable, write-once image blobs by key; a flat
mmap'd pack gives random access without an lmdb dependency:

    name.fpk/
    ├── data.bin        concatenated encoded-image blobs
    ├── keys.txt        one key per line, order = blob order
    ├── offsets.bin     uint64 little-endian (offset, length) per key
    └── meta_info.txt   "key.png (h,w,c) compress_level", KAIR's lmdb
                        meta_info.txt format (:121)

``FramePackMaker.put/close`` mirrors LmdbMaker (utils_lmdb.py:166-205) and
``make_framepack_from_imgs`` make_lmdb_from_imgs (:9-130, with its
threaded read and encode). ``FileClient`` mirrors utils_video.py:436-470
with the 'disk', 'framepack' and (where the module is installed) 'lmdb'
backends. A pack written by either package reads back in the other: the
layout is the same. Encoding and decoding use ``cv2``, imported inside the
functions that need it.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class FramePackMaker:
    """Incremental pack writer (reference LmdbMaker, utils_lmdb.py:166-205)."""

    def __init__(self, pack_path: str, compress_level: int = 1):
        if not pack_path.endswith(".fpk"):
            raise ValueError("pack_path must end with '.fpk'.")
        if os.path.exists(pack_path):
            raise FileExistsError(f"Folder {pack_path} already exists.")
        os.makedirs(pack_path)
        self.pack_path = pack_path
        self.compress_level = compress_level
        self._data = open(os.path.join(pack_path, "data.bin"), "wb")
        self._meta = open(os.path.join(pack_path, "meta_info.txt"), "w")
        self._keys: List[str] = []
        self._offsets: List[Tuple[int, int]] = []
        self._pos = 0

    def put(self, img_byte: bytes, key: str, img_shape: Sequence[int]):
        if "\n" in key:
            raise ValueError(f"key may not contain newlines: {key!r}")
        self._data.write(img_byte)
        self._keys.append(key)
        self._offsets.append((self._pos, len(img_byte)))
        self._pos += len(img_byte)
        h, w, c = img_shape
        self._meta.write(f"{key}.png ({h},{w},{c}) {self.compress_level}\n")

    def close(self):
        self._data.close()
        self._meta.close()
        with open(os.path.join(self.pack_path, "keys.txt"), "w") as f:
            f.write("\n".join(self._keys))
        with open(os.path.join(self.pack_path, "offsets.bin"), "wb") as f:
            for off, ln in self._offsets:
                f.write(struct.pack("<QQ", off, ln))


def read_img_worker(path: str, key: str, compress_level: int):
    """Read + PNG-encode one image (reference utils_lmdb.py:133-163)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise IOError(f"cannot read image: {path}")
    if img.ndim == 2:
        h, w, c = *img.shape, 1
    else:
        h, w, c = img.shape
    ok, img_byte = cv2.imencode(
        ".png", img, [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
    if not ok:
        raise IOError(f"cannot encode image: {path}")
    return key, img_byte.tobytes(), (h, w, c)


def make_framepack_from_imgs(data_path: str, pack_path: str,
                             img_path_list: Sequence[str],
                             keys: Sequence[str],
                             compress_level: int = 1,
                             n_thread: int = 8) -> None:
    """Build a pack from an image folder (reference make_lmdb_from_imgs,
    utils_lmdb.py:9-130). Reading/encoding is threaded; writing is ordered."""
    if len(img_path_list) != len(keys):
        raise ValueError("img_path_list and keys should have the same "
                         f"length, but got {len(img_path_list)} and "
                         f"{len(keys)}")
    results: Dict[int, Tuple[str, bytes, Tuple[int, int, int]]] = {}
    lock = threading.Lock()
    it = iter(enumerate(zip(img_path_list, keys)))

    def worker():
        while True:
            with lock:
                try:
                    idx, (path, key) = next(it)
                except StopIteration:
                    return
            out = read_img_worker(os.path.join(data_path, path), key,
                                  compress_level)
            with lock:
                results[idx] = out

    threads = [threading.Thread(target=worker)
               for _ in range(max(1, min(n_thread, len(keys))))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    maker = FramePackMaker(pack_path, compress_level)
    for idx in range(len(keys)):
        key, img_byte, shape = results[idx]
        maker.put(img_byte, key, shape)
    maker.close()
    print(f"Finish writing {len(keys)} images to {pack_path}.")


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class FramePackReader:
    """mmap'd random access by key: `get(key) -> bytes`."""

    def __init__(self, pack_path: str):
        with open(os.path.join(pack_path, "keys.txt")) as f:
            keys = f.read().split("\n")
        raw = np.fromfile(os.path.join(pack_path, "offsets.bin"),
                          dtype="<u8").reshape(-1, 2)
        if len(keys) == 1 and keys[0] == "":
            keys = []
        if len(keys) != raw.shape[0]:
            raise IOError(f"corrupt pack {pack_path}: {len(keys)} keys vs "
                          f"{raw.shape[0]} offsets")
        self._index = {k: (int(o), int(n)) for k, (o, n) in zip(keys, raw)}
        self._data = np.memmap(os.path.join(pack_path, "data.bin"),
                               dtype=np.uint8, mode="r")

    def __len__(self):
        return len(self._index)

    def __contains__(self, key: str):
        return key in self._index

    def get(self, key: str) -> bytes:
        off, ln = self._index[str(key)]
        return self._data[off: off + ln].tobytes()


# ---------------------------------------------------------------------------
# storage backends + FileClient (reference utils_video.py:309-473)
# ---------------------------------------------------------------------------

class HardDiskBackend:
    """reference utils_video.py:362-375."""

    def get(self, filepath: str) -> bytes:
        with open(str(filepath), "rb") as f:
            return f.read()

    def get_text(self, filepath: str) -> str:
        with open(str(filepath)) as f:
            return f.read()


class FramePackBackend:
    """Multi-pack backend keyed like the reference LmdbBackend
    (utils_video.py:378-433): `db_paths` + parallel `client_keys`."""

    def __init__(self, db_paths, client_keys="default", **kwargs):
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if not isinstance(db_paths, (list, tuple)):
            db_paths = [db_paths]
        if len(client_keys) != len(db_paths):
            raise ValueError("client_keys and db_paths should have the same "
                             f"length, but received {len(client_keys)} and "
                             f"{len(db_paths)}.")
        self._client = {k: FramePackReader(str(p))
                        for k, p in zip(client_keys, db_paths)}

    def get(self, filepath: str, client_key: str) -> bytes:
        if client_key not in self._client:
            raise KeyError(f"client_key {client_key} is not in framepack "
                           "clients.")
        return self._client[client_key].get(str(filepath))

    def get_text(self, filepath):
        raise NotImplementedError


class LmdbBackend:
    """LMDB, available only where the `lmdb` module is installed
    (reference utils_video.py:378-433); FramePackBackend is the drop-in
    replacement."""

    def __init__(self, db_paths, client_keys="default", readonly=True,
                 lock=False, readahead=False, **kwargs):
        try:
            import lmdb
        except ImportError:
            raise ImportError(
                "the `lmdb` module is not available; use the 'framepack' "
                "backend (kair_tpu_torch.data.framepack) instead")
        if isinstance(client_keys, str):
            client_keys = [client_keys]
        if not isinstance(db_paths, (list, tuple)):
            db_paths = [db_paths]
        self._client = {
            k: lmdb.open(str(p), readonly=readonly, lock=lock,
                         readahead=readahead, **kwargs)
            for k, p in zip(client_keys, db_paths)}

    def get(self, filepath: str, client_key: str) -> bytes:
        with self._client[client_key].begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))

    def get_text(self, filepath):
        raise NotImplementedError


class FileClient:
    """reference utils_video.py:436-470, without memcached."""

    _backends = {
        "disk": HardDiskBackend,
        "framepack": FramePackBackend,
        "lmdb": LmdbBackend,
    }

    def __init__(self, backend: str = "disk", **kwargs):
        if backend not in self._backends:
            raise ValueError(
                f"Backend {backend} is not supported. Currently supported "
                f"ones are {list(self._backends)}")
        self.backend = backend
        self.client = self._backends[backend](**kwargs)

    def get(self, filepath: str, client_key: str = "default") -> bytes:
        if self.backend in ("framepack", "lmdb"):
            return self.client.get(filepath, client_key)
        return self.client.get(filepath)

    def get_text(self, filepath: str) -> str:
        return self.client.get_text(filepath)


def imfrombytes(content: bytes, float32: bool = False) -> np.ndarray:
    """Decode an encoded image blob to an RGB HWC array
    (reference utils_video.py:476-494; RGB rather than BGR, as
    ``utils/image`` reads images)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(content, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise IOError("imfrombytes: cannot decode image buffer")
    img = img[:, :, ::-1]  # BGR -> RGB
    if float32:
        img = img.astype(np.float32) / 255.0
    return np.ascontiguousarray(img)
