"""Dataset protocol + batching loader (counterpart of
``kair_tpu/data/base.py``; pure numpy, copied so the port needs nothing of
the JAX package).

A dataset is a plain object with ``__len__`` and ``get_example(index, rng)
-> dict of HWC float32 numpy`` (an explicit numpy Generator instead of the
reference's global ``random`` state), and :class:`Loader` assembles NHWC
batches with a background thread prefetcher (cv2/numpy release the GIL
during decode). With the same seed the port draws the same batches as the
JAX package: same Generator protocol, same epoch seeding (seed + epoch, the
analog of the reference's ``DistributedSampler.set_epoch``,
main_train_psnr.py:166-167).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Sequence

import numpy as np


class Dataset:
    def __len__(self) -> int:
        raise NotImplementedError

    def get_example(self, index: int, rng: np.random.Generator) -> Dict[str, Any]:
        raise NotImplementedError


def collate(examples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack HWC dicts into NHWC arrays; non-array values become lists."""
    out: Dict[str, Any] = {}
    for k in examples[0]:
        v0 = examples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([e[k] for e in examples]).astype(v0.dtype)
        else:
            out[k] = [e[k] for e in examples]
    return out


class Loader:
    """Iterates shuffled batches with background prefetch.

    drop_last is True for training (every step sees a full batch).
    """

    def __init__(self, dataset: Dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, num_prefetch: int = 4,
                 num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_prefetch = num_prefetch
        self.num_shards = num_shards
        self.shard_index = shard_index

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, Any]]:
        if len(self) == 0:
            raise ValueError(
                f"Loader yields 0 batches: dataset has {len(self.dataset)} "
                f"items, batch_size={self.batch_size}, drop_last="
                f"{self.drop_last}, num_shards={self.num_shards} — lower the "
                "batch size or add data")
        rng = np.random.default_rng(self.seed + epoch)
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        order = order[self.shard_index::self.num_shards]
        n_batches = len(order) // self.batch_size if self.drop_last \
            else -(-len(order) // self.batch_size)

        stop = threading.Event()

        def put(q: queue.Queue, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce(q: queue.Queue):
            for b in range(n_batches):
                if stop.is_set():
                    return
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                exs = [self.dataset.get_example(int(i), rng) for i in idxs]
                if not put(q, collate(exs)):
                    return
            put(q, None)

        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            # abandoning the generator mid-epoch must not leave the producer
            # decoding inside C libraries at interpreter shutdown (aborts
            # with "terminate called without an active exception")
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)
