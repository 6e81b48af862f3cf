"""Threaded prefetching data loader (the port's copy of
``seervideoldm_tpu/data/loader.py``).

Replaces the reference's ``torch.utils.data.DataLoader`` workers
(``train.py:247-249``) with a thread-pool decode pipeline + bounded
prefetch queue — JPEG decode and preprocessing overlap device compute.
Deterministic epoch shuffling is keyed on ``(seed, epoch)`` so
checkpoint-resume replays the identical data order (stateless index
shuffling; SURVEY §5 failure-recovery plan).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


class DataLoader:
    """Batched iterator over a map-style dataset of (video, prompt) items."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        prefetch: int = 2,
        drop_last: bool = True,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.epoch = 0
        self._skip = 0

    def set_epoch(self, epoch: int, skip_batches: int = 0) -> None:
        """Position the loader at ``epoch``, optionally skipping the first
        ``skip_batches`` batches — mid-epoch checkpoint resume continues the
        exact data order of an uninterrupted run (index skipping only; no
        decode work is done for skipped batches)."""
        self.epoch = epoch
        self._skip = skip_batches
        if hasattr(self.dataset, "set_flip_state"):
            # stateless per-(seed, epoch, index) flip keying: augmentation
            # replays identically across checkpoint resume
            self.dataset.set_flip_state(self.seed, epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        # truncate to a multiple of num_shards BEFORE the strided split so
        # every rank sees the same shard length and the same batch count —
        # unequal counts would desync multi-process epochs (ranks shuffling
        # into the next epoch early) and hang the final collective when one
        # rank runs out of batches (torch's DistributedSampler pads for the
        # same reason; we drop the tail instead, deterministically)
        n -= n % self.num_shards
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        # strided shard per data-parallel host (every num_shards-th index)
        return idx[self.shard_index :: self.num_shards]

    def _num_batches(self, shard_len: int) -> int:
        if self.drop_last:
            return shard_len // self.batch_size
        return -(-shard_len // self.batch_size)

    def __len__(self) -> int:
        # after truncation every shard has exactly this many items
        shard_len = len(self.dataset) // self.num_shards
        return self._num_batches(shard_len)

    def __iter__(self) -> Iterator[tuple[np.ndarray, list[str]]]:
        indices = self._indices()
        nb = self._num_batches(len(indices))
        first = min(self._skip, nb)
        self._skip = 0  # consumed; later epochs start from batch 0
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            # any failure (e.g. one corrupt JPEG deep in a 200k-step run)
            # must surface promptly on the consumer side — swallowing it
            # here would leave the training loop blocked on out_q forever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(first, nb):
                        if stop.is_set():
                            return
                        batch_idx = indices[b * self.batch_size : (b + 1) * self.batch_size]
                        items = list(pool.map(self.dataset.__getitem__, batch_idx))
                        videos = np.stack([v for v, _ in items], axis=0)
                        prompts = [p for _, p in items]
                        out_q.put((videos, prompts))
                out_q.put(None)
            except BaseException as exc:  # noqa: BLE001 — relayed, not dropped
                out_q.put(exc)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer stuck on a full queue so it can observe stop
            try:
                while True:
                    out_q.get_nowait()
            except queue.Empty:
                pass
