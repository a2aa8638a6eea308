"""Bucketed batching data loader on the host (port of
decompdiff_tpu/training/loader.py; replaces the PyG DataLoader of ref
scripts/train_diffusion_decomp.py:121-133): featurize on worker threads,
group records by bucket key so every batch pads into one of a few fixed
shapes, and prefetch ahead of the training loop.

The batches are the JAX loader's, array for array: the same shuffle
(np.random.default_rng(seed), one permutation per epoch), the same
featurization in submission order and the same bucketing and flushes.
"""

from __future__ import annotations

import queue
import threading
from collections import Counter, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from decompdiff_tpu_torch.data.collate import (
    GROUP_BUCKETS, LIGAND_BUCKETS, PROTEIN_BUCKETS, bucket_key, collate)
from decompdiff_tpu_torch.device import DeviceLike, resolve_device


class BucketedLoader:
    """Iterator of ComplexBatch on `device` (CUDA unless given; role: ref
    utils/train.py:25-31 inf_iterator + DataLoader), infinite unless
    `infinite=False`.

    The producer thread collates each batch into CPU tensors, pinned when
    the device is CUDA, and the consumer moves it to the device with
    non_blocking=True: no CUDA work runs on the producer thread, and the
    host-to-device copy overlaps the device's work on the step before.

    Featurization failures are skipped and counted by exception type in
    `skip_counts`, records larger than the biggest bucket under 'oversize'.
    An epoch in which every record fails, or two epochs' worth of
    consecutive oversize records, raise RuntimeError in the consumer rather
    than spin forever. `close()` stops the producer and ends a consumer
    blocked waiting for a batch.
    """

    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 num_threads: int = 2, prefetch: int = 4,
                 protein_buckets=PROTEIN_BUCKETS,
                 ligand_buckets=LIGAND_BUCKETS,
                 group_buckets=GROUP_BUCKETS,
                 infinite: bool = True,
                 device: DeviceLike = None):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.num_threads = max(1, int(num_threads))
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.buckets = (protein_buckets, ligand_buckets, group_buckets)
        self.infinite = infinite
        self.device = resolve_device(device)
        self._pin = self.device.type == 'cuda'
        self.skip_counts: Counter = Counter()
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _record_iter(self, pool):
        """Epochs of featurized records. Featurization runs on `pool`, with
        a bounded in-flight window consumed in submission order, so the
        record stream is deterministic for a fixed seed."""
        depth = 2 * self.num_threads + 2
        while True:
            order = np.array(self.indices)
            if self.shuffle:
                self.rng.shuffle(order)
            ok = 0
            inflight = deque()
            it = iter(order)

            def submit_next():
                for idx in it:
                    inflight.append(pool.submit(self.dataset.__getitem__,
                                                int(idx)))
                    return
            for _ in range(depth):
                submit_next()
            while inflight:
                fut = inflight.popleft()
                submit_next()
                if self._stop.is_set():
                    return
                try:
                    rec = fut.result()
                except Exception as e:
                    self.skip_counts[type(e).__name__] += 1
                    continue
                ok += 1
                yield rec
            if len(order) and ok == 0:
                raise RuntimeError(
                    'BucketedLoader: every sample in the epoch failed to '
                    f'featurize; skip counts: {dict(self.skip_counts)}')
            if not self.infinite:
                return

    def _producer(self):
        pb, lb, gb = self.buckets
        try:
            with ThreadPoolExecutor(
                    max_workers=self.num_threads,
                    thread_name_prefix='ddtorch-featurize') as pool:
                self._bucket_loop(self._record_iter(pool), pb, lb, gb)
        except Exception as e:  # surface producer errors to the consumer
            self._put(e)

    def _put(self, item) -> bool:
        """Enqueue unless close() was requested; never blocks forever on a
        full queue with no consumer (returns False once stopped)."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _collate(self, records, key):
        batch = collate(records, device='cpu', np_override=key[0],
                        nl_override=key[1], na_override=key[2])
        return batch.pin_memory() if self._pin else batch

    def _bucket_loop(self, records, pb, lb, gb):
        # a run of consecutive oversize drops as long as two epochs means no
        # record fits (one epoch could be a false positive: a surviving
        # record first in epoch k and last in epoch k+1 leaves 2N-2 drops
        # between them)
        pending: dict = {}
        oversize_run = 0
        for rec in records:
            if self._stop.is_set():
                return
            try:
                key = bucket_key(rec, pb, lb, gb)
            except ValueError:
                self.skip_counts['oversize'] += 1
                oversize_run += 1
                if oversize_run >= 2 * max(1, len(self.indices)):
                    raise RuntimeError(
                        'BucketedLoader: two epochs of records were '
                        'dropped as oversize with none surviving '
                        '(bucket ladders too small for this corpus); '
                        f'skip counts: {dict(self.skip_counts)}')
                continue
            oversize_run = 0
            pending.setdefault(key, []).append(rec)
            if len(pending[key]) == self.batch_size:
                if not self._put(self._collate(pending.pop(key), key)):
                    return
        if self._stop.is_set():
            # close() mid-stream: no partial batches into a queue nobody
            # drains
            return
        # flush partial batches at the end of a finite pass
        for key, recs in pending.items():
            if recs and not self._put(self._collate(recs, key)):
                return
        self._put(None)

    def __iter__(self) -> Iterator:
        while True:
            try:
                item = self._queue.get(timeout=0.2)
            except queue.Empty:
                # after close() the producer exits without the None
                # sentinel, so a blocked consumer notices the stop itself
                if self._stop.is_set():
                    return
                continue
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item.to(self.device, non_blocking=self._pin)

    def close(self):
        self._stop.set()
