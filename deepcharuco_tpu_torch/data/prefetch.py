"""Batching in threads and the copy to the card
(``deepcharuco_tpu.data.prefetch``).

The reference feeds its trainer from DataLoader worker processes with
pinned memory (``src/train.py:27-32``). Here a pool of threads runs the
numpy synthesis (numpy releases the interpreter lock in its array loops)
into a bounded queue of batches, and :func:`device_prefetch` keeps ``size``
batches in flight to the card: each array is staged in pinned memory and
copied on a side stream, so the copy of batch N+1 overlaps the step on
batch N.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from deepcharuco_tpu_torch._device import resolve_device
from deepcharuco_tpu_torch.data.device_synth import share_rows


class BatchLoader:
    """Background-threaded batcher over an indexable dataset.

    ``dataset[idx]`` returns a dict of numpy arrays; batches stack them on a
    new leading axis. Infinite (epochs wrap) unless ``max_batches`` is given;
    :meth:`stop` ends the threads.

    ``share=(i, k)`` (rank ``i`` of a mesh's ``k`` data ranks) keeps the
    index stream of global batches of ``batch_size`` and builds only share
    ``i`` of each, ``batch_size / k`` samples (all of them when ``k`` does
    not divide the batch): the ``k`` shares of a batch are the indices of
    the one loader's batch of the same seed, and no sample is built twice.
    """

    def __init__(self, dataset, batch_size: int, num_workers: int = 6,
                 shuffle: bool = True, seed: Optional[int] = None,
                 queue_depth: int = 10, max_batches: Optional[int] = None,
                 share: Optional[Tuple[int, int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.share = share
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.max_batches = max_batches
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._threads = []
        self._started = False

    def _index_stream(self):
        n = len(self.dataset)
        while True:
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            yield from order

    def _producer(self, index_q: queue.Queue):
        while not self._stop.is_set():
            try:
                idxs = index_q.get(timeout=0.2)
            except queue.Empty:
                continue
            if idxs is None:
                return
            items = [self.dataset[int(i)] for i in idxs]
            batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def _feeder(self, index_q: queue.Queue):
        stream = self._index_stream()
        produced = 0
        while not self._stop.is_set():
            if self.max_batches is not None and produced >= self.max_batches:
                for _ in self._threads:
                    index_q.put(None)
                return
            idxs = [next(stream) for _ in range(self.batch_size)]
            lo, hi = share_rows(self.batch_size, self.share)
            idxs = idxs[lo:hi]
            while not self._stop.is_set():
                try:
                    index_q.put(idxs, timeout=0.2)
                    produced += 1
                    break
                except queue.Full:
                    continue

    def _start(self):
        index_q: queue.Queue = queue.Queue(maxsize=self.num_workers * 2)
        self._threads = [threading.Thread(target=self._producer, args=(index_q,), daemon=True)
                         for _ in range(self.num_workers)]
        for t in self._threads:
            t.start()
        self._feed_thread = threading.Thread(target=self._feeder, args=(index_q,),
                                             daemon=True)
        self._feed_thread.start()
        self._started = True

    def __iter__(self) -> Iterator[dict]:
        if not self._started:
            self._start()
        served = 0
        while self.max_batches is None or served < self.max_batches:
            yield self._q.get()
            served += 1

    def stop(self):
        self._stop.set()


def device_prefetch(iterator, size: int = 2, device=None):
    """Yield each batch (a dict of numpy arrays) as a dict of tensors on
    ``device`` (``None``: the card), ``size`` batches ahead.

    On the card every array is staged in pinned memory and copied with
    ``non_blocking=True`` on a side stream; before a batch is yielded the
    consumer's current stream waits on the copy's event, and each tensor is
    marked used on that stream (``record_stream``) so its memory is not
    reused while the consumer's work is queued. On the CPU the arrays pass
    through as tensors.
    """
    dev = resolve_device(device)
    it = iter(iterator)
    if dev.type != "cuda":
        for batch in it:
            yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(device=dev)

    def put(batch):
        with torch.cuda.stream(copy_stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(dev, non_blocking=True) for k, v in batch.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    buf = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        out, done = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out.values():
            t.record_stream(consumer)
        yield out
