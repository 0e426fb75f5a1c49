"""Epoch sampler and a prefetcher onto the card (counterpart of
``lafs_cvpr2024_tpu/data/pipeline.py``: ``EpochSampler`` and, in place of
``DataPipeline``, :class:`Prefetcher`).

The sampler draws the same indices as the JAX one for every (seed, epoch,
process); its process index and count are arguments (default one
process), not read from a framework. The prefetcher keeps the card fed: a
thread reads the next batches' records and decodes each batch on a side
stream (nvJPEG straight into device memory), up to ``depth`` batches
ahead of the step that consumes them; the consumer's stream waits on the
batch's event before the step reads it.

Spans (``utils/tracing.py``, when on), each with ``batch=i`` (the batch's
place in the epoch): ``input.fetch`` (the records' bytes) and
``input.decode`` (the decode call, nvJPEG on the side stream) on the
reading thread, ``input.wait`` (from the consumer's ask until the batch is
handed out) on the consumer's; the counter ``input.starved`` counts the
asks that found no batch ready.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..utils import tracing
from .decode import decode_batch


class EpochSampler:
    """Shuffled per-epoch index sampler with per-process sharding
    (DistributedSampler.set_epoch semantics, ``pipeline.py:25-70``)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count

    def epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        # pad by wrapping (np.resize tiles) so every process gets an equal
        # shard, as DistributedSampler does
        per = -(-self.n // self.process_count)
        if len(idx) < per * self.process_count:
            idx = np.resize(idx, per * self.process_count)
        local = idx[self.process_index::self.process_count]
        if self.drop_last:
            local = local[: len(local) // self.batch_size * self.batch_size]
        return local

    def steps_per_epoch(self) -> int:
        per = -(-self.n // self.process_count)
        return (per // self.batch_size if self.drop_last
                else -(-per // self.batch_size))


class Prefetcher:
    """Batches of one epoch as ``(images, labels)``: (B, H, W, 3) uint8 on
    ``device`` and float32 numpy labels, decoded ``depth`` (≥ 1) batches
    ahead.

    On a CUDA device the reading thread decodes on its own stream and
    records an event; the consumer's current stream waits on it, and the
    tensor is marked as used there so the allocator cannot hand its memory
    out early. On the CPU (tests) the thread decodes with PIL.

    ``decode(payload, extra)`` turns what ``dataset.fetch_batch`` returned
    into the images, on the reading thread's stream (default: the JPEGs by
    ``decode_batch``); ``extra`` is handed out in place of the labels."""

    def __init__(self, dataset, sampler: EpochSampler, device,
                 depth: int = 2, decode=None):
        if depth < 1:
            raise ValueError(f"Prefetcher: depth must be >= 1, got {depth}")
        self.dataset = dataset
        self.sampler = sampler
        self.device = torch.device(device)
        self.depth = depth
        self.decode = decode or (lambda jpegs, _: decode_batch(
            jpegs, self.device, self.dataset.bgr))

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator:
        """``start_step`` skips the first batches before any read: an exact
        mid-epoch resume (the order is a pure function of seed and epoch)."""
        indices = self.sampler.epoch_indices(epoch)
        bs = self.sampler.batch_size
        batches = [indices[i:i + bs] for i in range(0, len(indices), bs)]
        batches = batches[start_step:]
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        done = object()

        def produce():
            try:
                for i, idx in enumerate(batches, start_step):
                    if stop.is_set():
                        return
                    with tracing.span("input.fetch", batch=i):
                        jpegs, labels = self.dataset.fetch_batch(idx)
                    event = None
                    if cuda:
                        with torch.cuda.stream(side):
                            with tracing.span("input.decode", batch=i):
                                images = self.decode(jpegs, labels)
                            event = torch.cuda.Event()
                            event.record(side)
                    else:
                        with tracing.span("input.decode", batch=i):
                            images = self.decode(jpegs, labels)
                    q.put((images, labels, event))
                q.put(done)
            except BaseException as e:  # surfaced at the consumer
                q.put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            for i in itertools.count(start_step):
                with tracing.span("input.wait", batch=i):
                    if tracing.ON and q.empty():
                        tracing.count("input.starved")
                    item = q.get()
                    if item is done:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    images, labels, event = item
                    if event is not None:
                        stream = torch.cuda.current_stream(self.device)
                        stream.wait_event(event)
                        images.record_stream(stream)
                yield images, labels
        finally:
            stop.set()
            while thread.is_alive():  # let a blocked producer finish
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()


def serial(dataset, n: int, batch_size: int, decode) -> Iterator:
    """The ``Prefetcher``'s ``(images, extra)`` batches over samples
    ``0..n-1`` in order, fetched and decoded in turn (no read-ahead)."""
    for s in range(0, n, batch_size):
        payload, extra = dataset.fetch_batch(range(s, min(s + batch_size, n)))
        yield decode(payload, extra), extra
