"""Batching and device feeding: the threaded loader and CUDA prefetch.

The port's counterpart of ``sr3d_tpu/data/pipeline.py``:

* ``BatchLoader`` is the JAX package's, copied: an epoch-cycling,
  optionally shuffled loader whose ``num_workers`` threads decode batches
  (PIL releases the GIL) in submission order, at most ``num_workers + 2``
  in flight.  The same seed gives the same batches in the same order.
  ``skip(n)`` starts the next pass ``n`` batches in, as if they had been
  read (a resumed run continues the data where it stopped).
* ``prefetch_to_device`` keeps ``size`` batches in flight on the card:
  each batch is copied into pinned host memory, then to the device by a
  ``non_blocking`` copy on a side stream, whose event the consumer's
  stream waits on; the tensors are ``record_stream``-ed on the consumer's
  stream, so the allocator does not reuse them while the step reads them.
* ``shard_batch`` places a batch on one device (data parallelism over more
  than one card is not ported).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..device import resolve_device


def _stack_batch(items: list[dict]) -> dict:
    """Collate dict items: arrays stacked, numbers as an array, anything
    else listed."""
    out: dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


class BatchLoader:
    """Epoch-cycling, optionally shuffled, threaded batch loader.  Drops
    the last partial batch unless ``drop_last`` is false."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 2,
        drop_last: bool = True,
        collate: Callable[[list[dict]], dict] = _stack_batch,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate = collate
        self.num_workers = max(0, num_workers)
        self._rng = np.random.RandomState(seed)
        self._skip = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (
            (n + self.batch_size - 1) // self.batch_size)

    def _index_batches(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def skip(self, n_batches: int) -> None:
        """Make the next endless pass (``iter``) start ``n_batches`` in:
        the shuffles of the epochs passed are drawn and every skipped item
        is accounted for (``dataset.skip_item``, where the dataset has
        one), so the batches that follow are those an unbroken pass would
        have given."""
        self._skip = int(n_batches)

    def _skip_batch(self, b: np.ndarray) -> None:
        skip_item = getattr(self.dataset, "skip_item", None)
        if skip_item is not None:
            for i in b:
                skip_item(int(i))

    def _load(self, b: np.ndarray) -> dict:
        return self.collate([self.dataset[int(i)] for i in b])

    def _run(self, batches: list[np.ndarray]) -> Iterator[dict]:
        if self.num_workers == 0:
            for b in batches:
                yield self._load(b)
            return

        from concurrent.futures import ThreadPoolExecutor

        inflight: collections.deque = collections.deque()
        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            for b in batches:
                inflight.append(ex.submit(self._load, b))
                if len(inflight) > self.num_workers + 2:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            # a step-counted loop abandons the generator mid-epoch:
            # release the pool now, not at garbage collection
            ex.shutdown(wait=False, cancel_futures=True)

    def epoch(self) -> Iterator[dict]:
        """One pass over the dataset."""
        return self._run(self._index_batches())

    def __iter__(self) -> Iterator[dict]:
        """Endless epoch-cycling iterator (the trainer counts steps, not
        epochs), starting where ``skip`` put it."""
        if len(self) == 0:
            raise ValueError(
                f"BatchLoader yields zero batches (dataset "
                f"{len(self.dataset)} < batch_size {self.batch_size} with "
                f"drop_last) — an endless iterator would spin forever")
        skip, self._skip = self._skip, 0
        while True:
            batches = self._index_batches()
            n = min(skip, len(batches))
            for b in batches[:n]:
                self._skip_batch(b)
            skip -= n
            if n < len(batches):
                yield from self._run(batches[n:])


def flatten_actors(raw: dict, keys) -> dict:
    """``keys`` of a joint batch as float32, actor-K ``[B, K, …]`` arrays
    flattened to ``[B·K, …]`` (images 5-D, ``flame_shape`` 3-D)."""
    out = {}
    for key in keys:
        v = np.asarray(raw[key], np.float32)
        if v.ndim == 5 or (key == "flame_shape" and v.ndim == 3):
            v = v.reshape((-1,) + v.shape[2:])
        out[key] = v
    return out


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype != object


def shard_batch(batch: dict, device: str | torch.device | None = None
                ) -> dict:
    """Every numeric array of ``batch`` as a tensor on ``device`` (None:
    the GPU), copied synchronously; other entries pass through."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if _is_array(v) else v for k, v in batch.items()}


def prefetch_to_device(iterator: Iterator[dict], size: int = 2,
                       device: str | torch.device | None = None
                       ) -> Iterator[dict]:
    """The batches of ``iterator`` as tensors on ``device`` (None: the
    GPU; it raises where there is none), ``size`` of them in flight.

    On CUDA each batch goes through pinned host memory and a
    ``non_blocking`` copy on a side stream; the batch handed out is ready
    for the stream that is current when it is taken (that stream waits on
    the copy's event, and the tensors are recorded on it).  On the CPU the
    arrays become tensors in place (no copy)."""
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   if _is_array(v) else v for k, v in batch.items()}
        return

    side = torch.cuda.Stream(device)
    buf: collections.deque = collections.deque()

    def put(batch: dict) -> None:
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items() if _is_array(v)}
        # allocated on the side stream's pool: the copy need not wait for
        # the consumer's work (its blocks come back to that pool only
        # after the consumer's recorded uses end)
        with torch.cuda.stream(side):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        rest = {k: v for k, v in batch.items() if not _is_array(v)}
        buf.append((dev, rest, done))

    def take() -> dict:
        dev, rest, done = buf.popleft()
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        for t in dev.values():
            t.record_stream(cur)
        return {**dev, **rest}

    for batch in iterator:
        put(batch)
        if len(buf) >= size:
            yield take()
    while buf:
        yield take()
