"""Host input pipeline: threaded loading and batching, and the copy of the
next batches to the card while the current step runs.

`Loader` is a copy of `monodepth_tpu.data.pipeline.Loader` (reference:
`DataLoader(batch, shuffle, num_workers=12, drop_last=True)`,
model_tool/loader.py:60-61): a thread pool loads samples in a sliding
window, each sample from its own RNG keyed by (seed, epoch, global index),
so batches do not depend on thread scheduling and equal the JAX
package's bit for bit. `prefetch_to_device` stages the next batches on the
card from pinned host memory on a side CUDA stream.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from monodepth_tpu_torch.training.state import resolve_device


def _collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class Loader:
    """Epoch-based batch iterator over a dataset with `sample(i, rng)`."""

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 num_workers: int = 8, seed: int = 0, drop_last: bool = True,
                 prefetch_batches: int = 2, process_index: int | None = None,
                 process_count: int | None = None):
        """`batch_size` is always the GLOBAL batch. With several processes
        each builds the same global permutation (same seed) and loads only
        its own contiguous `batch_size / process_count` slice of every
        batch. `process_index` and `process_count` are given together or
        not at all; left out, they are `torch.distributed`'s rank and world
        size when a process group is initialized, else 0 and 1."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch_batches = max(1, prefetch_batches)
        if (process_count is None) != (process_index is None):
            # defaulting the other half would duplicate (or mislabel) every
            # process's batch slice
            raise ValueError("process_count and process_index must be "
                             "given together (or both left to "
                             "torch.distributed)")
        if process_count is None:
            initialized = dist.is_available() and dist.is_initialized()
            process_count = dist.get_world_size() if initialized else 1
            process_index = dist.get_rank() if initialized else 0
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = batch_size // process_count
        self._pool: Optional[ThreadPoolExecutor] = None

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix="loader")
        return self._pool

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield numpy batches for one epoch (this process's slice of
        each global batch; the global batch when single-process)."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        if self.drop_last:
            order = order[: (n // self.batch_size) * self.batch_size]

        if self.process_count > 1:
            # this process's CONTIGUOUS slice of every batch; the sample
            # RNG keyed by the GLOBAL index keeps augmentation identical
            # to the single-process run
            if not self.drop_last:
                raise ValueError("multi-process loading requires drop_last "
                                 "(a partial global batch cannot shard "
                                 "evenly across processes)")
            steps = len(order) // self.batch_size
            order = (order[: steps * self.batch_size]
                     .reshape(steps, self.process_count, self.local_batch)
                     [:, self.process_index].reshape(-1))

        pool = self._ensure_pool()

        def load(index: int):
            rng = np.random.default_rng((self.seed, epoch, int(index)))
            return self.dataset.sample(int(index), rng)

        window = self.local_batch * (self.prefetch_batches + 1)
        futures = collections.deque()
        it = iter(order)
        # islice consumes from `it`, so the main loop continues where the
        # priming window stopped
        for idx in itertools.islice(it, window):
            futures.append(pool.submit(load, idx))

        batch = []
        for fut in iter(lambda: futures.popleft() if futures else None, None):
            batch.append(fut.result())
            nxt = next(it, None)
            if nxt is not None:
                futures.append(pool.submit(load, nxt))
            if len(batch) == self.local_batch:
                yield _collate(batch)
                batch = []
        if batch and not self.drop_last:
            yield _collate(batch)

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None


def _stage(batch, device: torch.device, stream: torch.cuda.Stream):
    """Copy a numpy batch to `device` on `stream`: each array into a
    pinned host tensor, then a `non_blocking` copy. -> (device batch, the
    event that marks the copies' end)."""
    out = {}
    with torch.cuda.stream(stream):
        for key, value in batch.items():
            host = torch.from_numpy(np.ascontiguousarray(value))
            pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
            pinned.copy_(host)
            # the caching host allocator records this copy on `pinned` and
            # does not hand its block out again until the copy has run
            out[key] = pinned.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Yield the batches of `iterator` (dicts of numpy arrays) as dicts of
    tensors on `device` (default: the card), keeping the next `size` ones
    in flight.

    On a CUDA device each batch is copied from pinned host buffers with
    `non_blocking=True` on a side stream, so the copies overlap the step
    that runs on the consumer's stream. Before a batch is yielded, the
    consumer's current stream waits on its copies' event, and its tensors
    are `record_stream`ed on that stream, so the allocator does not reuse
    their memory while the consumer may still read them. A pinned buffer
    is not reused while its copy may be in flight (PyTorch's caching host
    allocator). On a CPU device the batches pass through as tensors, in
    order."""
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield {k: torch.as_tensor(v) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)
    queue = collections.deque()

    def release():
        out, done = queue.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for tensor in out.values():
            tensor.record_stream(consumer)
        return out

    for batch in iterator:
        queue.append(_stage(batch, device, stream))
        if len(queue) > size:
            yield release()
    while queue:
        yield release()
