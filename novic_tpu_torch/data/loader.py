"""Host-side batch prefetch loader (the counterpart of novic_tpu.data.loader).

A background thread assembles numpy batches from the dataset (the cache reads
zero-copy slices of its memory map) and, for a CUDA device, copies them into
pinned host memory, while the device computes the previous step. The consumer
then issues `.to(device, non_blocking=True)` on the current stream: the copy is
ordered before the kernels that read the batch on that stream, so no event or
stream wait is needed, and the host does not block on it. PyTorch's pinned
allocator keeps each pinned buffer alive until its copy has completed.
"""

from __future__ import annotations

import queue
import random as _random
import threading
from typing import Iterator, Optional, Union

import numpy as np
import torch

from novic_tpu_torch.device import resolve
from novic_tpu_torch.utils import trace


def _host_tensor(x, pin: bool) -> torch.Tensor:
    x = np.asarray(x)
    if not pin:
        return torch.from_numpy(np.array(x))
    t = torch.empty(x.shape, dtype=torch.from_numpy(np.empty(0, x.dtype)).dtype, pin_memory=True)
    t.numpy()[...] = x
    return t


class BatchLoader:
    """Iterates a batch-item dataset with background prefetching.

    Each epoch: optionally draws a new circular offset (training mode, from a
    `random.Random(seed)` exactly as the JAX package's loader), then yields
    dataset[0..len). With a device, batch members arrive as tensors on it."""

    def __init__(self, dataset, prefetch: int = 2,
                 device: Optional[Union[str, torch.device]] = None, seed: Optional[int] = None):
        self.dataset = dataset
        self.prefetch = max(prefetch, 1)
        self.device = resolve(device) if device is not None else None
        self.rng = _random.Random(seed)

    def __len__(self) -> int:
        return len(self.dataset)

    def _host(self, batch):
        """Producer side: host tensors owning a copy of the batch (which may view
        the read-only memory map), pinned for a CUDA device."""
        if self.device is None:
            return batch
        pin = self.device.type == "cuda"
        return tuple(None if x is None else _host_tensor(x, pin) for x in batch)

    def _put(self, batch):
        """Consumer side: non-blocking copies on the current stream."""
        if self.device is None or self.device.type == "cpu":
            return batch
        return tuple(None if t is None else t.to(self.device, non_blocking=True) for t in batch)

    def __iter__(self) -> Iterator:
        if hasattr(self.dataset, "new_epoch"):
            self.dataset.new_epoch(self.rng)
        n = len(self.dataset)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for i in range(n):
                    if stop.is_set():
                        return
                    with trace.span("loader.produce", index=i):
                        batch = self._host(self.dataset[i])
                    if stop.is_set():
                        return
                    q.put((False, batch))
                q.put((True, None))
            except BaseException as e:  # surface worker errors to the consumer
                q.put((None, e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                with trace.span("loader.wait"):  # the consumer blocked on the producer
                    done, item = q.get()
                if done is None:
                    raise item
                if done:
                    return
                yield self._put(item)
        finally:
            stop.set()
            # Drain so the producer can exit
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
