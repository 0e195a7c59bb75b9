"""Input pipeline (port of vacnic_tpu/data/pipeline.py): a thread pool reads
and collates batches in the background while the device runs the step
before, and each batch's arrays are copied to the device ahead of use.

JAX's `jax.device_put` becomes, on the card: the collated array pinned in
host memory and copied with `non_blocking=True` on a CUDA stream of the
producer thread's own, one event recorded a batch. The consumer makes its
current stream wait on that event and `record_stream`s each tensor onto it
before it yields the batch, so the caching allocator cannot hand the memory
to the producer's next copy while the step still reads it. The producer
holds the pinned host tensors until the event has completed. Dtypes stay
numpy's (int32 ids, float32 features and pixels): the step sees the tensors
that `core.device.as_tensor` would make.

The loader runs on "cuda" unless the caller passes device="cpu" (then the
arrays become CPU tensors, no copy); without a card it raises. `sharding=`
and `shard_for_data_parallel` wait for multi-GPU data parallelism (ROADMAP
A.5).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from vacnic_tpu_torch.core.device import resolve_device

THREAD_NAME = "PrefetchLoader"  # prefix of the producer's and the workers' thread names


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable[[list[dict]], dict[str, np.ndarray]],
        *,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        drop_last: bool = True,
        sharding=None,
        device_keys: Sequence[str] | None = None,
        device=None,
    ):
        if sharding is not None:
            raise NotImplementedError("PrefetchLoader(sharding=...) waits for multi-GPU data "
                                      "parallelism (ROADMAP A.5)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device_keys = device_keys
        self.device = resolve_device(device)
        self.pinned_bytes = 0  # host bytes pinned for copies to the card, all epochs
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _batch_indices(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # epoch-deterministic shuffle (DistributedSampler semantics)
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        nb = len(self)
        return [idx[i * self.batch_size: (i + 1) * self.batch_size] for i in range(nb)]

    def _on_device(self, k: str, v) -> bool:
        return isinstance(v, np.ndarray) and (self.device_keys is None or k in self.device_keys)

    def _stage(self, batch: dict, dev: torch.device, stream):
        """-> (the batch with its arrays as tensors on `dev`, the copy's event
        or None, the pinned host tensors the copy reads)."""
        if dev.type == "cpu":
            return {k: torch.from_numpy(np.ascontiguousarray(v)) if self._on_device(k, v) else v
                    for k, v in batch.items()}, None, []
        out, pinned = {}, []
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if self._on_device(k, v):
                    host = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    self.pinned_bytes += host.nbytes if host.is_pinned() else 0
                    pinned.append(host)
                    out[k] = host.to(dev, non_blocking=True)
                else:
                    out[k] = v
            event = torch.cuda.Event()
            event.record(stream)
        return out, event, pinned

    def __iter__(self) -> Iterator[dict[str, Any]]:
        self._epoch += 1
        batches = self._batch_indices()
        dev = self.device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # bounded put that re-checks stop: an abandoned iterator (fit()
            # breaking at max_steps) sets stop while the producer is blocked
            # on the full queue; a bare q.put would never return
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # a producer failure (bad image file, collate error) is re-raised
            # in the consumer instead of leaving it blocked on q.get()
            try:
                stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
                with ThreadPoolExecutor(self.num_workers,
                                        thread_name_prefix=f"{THREAD_NAME}.worker") as pool:
                    for binds in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, binds))
                        out, event, pinned = self._stage(self.collate_fn(samples), dev, stream)
                        queued = put_or_stop((out, event))
                        if event is not None:
                            event.synchronize()  # the copy has read the pinned memory
                        del pinned
                        if not queued:
                            return
                put_or_stop(None)
            except BaseException as e:
                put_or_stop(e)

        t = threading.Thread(target=produce, name=f"{THREAD_NAME}.producer", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                out, event = item
                if event is not None:
                    current = torch.cuda.current_stream(dev)
                    current.wait_event(event)
                    for v in out.values():
                        if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                            v.record_stream(current)
                yield out
        finally:
            stop.set()
