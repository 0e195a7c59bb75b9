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
arrays become CPU tensors, no copy); without a card it raises. With
`sharding=` (`shard_for_data_parallel(mesh)`, or `core/mesh.batch_sharding`)
each batch's arrays are cut into contiguous row shards, shard i copied from
pinned memory to the i-th device of the mesh's data axis on that device's
own copy stream, and come as `core/mesh.Sharded` values, which
`infer/generate.generate_mm_sharded` takes where they lie. A batch whose
rows do not divide by the axis (a last batch with drop_last=False) comes
whole, as plain tensors on the axis's first device: JAX's device_put would
refuse it, and `train/loop.generate_captions` decodes it on one device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from vacnic_tpu_torch.core.device import resolve_device
from vacnic_tpu_torch.core.mesh import ShardSpec, Sharded, batch_sharding

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
        sharding: ShardSpec | None = None,
        device_keys: Sequence[str] | None = None,
        device=None,
    ):
        if sharding is not None:
            if device is not None:
                raise ValueError("PrefetchLoader: pass sharding= or device=, not both")
            if sharding.dim != 0:
                raise ValueError("PrefetchLoader: sharding= must cut the batch dimension "
                                 "(shard_for_data_parallel(mesh))")
            self.devices = sharding.mesh.data_devices(sharding.axis)
        else:
            self.devices = [resolve_device(device)]
        self.sharding = sharding
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device_keys = device_keys
        self.device = self.devices[0]
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

    def _stage(self, batch: dict, rows: int, devs: list[torch.device], streams: dict):
        """-> (the batch with its arrays as tensors on devs[0], or as
        `Sharded` row shards over `devs` when the loader shards and `rows`
        divides by them; the copies' events [(device, event)]; the pinned
        host tensors the copies read)."""
        split = self.sharding is not None and rows % len(devs) == 0
        on_card = devs[0].type == "cuda"
        out, pinned = {}, []
        for k, v in batch.items():
            if not self._on_device(k, v):
                out[k] = v
                continue
            host = torch.from_numpy(np.ascontiguousarray(v))
            if on_card:
                host = host.pin_memory()
                self.pinned_bytes += host.nbytes if host.is_pinned() else 0
                pinned.append(host)
            if not (split and host.ndim and host.shape[0] == rows):
                parts = [(host, devs[0])]
            else:
                parts = list(zip(torch.chunk(host, len(devs)), devs))
            moved = []
            for part, dev in parts:
                if on_card:
                    with torch.cuda.stream(streams[dev]):
                        part = part.to(dev, non_blocking=True)
                moved.append(part)
            out[k] = Sharded(tuple(moved)) if len(parts) > 1 else moved[0]
        events = []
        for dev, stream in streams.items():
            event = torch.cuda.Event()
            event.record(stream)
            events.append((dev, event))
        return out, events, pinned

    def __iter__(self) -> Iterator[dict[str, Any]]:
        self._epoch += 1
        batches = self._batch_indices()
        devs = self.devices
        if devs[0].type == "cuda" and devs[0].index is None:
            devs = [torch.device("cuda", torch.cuda.current_device())]
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
                # a copy stream a device, the producer's own
                streams = ({d: torch.cuda.Stream(d) for d in devs} if devs[0].type == "cuda"
                           else {})
                with ThreadPoolExecutor(self.num_workers,
                                        thread_name_prefix=f"{THREAD_NAME}.worker") as pool:
                    for binds in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, binds))
                        out, events, pinned = self._stage(self.collate_fn(samples), len(binds),
                                                          devs, streams)
                        queued = put_or_stop((out, events))
                        for _, event in events:
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
                out, events = item
                for dev, event in events:
                    current = torch.cuda.current_stream(dev)
                    current.wait_event(event)
                    for v in out.values():
                        for t in (v.shards if isinstance(v, Sharded) else (v,)):
                            if isinstance(t, torch.Tensor) and t.device == dev:
                                t.record_stream(current)
                yield out
        finally:
            stop.set()


def shard_for_data_parallel(mesh) -> ShardSpec:
    """The loader's `sharding=` for data parallelism over `mesh`: batch rows
    cut over its first (data) axis."""
    return batch_sharding(mesh)
