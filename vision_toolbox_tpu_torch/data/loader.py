"""Threaded batching loader with device prefetch — port of
``vision_toolbox_tpu/data/loader.py``.

Replaces the reference's torch DataLoader(num_workers=8, pin_memory) +
per-rank batch split (data.py:63-86). Decode + per-sample host transforms run
in a thread pool (PIL releases the GIL during JPEG decode/resize), with the
JAX package's per-epoch shuffle and per-sample ``random.Random`` seeds, so
the same seed and epoch give bit-equal batches. ``prefetch_to_device`` feeds
the card: a producer thread stages each host batch in page-locked memory
and copies it on a side CUDA stream while the current step runs.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from .datasets import ImageFolder


class DataLoader:
    """Batches an indexable dataset with a per-epoch shuffle.

    ``transform(rng, sample.image) -> HWC float array``.
    """

    def __init__(
        self,
        dataset: ImageFolder,
        batch_size: int,
        transform: Callable,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.transform = transform
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = list(range(len(self.dataset)))
        rng = random.Random((self.seed, self.epoch).__hash__())
        if self.shuffle:
            rng.shuffle(order)
        self.epoch += 1

        def load_one(args):
            idx, sample_seed = args
            sample = self.dataset[idx]
            r = random.Random(sample_seed)
            return self.transform(r, sample.image), sample.label

        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                idxs = order[start : start + self.batch_size]
                if self.drop_last and len(idxs) < self.batch_size:
                    break
                seeds = [rng.getrandbits(32) for _ in idxs]
                results = list(pool.map(load_one, zip(idxs, seeds)))
                images = np.stack([r[0] for r in results])
                labels = np.asarray([r[1] for r in results], np.int32)
                yield images, labels


class DeviceFeed:
    """Host batches (numpy arrays, or tuples of them) → tensors on ``device``,
    ``size`` batches in flight — the counterpart of the JAX package's
    ``prefetch_to_device`` (``jax.device_put`` in a producer thread).

    On a CUDA device a producer thread copies each batch into a page-locked
    buffer and issues ``non_blocking`` host-to-device copies on a side
    stream, then records an event; the consumer makes its current stream
    wait on that event and marks the tensors as used there
    (``record_stream``), so the allocator keeps their memory until that
    stream's work is done. A page-locked buffer is written again only after
    the event of its last copy has completed. ``bytes_copied`` and
    ``batches`` count what crossed to the card. On ``device="cpu"`` the
    batches come back as tensors and nothing else happens; asked for
    ``"cuda"`` without a card, it raises. An error in the producer is raised
    in the consumer.
    """

    def __init__(self, it: Iterator, device: torch.device | str = "cuda", size: int = 2):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"prefetch_to_device: device {str(self.device)!r} asked for and "
                               "no CUDA device is available; pass device='cpu' on the CPU")
        self.it, self.size = it, size
        self.bytes_copied = 0
        self.batches = 0

    def __iter__(self) -> Iterator:
        if self.device.type != "cuda":
            for batch in self.it:
                self.batches += 1
                yield _map(batch, lambda a: torch.from_numpy(np.asarray(a)).to(self.device))
            return
        yield from self._cuda_feed()

    def _cuda_feed(self) -> Iterator:
        device = self.device
        with torch.cuda.device(device):
            copy_stream = torch.cuda.Stream(device)
        q: queue.Queue = queue.Queue(maxsize=self.size)
        stop = threading.Event()
        done = object()
        # one more slot than can wait in the queue: the producer fills a slot
        # while ``size`` others wait; it waits on a slot's event before reuse
        slots: list[dict] = [{} for _ in range(self.size + 1)]

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stage(slot: dict, arrays: list[np.ndarray]) -> tuple[list[torch.Tensor], object]:
            if "event" in slot:
                slot["event"].synchronize()  # its last copy has left the buffer
            want = [(torch.Size(a.shape), torch.from_numpy(a[:0]).dtype) for a in arrays]
            pinned = slot.get("pinned", [])
            if [(p.shape, p.dtype) for p in pinned] != want:
                pinned = [torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in want]
                slot["pinned"] = pinned
            for p, a in zip(pinned, arrays):
                p.numpy()[...] = a
            with torch.cuda.stream(copy_stream):
                out = [p.to(device, non_blocking=True) for p in pinned]
                event = torch.cuda.Event()
                event.record(copy_stream)
            slot["event"] = event
            return out, event

        def producer():
            try:
                with torch.cuda.device(device):
                    for n, batch in enumerate(self.it):
                        arrays = [np.ascontiguousarray(a) for a in _leaves(batch)]
                        out, event = stage(slots[n % len(slots)], arrays)
                        self.bytes_copied += sum(a.nbytes for a in arrays)
                        if not put((batch, out, event)):
                            return
            except Exception as exc:  # raised again in the consumer
                put((done, exc, None))
                return
            put((done, None, None))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch, out, event = q.get()
                if batch is done:
                    if out is not None:
                        raise RuntimeError("prefetch_to_device: the host loader failed") from out
                    return
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for t in out:
                    t.record_stream(stream)
                self.batches += 1
                leaves = iter(out)
                yield _map(batch, lambda _: next(leaves))
        finally:
            stop.set()
            thread.join(timeout=10.0)


def _leaves(batch) -> list:
    return list(batch) if isinstance(batch, (tuple, list)) else [batch]


def _map(batch, fn):
    if isinstance(batch, (tuple, list)):
        return tuple(fn(a) for a in batch)
    return fn(batch)


def prefetch_to_device(it: Iterator, device: torch.device | str = "cuda",
                       size: int = 2) -> DeviceFeed:
    """Stage host batches onto ``device`` while the current step runs
    (pin_memory + async H2D on a copy stream): ``DeviceFeed``."""
    return DeviceFeed(it, device, size)
