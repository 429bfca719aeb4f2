"""Batching loader over WebDataset tar shards (streaming, per-process
sharded) — port of ``vision_toolbox_tpu/data/wds_loader.py``.

Mirrors the reference wds pipeline (data.py:32-38, 68-77): shard shuffle +
1000-sample buffer + per-sample transform + fixed-size batches. Epoch length
is ``train_size // global_batch`` like wds ``ddp_equalize`` — each host
streams its own disjoint shards and contributes batch_size/host_count
samples per step.

``num_streams > 1`` runs that many parallel tar readers (threads; tarfile IO
and PIL JPEG decode release the GIL in their C cores), each streaming a
disjoint round-robin slice of the host's shards into one bounded queue that
a single assembler drains into batches — the host-side analogue of the
reference's ``num_workers: 8`` DataLoader processes (data.py:68-77). The
epoch-length and exactly-once contracts are preserved: every sample of every
shard is yielded once per cycle, and ``num_batches`` still bounds the epoch.

``native_crop_size`` switches the train path to the C++ decoder
(data/native.py): streams carry UNDECODED jpeg bytes out of the tars, and
batch assembly samples torchvision-parity RandomResizedCrop boxes + flips,
then decodes the whole batch in the native thread pool (DCT-scaled libjpeg
decode + crop + bilinear resize). PIL decode is the wds hot cost on a
few-core host (artifacts/decode_scaling.json, the JAX package's host);
this mode replaces it the same way NativeJPEGLoader does for ImageFolder.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterator

import numpy as np

from .datasets import iter_webdataset, shard_for_host


class WebDatasetLoader:
    def __init__(
        self,
        shards: list[str],
        batch_size: int,
        transform: Callable | None,  # (rng, PIL.Image) -> HWC array
        training: bool = True,
        num_batches: int | None = None,
        seed: int = 0,
        per_host: bool = True,
        num_streams: int = 1,
        native_crop_size: int | None = None,
        decode_threads: int = 8,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.shards = (shard_for_host(shards, process_index, process_count) if per_host
                       else list(shards))
        self.batch_size = batch_size
        self.transform = transform
        self.training = training
        self.num_batches = num_batches
        self.seed = seed
        self.num_streams = max(1, min(num_streams, len(self.shards) or 1))
        self.native_crop_size = native_crop_size
        self.decode_threads = decode_threads
        self.epoch = 0
        if native_crop_size is not None:
            if not training:
                raise ValueError("native_crop_size is a train-path mode (RRC + "
                                 "flip); keep the PIL transform for val parity")
            from .native import native_available

            if not native_available():
                raise RuntimeError("native_crop_size set but native/libvttdata.so "
                                   "is unavailable (run `make -C native`)")

    def __len__(self) -> int:
        if self.num_batches is None:
            raise TypeError("streaming loader has no length without num_batches")
        return self.num_batches

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        epoch_seed = (self.seed, self.epoch).__hash__() & 0x7FFFFFFF
        self.epoch += 1
        rng = random.Random(epoch_seed)

        native = self.native_crop_size is not None

        def transformed_samples(cycle: int):
            """One stream (num_streams == 1): decode + transform inline
            (native mode: pass undecoded bytes through — the batch assembler
            decodes in the C++ pool)."""
            sample_iter = iter_webdataset(
                self.shards,
                shuffle_shards=self.training,
                shuffle_buffer=1000 if self.training else 0,
                seed=epoch_seed + cycle,
                decode=not native,
            )
            for sample in sample_iter:
                if native:
                    yield sample.data, sample.label
                else:
                    yield self.transform(rng, sample.image), sample.label

        def parallel_samples(cycle: int):
            """num_streams parallel tar readers + decoders → one bounded queue.

            Shards are dealt round-robin AFTER the epoch shard shuffle, so the
            partition changes every epoch; each stream keeps its own transform
            rng (seeded per (epoch, cycle, stream)) and its own shuffle
            buffer — the union is exactly one pass over the host's shards."""
            shards = list(self.shards)
            if self.training:
                random.Random(epoch_seed + cycle).shuffle(shards)
            groups = [shards[i :: self.num_streams] for i in range(self.num_streams)]
            groups = [g for g in groups if g]
            q: queue.Queue = queue.Queue(maxsize=4 * self.batch_size)
            _SENTINEL = object()
            cancel = threading.Event()

            def put(item) -> bool:
                """Bounded put that aborts when the consumer is gone."""
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def work(idx: int, group: list[str]):
                srng = random.Random((epoch_seed, cycle, idx).__hash__() & 0x7FFFFFFF)
                try:
                    for sample in iter_webdataset(
                        group,
                        shuffle_shards=False,  # already shuffled + dealt above
                        shuffle_buffer=1000 // len(groups) if self.training else 0,
                        seed=epoch_seed + cycle + idx,
                        decode=not native,
                    ):
                        item = (
                            (sample.data, sample.label)
                            if native
                            else (self.transform(srng, sample.image), sample.label)
                        )
                        if not put(item):
                            return
                except BaseException as exc:  # surface corrupt-shard/decode errors
                    put((_SENTINEL, exc))
                finally:
                    put((_SENTINEL, None))

            threads = [
                threading.Thread(target=work, args=(i, g), daemon=True)
                for i, g in enumerate(groups)
            ]
            for t in threads:
                t.start()
            try:
                live = len(threads)
                while live:
                    item = q.get()
                    if isinstance(item, tuple) and item[0] is _SENTINEL:
                        if item[1] is not None:
                            # fail FAST: a corrupt shard must not let the
                            # epoch run on for hours on silently skewed data
                            # (the finally below cancels + drains the rest)
                            raise RuntimeError("wds reader stream failed") from item[1]
                        live -= 1
                        continue
                    yield item
                for t in threads:
                    t.join()
            finally:
                # Consumer abandoned mid-epoch (num_batches truncation, break,
                # raise): unblock any reader parked on the full queue and drain
                # so the threads exit instead of leaking decoded batches.
                cancel.set()
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                for t in threads:
                    t.join(timeout=5.0)

        def decode_native(jpegs: list[bytes], labels: list[int]):
            """RRC boxes + flips on the host rng, decode+crop+resize in the
            C++ thread pool — same distribution as NativeJPEGLoader."""
            from .native import decode_batch, jpeg_size, sample_rrc_box

            n = len(jpegs)
            sizes = np.empty((n, 2), np.int32)
            boxes = np.empty((n, 4), np.int32)
            flips = np.empty((n,), np.uint8)
            for j, data in enumerate(jpegs):
                W, H = jpeg_size(data)
                sizes[j] = (W, H)
                boxes[j] = sample_rrc_box(rng, W, H)
                flips[j] = 1 if rng.random() < 0.5 else 0
            out = decode_batch(jpegs, boxes, sizes, flips,
                               self.native_crop_size, self.decode_threads)
            return out, np.asarray(labels, np.int32)

        def batches(cycle: int = 0):
            source = parallel_samples if self.num_streams > 1 else transformed_samples
            images, labels = [], []
            for image, label in source(cycle):
                images.append(image)
                labels.append(label)
                if len(images) == self.batch_size:
                    if native:
                        yield decode_native(images, labels)
                    else:
                        yield np.stack(images), np.asarray(labels, np.int32)
                    images, labels = [], []
            if images and not self.training:
                yield np.stack(images), np.asarray(labels, np.int32)

        it = batches()
        if self.num_batches is None:
            yield from it
            return
        # fixed epoch length (ddp_equalize data.py:76-77): cycle if short
        produced = 0
        cycle = 0
        while produced < self.num_batches:
            got = False
            for batch in it:
                got = True
                yield batch
                produced += 1
                if produced >= self.num_batches:
                    return
            if not got:
                return
            cycle += 1
            it = batches(cycle)  # re-stream fresh shards
