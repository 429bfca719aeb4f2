"""Pre-decoded raw-crop shard format — the input-pipeline escape hatch; port
of ``vision_toolbox_tpu/data/raw_shards.py`` (the same numpy code: the same
seed and epoch give bit-equal batches).

The reference feeds training from JPEG decode in DataLoader workers
(data.py:63-86, num_workers=8). On a host with few cores JPEG decode cannot
keep an accelerator fed (the JAX package's host measurement:
artifacts/decode_scaling.json). This module trades disk bytes for
host CPU: images are decoded ONCE offline into fixed-size uint8 HWC crops
stored contiguously in shard files, and the training-time "decode" is a
memmap copy — per image a ~100 KB memcpy plus a random-crop slice, hundreds
of MB/s on a single core.

Format (one ``.vtraw`` file per shard)::

    magic   b"VTRAW001"                     (8 bytes)
    n       u32 little-endian               image count
    h, w, c u16 little-endian each          stored image geometry
    labels  i32[n]                          little-endian
    data    u8[n, h, w, c]                  C-contiguous

A ``meta.json`` beside the shards records classes / geometry / counts.

What is given up relative to online RandomResizedCrop: the stored image is a
fixed squash-resize of the full frame to (store,store), so per-epoch scale
diversity is reduced to random (crop,crop)-window + hflip on the host plus
the device-side TrivialAugment warp (shear/translate) — the same trade FFCV
makes. Store at ``store > crop`` (e.g. 200 for a 176 train crop) to retain
translation diversity.

Multi-process: the loader splits the global index range per process
(process_index/process_count, from ``torch.distributed`` when it is
initialized: ``datasets.process_rank``), mirroring ``shard_for_host``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator

import numpy as np

from .datasets import process_rank

MAGIC = b"VTRAW001"
_HEADER = struct.Struct("<8sIHHH")  # magic, n, h, w, c


def write_shard(path: str, images: np.ndarray, labels: np.ndarray) -> None:
    """``images``: uint8 (n, h, w, c) C-contiguous; ``labels``: int (n,)."""
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.ascontiguousarray(labels, np.int32)
    n, h, w, c = images.shape
    assert labels.shape == (n,), (labels.shape, n)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HEADER.pack(MAGIC, n, h, w, c))
        f.write(labels.tobytes())
        f.write(images.tobytes())
    os.replace(tmp, path)  # atomic: no torn shards on preemption


class RawShard:
    """One memmapped shard: ``.labels`` i32 (n,), ``.images`` uint8 view.

    ``preload=True`` reads the shard into RAM in one sequential pass —
    random-access training then never pays cold memmap page faults (a random
    first epoch over a cold shard is seek-bound; sequential read is disk
    bandwidth). Use when the corpus fits in memory.
    """

    def __init__(self, path: str, preload: bool = False):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(_HEADER.size)
        magic, n, h, w, c = _HEADER.unpack(head)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a VTRAW001 shard (magic {magic!r})")
        self.n, self.h, self.w, self.c = n, h, w, c
        off = _HEADER.size
        self.labels = np.memmap(path, np.int32, "r", offset=off, shape=(n,))
        off += 4 * n
        self.images = np.memmap(path, np.uint8, "r", offset=off, shape=(n, h, w, c))
        if preload:
            # np.array(copy=True), NOT asarray — asarray returns a view on the
            # memmap (the "preloaded" loader would then run at disk
            # random-read speed)
            self.labels = np.array(self.labels, copy=True)
            self.images = np.array(self.images, copy=True)

    def __len__(self) -> int:
        return self.n


class RawShardDataset:
    """Directory of ``.vtraw`` shards, indexable as one flat dataset."""

    def __init__(self, root: str, preload: bool = False):
        self.root = root
        paths = sorted(
            os.path.join(root, f) for f in os.listdir(root) if f.endswith(".vtraw")
        )
        if not paths:
            raise FileNotFoundError(f"no .vtraw shards under {root}")
        self.shards = [RawShard(p, preload=preload) for p in paths]
        g = self.shards[0]
        for s in self.shards:
            if (s.h, s.w, s.c) != (g.h, g.w, g.c):
                raise ValueError(f"{s.path}: geometry {(s.h, s.w, s.c)} != {(g.h, g.w, g.c)}")
        self.h, self.w, self.c = g.h, g.w, g.c
        self._starts = np.cumsum([0] + [len(s) for s in self.shards])
        # flat label gather + per-shard image base addresses (one vectorized
        # lookup per batch instead of a python loop per sample)
        self._labels_flat = np.concatenate([np.asarray(s.labels) for s in self.shards])
        self._base_addrs = np.array(
            [s.images.ctypes.data for s in self.shards], np.uint64
        )
        meta_path = os.path.join(root, "meta.json")
        self.meta = json.load(open(meta_path)) if os.path.exists(meta_path) else {}

    def __len__(self) -> int:
        return int(self._starts[-1])

    def locate(self, i: int) -> tuple[RawShard, int]:
        s = int(np.searchsorted(self._starts, i, "right")) - 1
        return self.shards[s], i - int(self._starts[s])


class RawShardLoader:
    """Batches pre-decoded shards: memmap copy + random (crop,crop) window +
    hflip per image on the host. Yields (uint8 NHWC batch, int32 labels) —
    the same contract as NativeJPEGLoader (normalization stays on device).

    ``training=False`` uses the deterministic center window and no flip.
    """

    def __init__(self, dataset: RawShardDataset, batch_size: int, crop_size: int,
                 training: bool = True, drop_last: bool | None = None, seed: int = 0,
                 process_index: int | None = None, process_count: int | None = None):
        if crop_size > dataset.h or crop_size > dataset.w:
            raise ValueError(
                f"crop {crop_size} exceeds stored size {(dataset.h, dataset.w)}"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.training = training
        self.drop_last = training if drop_last is None else drop_last
        self.seed = seed
        self.epoch = 0
        if process_index is None:
            process_index, process_count = process_rank()
        # disjoint contiguous 1/N of the global index per host
        n = len(dataset)
        per = n // (process_count or 1)
        self._lo, self._hi = process_index * per, (process_index + 1) * per
        if process_index == (process_count or 1) - 1:
            self._hi = n

    def __len__(self) -> int:
        n = self._hi - self._lo
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng([self.seed, self.epoch])
        self.epoch += 1
        order = np.arange(self._lo, self._hi)
        if self.training:
            rng.shuffle(order)
        S = self.crop_size
        ds = self.dataset
        H, W, C = ds.h, ds.w, ds.c
        cy, cx = (H - S) // 2, (W - S) // 2
        img_bytes = np.uint64(H * W * C)
        use_native = C == 3 and _crop_flip_native()
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            n = len(idxs)
            if self.drop_last and n < self.batch_size:
                break
            # vectorized flat→(shard, local) resolution for the whole batch
            sid = np.searchsorted(ds._starts, idxs, "right") - 1
            local = (idxs - ds._starts[sid]).astype(np.uint64)
            labels = ds._labels_flat[idxs].astype(np.int32, copy=True)
            out = np.empty((n, S, S, C), np.uint8)
            if self.training:
                y0 = rng.integers(0, H - S + 1, n).astype(np.int32)
                x0 = rng.integers(0, W - S + 1, n).astype(np.int32)
                flips = rng.integers(0, 2, n).astype(np.uint8)
            else:
                y0 = np.full((n,), cy, np.int32)
                x0 = np.full((n,), cx, np.int32)
                flips = np.zeros((n,), np.uint8)
            if use_native:
                # one native call: row memcpys (no flip) / 3-byte pixel
                # reversal (flip). NumPy's negative-stride uint8x3 copy is
                # much slower than memcpy — the python fallback below pays it.
                from .native import crop_flip_batch

                src_ptrs = ds._base_addrs[sid] + local * img_bytes
                crop_flip_batch(src_ptrs, W, y0, x0, flips, S, out)
            else:
                shards = ds.shards
                for j in range(n):
                    out[j] = shards[sid[j]].images[
                        local[j], y0[j] : y0[j] + S, x0[j] : x0[j] + S
                    ]
                for j in np.nonzero(flips)[0]:
                    out[j] = out[j, :, ::-1]
            yield out, labels


class DeviceIndexLoader:
    """Index batches for the device-resident mode (data.device_resident).

    The images never cross the host→device link after the one-time store
    upload; per step this loader yields only a shuffled ``(B,) int32`` index
    vector plus the matching labels (labels ride along so the trainer's
    loader contract — (array, labels) tuples with ``len`` — is unchanged; the
    device step re-gathers labels from the device store itself).
    """

    def __init__(self, n: int, labels: np.ndarray, batch_size: int,
                 seed: int = 0, drop_last: bool = True):
        self.n = n
        self.labels = np.asarray(labels, np.int32)
        self.batch_size = batch_size
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        return self.n // self.batch_size if self.drop_last else -(-self.n // self.batch_size)

    def __iter__(self):
        rng = np.random.default_rng([self.seed, self.epoch])
        self.epoch += 1
        order = rng.permutation(self.n).astype(np.int32)
        for start in range(0, self.n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield idx, self.labels[idx]


def _crop_flip_native() -> bool:
    try:
        from .native import native_available

        return native_available()
    except Exception:
        return False
