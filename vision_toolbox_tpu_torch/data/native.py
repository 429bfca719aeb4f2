"""ctypes bindings for the native (C++) JPEG data path (native/decoder.cpp at
the repo root, shared with the JAX package) — port of
``vision_toolbox_tpu/data/native.py``.

Exposes batched decode+crop+resize with an internal thread pool; emits uint8
NHWC batches (normalization happens on device, shrinking H2D transfers 4×).
Falls back cleanly when the shared library hasn't been built —
``native_available()`` gates usage; ``build_native()`` compiles it on demand.
"""

from __future__ import annotations

import ctypes
import math
import os
import random
import subprocess

import numpy as np

from .datasets import process_rank
from .loader import count_batches, split_batches

_LIB = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libvttdata.so"))


def build_native() -> bool:
    try:
        subprocess.run(["make"], cwd=os.path.abspath(_NATIVE_DIR), check=True,
                       capture_output=True)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    if not os.path.exists(_LIB_PATH) and not build_native():
        raise OSError(f"native library not available at {_LIB_PATH}")
    lib = ctypes.CDLL(_LIB_PATH)
    lib.vtt_jpeg_size.restype = ctypes.c_int
    lib.vtt_jpeg_size.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vtt_decode_crop_resize_batch.restype = ctypes.c_int
    lib.vtt_decode_crop_resize_batch.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_int),   # orig sizes (w,h)*n
        ctypes.POINTER(ctypes.c_int),   # boxes (x,y,w,h)*n
        ctypes.POINTER(ctypes.c_ubyte),  # flips
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int,
    ]
    lib.vtt_crop_flip_batch.restype = None
    lib.vtt_crop_flip_batch.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),  # per-sample src pointers
        ctypes.c_int,                     # src row width (px)
        ctypes.POINTER(ctypes.c_int),     # y0
        ctypes.POINTER(ctypes.c_int),     # x0
        ctypes.POINTER(ctypes.c_ubyte),   # flips
        ctypes.c_int, ctypes.c_int,       # out_w, out_h
        ctypes.POINTER(ctypes.c_ubyte),   # out
        ctypes.c_int,                     # threads
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def jpeg_size(data: bytes) -> tuple[int, int]:
    lib = _load()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.vtt_jpeg_size(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise ValueError("not a decodable JPEG")
    return w.value, h.value


def sample_rrc_box(
    rng: random.Random, W: int, H: int,
    scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
) -> tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box distribution (same as
    transforms.random_resized_crop)."""
    area = W * H
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            # randrange(0, n + 1) is what random.Random.randint(0, n) calls
            return rng.randrange(0, W - w + 1), rng.randrange(0, H - h + 1), w, h
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = H, int(round(H * ratio[1]))
    else:
        w, h = W, H
    return (W - w) // 2, (H - h) // 2, w, h


def decode_batch(
    jpegs: list[bytes],
    boxes: np.ndarray,       # (n, 4) int32 x,y,w,h in original coords
    orig_sizes: np.ndarray,  # (n, 2) int32 w,h
    flips: np.ndarray,       # (n,) uint8
    out_size: int,
    n_threads: int = 8,
) -> np.ndarray:
    """Returns uint8 (n, out_size, out_size, 3)."""
    lib = _load()
    n = len(jpegs)
    data_ptrs = (ctypes.c_char_p * n)(*jpegs)
    lens = (ctypes.c_size_t * n)(*[len(b) for b in jpegs])
    boxes = np.ascontiguousarray(boxes, np.int32)
    sizes = np.ascontiguousarray(orig_sizes, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    failures = lib.vtt_decode_crop_resize_batch(
        n, data_ptrs, lens,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out_size, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n_threads,
    )
    if failures:
        raise ValueError(f"{failures}/{n} JPEGs failed to decode")
    return out


def crop_flip_batch(
    src_ptrs: np.ndarray,  # (n,) uint64 — per-sample image base addresses
    src_w: int,
    y0: np.ndarray,        # (n,) int32
    x0: np.ndarray,        # (n,) int32
    flips: np.ndarray,     # (n,) uint8
    out_size: int,
    out: np.ndarray,       # (n, out_size, out_size, 3) uint8, written in place
    n_threads: int = 1,
) -> None:
    """Batch window-crop + hflip over pre-decoded uint8 RGB images (the raw
    shard path). One native call per batch: memcpy rows (no flip) / 3-byte
    pixel reversal (flip) — numpy's negative-stride uint8x3 copy is much
    slower (native/decoder.cpp vtt_crop_flip_batch)."""
    lib = _load()
    n = len(src_ptrs)
    lib.vtt_crop_flip_batch(
        n,
        src_ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        src_w,
        np.ascontiguousarray(y0, np.int32).ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        np.ascontiguousarray(x0, np.int32).ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        np.ascontiguousarray(flips, np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        out_size, out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n_threads,
    )


class NativeJPEGLoader:
    """Train loader over an ImageFolder of JPEGs: reads raw bytes, samples RRC
    boxes + flips on the host, then decode+crop+resize in the C++ thread pool.
    Yields (uint8 NHWC batch, int32 labels). Over several processes each
    takes its rows of every global batch (``loader.split_batches``;
    ``process_index``/``process_count`` default to ``datasets.process_rank``)
    and draws its boxes and flips from a generator of its own."""

    def __init__(self, dataset, batch_size: int, crop_size: int = 176,
                 shuffle: bool = True, drop_last: bool = True,
                 num_threads: int = 8, seed: int = 0,
                 process_index: int | None = None, process_count: int | None = None):
        if process_index is None:
            process_index, process_count = process_rank()
        self.process_index, self.process_count = process_index, process_count
        self.dataset = dataset  # ImageFolder: .samples [(path, label)]
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.seed = seed
        self.epoch = 0
        self._size_cache: dict[str, tuple[int, int]] = {}

    def __len__(self):
        return count_batches(len(self.dataset.samples), self.batch_size, self.process_index,
                             self.process_count, self.drop_last)

    def __iter__(self):
        rng = random.Random((self.seed, self.epoch).__hash__())
        if self.process_count > 1:  # the order alike on every process, the draws its own
            draws = random.Random((self.seed, self.epoch, self.process_index).__hash__())
        else:
            draws = rng
        self.epoch += 1
        order = list(range(len(self.dataset.samples)))
        if self.shuffle:
            rng.shuffle(order)
        for idxs, rows in split_batches(order, self.batch_size, self.process_index,
                                        self.process_count, self.drop_last):
            jpegs, labels, boxes, sizes, flips = [], [], [], [], []
            for i in idxs[rows]:
                path, label = self.dataset.samples[i]
                with open(path, "rb") as f:
                    data = f.read()
                wh = self._size_cache.get(path)
                if wh is None:
                    wh = jpeg_size(data)
                    self._size_cache[path] = wh
                W, H = wh
                jpegs.append(data)
                labels.append(label)
                boxes.append(sample_rrc_box(draws, W, H))
                sizes.append((W, H))
                flips.append(1 if draws.random() < 0.5 else 0)
            batch = decode_batch(
                jpegs, np.asarray(boxes), np.asarray(sizes),
                np.asarray(flips, np.uint8), self.crop_size, self.num_threads,
            )
            yield batch, np.asarray(labels, np.int32)
