"""Datasets: ImageFolder and WebDataset-style tar shards — port of
``vision_toolbox_tpu/data/datasets.py`` (the same PIL and stdlib code, so the
same files give the same samples).

* ImageFolder mirrors torchvision's layout contract (class-per-subdir,
  sorted class names → indices) used by the reference (data.py:40).
* WebDataset reader consumes the shard layout produced by the reference's
  scripts/wds.py:22-32: tar members ``{key}.jpg`` + ``{key}.cls`` — read with
  the stdlib tarfile, no webdataset dependency.

Multi-process: ``shard_for_host`` slices the shard list per process — the
replacement for both the world-size batch division (data.py:65-66) and wds
``ddp_equalize`` (data.py:76-77): each process streams a disjoint 1/N of the
shards. Its rank and world size come from ``torch.distributed`` when it is
initialized (``process_rank``), else 0 and 1.
"""

from __future__ import annotations

import io
import os
import random
import tarfile
from dataclasses import dataclass
from typing import Iterator

from PIL import Image

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


@dataclass
class Sample:
    image: Image.Image
    label: int


@dataclass
class RawSample:
    """Undecoded image bytes — for loaders that decode natively (data/native.py)."""

    data: bytes
    label: int


class ImageFolder:
    """class-per-subdir dataset; indexable."""

    def __init__(self, root: str):
        self.root = root
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: list[tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Sample:
        path, label = self.samples[i]
        with Image.open(path) as img:
            return Sample(img.convert("RGB"), label)


def process_rank() -> tuple[int, int]:
    """(rank, world size) of this process: ``torch.distributed``'s when it is
    initialized, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_for_host(shards: list[str], process_index: int | None = None, process_count: int | None = None) -> list[str]:
    """Disjoint per-process shard assignment (SURVEY.md §5.8); explicit
    arguments win over ``process_rank``."""
    if process_index is None:
        process_index, process_count = process_rank()
    return shards[process_index::process_count]


def iter_webdataset(
    shards: list[str],
    shuffle_shards: bool = False,
    shuffle_buffer: int = 0,
    seed: int = 0,
    image_keys: tuple[str, ...] = ("jpg", "jpeg", "png"),
    decode: bool = True,
) -> Iterator[Sample | RawSample]:
    """Stream (image, cls) samples from .tar shards (reference shard layout).

    shard-level shuffle + a bounded sample shuffle buffer mirror the reference
    wds pipeline (data.py:32-38: shardshuffle + .shuffle(1000)).

    ``decode=False`` yields ``RawSample`` (undecoded bytes) so a downstream
    native decoder (data/native.py decode_batch) can do decode+crop+resize in
    its C++ thread pool — PIL decode is the wds bottleneck on a few-core host
    (the JAX package's host measurement: artifacts/decode_scaling.json)."""
    rng = random.Random(seed)
    shards = list(shards)
    if shuffle_shards:
        rng.shuffle(shards)

    def raw_iter() -> Iterator[Sample | RawSample]:
        for shard in shards:
            with tarfile.open(shard, "r") as tf:
                current_key = None
                parts: dict[str, bytes] = {}
                for member in tf:
                    if not member.isfile():
                        continue
                    base, ext = os.path.splitext(member.name)
                    ext = ext.lstrip(".").lower()
                    if base != current_key:
                        if current_key is not None:
                            s = _assemble(parts, image_keys, decode)
                            if s is not None:
                                yield s
                        current_key = base
                        parts = {}
                    parts[ext] = tf.extractfile(member).read()
                if current_key is not None:
                    s = _assemble(parts, image_keys, decode)
                    if s is not None:
                        yield s

    if shuffle_buffer <= 1:
        yield from raw_iter()
        return

    buf: list[Sample | RawSample] = []
    for sample in raw_iter():
        if len(buf) < shuffle_buffer:
            buf.append(sample)
            continue
        j = rng.randrange(shuffle_buffer)
        yield buf[j]
        buf[j] = sample
    rng.shuffle(buf)
    yield from buf


def _assemble(
    parts: dict[str, bytes], image_keys: tuple[str, ...], decode: bool = True
) -> Sample | RawSample | None:
    img_bytes = None
    for k in image_keys:
        if k in parts:
            img_bytes = parts[k]
            break
    if img_bytes is None or "cls" not in parts:
        return None
    label = int(parts["cls"].decode().strip())
    if not decode:
        return RawSample(img_bytes, label)
    img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
    return Sample(img, label)
