"""The port's data package (vision_toolbox_tpu_torch/data/) vs the JAX
package's: the same files, seed and epoch give bit-equal arrays.

On a tiny generated ImageFolder (JPEG), a raw-shard directory of two
shards, and two WebDataset tars: the transforms, ``DataLoader``,
``NativeJPEGLoader``, ``RawShardLoader`` (train and eval, two epochs),
``DeviceIndexLoader`` and ``WebDatasetLoader`` (one stream bit for bit, two
streams as the same multiset of samples: their interleaving is the
threads'), the per-process splits of ``shard_for_host`` and the raw-shard
loader with explicit rank and count (disjoint, complete, equal to the JAX
package's), ``process_rank`` from ``torch.distributed``, and
``prefetch_to_device`` on the CPU (the order and the values, as tensors).
All of it is host numpy, PIL and the stdlib on both sides: no tolerance.
"""

import torch_threads  # noqa: F401  (one torch CPU thread per test process)

import io
import random
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

import vision_toolbox_tpu.data as jdata
import vision_toolbox_tpu.data.native as jnative
import vision_toolbox_tpu.data.raw_shards as jraw
import vision_toolbox_tpu.data.wds_loader as jwds
import vision_toolbox_tpu_torch.data as pdata
import vision_toolbox_tpu_torch.data.native as pnative
import vision_toolbox_tpu_torch.data.raw_shards as praw
import vision_toolbox_tpu_torch.data.wds_loader as pwds


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(0)
    for cls in ("cat", "dog", "eel"):
        (root / cls).mkdir()
        for i in range(5):
            h, w = rng.integers(30, 60, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(root / cls / f"{i}.jpg")
    return str(root)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(1)
    for s, n in enumerate((13, 11)):
        praw.write_shard(str(root / f"{s:03d}.vtraw"), rng.integers(0, 256, (n, 20, 20, 3), np.uint8),
                         rng.integers(0, 5, n))
    return str(root)


@pytest.fixture(scope="module")
def wds_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("wds")
    rng = np.random.default_rng(2)
    paths, idx = [], 0
    for s in range(2):
        path = root / f"{s:04d}.tar"
        with tarfile.open(path, "w") as tf:
            for _ in range(9):
                buf = io.BytesIO()
                Image.fromarray(rng.integers(0, 256, (28, 34, 3), np.uint8)).save(buf, format="JPEG")
                for ext, data in (("jpg", buf.getvalue()), ("cls", str(idx % 4).encode())):
                    info = tarfile.TarInfo(f"{idx:06d}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
                idx += 1
        paths.append(str(path))
    return paths


def _equal_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_transforms_bit_equal(image_folder):
    ds_j, ds_p = jdata.ImageFolder(image_folder), pdata.ImageFolder(image_folder)
    assert ds_p.samples == ds_j.samples and ds_p.classes == ds_j.classes
    for i in range(len(ds_j)):
        img = ds_j[i].image
        np.testing.assert_array_equal(pdata.train_transform(random.Random(i), img, 24),
                                      jdata.train_transform(random.Random(i), img, 24))
        np.testing.assert_array_equal(pdata.val_transform(img, 36, 32),
                                      jdata.val_transform(img, 36, 32))
        for scale in ((0.08, 1.0), (0.9, 1.0)):
            np.testing.assert_array_equal(
                np.asarray(pdata.random_resized_crop(random.Random(i), img, 20, scale)),
                np.asarray(jdata.random_resized_crop(random.Random(i), img, 20, scale)))


@pytest.mark.parametrize("shuffle", [True, False])
def test_dataloader_bit_equal(image_folder, shuffle):
    def make(pkg):
        ds = pkg.ImageFolder(image_folder)
        return pkg.DataLoader(ds, 4, lambda r, im: pkg.train_transform(r, im, 24), shuffle=shuffle,
                              drop_last=shuffle, num_workers=3, seed=5)

    lj, lp = make(jdata), make(pdata)
    assert len(lp) == len(lj)
    for _ in range(2):  # two epochs: each reshuffles and redraws
        _equal_batches(lp, lj)


def test_native_loader_bit_equal(image_folder):
    """NativeJPEGLoader: the same boxes and flips from the same
    ``random.Random``, decoded by the one shared native/libvttdata.so."""
    if not (pnative.native_available() and jnative.native_available()):
        pytest.skip("native/libvttdata.so cannot be built here (libjpeg missing)")
    make = lambda pkg, mod: mod.NativeJPEGLoader(pkg.ImageFolder(image_folder), 4, 24,
                                                 num_threads=2, seed=3)
    lj, lp = make(jdata, jnative), make(pdata, pnative)
    for _ in range(2):
        _equal_batches(lp, lj)


@pytest.mark.parametrize("training", [True, False])
def test_raw_shard_loader_bit_equal(raw_dir, training):
    dj, dp = jraw.RawShardDataset(raw_dir, preload=True), praw.RawShardDataset(raw_dir)
    assert len(dp) == len(dj) == 24
    kw = dict(training=training, seed=7, process_index=0, process_count=1)
    lj, lp = jraw.RawShardLoader(dj, 5, 16, **kw), praw.RawShardLoader(dp, 5, 16, **kw)
    assert len(lp) == len(lj) == (4 if training else 5)
    for _ in range(2):
        _equal_batches(lp, lj)


def test_device_index_loader_bit_equal(raw_dir):
    labels = praw.RawShardDataset(raw_dir)._labels_flat
    lj, lp = jraw.DeviceIndexLoader(24, labels, 5, seed=3), praw.DeviceIndexLoader(24, labels, 5, seed=3)
    for _ in range(2):
        _equal_batches(lp, lj)


@pytest.mark.parametrize("count", [1, 2, 3])
def test_host_splits_disjoint_complete_and_equal(raw_dir, wds_shards, count):
    shards = wds_shards * 3 + ["x.tar"]
    parts = [pdata.shard_for_host(shards, i, count) for i in range(count)]
    assert parts == [jdata.shard_for_host(shards, i, count) for i in range(count)]
    assert sorted(sum(parts, [])) == sorted(shards)
    ds = praw.RawShardDataset(raw_dir)
    seen = []
    for i in range(count):
        kw = dict(training=False, process_index=i, process_count=count)
        loader = praw.RawShardLoader(ds, 4, 16, **kw)
        want = jraw.RawShardLoader(jraw.RawShardDataset(raw_dir), 4, 16, **kw)
        assert (loader._lo, loader._hi) == (want._lo, want._hi)
        seen.extend(range(loader._lo, loader._hi))
    assert seen == list(range(len(ds)))


def test_process_rank_from_torch_distributed(monkeypatch):
    assert pdata.process_rank() == (0, 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 3)
    assert pdata.process_rank() == (1, 3)
    assert pdata.shard_for_host(list("abcdef")) == ["b", "e"]
    assert pdata.shard_for_host(list("abcdef"), 0, 2) == ["a", "c", "e"]  # explicit wins


def _wds(pkg, mod, shards, **kw):
    return mod.WebDatasetLoader(shards, 4, lambda r, im: pkg.train_transform(r, im, 20), seed=4,
                                **kw)


def test_wds_loader_bit_equal(wds_shards):
    for kw in (dict(num_batches=5), dict(training=False)):
        lj, lp = _wds(jdata, jwds, wds_shards, **kw), _wds(pdata, pwds, wds_shards, **kw)
        for _ in range(2):
            _equal_batches(lp, lj)


def test_wds_two_streams_same_samples(wds_shards):
    def samples(loader):
        return sorted((int(lab), im.tobytes()) for ims, labs in loader for im, lab in zip(ims, labs))

    kw = dict(training=False, num_streams=2)
    assert samples(_wds(pdata, pwds, wds_shards, **kw)) == samples(_wds(jdata, jwds, wds_shards, **kw))


def test_prefetch_to_device_cpu_keeps_order_and_values(raw_dir):
    loader = praw.RawShardLoader(praw.RawShardDataset(raw_dir), 5, 16, training=True, seed=1,
                                 process_index=0, process_count=1)
    want = list(loader)
    loader.epoch = 0
    feed = pdata.prefetch_to_device(iter(loader), device="cpu")
    got = list(feed)
    assert feed.batches == len(want) == len(got)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert isinstance(gi, torch.Tensor) and gi.device.type == "cpu"
        np.testing.assert_array_equal(gi.numpy(), wi)
        np.testing.assert_array_equal(gl.numpy(), wl)
    single = list(pdata.prefetch_to_device(iter([np.arange(3)]), device="cpu"))
    assert torch.equal(single[0], torch.arange(3))


def test_prefetch_to_device_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdata.prefetch_to_device(iter([]))
