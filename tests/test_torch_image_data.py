"""The port's image data planes against the reference's, on the CPU.

``ImageNetData`` (synthetic shards, and shards written to disk),
``Cifar10Data`` and ``SyntheticDataset`` give batches bit-equal to the
reference's (``theanompi_tpu.models.data``) for train epochs 0 and 1,
for validation, and from a ``start_batch`` cursor; the reference's crop
may run in its C helper, the port's in the numpy loop, and the bytes must
still agree.  ``to_device`` keeps uint8 images as uint8.  The loader
pool's config builds without spawning, and the hickle converter raises
without hickle.
"""

import numpy as np
import pytest
import torch

from theanompi_tpu.models.data import base as RB
from theanompi_tpu.models.data import cifar10 as RC
from theanompi_tpu.models.data import imagenet as RI

from theanompi_torch.models.data import base as B
from theanompi_torch.models.data import cifar10 as C
from theanompi_torch.models.data import imagenet as I
from theanompi_torch.utils.helper_funcs import to_device

#: batches of 6 over shards of 16: the remainder buffer crosses shard
#: boundaries, and 40 samples leave a ragged tail to drop
IMAGENET = {"image_size": 24, "store_size": 32, "n_classes": 10,
            "n_train": 40, "n_val": 20, "shard_size": 16}


def _same_stream(mine, ref, batch, seed=3, start=0):
    ours = list(mine.train_batches(batch, 0, seed=seed))
    for epoch in (0, 1):
        a = list(mine.train_batches(batch, epoch, seed=seed))
        b = list(ref.train_batches(batch, epoch, seed=seed))
        assert len(a) == len(b) > 0, epoch
        for x, y in zip(a, b):
            assert (x["x"].dtype, x["y"].dtype) == (y["x"].dtype,
                                                    y["y"].dtype)
            np.testing.assert_array_equal(x["x"], y["x"])
            np.testing.assert_array_equal(x["y"], y["y"])
    a = list(mine.val_batches(batch))
    b = list(ref.val_batches(batch))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["x"], y["x"])
        np.testing.assert_array_equal(x["y"], y["y"])
    # a cursor fast-forward gives the uninterrupted epoch's tail
    tail = list(mine.train_batches(batch, 0, seed=seed, start_batch=start))
    assert len(tail) == len(ours) - start
    for x, y in zip(tail, ours[start:]):
        np.testing.assert_array_equal(x["x"], y["x"])
        np.testing.assert_array_equal(x["y"], y["y"])
    return ours


def test_imagenet_synthetic_batches_bit_equal():
    mine, ref = I.ImageNetData(dict(IMAGENET)), RI.ImageNetData(dict(IMAGENET))
    assert (mine.n_train, mine.n_val, mine.n_classes, mine.store_size) == (
        ref.n_train, ref.n_val, ref.n_classes, ref.store_size)
    ours = _same_stream(mine, ref, 6, start=3)
    assert ours[0]["x"].dtype == np.uint8
    assert ours[0]["x"].shape == (6, 24, 24, 3)
    for a, b in zip(mine.norm_stats, ref.norm_stats):
        np.testing.assert_array_equal(a, b)


def test_imagenet_shards_on_disk_bit_equal(tmp_path):
    r = np.random.RandomState(0)
    for split, n in (("train", 37), ("val", 14)):
        x = r.randint(0, 256, size=(n, 30, 30, 3)).astype(np.uint8)
        y = r.randint(0, 7, size=n).astype(np.int32)
        I.write_shards(str(tmp_path / split), x, y, shard_size=10)
    cfg = {"data_path": str(tmp_path), "image_size": 26}
    mine, ref = I.ImageNetData(dict(cfg)), RI.ImageNetData(dict(cfg))
    assert not mine.synthetic and mine.store_size == 30
    assert (mine.n_train, mine.n_val, mine.n_classes) == (
        ref.n_train, ref.n_val, ref.n_classes) == (37, 14, 7)
    _same_stream(mine, ref, 4, start=5)


def test_cifar10_batches_bit_equal():
    cfg = {"n_train": 40, "n_val": 16, "image_size": 16}
    mine, ref = C.Cifar10Data(dict(cfg)), RC.Cifar10Data(dict(cfg))
    np.testing.assert_array_equal(mine.x_train, ref.x_train)
    ours = _same_stream(mine, ref, 8, start=2)
    assert ours[0]["x"].dtype == np.float32
    x = np.random.RandomState(1).rand(5, 12, 12, 3).astype(np.float32)
    np.testing.assert_array_equal(
        C.pad_crop_mirror(x, np.random.RandomState(4)),
        RC.pad_crop_mirror(x, np.random.RandomState(4)))


def test_synthetic_dataset_bit_equal():
    kw = dict(n_train=30, n_val=12, sample_shape=(6, 6, 3), n_classes=4,
              seed=2)
    _same_stream(B.SyntheticDataset(**kw), RB.SyntheticDataset(**kw), 5,
                 start=4)


def test_to_device_keeps_uint8_images():
    batch = {"x": np.zeros((2, 4, 4, 3), np.uint8),
             "y": np.arange(2, dtype=np.int32),
             "f": np.ones((2, 3), np.float32)}
    out = to_device(batch, "cpu")
    assert out["x"].dtype == torch.uint8
    assert out["y"].dtype == torch.int64
    assert out["f"].dtype == torch.float32


def test_what_is_not_ported_raises(monkeypatch):
    # the loader pool is ported: the config builds, and spawns nothing
    # before the first training epoch
    data = I.ImageNetData({**IMAGENET, "loader_workers": 2})
    assert data.loader_workers == 2 and data._shm_pool is None
    # the hickle converter is ported; without hickle it raises, as the
    # reference's does
    monkeypatch.setitem(__import__("sys").modules, "hickle", None)
    with pytest.raises(ImportError, match="hickle"):
        I.convert_hkl_tree("a", "b")


def test_read_with_retry_retries_then_raises():
    calls, sleeps = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("EIO")
        return 7

    assert B.read_with_retry(flaky, "f", sleep=sleeps.append) == 7
    assert sleeps == [0.05, 0.1]

    def broken():
        raise ValueError("torn")

    with pytest.raises(B.DataReadError, match="after 2 attempts"):
        B.read_with_retry(broken, "g", retries=2, sleep=sleeps.append)
