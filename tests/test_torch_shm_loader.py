"""The port's shared-memory loader pool
(``theanompi_torch.models.data.shm_loader``) against the reference's
inline ``ImageNetData``, on the CPU.

- ``ImageNetData(loader_workers=2)`` gives batches bit-equal to the
  reference's inline batches, from synthetic shards and from shards on
  disk, whole and as two ranks' ``rows`` (the pool loads only the shards
  a rank's rows need);
- closing an epoch's generator early drains the ring, and the next epoch
  runs on the same pool;
- the token mode hands back the shard ``load_token_shard`` reads;
- a rank started by ``dist.spawn`` trains from a pool of its own, as a
  process fed inline does;
- a worker that dies makes the pool raise instead of hanging.

One pool of two spawned workers serves the module; its finalizer closes
it and asserts that no worker process and no ``data-prefetch`` thread is
left.
"""

import multiprocessing
import threading
import time

import numpy as np
import pytest

from theanompi_tpu.models.data import imagenet as RI

from theanompi_torch.models.data import imagenet as I
from theanompi_torch.models.data.shm_loader import ShmShardPool
from theanompi_torch.models.data.stream import load_token_shard

IMAGE = 24
SHARD = 16
SYNTH = {"image_size": IMAGE, "store_size": 32, "n_classes": 10,
         "n_train": 72, "n_val": 16, "shard_size": SHARD}


def _assert_torn_down():
    assert multiprocessing.active_children() == []
    alive = [t.name for t in threading.enumerate()
             if t.name == "data-prefetch" and t.is_alive()]
    assert alive == [], alive


class _Pools:
    """The module's one pool, replaced only after a test broke it."""

    def __init__(self):
        self.pool = None

    def get(self):
        if self.pool is None or self.pool._closed or self.pool._broken:
            if self.pool is not None:
                self.pool.close()
            self.pool = ShmShardPool(IMAGE, SHARD, workers=2)
        return self.pool


@pytest.fixture(scope="module")
def pools():
    p = _Pools()
    yield p
    if p.pool is not None:
        p.pool.close()
    _assert_torn_down()


@pytest.fixture
def pool(pools):
    return pools.get()


def _pooled(cfg, pool):
    """The port's ``ImageNetData`` with ``loader_workers=2`` on the
    module's pool (it never closes it)."""
    data = I.ImageNetData({**cfg, "loader_workers": 2})
    data._shm_pool = pool
    return data


@pytest.fixture(scope="module")
def on_disk(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    r = np.random.RandomState(0)
    for split, n in (("train", 61), ("val", 14)):
        x = r.randint(0, 256, size=(n, 28, 28, 3)).astype(np.uint8)
        y = r.randint(0, 7, size=n).astype(np.int32)
        I.write_shards(str(root / split), x, y, shard_size=SHARD)
    return {"data_path": str(root), "image_size": IMAGE}


def _check_against_reference(mine, ref, batch, epochs=(0, 1), seed=3):
    for epoch in epochs:
        whole = list(ref.train_batches(batch, epoch, seed=seed))
        assert len(whole) > 1
        got = list(mine.train_batches(batch, epoch, seed=seed))
        assert len(got) == len(whole)
        for a, b in zip(got, whole):
            assert a["x"].dtype == np.uint8
            np.testing.assert_array_equal(a["x"], b["x"])
            np.testing.assert_array_equal(a["y"], b["y"])
        # two ranks: each its rows of every batch
        half = batch // 2
        for lo, hi in ((0, half), (half, batch)):
            rows = list(mine.train_batches(batch, epoch, seed=seed,
                                           rows=(lo, hi)))
            assert len(rows) == len(whole)
            for a, b in zip(rows, whole):
                np.testing.assert_array_equal(a["x"], b["x"][lo:hi])
                np.testing.assert_array_equal(a["y"], b["y"][lo:hi])


def test_synthetic_batches_bit_equal_to_the_reference(pool):
    mine, ref = _pooled(SYNTH, pool), RI.ImageNetData(dict(SYNTH))
    _check_against_reference(mine, ref, 10)
    # a cursor fast-forward through the pool is the epoch's tail
    tail = list(mine.train_batches(10, 0, seed=3, start_batch=4))
    whole = list(ref.train_batches(10, 0, seed=3))
    assert len(tail) == len(whole) - 4
    for a, b in zip(tail, whole[4:]):
        np.testing.assert_array_equal(a["x"], b["x"])


def test_on_disk_batches_bit_equal_to_the_reference(pool, on_disk):
    mine, ref = _pooled(on_disk, pool), RI.ImageNetData(dict(on_disk))
    assert not mine.synthetic
    _check_against_reference(mine, ref, 8, epochs=(0,))


def test_a_rank_loads_only_the_shards_its_rows_need(pool):
    mine = _pooled({**SYNTH, "n_train": 64}, pool)  # 4 whole shards
    asked = []
    run = pool.run

    def counting(tasks):
        tasks = list(tasks)
        asked.append(len(tasks))
        return run(tasks)

    pool.run = counting
    try:
        # batch 32 over shards of 16: rows 0:16 of each batch are the
        # epoch order's shards 0 and 2
        n = len(list(mine.train_batches(32, 0, seed=1, rows=(0, 16))))
    finally:
        del pool.run
    assert n == 2 and asked == [2]


def test_an_early_close_then_the_next_epoch(pool):
    mine, ref = _pooled(SYNTH, pool), RI.ImageNetData(dict(SYNTH))
    gen = mine.train_batches(8, 0, seed=2)
    first = next(gen)
    gen.close()  # slots still in flight are drained
    assert not pool._busy.locked() and not pool._broken
    np.testing.assert_array_equal(
        first["x"], next(iter(ref.train_batches(8, 0, seed=2)))["x"])
    got = list(mine.train_batches(8, 1, seed=2))
    want = list(ref.train_batches(8, 1, seed=2))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["x"], b["x"])
    # one epoch at a time
    busy = mine.train_batches(8, 0, seed=2)
    next(busy)
    with pytest.raises(RuntimeError, match="already serving"):
        next(mine.train_batches(8, 1, seed=2))
    busy.close()


def test_token_mode(pool, tmp_path):
    paths = []
    for i, n in enumerate((1000, 37, 2048)):
        p = tmp_path / f"t{i}.npy"
        np.save(p, np.arange(n, dtype=np.int64) * (i + 1))
        paths.append(str(p))
    assert pool.slot_nbytes >= 4 * 2048
    got = list(pool.run([(("tokens", p), 0) for p in paths]))
    assert len(got) == 3
    for (toks, y), p in zip(got, paths):
        assert y is None and toks.dtype == np.int32
        np.testing.assert_array_equal(toks, load_token_shard(p))


def test_a_spawned_rank_trains_from_its_own_pool():
    """A rank of ``dist.spawn`` (a process of its own) starts its loader
    pool, trains through the prefetcher on it, and stops it: the params
    after each step equal a one-process run fed inline."""
    import torch

    from theanompi_torch import dist as tdist
    from theanompi_torch.parallel.rank_jobs import bsp_run

    cfg = {"image_size": 32, "n_classes": 9, "stage_blocks": (1, 1, 1, 1),
           "batch_size": 4, "shard_size": 8, "n_train": 16, "n_val": 8,
           "precision": "fp32"}
    job = {"modelfile": "theanompi_torch.models.resnet50",
           "modelclass": "ResNet50", "steps": 3,
           "rule_config": {"seed": 1, "verbose": False,
                           "prefetch_stall_timeout": 60}}
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # as the rank runs
    try:
        inline = bsp_run(torch.device("cpu"), {
            **job, "model_config": cfg,
            "rule_config": {**job["rule_config"], "prefetch": 0}})
    finally:
        torch.set_num_threads(prev)
    pooled, = tdist.spawn(bsp_run, 1, "gloo", "cpu", (
        {**job, "model_config": {**cfg, "loader_workers": 1}},),
        timeout_s=120)
    assert pooled["digests"] == inline["digests"]
    assert pooled["metrics"] == inline["metrics"]
    # the rank is gone (the module's own pool may be alive beside)
    assert not [p.name for p in multiprocessing.active_children()
                if not p.name.startswith("shm-loader-")]


def test_a_dead_worker_raises(pool):
    # a shard that cannot be read kills the worker that takes it (after
    # the read's retries); the pool must say so, not wait forever
    bad = ("files", "/nonexistent/x_0000.npy", "/nonexistent/y_0000.npy")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="died"):
        list(pool.run([(bad, 0)]))
    assert time.perf_counter() - t0 < 10
    assert pool._broken
    with pytest.raises(RuntimeError, match="closed or broken"):
        next(pool.run([]))
    pool.close()
