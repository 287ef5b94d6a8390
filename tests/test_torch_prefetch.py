"""The port's prefetcher (``theanompi_torch.models.data.prefetch``) against
the reference's ``Prefetcher(mesh=None)``, on the CPU.

- items and their order, a source's error raised at the consumer,
  ``state()``'s ``consumed`` cursor, ``stall_timeout``, ``close()`` (queue
  dropped, thread joined, source generator closed) and ``depth=0``'s
  pass-through, each beside the reference;
- with ``device="cpu"`` the batches arrive as tensors of the step's dtypes
  (uint8 stays, other integers int64, floats keep theirs);
- the tiny Wide-ResNet and the tiny ``TransformerLM`` trained through
  ``BSP`` at ``prefetch=2`` and at ``prefetch=0`` end with bit-equal
  params, losses and validation;
- mirrors of ``tests/test_data.py``'s prefetcher tests and
  ``tests/test_recorder_prefetch.py``'s wait tests.

Every prefetcher a test starts is closed in a fixture's finalizer, which
then asserts that no ``data-prefetch`` thread and no child process is
left; every queue read has a timeout.
"""

import multiprocessing
import threading
import time

import numpy as np
import pytest
import torch

from theanompi_tpu.models.data.prefetch import Prefetcher as RefPrefetcher
from theanompi_tpu.models.data.prefetch import (
    PrefetchStallError as RefStallError,
)
from theanompi_tpu.models.data.prefetch import prefetch as ref_prefetch

from theanompi_torch import BSP
from theanompi_torch.models.data.prefetch import (
    Prefetcher,
    PrefetchStallError,
    prefetch,
)
from theanompi_torch.tree import tree_leaves_with_path

WRN = {"depth": 10, "widen": 1, "batch_size": 8, "image_size": 16,
       "n_train": 24, "n_val": 8, "n_epochs": 2, "precision": "fp32",
       "verbose": False}
LM = {"n_layers": 2, "dim": 32, "heads": 2, "seq_len": 32, "vocab": 64,
      "batch_size": 4, "n_train": 12, "n_val": 4, "n_epochs": 2,
      "dropout": 0.1, "precision": "fp32", "verbose": False}
#: every dequeue's bound (seconds): a hung source fails the test
T = 30
#: ``tests/test_recorder_prefetch.py``'s model
STARVE = {"depth": 10, "widen": 1, "batch_size": 8, "n_epochs": 1,
          "lr": 0.05, "n_train": 64, "n_val": 16, "augment": False,
          "precision": "fp32", "verbose": False}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _assert_torn_down():
    assert multiprocessing.active_children() == []
    alive = [t.name for t in threading.enumerate()
             if t.name == "data-prefetch" and t.is_alive()]
    assert alive == [], alive


@pytest.fixture
def opened():
    """Prefetchers (the port's and the reference's) a test opens: closed
    at teardown, then nothing may be left running."""
    made = []
    yield made
    for p in made:
        close = getattr(p, "close", None)
        if close is not None:
            close()
    _assert_torn_down()


@pytest.fixture
def torn_down():
    """For tests whose trainer opens and closes its own prefetchers."""
    yield
    _assert_torn_down()


def _items(n=20):
    return [{"x": np.full((2, 2), i), "y": np.arange(2, dtype=np.int32) + i}
            for i in range(n)]


def _drain(it, limit=1000):
    out = []
    for _ in range(limit):
        try:
            out.append(next(it))
        except StopIteration:
            return out
    raise AssertionError("the iterator did not end")


def test_items_and_order_as_the_reference(opened):
    mine = Prefetcher(iter(_items()), depth=3, stall_timeout=T)
    ref = RefPrefetcher(iter(_items()), depth=3, stall_timeout=T)
    opened += [mine, ref]
    a, b = _drain(mine), _drain(ref)
    assert len(a) == len(b) == 20
    for i, (x, y) in enumerate(zip(a, b)):
        assert x["x"][0, 0] == y["x"][0, 0] == i
        np.testing.assert_array_equal(x["y"], y["y"])


def test_source_errors_reach_the_consumer(opened):
    def gen():
        yield {"x": np.zeros(2)}
        raise RuntimeError("boom")

    for cls in (Prefetcher, RefPrefetcher):
        p = cls(gen(), depth=2, stall_timeout=T)
        opened.append(p)
        next(p)
        with pytest.raises(RuntimeError, match="boom"):
            next(p)


def test_state_counts_what_the_consumer_took(opened):
    mine = Prefetcher(iter(_items(6)), depth=4, start_batch=10,
                      stall_timeout=T)
    ref = RefPrefetcher(iter(_items(6)), depth=4, start_batch=10,
                        stall_timeout=T)
    opened += [mine, ref]
    assert mine.state() == ref.state() == {"consumed": 10}
    for _ in range(3):
        next(mine)
        next(ref)
    time.sleep(0.05)  # let the threads run ahead: queued is not consumed
    assert mine.state() == ref.state() == {"consumed": 13}
    _drain(mine), _drain(ref)
    assert mine.state() == ref.state() == {"consumed": 16}


def test_stall_timeout_raises(opened):
    release = threading.Event()

    def hung():
        yield {"x": np.zeros(1)}
        release.wait(10)  # a source that produces nothing more

    for cls, err in ((Prefetcher, PrefetchStallError),
                     (RefPrefetcher, RefStallError)):
        p = cls(hung(), depth=2, stall_timeout=0.3)
        next(p)
        t0 = time.perf_counter()
        with pytest.raises(err, match="stalled"):
            next(p)
        assert 0.25 < time.perf_counter() - t0 < 5
        release.set()  # free the thread, then close
        p.close()
        release.clear()
    with pytest.raises(ValueError, match="positive"):
        Prefetcher(iter([]), stall_timeout=0)
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter([]), depth=0)


def test_close_drops_the_queue_and_closes_the_source(opened):
    closed = []

    def gen():
        try:
            for i in range(100):
                yield {"x": np.full(1, i)}
        finally:
            closed.append(True)

    for cls in (Prefetcher, RefPrefetcher):
        p = cls(gen(), depth=2, stall_timeout=T)
        next(p)
        p.close()
        assert closed.pop() is True
        assert not p._thread.is_alive()
        if cls is Prefetcher:  # the port drops a put that raced close too
            assert p._q.empty()


def test_depth_zero_passes_through():
    it = iter([1, 2, 3])
    assert prefetch(it, depth=0) is it
    assert ref_prefetch(it, depth=0) is it


def test_cpu_device_gives_tensors_of_the_steps_dtypes(opened):
    batch = {"x": np.zeros((2, 4, 4, 3), np.uint8),
             "y": np.arange(2, dtype=np.int32),
             "f": np.ones((2, 3), np.float32)}
    p = prefetch(iter([batch]), device="cpu", depth=2, stall_timeout=T)
    opened.append(p)
    out = next(p)
    assert (out["x"].dtype, out["y"].dtype, out["f"].dtype) == (
        torch.uint8, torch.int64, torch.float32)
    assert all(t.device.type == "cpu" for t in out.values())
    np.testing.assert_array_equal(out["y"].numpy(), batch["y"])
    with pytest.raises(StopIteration):
        next(p)


def _train(modelfile, modelclass, cfg, depth):
    rule = BSP({"prefetch": depth, "seed": 5, "verbose": False,
                "print_freq": 100, "prefetch_stall_timeout": T}).init(
        devices=1, modelfile=modelfile, modelclass=modelclass,
        model_config=dict(cfg), device="cpu")
    rec = rule.wait()
    return rule.trainer, rec


@pytest.mark.parametrize("model", ["wide_resnet", "transformer_lm"])
def test_prefetch_2_and_0_train_bit_equal(model, torn_down):
    modelfile, modelclass, cfg = {
        "wide_resnet": ("theanompi_torch.models.wide_resnet", "WideResNet",
                        WRN),
        "transformer_lm": ("theanompi_torch.models.transformer_lm",
                           "TransformerLM", LM)}[model]
    (a, ra), (b, rb) = (_train(modelfile, modelclass, cfg, d)
                        for d in (2, 0))
    assert a.prefetch_depth == 2 and b.prefetch_depth == 0
    assert a.iteration == b.iteration == 2 * 3
    assert ra.train_history["cost"] == rb.train_history["cost"]
    assert ra.val_history == rb.val_history
    for (p, x), (q, y) in zip(tree_leaves_with_path(a.params),
                              tree_leaves_with_path(b.params)):
        assert p == q and torch.equal(x, y), p
    for (p, x), (_, y) in zip(tree_leaves_with_path(a.state),
                              tree_leaves_with_path(b.state)):
        assert torch.equal(x, y), p


def _run_with_loader_delay(delay):
    """``tests/test_recorder_prefetch.py``'s run: a throttled loader."""
    from theanompi_torch.models.wide_resnet import WideResNet

    rule = BSP({"prefetch": 1, "verbose": False,
                "prefetch_stall_timeout": T}).init(
        devices=1, modelfile="theanompi_torch.models.wide_resnet",
        modelclass="WideResNet", model_config=dict(STARVE), device="cpu")
    model = rule.trainer.model
    assert isinstance(model, WideResNet)
    orig = model.data.train_batches

    def slow_batches(*args, **kwargs):
        for b in orig(*args, **kwargs):
            if delay:
                time.sleep(delay)
            yield b

    model.data.train_batches = slow_batches
    return rule.wait()


def test_starved_pipeline_reports_wait(torn_down):
    rec = _run_with_loader_delay(0.15)
    waits = rec.time_history["wait"]
    assert len(waits) == STARVE["n_train"] // STARVE["batch_size"]
    assert sum(waits) > 0.3, f"starved pipeline hid its stall: {waits}"


def test_fed_pipeline_wait_is_small(torn_down):
    rec = _run_with_loader_delay(0.0)
    wait, calc = sum(rec.time_history["wait"]), sum(rec.time_history["calc"])
    assert wait < max(0.25 * calc, 0.2), (wait, calc)
