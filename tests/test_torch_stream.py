"""The port's token stream (``theanompi_torch.models.data.stream``) against
the reference's ``StreamTokenDataset``, on the CPU.

- batches bit-equal to the reference's, synthetic sources (two epochs:
  the cursors carry over) and sources on disk; validation batches too;
- a synthetic window equals the reference's window (the port draws a
  window's doubles in one call, the reference one a token);
- two ranks' ``rows`` are the rows of the whole batch, and every rank
  ends the epoch at the same cursors;
- ``state``/``set_state``: a mid-epoch resume equals the uninterrupted
  tail; ``set_mixture_weights`` acts at the next epoch, as the
  reference's;
- ``loader_workers`` warm-loads file sources through the pool's token
  mode, with the same batches;
- the tiny ``TransformerLM`` on ``dataset="stream"`` (and on
  ``stream_dir``): the same batches as the reference's model, and the
  loss and every grad leaf against the reference at rtol 1e-5 /
  atol 1e-6.
"""

import multiprocessing
import threading

import numpy as np
import pytest
import torch

import jax

from theanompi_tpu.models.data import stream as RS
from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM

from theanompi_torch.convert import params_from_jax
from theanompi_torch.models.data import stream as S
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.parallel.trainer import loss_and_grads
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils.helper_funcs import to_device

RTOL, ATOL = 1e-5, 1e-6
SYN = {"seq_len": 16, "vocab": 97, "n_train": 24, "n_val": 8,
       "stream_sources": [
           {"name": "a", "weight": 3.0, "tokens": 400, "vocab": 97,
            "seed": 4},
           {"name": "b", "weight": 1.0, "tokens": 2000, "vocab": 97,
            "seed": 9},
           {"name": "c", "weight": 2.0, "tokens": 170, "vocab": 97,
            "seed": 1}]}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def file_sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokens")
    r = np.random.RandomState(2)
    for name, sizes in (("web", (100, 37, 250)), ("code", (60, 90))):
        (root / name).mkdir()
        for i, n in enumerate(sizes):
            np.save(root / name / f"s{i:03d}.npy",
                    r.randint(0, 50, n).astype(np.int64))
    return root


def _file_cfg(root):
    return {"seq_len": 8, "vocab": 50, "n_train": 12, "n_val": 4,
            "stream_sources": [
                {"name": "web", "weight": 2.0, "path": str(root / "web")},
                {"name": "code", "weight": 1.0, "path": str(root / "code")}]}


def _same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x["x"].dtype == y["x"].dtype == np.int32
        np.testing.assert_array_equal(x["x"], y["x"])
        np.testing.assert_array_equal(x["y"], y["y"])


def test_synthetic_batches_bit_equal_over_two_epochs():
    mine, ref = S.StreamTokenDataset(dict(SYN)), RS.StreamTokenDataset(
        dict(SYN))
    assert (mine.vocab, mine.n_train, mine.sample_shape) == (
        ref.vocab, ref.n_train, ref.sample_shape)
    for epoch in (0, 1):
        _same(list(mine.train_batches(4, epoch, seed=7)),
              list(ref.train_batches(4, epoch, seed=7)))
        assert mine.state() == ref.state()
    assert mine.state()["base_epoch"] == 2
    _same(list(mine.val_batches(4)), list(ref.val_batches(4)))


def test_default_sources_bit_equal():
    cfg = {"seq_len": 12, "vocab": 40000, "n_train": 16, "n_val": 4}
    mine, ref = S.StreamTokenDataset(dict(cfg)), RS.StreamTokenDataset(
        dict(cfg))
    _same(list(mine.train_batches(8, 0)), list(ref.train_batches(8, 0)))


@pytest.mark.parametrize("w", [0, 5, 23, 1000])
def test_synthetic_window_equals_the_references(w):
    mine = S._SyntheticTokenSource("s", 50000, 32768, 3, 2047)
    ref = RS._SyntheticTokenSource("s", 50000, 32768, 3, 2047)
    got = mine.window(w)
    assert got.dtype == np.int32 and got.shape == (2048,)
    np.testing.assert_array_equal(got, ref.window(w))


def test_file_sources_bit_equal(file_sources):
    cfg = _file_cfg(file_sources)
    mine, ref = S.StreamTokenDataset(dict(cfg)), RS.StreamTokenDataset(
        dict(cfg))
    for epoch in (0, 1):
        _same(list(mine.train_batches(3, epoch, seed=1)),
              list(ref.train_batches(3, epoch, seed=1)))
    assert mine.state() == ref.state()
    _same(list(mine.val_batches(2)), list(ref.val_batches(2)))


def test_two_ranks_rows_and_cursors():
    whole = S.StreamTokenDataset(dict(SYN))
    want = list(whole.train_batches(6, 0, seed=3))
    for lo, hi in ((0, 3), (3, 6)):
        rank = S.StreamTokenDataset(dict(SYN))
        got = list(rank.train_batches(6, 0, seed=3, rows=(lo, hi)))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["x"], b["x"][lo:hi])
            np.testing.assert_array_equal(a["y"], b["y"][lo:hi])
        # every rank advanced over the whole global batch
        assert rank.state() == whole.state()
        v = list(rank.val_batches(6, rows=(lo, hi)))
        for a, b in zip(v, whole.val_batches(6)):
            np.testing.assert_array_equal(a["x"], b["x"][lo:hi])


def test_mid_epoch_resume_equals_the_uninterrupted_tail():
    full = S.StreamTokenDataset(dict(SYN))
    list(full.train_batches(4, 0, seed=2))  # epoch 0: cursors move
    saved = full.state()
    tail = list(full.train_batches(4, 1, seed=2))
    resumed = S.StreamTokenDataset(dict(SYN))
    resumed.set_state(saved)
    _same(list(resumed.train_batches(4, 1, seed=2, start_batch=3)),
          tail[3:])
    assert resumed.state() == full.state()
    ref = RS.StreamTokenDataset(dict(SYN))
    ref.set_state(saved)
    _same(list(ref.train_batches(4, 1, seed=2, start_batch=3)), tail[3:])
    # a generator abandoned mid-epoch (a prefetcher ahead) moves nothing
    again = S.StreamTokenDataset(dict(SYN))
    again.set_state(saved)
    gen = again.train_batches(4, 1, seed=2)
    next(gen), next(gen)
    gen.close()
    assert again.state() == saved


def test_mixture_weights_act_at_the_next_epoch():
    mine, ref = S.StreamTokenDataset(dict(SYN)), RS.StreamTokenDataset(
        dict(SYN))
    for d in (mine, ref):
        gen = d.train_batches(4, 0)
        first = next(gen)
        d.set_mixture_weights({"a": 1.0, "b": 1.0, "c": 6.0})
        d._rest = [first] + list(gen)
    _same(mine._rest, ref._rest)
    _same(list(mine.train_batches(4, 1)), list(ref.train_batches(4, 1)))
    assert mine.state() == ref.state()
    with pytest.raises(ValueError, match="positive"):
        mine.set_mixture_weights({"a": 1.0, "b": 0.0, "c": 1.0})
    with pytest.raises(ValueError, match="missing"):
        mine.set_state({"weights": {"a": 1.0}})


@pytest.fixture
def opened():
    """Datasets a test opens a pool for: cleaned up at teardown, then no
    worker process and no ``data-prefetch`` thread may be left."""
    made = []
    yield made
    for d in made:
        d.cleanup()
    assert multiprocessing.active_children() == []
    assert not [t for t in threading.enumerate()
                if t.name == "data-prefetch" and t.is_alive()]


def test_warm_load_through_the_pool(file_sources, opened):
    cfg = _file_cfg(file_sources)
    pooled = S.StreamTokenDataset({**cfg, "loader_workers": 2})
    opened.append(pooled)
    plain = S.StreamTokenDataset(dict(cfg))
    got = list(pooled.train_batches(3, 0, seed=4))
    assert sum(len(s._cache) for s in pooled._sources) == 5  # every shard
    _same(got, list(plain.train_batches(3, 0, seed=4)))


@pytest.mark.parametrize("how", ["stream", "stream_dir"])
def test_transformer_on_the_stream_against_the_reference(how,
                                                         file_sources):
    cfg = {"n_layers": 2, "dim": 32, "heads": 2, "seq_len": 16,
           "vocab": 97, "batch_size": 4, "dropout": 0.0,
           "precision": "fp32", "attn_impl": "blockwise", "n_train": 16,
           "n_val": 4}
    if how == "stream":
        cfg.update(dataset="stream",
                   stream_sources=SYN["stream_sources"])
    else:
        cfg.update(stream_dir=str(file_sources), vocab=50, seq_len=8)
    jm = JaxLM(dict(cfg))
    jp, _ = jm.init_params(jax.random.PRNGKey(2))
    tm = TransformerLM(dict(cfg))
    assert type(tm.data).__name__ == "StreamTokenDataset"
    assert tm.vocab == jm.data.vocab
    assert tm.data._names == jm.data._names
    mine = list(tm.data.train_batches(4, 0, seed=1))
    ref = list(jm.data.train_batches(4, 0, seed=1))
    _same(mine, ref)
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    batch = {k: jax.numpy.asarray(v) for k, v in ref[1].items()}

    def lossw(p):
        return jm.loss_fn(p, {}, batch, None, train=True)

    (loss, _), g = jax.jit(jax.value_and_grad(lossw, has_aux=True))(jp)
    _, metrics, grads = loss_and_grads(tm, tp, {},
                                       to_device(mine[1], "cpu"), None)
    np.testing.assert_allclose(float(metrics["cost"]), float(loss),
                               rtol=RTOL, atol=ATOL)
    ref_g = {"/".join(p): np.asarray(x) for p, x in tree_leaves_with_path(
        jax.tree.map(np.asarray, g))}
    got_g = {"/".join(p): x.numpy() for p, x in tree_leaves_with_path(
        grads)}
    assert got_g.keys() == ref_g.keys()
    for k, x in got_g.items():
        np.testing.assert_allclose(x, ref_g[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
