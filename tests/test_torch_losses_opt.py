"""The port's losses, optimizer, data plane and dropout against the
reference, on the CPU.

- ``softmax_cross_entropy``/``top_k_error`` (ties count against the
  model) and ``fused_lm_xent`` — loss, top-1/top-5 error and the grads
  ``dh, dw, db`` under ``jax.grad`` — on the same numpy inputs, including a
  token count that does not fill the last chunk and ``b=None``;
- ``SGD`` (plain, momentum, Nesterov, weight decay, clipping active and
  inactive): one and three updates of the same tree;
- ``derive_seed``, ``SyntheticSequenceDataset`` and ``PTBData`` batches,
  bit-equal for the dense (V=256) and procedural (V=8192) tables, epochs 0
  and 1;
- ``Dropout`` on its own terms (``jax.random`` bits cannot be repeated):
  keep rate, ``1/keep`` scaling, identical masks for one seed and step,
  different masks across steps.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.models.data.base import (
    SyntheticSequenceDataset as JSeq,
    derive_seed as j_derive_seed,
)
from theanompi_tpu.models.lstm import PTBData as JPTB
from theanompi_tpu.ops import losses as jl
from theanompi_tpu.ops import opt as jopt

from theanompi_torch.models.data.base import (
    SyntheticSequenceDataset,
    derive_seed,
)
from theanompi_torch.models.lstm import PTBData
from theanompi_torch.ops import losses as tl
from theanompi_torch.ops import opt as topt
from theanompi_torch.ops.layers import Dropout
from theanompi_torch.tree import tree_leaves_with_path

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _close(a, r, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(r), rtol=rtol,
                               atol=atol)


# -- losses ---------------------------------------------------------------------

def test_softmax_cross_entropy_and_top_k_error_match_reference():
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 6, 11).astype(np.float32)
    logits[0, 0, :] = 1.0   # a collapsed row: ties score against the model
    labels = rng.randint(0, 11, (4, 6)).astype(np.int32)
    _close(tl.softmax_cross_entropy(_t(logits), _t(labels)),
           jl.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    for k in (1, 5):
        got = tl.top_k_error(_t(logits), _t(labels), k)
        ref = jl.top_k_error(jnp.asarray(logits), jnp.asarray(labels), k)
        assert float(got) == float(ref)
    # bf16 logits: the loss is taken in fp32 of the same values
    lb = torch.from_numpy(logits).bfloat16()
    _close(tl.softmax_cross_entropy(lb, _t(labels)),
           jl.softmax_cross_entropy(jnp.asarray(lb.float().numpy(),
                                                jnp.bfloat16),
                                    jnp.asarray(labels)))


@pytest.mark.parametrize("n_tok,v,chunk", [
    (2 * 50, 64, 48),      # 100 tokens in chunks of 48: the padding mask
    (2 * 32, 96, None),    # the default chunk rule (one chunk)
    (3 * 40, 128, 40),     # chunks that tile exactly
])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_lm_xent_matches_reference(n_tok, v, chunk, bias):
    rng = np.random.RandomState(n_tok + v)
    d = 16
    h = rng.randn(2, n_tok // 2, d).astype(np.float32)
    w = (rng.randn(d, v) * 0.3).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32) if bias else None
    y = rng.randint(0, v, h.shape[:-1]).astype(np.int32)
    y.reshape(-1)[:3] = np.argmax(h.reshape(-1, d)[:3] @ w, -1)  # some hits

    def jloss(h, w, b):
        return jl.fused_lm_xent(h, w, b, jnp.asarray(y), chunk_tokens=chunk)

    jargs = [jnp.asarray(h), jnp.asarray(w),
             None if b is None else jnp.asarray(b)]
    (jlo, je1, je5) = jloss(*jargs)
    argnums = (0, 1, 2) if bias else (0, 1)
    jg = jax.grad(lambda *a: jloss(*a)[0], argnums=argnums)(*jargs)

    th = _t(h).requires_grad_()
    tw = _t(w).requires_grad_()
    tb = None if b is None else _t(b).requires_grad_()
    lo, e1, e5 = tl.fused_lm_xent(th, tw, tb, _t(y), chunk_tokens=chunk)
    assert not e1.requires_grad and not e5.requires_grad
    inputs = [th, tw] + ([tb] if bias else [])
    tg = torch.autograd.grad(lo, inputs)
    _close(lo.detach(), jlo)
    assert float(e1) == float(je1) and float(e5) == float(je5)
    for a, r in zip(tg, jg):
        _close(a, r)
    # the unfused path on the same inputs agrees too
    logits = th.detach() @ tw.detach() + (0 if tb is None else tb.detach())
    _close(tl.softmax_cross_entropy(logits, _t(y)), jlo)


def test_chunk_rule_matches_reference():
    for v in (256, 8192, 32768, 131072):
        for n in (7, 300, 5000):
            h = np.zeros((n, 4), np.float32)
            y = np.zeros((n,), np.int32)
            jh3, _, jm, jn = jl._chunk_and_pad(jnp.asarray(h), jnp.asarray(y),
                                               v, None)
            th3, _, tm, tn = tl._chunk_and_pad(_t(h), _t(y), v, None)
            assert tuple(th3.shape) == tuple(jh3.shape) and tn == jn
            assert (tm.numpy() == np.asarray(jm)).all()


# -- optimizer ------------------------------------------------------------------

def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": {"w": rng.randn(5, 3).astype(np.float32),
                  "b": rng.randn(3).astype(np.float32)},
            "z": rng.randn(4).astype(np.float32)}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _assert_trees(t_tree, j_tree):
    jflat = {"/".join(p): x for p, x in tree_leaves_with_path(
        jax.tree.map(np.asarray, j_tree))}
    for p, x in tree_leaves_with_path(t_tree):
        _close(x.numpy(), jflat["/".join(p)])


@pytest.mark.parametrize("kw", [
    {},
    {"momentum": 0.9},
    {"momentum": 0.9, "nesterov": True},
    {"momentum": 0.5, "weight_decay": 1e-2},
    {"momentum": 0.9, "grad_clip": 0.5},     # clip active
    {"momentum": 0.9, "grad_clip": 100.0},   # clip inactive
    {"nesterov": True, "momentum": 0.9, "weight_decay": 1e-3,
     "grad_clip": 1.0},
])
def test_sgd_one_and_three_updates_match_reference(kw):
    params = _tree(0)
    jo, to = jopt.SGD(**kw), topt.SGD(**kw)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _tree(step + 1)
        lr = 0.1 / (step + 1)
        jp, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp,
                           jnp.float32(lr))
        with torch.no_grad():
            tp, ts = to.update(_to_torch(grads), ts, tp, lr)
        _assert_trees(tp, jp)
        if "velocity" in js:
            _assert_trees(ts["velocity"], js["velocity"])
        else:
            assert ts == {}


def test_clip_and_global_norm_match_reference():
    g = _tree(4)
    _close(topt.global_sq_norm(_to_torch(g)),
           jopt.global_sq_norm(jax.tree.map(jnp.asarray, g)))
    for max_norm in (0.1, 1e3):
        _assert_trees(topt.clip_by_global_norm(_to_torch(g), max_norm),
                      jopt.clip_by_global_norm(
                          jax.tree.map(jnp.asarray, g), max_norm))


# -- data -----------------------------------------------------------------------

def test_derive_seed_is_the_references():
    for parts in (("shuffle", 0, 0), ("dropout", 3, 17), ("x", 1, 2, 3)):
        assert derive_seed(*parts) == j_derive_seed(*parts)


@pytest.mark.parametrize("vocab", [256, 8192])
def test_synthetic_and_ptb_batches_bit_equal(vocab):
    kw = dict(n_train=24, n_val=8, seq_len=12, vocab=vocab)
    mine, ref = SyntheticSequenceDataset(**kw), JSeq(**kw)
    np.testing.assert_array_equal(mine._train, ref._train)
    np.testing.assert_array_equal(mine._val, ref._val)
    cfg = {"seq_len": 12, "vocab": vocab, "n_train": 24, "n_val": 8}
    pm, pr = PTBData(cfg), JPTB(cfg)
    assert pm.synthetic and pm.vocab == pr.vocab == vocab
    for data_m, data_r in ((mine, ref), (pm, pr)):
        for epoch in (0, 1):
            bm = list(data_m.train_batches(4, epoch, seed=5))
            br = list(data_r.train_batches(4, epoch, seed=5))
            assert len(bm) == len(br) == 6
            for a, r in zip(bm, br):
                for k in ("x", "y"):
                    assert a[k].dtype == r[k].dtype
                    np.testing.assert_array_equal(a[k], r[k])
            tail = list(data_m.train_batches(4, epoch, seed=5,
                                             start_batch=4))
            np.testing.assert_array_equal(tail[0]["x"], bm[4]["x"])
        for a, r in zip(data_m.val_batches(4), data_r.val_batches(4)):
            np.testing.assert_array_equal(a["y"], r["y"])
    e0 = next(pm.train_batches(4, 0, seed=5))["x"]
    e1 = next(pm.train_batches(4, 1, seed=5))["x"]
    assert not np.array_equal(e0, e1)


def test_ptb_reads_real_files(tmp_path):
    words = "the cat sat on the mat and the dog sat too".split()
    (tmp_path / "ptb.train.txt").write_text(" ".join(words * 6))
    (tmp_path / "ptb.valid.txt").write_text(" ".join(words * 2))
    cfg = {"seq_len": 5, "data_path": str(tmp_path)}
    pm, pr = PTBData(cfg), JPTB(cfg)
    assert not pm.synthetic and pm.vocab == pr.vocab
    np.testing.assert_array_equal(pm._train_seqs, pr._train_seqs)
    np.testing.assert_array_equal(pm._val_seqs, pr._val_seqs)


# -- dropout --------------------------------------------------------------------

def _gen(*key):
    return torch.Generator().manual_seed(derive_seed("dropout", *key))


def test_dropout_keep_rate_scaling_and_masks():
    x = torch.ones(64, 256)
    drop = Dropout(0.25)
    assert drop(None, x, train=False) is x
    assert Dropout(0.0)(None, x, train=True, gen=_gen(0, 0)) is x
    with pytest.raises(ValueError, match="generator"):
        drop(None, x, train=True)
    y = drop(None, x, train=True, gen=_gen(0, 3))
    kept = y != 0
    # 16384 draws at keep 0.75: 4 sigma is ~0.014
    assert abs(float(kept.float().mean()) - 0.75) < 0.014
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.75, rtol=1e-7)
    again = drop(None, x, train=True, gen=_gen(0, 3))
    assert torch.equal(y, again)                    # same seed and step
    other = drop(None, x, train=True, gen=_gen(0, 4))
    assert not torch.equal(y != 0, other != 0)      # the next step
    # bf16 keeps its dtype; the scaling happens in it
    yb = drop(None, x.bfloat16(), train=True, gen=_gen(0, 3))
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, kept)
