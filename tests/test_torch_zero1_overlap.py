"""The port's ``zero1``, overlapped exchange and exchange ramp against the
reference, on the CPU: 4 gloo ranks against the 4-device ``mesh4``.

One spawn of 4 ranks for the whole file (module-scoped), each running
``theanompi_torch.parallel.rank_jobs`` on inputs this module writes as
files; the reference runs here, through its session fixtures
``exchange_run`` and ``mesh4``.

- (a) ``zero1`` on the tiny WRN (the reference's ``EXCHANGE_TINY``, no
  sync-BN, lr 0.05), two steps from the reference's init and batches:
  the params against the reference's ``exchange_run(mesh4, "zero1")`` and
  against the port's own ``psum_bucket`` run at rtol/atol 1e-5
  (``tests/test_exchanger.py:275-281``); each rank's momentum slices,
  joined by ``convert.zero1_opt_state_to_jax``, against the reference's
  ``opt_state["velocity"]`` at 1e-5; each rank storing ``padded // 4`` of
  every bucket; every rank's params bit-identical.
- (b) overlap bit-equal to the fused exchange, port against port, on the
  tiny WRN in 0.05 MiB buckets (several a step): ``psum_bucket`` and
  ``zero1``, each also with sync-BN (``bn_axis="data"``, whose backward
  all-reduces interleave with the hook-issued buckets), and ``n_subb=2``
  under ``psum_bucket``; every bucket's collective issued from backward;
  and at the exchange level ``psum_bucket`` and ``ring_int8``
  (``tests/test_overlap.py:99-129``).
- (c) Adam and RMSProp, with ``grad_clip`` and ``weight_decay``: under
  ``zero1`` at 4 ranks against the reference's ``Exchanger("zero1")
  .exchange_and_update`` under ``shard_map`` on ``mesh4`` (same per-rank
  grads, two steps) at 1e-5; their plain ``update`` against the
  reference's in one process at 1e-6.
- (d) ``zero1``'s ``wire_bytes`` equal to the reference's at n = 1, 2 and
  4 (``tests/test_exchanger.py:229-237``); overlap changes no accounting
  (``tests/test_overlap.py:150``).
- (e) ``RampSchedule``: the reference's parse and lookup cases and its
  eight rejections (``tests/test_overlap.py:164-190``); a world-1 run of
  the tiny WRN over 3 epochs under ``exch_ramp="ring_int8:1,psum_bucket:2"``
  whose strategy changes only at epoch boundaries, one step closure a
  phase (:220-269); ``BSPTrainer`` refusing a ``zero1`` base (:322-333).
- ``launcher --devices 2 --device cpu`` trains under ``zero1`` with
  overlap, and under a ramp with overlap.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM
from theanompi_tpu.models.wide_resnet import WideResNet as JaxWRN
from theanompi_tpu.ops import opt as ref_opt
from theanompi_tpu.parallel import exchanger as ref_ex
from theanompi_tpu.parallel import overlap as ref_overlap
from theanompi_tpu.parallel.mesh import DATA_AXIS, shard_map

from theanompi_torch import dist as tdist
from theanompi_torch.convert import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
    zero1_opt_state_from_jax,
    zero1_opt_state_to_jax,
)
from theanompi_torch.models.wide_resnet import WideResNet
from theanompi_torch.ops import opt as port_opt
from theanompi_torch.parallel import exchanger as ex
from theanompi_torch.parallel.bsp import BSPTrainer
from theanompi_torch.parallel.overlap import RampSchedule
from theanompi_torch.parallel.rank_jobs import run_all
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils.recorder import Recorder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
LR = 0.05
#: the reference's ``EXCHANGE_TINY`` (``tests/conftest.py:184``)
EXCHANGE_TINY = {"depth": 10, "widen": 1, "batch_size": 2, "image_size": 8,
                 "n_train": 32, "n_val": 16, "n_epochs": 1,
                 "precision": "fp32", "augment": False, "verbose": False}
#: several buckets a step, so an overlapped run has an order to keep
CHAIN_MB = 0.05
#: (b): name -> (strategy, model config beyond EXCHANGE_TINY)
OVERLAP = {"psum_bucket": ("psum_bucket", {"bn_axis": None}),
           "zero1": ("zero1", {"bn_axis": None}),
           "psum_bucket-syncbn": ("psum_bucket", {"bn_axis": "data"}),
           "zero1-syncbn": ("zero1", {"bn_axis": "data"}),
           "psum_bucket-nsubb2": ("psum_bucket", {"bn_axis": None,
                                                  "n_subb": 2})}
#: (c): the adaptive rules as the GAN models configure them, with clipping
#: that binds (the grads' norm is ~9) and weight decay
RULES = {"Adam": {"b1": 0.5, "grad_clip": 0.5, "weight_decay": 1e-2},
         "RMSProp": {"decay": 0.9, "grad_clip": 0.5, "weight_decay": 1e-2}}
UPDATE_SHAPES = {"a": (13,), "b": (3, 5), "z/k": (7, 3, 2)}
UPDATE_LR = 0.01
#: exchange-level overlap: three leaves of 192 bytes against 256-byte
#: buckets, one bucket each (``tests/test_overlap.py:92``)
CHAIN_SHAPES = {"a": (48,), "b": (48,), "c": (48,)}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(x)
            for p, x in tree_leaves_with_path(tree)}


def _nest(flat):
    tree = {}
    for key, x in flat.items():
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def _wrn_job(d, name, strategy, cfg, mb=4.0, overlap=False, init="ref"):
    return {"modelfile": "theanompi_torch.models.wide_resnet",
            "modelclass": "WideResNet",
            "model_config": {**EXCHANGE_TINY, "lr": LR, **cfg},
            "rule_config": {"exch_strategy": strategy, "exch_bucket_mb": mb,
                            "exch_overlap": overlap, "verbose": False},
            "steps": 2, "init": str(d / f"{init}.pt"),
            "batches": str(d / f"{init}.npz"), "out": str(d / name),
            "save": ["params", "opt_state"]}


def _update_inputs():
    rng = np.random.RandomState(5)
    vals = {}
    for k, s in UPDATE_SHAPES.items():
        vals[f"g/{k}"] = rng.randn(N, *s).astype(np.float32)
        vals[f"p/{k}"] = rng.randn(*s).astype(np.float32)
    return vals


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4, exchange_run):
    """The reference's ``zero1`` run and the port's 4 ranks, one spawn:
    (a)'s two runs, (b)'s fused and overlapped pairs, (c)'s update cases
    and the exchange-level cases."""
    d = tmp_path_factory.mktemp("zero1")
    jt, jparams = exchange_run(mesh4, "zero1")
    init_p, init_s = JaxWRN(dict(EXCHANGE_TINY)).init_params(
        jax.random.PRNGKey(1))
    batches = list(jt.model.data.train_batches(jt.global_batch, 0,
                                               seed=0))[:2]
    torch.save({"params": params_from_jax(_np(init_p)),
                "state": state_from_jax(_np(init_s))}, d / "ref.pt")
    np.savez(d / "ref.npz", **{k: np.stack([b[k] for b in batches])
                               for k in batches[0]})
    calls = [("bsp_run", (_wrn_job(d, "zero1", "zero1", {"bn_axis": None}),)),
             ("bsp_run", (_wrn_job(d, "psum_bucket", "psum_bucket",
                                   {"bn_axis": None}),))]
    for name, (strategy, cfg) in OVERLAP.items():
        for overlap in (False, True):
            calls.append(("bsp_run", (_wrn_job(
                d, f"{name}-{overlap}", strategy, cfg, mb=CHAIN_MB,
                overlap=overlap),)))
    np.savez(d / "update.npz", **_update_inputs())
    cases = [(rule, rule, kw, 128, UPDATE_LR, 2) for rule, kw in RULES.items()]
    calls.append(("zero1_update_cases", (str(d / "update.npz"), str(d),
                                         cases)))
    rng = np.random.RandomState(0)
    np.savez(d / "chain.npz", **{k: rng.randn(N, *s).astype(np.float32)
                                 for k, s in CHAIN_SHAPES.items()})
    chain = [(f"{s}-{o}", s, 256, 3, o) for s in ("psum_bucket", "ring_int8")
             for o in (False, True)]
    calls.append(("exchange_cases", (str(d / "chain.npz"), str(d), chain)))
    calls.append(("loaded_modules", (("jax", "jaxlib", "theanompi_tpu"),)))
    port = tdist.spawn(run_all, N, "gloo", "cpu", (calls,), timeout_s=600)
    return {"d": d, "port": port, "jt": jt, "jparams": jparams,
            "calls": calls}


def _result(runs, name):
    """Every rank's result of the ``bsp_run`` job writing ``name``."""
    i = next(i for i, (job, args) in enumerate(runs["calls"])
             if job == "bsp_run" and args[0]["out"].endswith(f"/{name}"))
    return [runs["port"][r][i] for r in range(N)]


def _saved(runs, name, r=0):
    return torch.load(runs["d"] / f"{name}-r{r}.pt")


def _assert_close(port_tree, ref_tree, what, tol):
    mine, want = _flat(port_tree), _flat(ref_tree)
    assert mine.keys() == want.keys(), what
    for k, x in mine.items():
        np.testing.assert_allclose(x, want[k], rtol=tol, atol=tol,
                                   err_msg=f"{what} {k}")


def test_zero1_matches_the_reference_and_psum_bucket(runs):
    """(a): the params after two steps within 1e-5 of the reference's
    ``zero1`` and of the port's ``psum_bucket``, bit-identical on every
    rank, with the ranks importing no JAX."""
    mine = params_to_jax(_saved(runs, "zero1")["params"])
    _assert_close(mine, runs["jparams"], "zero1 vs the reference", 1e-5)
    _assert_close(mine, params_to_jax(_saved(runs, "psum_bucket")["params"]),
                  "zero1 vs psum_bucket", 1e-5)
    res = _result(runs, "zero1")
    assert res[0]["collectives"]["reduce_scatter_tensor"] >= 1
    assert res[0]["collectives"]["all_gather_into_tensor"] >= 1
    assert "all_reduce" not in res[0]["collectives"]  # no grad_clip here
    assert all(r["digests"] == res[0]["digests"] for r in res)
    for r in range(1, N):
        other = _saved(runs, "zero1", r)["params"]
        for (p, a), (_, b) in zip(
                tree_leaves_with_path(_saved(runs, "zero1")["params"]),
                tree_leaves_with_path(other)):
            assert torch.equal(a, b), (r, p)
    assert [res[-1] for res in runs["port"]] == [[]] * N


def test_zero1_momentum_slices_match_the_reference(runs):
    """(a): rank r holds chunk r of each bucket's momentum, ``padded //
    4`` elements, a quarter of ``psum_bucket``'s optimizer state; joined,
    the slices are the reference's ``velocity`` within 1e-5."""
    states = [_saved(runs, "zero1", r)["opt_state"] for r in range(N)]
    want = runs["jt"].opt_state["velocity"]
    layout = ex.Exchanger("zero1").zero1_layout(
        _saved(runs, "psum_bucket")["params"], N)
    assert isinstance(want, list) and len(want) == len(layout) >= 1
    for r, st in enumerate(states):
        assert list(st) == ["velocity"]
        assert [v.shape for v in st["velocity"]] == [
            (b.padded // N,) for b in layout]
        cut = zero1_opt_state_from_jax({"velocity": _np(want)}, layout, r,
                                       N)
        for a, b in zip(st["velocity"], cut["velocity"]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)
    joined = zero1_opt_state_to_jax(states, layout)["velocity"]
    for a, b in zip(joined, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    z, ps = _result(runs, "zero1")[0], _result(runs, "psum_bucket")[0]
    padded = sum(b.padded * 4 for b in layout)
    assert z["opt_state_bytes"] == padded // N
    assert ps["opt_state_bytes"] * 1.0 == pytest.approx(
        N * z["opt_state_bytes"], rel=1e-3)


@pytest.mark.parametrize("name", list(OVERLAP))
def test_overlap_is_bit_equal_to_fused(runs, name):
    """(b): the same buckets through the same collectives: every step's
    metrics, the params' bits after each step and at the end equal with
    and without overlap, on every rank; each bucket of the overlapped
    run issued from backward, none of the fused run's."""
    fused, over = _result(runs, f"{name}-False"), _result(runs, f"{name}-True")
    for a, b in zip(fused, over):
        assert a["metrics"] == b["metrics"]
        assert a["digests"] == b["digests"] == fused[0]["digests"]
        assert a["collectives"] == b["collectives"]
    c, n_buckets = over[0]["collectives"], over[0]["buckets_from_backward"]
    if name.startswith("zero1"):
        # a scatter and a gather a bucket; clipping's norm, one all-reduce
        assert (c["reduce_scatter_tensor"] == c["all_gather_into_tensor"]
                == n_buckets), c
        assert c.get("all_reduce", 0) == (1 if over[0]["grad_clip"] else 0)
    else:
        assert c == {"all_reduce": n_buckets}
    assert n_buckets >= 2, c
    assert fused[0]["buckets_from_backward"] == 0
    a = _saved(runs, f"{name}-False")["params"]
    b = _saved(runs, f"{name}-True")["params"]
    for (p, x), (_, y) in zip(tree_leaves_with_path(a),
                              tree_leaves_with_path(b)):
        assert torch.equal(x, y), p


@pytest.mark.parametrize("strategy", ["psum_bucket", "ring_int8"])
def test_overlap_exchange_matches_fused(runs, strategy):
    """(b) at the exchange level: buckets issued in reverse layout order
    as their leaves come in give the fused exchange's bits (``ring_int8``
    seeds bucket b from b, not from the issue order), the ranks' mean
    within the strategy's wire tolerance."""
    d = runs["d"]
    vals = dict(np.load(d / "chain.npz"))
    tol = 5e-2 if "int8" in strategy else 1e-6
    for r in range(N):
        fused = np.load(d / f"{strategy}-False-r{r}.npz")
        over = np.load(d / f"{strategy}-True-r{r}.npz")
        for k, v in vals.items():
            np.testing.assert_array_equal(over[k], fused[k])
            np.testing.assert_allclose(over[k], v.mean(0), rtol=tol,
                                       atol=tol)


def _ref_zero1_update(mesh, rule, kwargs, vals):
    """The reference's ``zero1`` exchange and update, two steps, on
    ``mesh``: -> (params, global opt state) as numpy."""
    opt = getattr(ref_opt, rule)(**kwargs)
    exch = ref_ex.Exchanger("zero1", bucket_bytes=128)
    params = jax.tree.map(jnp.asarray, _nest(
        {k[2:]: v for k, v in vals.items() if k.startswith("p/")}))
    grads = jax.tree.map(jnp.asarray, _nest(
        {k[2:]: v for k, v in vals.items() if k.startswith("g/")}))
    state = exch.zero1_init_opt_state(opt, params, N)
    ospecs = exch.zero1_opt_state_specs(opt, params, N)

    def f(g, st, p):
        return exch.exchange_and_update(jax.tree.map(lambda a: a[0], g), st,
                                        p, UPDATE_LR, opt)

    step = jax.jit(shard_map(f, mesh=mesh, in_specs=(P(DATA_AXIS), ospecs,
                                                     P()),
                             out_specs=(P(), ospecs), check=False))
    for _ in range(2):
        params, state = step(grads, state, params)
    return _np(params), _np(state)


@pytest.mark.parametrize("rule", list(RULES))
def test_zero1_adaptive_rules_match_the_reference(runs, mesh4, rule):
    """(c): two ``zero1`` steps of Adam and RMSProp, clipped (one scalar
    all-reduce of the shards' squared norms) and decayed, on 128-byte
    buckets (two, padded): the params and the joined optimizer state
    within 1e-5 of the reference's on ``mesh4``."""
    d = runs["d"]
    vals = dict(np.load(d / "update.npz"))
    jparams, jstate = _ref_zero1_update(mesh4, rule, RULES[rule], vals)
    outs = [torch.load(d / f"{rule}-r{r}.pt") for r in range(N)]
    for r in range(N):
        mine = _flat(outs[r]["params"])
        for k, want in _flat(jparams).items():
            np.testing.assert_allclose(mine[k], want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {k}")
            np.testing.assert_array_equal(mine[k],
                                          _flat(outs[0]["params"])[k])
    layout = ex.Exchanger("zero1", bucket_bytes=128).zero1_layout(
        outs[0]["params"], N)
    joined = zero1_opt_state_to_jax([o["opt_state"] for o in outs], layout)
    assert joined.keys() == jstate.keys()
    for k, want in jstate.items():
        if isinstance(want, list):
            assert len(joined[k]) == len(want) == 2
            for a, b in zip(joined[k], want):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=k)
        else:
            assert int(joined[k]) == int(want) == 2  # Adam's t


@pytest.mark.parametrize("rule", list(RULES))
def test_plain_update_matches_the_reference(rule):
    """(c): three steps of ``update`` on one process, with the
    reference's clip-then-decay order, within 1e-6."""
    rng = np.random.RandomState(11)
    params = {k: rng.randn(*s).astype(np.float32)
              for k, s in UPDATE_SHAPES.items()}
    grads = [{k: rng.randn(*s).astype(np.float32)
              for k, s in UPDATE_SHAPES.items()} for _ in range(3)]
    mine_opt = getattr(port_opt, rule)(**RULES[rule])
    ref = getattr(ref_opt, rule)(**RULES[rule])
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = jax.tree.map(jnp.asarray, params)
    st, jst = mine_opt.init(p), ref.init(jp)
    for g in grads:
        p, st = mine_opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                                st, p, 0.01)
        jp, jst = ref.update(jax.tree.map(jnp.asarray, g), jst, jp, 0.01)
    for k in params:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for key, want in _flat(_np(jst)).items():
        np.testing.assert_allclose(_flat(st)[key], want, rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    if rule == "Adam":
        assert st["t"].dtype == torch.int32 and int(st["t"]) == 3


def test_accounting():
    """(d): ``zero1``'s wire bytes are the reference's at n = 1, 2 and 4
    (a reduce-scatter and an all-gather, psum's total); overlap changes
    neither the wire bytes nor the bucket layout."""
    cfg = {"n_layers": 2, "dim": 64, "heads": 2, "seq_len": 64,
           "vocab": 256}
    from theanompi_torch.models.transformer_lm import TransformerLM

    p, _ = TransformerLM(dict(cfg)).init_params(
        torch.Generator().manual_seed(0))
    jp, _ = jax.eval_shape(JaxLM(dict(cfg)).init_params,
                           jax.random.PRNGKey(0))
    for n in (1, 2, 4):
        mine = ex.Exchanger("zero1").wire_bytes(p, n)
        assert mine == ref_ex.Exchanger("zero1").wire_bytes(jp, n)
        assert mine == ex.Exchanger("psum").wire_bytes(p, n)
        assert (mine > 0) == (n > 1)
    tree = {"w": torch.zeros(1000), "b": torch.zeros(10)}
    for strategy in ex.BUCKETED_STRATEGIES:
        fused = ex.Exchanger(strategy, bucket_bytes=1024)
        over = ex.Exchanger(strategy, bucket_bytes=1024, overlap=True)
        assert over.overlap and not fused.overlap
        assert fused.wire_bytes(tree, 8) == over.wire_bytes(tree, 8)
        assert fused.bucket_summary(tree, 8) == over.bucket_summary(tree, 8)


#: the reference's rejections, ``tests/test_overlap.py:176-185``
REJECTS = [("ring_int8", "psum_bucket", "strategy:until_epoch"),
           ("ring_int8:x", "psum_bucket", "not an epoch"),
           ("nope:2", "psum_bucket", "unknown"),
           ("ring_int8:3,psum_bf16_bucket:2", "psum_bucket",
            "strictly increasing"),
           ("ring_int8:2,psum_bf16_bucket:2", "psum_bucket",
            "strictly increasing"),
           ("zero1:2", "psum_bucket", "zero1"),
           ("ring_int8:2", "zero1", "zero1"),
           ("", "psum_bucket", "empty")]


def test_ramp_parses_and_rejects_as_the_reference():
    """(e): phases, lookup and description equal the reference's; the
    eight malformed specs raise the reference's ``ValueError``s."""
    for spec, base in (("ring_int8:2,psum_bf16_bucket:4", "psum_bucket"),
                       ("ring_int8:1,psum_bucket:2", "psum")):
        mine = RampSchedule.parse(spec, base)
        theirs = ref_overlap.RampSchedule.parse(spec, base)
        assert mine.phases == theirs.phases
        assert mine.strategies == theirs.strategies
        assert mine.describe() == theirs.describe()
        assert [mine.strategy_for_epoch(e) for e in range(6)] == [
            theirs.strategy_for_epoch(e) for e in range(6)]
        assert [mine.phase_for_epoch(e) for e in (0, 1, 3, 99)] == [
            theirs.phase_for_epoch(e) for e in (0, 1, 3, 99)]
    r = RampSchedule.parse("ring_int8:2,psum_bf16_bucket:4", "psum_bucket")
    assert [r.strategy_for_epoch(e) for e in range(6)] == (
        ["ring_int8"] * 2 + ["psum_bf16_bucket"] * 2 + ["psum_bucket"] * 2)
    for spec, base, msg in REJECTS:
        with pytest.raises(ValueError, match=msg):
            RampSchedule.parse(spec, base)
        with pytest.raises(ValueError, match=msg):
            ref_overlap.RampSchedule.parse(spec, base)


def test_ramp_switches_only_at_epoch_boundaries():
    """(e): a world-1 run of 3 epochs under ``ring_int8:1,psum_bucket:2``
    on a ``psum`` base: each epoch's steps run its phase's strategy
    through one step closure, one closure a phase, and the exchangers
    were built at construction."""
    model = WideResNet({**EXCHANGE_TINY, "n_epochs": 3, "n_train": 16})
    t = BSPTrainer(model, exch_strategy="psum", exch_bucket_mb=CHAIN_MB,
                   exch_overlap=True, exch_ramp="ring_int8:1,psum_bucket:2",
                   device="cpu", recorder=Recorder(verbose=False,
                                                   print_freq=10**9))
    assert set(t._ramp_exchangers) == {"ring_int8", "psum_bucket", "psum"}
    assert t._ramp_exchangers["ring_int8"].overlap
    assert not t._ramp_exchangers["psum"].overlap  # leaf-wise: no buckets
    t.compile_iter_fns()
    t.init_state()
    seen = []
    orig = t.train_iter

    def spy(batch, lr):
        seen.append((t.epoch, t.exchanger.strategy, t._step_fn))
        return orig(batch, lr)

    t.train_iter = spy
    t.run()
    by_epoch = {}
    for epoch, strategy, fn in seen:
        by_epoch.setdefault(epoch, []).append((strategy, fn))
    assert sorted(by_epoch) == [0, 1, 2]
    want = {0: "ring_int8", 1: "psum_bucket", 2: "psum"}
    for epoch, steps in by_epoch.items():
        assert {s for s, _ in steps} == {want[epoch]}, (epoch, steps)
        assert len({id(fn) for _, fn in steps}) == 1, (epoch, steps)
    assert len({id(fn) for _, _, fn in seen}) == 3  # seen keeps them alive
    assert all(np.isfinite(t.recorder.train_history["cost"]))


def test_ramp_and_overlap_refusals():
    """(e): a ``zero1`` base or phase is refused when the trainer is
    built; overlap of a leaf-wise strategy raises the reference's
    ``ValueError``; a ``zero1`` exchanger refuses a plain exchange."""
    for kw in ({"exch_strategy": "zero1", "exch_ramp": "ring_int8:1"},
               {"exch_strategy": "psum_bucket", "exch_ramp": "zero1:1"}):
        with pytest.raises(ValueError, match="zero1"):
            BSPTrainer(WideResNet(dict(EXCHANGE_TINY)), device="cpu",
                       recorder=Recorder(verbose=False), **kw)
    with pytest.raises(ValueError, match="not bucketed"):
        BSPTrainer(WideResNet(dict(EXCHANGE_TINY)), device="cpu",
                   exch_strategy="psum", exch_overlap=True,
                   recorder=Recorder(verbose=False))
    with pytest.raises(ValueError, match="exchange_and_update"):
        ex.Exchanger("zero1").exchange({"w": torch.ones(3)})


def test_launcher_trains_zero1_overlap_and_a_ramp_on_two_ranks():
    """``--rule-set`` reaches the rule (``true`` typed as a bool): the
    tiny WRN trains on 2 gloo ranks under ``zero1`` with overlap, and over
    2 epochs under a ramp with overlap, to a final validation line."""
    base = [sys.executable, "-m", "theanompi_torch.launcher", "--devices",
            "2", "--device", "cpu", "--modelfile",
            "theanompi_torch.models.wide_resnet", "--modelclass",
            "WideResNet", "--rule-set", "exch_overlap=true",
            "--rule-set", "exch_bucket_mb=0.05"]
    for k, v in {"depth": 10, "widen": 1, "image_size": 8,
                 "batch_size": 4, "n_train": 16, "n_val": 8,
                 "precision": "fp32"}.items():
        base += ["--set", f"{k}={v!r}"]
    env = {**os.environ, "PYTHONPATH": REPO}
    for extra in (["--rule-set", "exch_strategy=zero1", "--set",
                   "n_epochs=1"],
                  ["--rule-set", "exch_strategy=psum_bucket", "--rule-set",
                   "exch_ramp=ring_int8:1,psum_bucket:2", "--set",
                   "n_epochs=2"]):
        r = subprocess.run(base + extra, cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        done = [line for line in r.stdout.splitlines()
                if line.startswith("tmlauncher: done. final val: ")]
        assert len(done) == 1 and "'cost'" in done[0], r.stdout


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_smoke_counts_bucket_collectives_by_name():
    """``chip_smoke.py``'s check that an overlapped run issued every
    bucket from backward counts the collectives by name: under ``zero1`` a
    missing all-gather, or a stray all-reduce beside clipping's one, is
    caught, not folded into a halved total."""
    ok = _smoke().bucket_collectives_ok

    def res(clip, **c):
        return {"collectives": c, "buckets_from_backward": 44,
                "grad_clip": clip}

    z = {"reduce_scatter_tensor": 44, "all_gather_into_tensor": 44}
    assert ok(res(1.0, **z, all_reduce=1), "zero1")
    assert ok(res(None, **z), "zero1")
    assert not ok(res(1.0, **{**z, "all_gather_into_tensor": 43},
                      all_reduce=1), "zero1")
    assert not ok(res(1.0, **z), "zero1")
    assert not ok(res(None, **z, all_reduce=1), "zero1")
    assert ok(res(None, all_reduce=44), "psum_bucket")
    assert not ok(res(None, all_reduce=45), "psum_bucket")
    assert not ok(res(None, all_reduce=44, reduce_scatter_tensor=1),
                  "psum_bucket")
    assert not ok({"collectives": {}, "buckets_from_backward": 0,
                   "grad_clip": None}, "psum_bucket")


def test_smoke_holds_the_none_strategy_to_each_ranks_input(tmp_path):
    """``chip_smoke.py``'s exchange check, which with two or more cards
    takes every strategy, ``none`` among them: ``none`` exchanges nothing,
    so each rank's output is held to its own input, not to the ranks'
    mean, and the ranks differ; a mean strategy's ranks must not."""
    smoke = _smoke()
    vals = {"w": np.random.RandomState(2).randn(2, 5).astype(np.float32)}
    for r in range(2):
        np.savez(tmp_path / f"none-r{r}.npz", w=vals["w"][r])
        np.savez(tmp_path / f"psum-r{r}.npz", w=vals["w"].mean(0))
        np.savez(tmp_path / f"psum_bucket-r{r}.npz", w=vals["w"][r])
    smoke.bsp_exchange_check(str(tmp_path), vals, ("none", "psum"), {})
    with pytest.raises(smoke.SmokeFailure, match="differs from rank 0"):
        smoke.bsp_exchange_check(str(tmp_path), vals, ("psum_bucket",), {})
