"""The port's exchanger at 4 gloo ranks against the reference's on the
4-device ``mesh4``, on the CPU.

One spawn of 4 ranks for the whole file (module-scoped), each running the
port's jobs from ``theanompi_torch.parallel.rank_jobs`` on inputs this
module writes as ``.npz`` files, so the ranks import neither JAX nor this
module (one more job reports their loaded modules).  The inputs are made
with numpy from a seed: a tree of per-rank fp32 leaves of ragged sizes (13,
15 and 42 elements, none a multiple of 4) and an int32 leaf, exchanged with
buckets of 128 bytes (the greedy layout then makes a bucket of the first
two leaves and an oversized bucket of the third).

- (a) every ported strategy against the reference's ``Exchanger`` on the
  same per-rank inputs, within the reference's own ``TOL``
  (``tests/test_exchanger.py:34``): fp32 1e-6, bf16 1e-2, int8 5e-2;
  ``ring`` and ``ring_bucket`` bit-equal to the reference's (the same
  chunks, the same adds in the same order); every rank's result
  bit-identical (``ring_int8`` by design); int leaves passed through;
  ``none`` the identity;
- (b) ``wire_bytes`` equal to the reference's for every strategy at n =
  1, 2 and 4, with the compression invariants (1/2 for bf16 wires, 1/4
  for ``ring_int8``);
- (c) the bucket layout equal to the reference's ``_bucket_layout`` on the
  tiny WRN and tiny ``TransformerLM`` param trees;
- (d) the collective budget: a ``psum_bucket`` BSP step of the tiny
  ``TransformerLM`` (38 leaves) issues at most 4 gradient all-reduces;
- ``fused_pmean`` against the reference's, one collective a dtype;
- what stays refused: overlap of a leaf-wise strategy, ``exchange()`` on
  a ``zero1`` exchanger (its exchange is its update:
  ``tests/test_torch_zero1_overlap.py``), an unknown strategy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM
from theanompi_tpu.models.wide_resnet import WideResNet as JaxWRN
from theanompi_tpu.parallel import exchanger as ref_ex
from theanompi_tpu.parallel.mesh import DATA_AXIS, shard_map

from theanompi_torch import dist as tdist
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.models.wide_resnet import WideResNet
from theanompi_torch.parallel import exchanger as ex
from theanompi_torch.parallel.rank_jobs import run_all

N = 4
BUCKET_BYTES = 128
#: the ten strategies whose ``exchange`` is a mean (``zero1`` fuses the
#: exchange into the update: ``tests/test_torch_zero1_overlap.py``)
STRATEGIES = tuple(s for s in ex.LEAFWISE_STRATEGIES + ex.BUCKETED_STRATEGIES
                   if s != "zero1")
#: the reference's tolerances, ``tests/test_exchanger.py:34``
TOL = {"bf16": 1e-2, "int8": 5e-2, "fp32": 1e-6}
SHAPES = {"a": (13,), "b": (3, 5), "z/k": (7, 3, 2)}
TINY_LM = {"n_layers": 2, "dim": 64, "heads": 2, "seq_len": 64,
           "vocab": 256, "batch_size": 2, "n_train": 16, "n_val": 8,
           "dropout": 0.0, "precision": "fp32", "attn_impl": "blockwise",
           "lr": 0.05, "n_epochs": 1}
TINY_WRN = {"depth": 10, "widen": 1, "image_size": 8, "precision": "fp32"}
_FORBIDDEN = ("jax", "jaxlib", "theanompi_tpu")


def _tol(strategy):
    if "int8" in strategy:
        return TOL["int8"]
    return TOL["bf16"] if "bf16" in strategy else TOL["fp32"]


def _inputs():
    rng = np.random.RandomState(0)
    vals = {k: rng.randn(N, *s).astype(np.float32)
            for k, s in SHAPES.items()}
    vals["count"] = np.tile(np.arange(2, dtype=np.int32), (N, 1)) + 7
    return vals


def _nest(flat):
    tree = {}
    for key, x in flat.items():
        *head, last = key.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def _reference(mesh, strategy, vals):
    """Per-device outputs ``{"a/b": [n, ...]}`` of the reference's
    exchange of the per-device rows of ``vals``."""
    exch = ref_ex.Exchanger(strategy=strategy, bucket_bytes=BUCKET_BYTES)

    def f(tree):
        out = exch.exchange(jax.tree.map(lambda a: a[0], tree))
        return jax.tree.map(lambda a: a[None], out)

    tree = jax.tree.map(jnp.asarray, _nest(vals))
    out = shard_map(f, mesh=mesh, in_specs=P(DATA_AXIS),
                    out_specs=P(DATA_AXIS), check=False)(tree)
    flat = {}
    for path, x in jax.tree_util.tree_flatten_with_path(out)[0]:
        flat["/".join(p.key for p in path)] = np.asarray(x)
    return flat


#: the fused_pmean case: metrics-like and state-like leaves in two float
#: dtypes and an int leaf
PMEAN = {"bn/mean": (5,), "cost": (), "f64": (4,)}


def _pmean_inputs():
    rng = np.random.RandomState(3)
    vals = {k: rng.randn(N, *s).astype(np.float64 if k == "f64" else
                                        np.float32)
            for k, s in PMEAN.items()}
    vals["step"] = np.arange(N, dtype=np.int32)
    return vals


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    """The reference's outputs per strategy, and the port's 4 ranks' in
    one spawn: the exchange cases, a psum_bucket and a psum BSP step of
    the tiny TransformerLM, a fused_pmean case, the ranks' modules."""
    d = tmp_path_factory.mktemp("exchanger")
    vals = _inputs()
    np.savez(d / "in.npz", **vals)
    np.savez(d / "pmean.npz", **_pmean_inputs())
    cases = [(s, s, BUCKET_BYTES, 11) for s in STRATEGIES]
    lm = {"modelfile": "theanompi_torch.models.transformer_lm",
          "modelclass": "TransformerLM", "model_config": TINY_LM,
          "steps": 1}
    calls = [("exchange_cases", (str(d / "in.npz"), str(d), cases)),
             ("bsp_run", ({**lm, "rule_config": {
                 "exch_strategy": "psum_bucket", "verbose": False}},)),
             ("bsp_run", ({**lm, "rule_config": {
                 "exch_strategy": "psum", "verbose": False}},)),
             ("pmean_case", (str(d / "pmean.npz"),)),
             ("loaded_modules", (_FORBIDDEN,))]
    port = tdist.spawn(run_all, N, "gloo", "cpu", (calls,), timeout_s=600)
    ref = {s: _reference(mesh4, s, vals) for s in STRATEGIES}
    out = {s: [dict(np.load(d / f"{s}-r{r}.npz")) for r in range(N)]
           for s in STRATEGIES}
    return {"vals": vals, "ref": ref, "out": out, "port": port}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_the_reference(runs, strategy):
    vals, ref, out = runs["vals"], runs["ref"][strategy], runs["out"][strategy]
    tol = _tol(strategy)
    for r in range(N):
        assert out[r].keys() == ref.keys() == vals.keys()
        # int leaves pass through, dtype and all
        assert out[r]["count"].dtype == np.int32
        np.testing.assert_array_equal(out[r]["count"], vals["count"][r])
        for k in SHAPES:
            if strategy == "none":
                np.testing.assert_array_equal(out[r][k], vals[k][r])
                continue
            np.testing.assert_allclose(out[r][k], ref[k][r], rtol=tol,
                                       atol=tol, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(out[r][k], vals[k].mean(0),
                                       rtol=tol, atol=tol)
            if strategy in ("ring", "ring_bucket"):
                # the same chunk indices and order of fp32 adds as the
                # reference's ppermute ring: bit for bit
                np.testing.assert_array_equal(out[r][k], ref[k][r])
            if strategy != "none":
                np.testing.assert_array_equal(out[r][k], out[0][k])
    counts = runs["port"][0][0]
    # leaf-wise psum: one a float leaf; bucketed: one a bucket
    want = {"psum": 3, "psum_bf16": 3, "psum_bucket": 2,
            "psum_bf16_bucket": 2}
    assert counts[strategy] == want.get(strategy, 0), counts


def _trees():
    """The tiny LM's params (plus an int leaf) on both sides, and the
    tiny WRN's."""
    out = {}
    for name, (mine, theirs, cfg) in {
            "lm": (TransformerLM, JaxLM, TINY_LM),
            "wrn": (WideResNet, JaxWRN, TINY_WRN)}.items():
        p, _ = mine(dict(cfg)).init_params(torch.Generator().manual_seed(0))
        jp, _ = jax.eval_shape(theirs(dict(cfg)).init_params,
                               jax.random.PRNGKey(0))
        out[name] = (p, jp)
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_wire_bytes_equal_the_reference(n):
    p, jp = _trees()["lm"]
    p = {**p, "step": torch.zeros((3,), dtype=torch.int32)}
    jp = {**jp, "step": jax.ShapeDtypeStruct((3,), jnp.int32)}
    mine = {s: ex.Exchanger(s).wire_bytes(p, n) for s in STRATEGIES}
    theirs = {s: ref_ex.Exchanger(s).wire_bytes(jp, n) for s in STRATEGIES}
    assert mine == theirs
    if n > 1:
        assert mine["psum"] > 0 and mine["none"] == 0
        for s in STRATEGIES:
            if "bf16" in s:
                assert 2 * mine[s] == mine["psum"], s
        assert 4 * mine["ring_int8"] == mine["psum"]
        assert mine["ring"] == mine["psum_bucket"] == mine["psum"]
    else:
        assert set(mine.values()) == {0}
    for s in STRATEGIES:
        for dt in (torch.float32, torch.bfloat16, torch.int32):
            jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
                   torch.int32: jnp.int32}[dt]
            assert ex.wire_itemsize(s, dt) == ref_ex.wire_itemsize(s, jdt)
    for b in (0, 1000, 4096):
        assert ex.collective_wire_bytes(b, n) == \
            ref_ex.collective_wire_bytes(b, n)


@pytest.mark.parametrize("model", ["wrn", "lm"])
def test_bucket_layout_equals_the_reference(model):
    p, jp = _trees()[model]
    for bucket_bytes in (ex.DEFAULT_BUCKET_BYTES, 16 * 1024):
        for n in (1, 4):
            mine = ex.Exchanger("psum_bucket", bucket_bytes).layout(p, n)
            theirs = ref_ex._bucket_layout(jax.tree.leaves(jp), bucket_bytes,
                                            n)
            key = [(str(b.dtype).split(".")[-1], b.indices, b.sizes,
                    b.elems, b.padded) for b in mine]
            want = [(str(b.dtype), b.indices, b.sizes, b.elems, b.padded)
                    for b in theirs]
            assert key == want, (model, bucket_bytes, n)
            summary = ex.Exchanger("ring_int8", bucket_bytes) \
                .bucket_summary(p, n)
            assert summary == ref_ex.Exchanger(
                "ring_int8", bucket_bytes=bucket_bytes).bucket_summary(jp, n)
    assert ex.Exchanger("psum").bucket_summary(p, 4) is None


def test_collective_budget_of_a_bucketed_step(runs):
    bucketed, leafwise = runs["port"][0][1], runs["port"][0][2]
    assert bucketed["grad_leaves"] == leafwise["grad_leaves"] >= 30
    assert bucketed["all_reduces"] <= 4, bucketed["all_reduces"]
    # leaf-wise: one collective a leaf
    assert leafwise["all_reduces"] == leafwise["grad_leaves"]
    # every rank took the same step
    for r in range(1, N):
        assert runs["port"][r][1]["metrics"] == bucketed["metrics"]


def test_ranks_import_no_jax(runs):
    assert [res[-1] for res in runs["port"]] == [[]] * N


def test_fused_pmean_against_the_reference(runs, mesh4):
    """The rank mean, one all-reduce a float dtype, the int passed
    through."""
    vals = _pmean_inputs()
    ref = {k: v for k, v in vals.items() if k != "f64"}  # no x64 in jax
    tree = jax.tree.map(jnp.asarray, _nest(ref))
    want = shard_map(
        lambda t: jax.tree.map(lambda a: a[None], ref_ex.fused_pmean(
            jax.tree.map(lambda a: a[0], t), DATA_AXIS)),
        mesh=mesh4, in_specs=P(DATA_AXIS), out_specs=P(DATA_AXIS),
        check=False)(tree)
    for r in range(N):
        out, n_reduces = runs["port"][r][3]
        assert n_reduces == 2  # fp32 and float64
        np.testing.assert_allclose(out["cost"], np.asarray(want["cost"])[r],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out["bn/mean"],
                                   np.asarray(want["bn"]["mean"])[r],
                                   rtol=1e-6, atol=1e-6)
        assert out["f64"].dtype == np.float64
        np.testing.assert_allclose(out["f64"], vals["f64"].mean(0),
                                   rtol=1e-12)
        assert out["step"] == r


def test_zero1_and_overlap_are_refused():
    """What stays refused now that ``zero1`` and overlap are ported: a
    leaf-wise strategy with overlap (it has no buckets to issue), and
    ``exchange()`` on ``zero1``, whose exchange is its update."""
    for s in ex.LEAFWISE_STRATEGIES:
        with pytest.raises(ValueError, match="not bucketed"):
            ex.Exchanger(s, overlap=True)
    for s in ex.BUCKETED_STRATEGIES:
        assert ex.Exchanger(s, overlap=True).overlap
    z = ex.Exchanger("zero1")
    assert z.fuses_update and z.bucketed
    with pytest.raises(ValueError, match="exchange_and_update"):
        z.exchange({"w": torch.ones(3)})
    with pytest.raises(ValueError, match="unknown exchange strategy"):
        ex.Exchanger("asa32")
    # at one process every strategy is the identity, with no group
    tree = {"w": torch.ones(3)}
    for s in STRATEGIES:
        assert ex.Exchanger(s).exchange(tree) is tree
    assert ex.fused_pmean(tree) is tree
