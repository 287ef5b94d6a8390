"""Tensor parallelism in the port at 4 gloo ranks against the reference's
``model`` mesh axis on the CPU.

The reference runs here on ``make_mesh(n_data, n_model)`` over the host's
forced devices; the port's ranks run in one module-scoped spawn
(``theanompi_torch.parallel.rank_jobs.run_all``), fed the reference's
initial params (converted) and global batches as files.

- Megatron's ``f`` and ``g`` (forward and cotangents), and a
  column-parallel ``up``, GELU, row-parallel ``down`` MLP (outputs and the
  grads of the input and of each rank's weight shards) against the
  reference's layers under ``shard_map`` on a 1x4 mesh;
- ``TransformerLM`` with the fused, vocab-parallel loss at dp x tp 1x4 and
  2x2, two steps through ``BSP(config={"n_model": k}).init``: both steps'
  metrics and the params after step 1 against the reference's run on the
  same mesh; the exchanged grads of step 1, gathered to the full tree,
  against the reference's grads of its loss on the unsharded tree (its
  mesh run keeps its grads inside the step);
- the same against the port's one process at ``n_model`` 1, with ``l2``
  on and, at one data worker, dropout on (the dropout stream is keyed by
  the data index, so the ranks of a model group and the one process draw
  the same masks); the gathered params bit-equal on every rank, and the
  model group's collectives of a step counted by kind;
- the reference's L2 term under ``shard_map`` differentiates its ``psum``
  into a sum, so its gradient of a cut leaf is ``n_model`` times the
  one-process one; the port's is the one-process one (ROADMAP queue 3);
- a 2x2 checkpoint holds the reference's global layout, resumes at tp2
  bit-equal to an uninterrupted run, and is refused at tp1
  (``CheckpointReshardableMismatch``);
- the refusals: ``zero1`` over cut params, ``n_seq`` and ``n_pipe``;
- the launcher at ``--devices 1 --rule-set n_model=2`` on the CPU.

Tolerance: fp32 rtol 1e-5 / atol 1e-6 (ROADMAP rule 2), grads against a
floor of 1e-6 of the tree's largest (the attention's k bias has a true
gradient of 0, its computed one rounding noise on both sides).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM
from theanompi_tpu.ops.opt import global_sq_norm as jax_sq_norm
from theanompi_tpu.parallel import tensor as jtensor
from theanompi_tpu.parallel.bsp import BSPTrainer as JaxBSPTrainer
from theanompi_tpu.parallel.mesh import make_mesh, shard_map
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder

from theanompi_torch import BSP
from theanompi_torch import dist as tdist
from theanompi_torch.convert import params_from_jax, params_to_jax
from theanompi_torch.models.data.base import derive_seed
from theanompi_torch.parallel import mesh as tmesh
from theanompi_torch.parallel.rank_jobs import run_all, tp_run
from theanompi_torch.parallel.trainer import _dropout_gen
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils.checkpoint import CheckpointReshardableMismatch

N = 4
RTOL, ATOL = 1e-5, 1e-6
LR = 0.05
LM = {"batch_size": 4, "n_train": 16, "n_val": 4, "seq_len": 16,
      "vocab": 64, "dim": 32, "heads": 4, "n_layers": 2, "dropout": 0.0,
      "n_epochs": 1, "precision": "fp32", "fused_loss": True,
      "attn_impl": "blockwise", "lr": LR, "momentum": 0.9,
      "grad_clip": 1.0}
LAYOUTS = [(1, 4), (2, 2)]
MODELFILE = "theanompi_torch.models.transformer_lm"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(x)
            for p, x in tree_leaves_with_path(tree)}


def _close_tree(port, ref, what, floor=0.0):
    """Leaf by leaf at rtol 1e-5 / atol 1e-6, the atol raised to ``floor``
    times the tree's largest element where given."""
    mine, want = _flat(port), _flat(ref)
    assert mine.keys() == want.keys(), what
    atol = max(ATOL, floor * max(float(np.abs(v).max())
                                 for v in want.values()))
    for k, x in mine.items():
        np.testing.assert_allclose(x, want[k], rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {k}")


def _ref_run(cfg, n_data, n_model, batches):
    """The reference's two steps on a ``n_data x n_model`` mesh -> (the
    metrics of each step, params after step 1)."""
    mesh = make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n_data * n_model])
    jt = JaxBSPTrainer(JaxLM({**cfg, "batch_size": cfg["batch_size"]
                              // n_data}), mesh=mesh,
                       recorder=JaxRecorder(verbose=False))
    jt.compile_iter_fns()
    jt.init_state()
    m1 = {k: float(v) for k, v in jt.train_iter(batches[0], LR).items()}
    p1 = _np(jt.params)
    m2 = {k: float(v) for k, v in jt.train_iter(batches[1], LR).items()}
    return [m1, m2], p1


def _ref_grads(cfg, params, batch):
    model = JaxLM(dict(cfg))
    return _np(jax.jit(jax.grad(lambda p: model.loss_fn(
        p, {}, batch, jax.random.PRNGKey(0), train=True)[0]))(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    model = JaxLM(dict(LM))
    params, _ = model.init_params(jax.random.PRNGKey(1))
    params = _np(params)
    batches = list(model.data.train_batches(LM["batch_size"], 0,
                                            seed=0))[:2]
    torch.save({"params": params_from_jax(params), "state": {}},
               d / "init.pt")
    np.savez(d / "batches.npz", **{k: np.stack([b[k] for b in batches])
                                   for k in batches[0]})
    ref = {lay: _ref_run(LM, *lay, batches) for lay in LAYOUTS}
    ref["grads"] = _ref_grads(LM, params, batches[0])

    def job(name, cfg, n_data, n_model):
        return {"modelfile": MODELFILE, "modelclass": "TransformerLM",
                "model_config": {**cfg, "batch_size": cfg["batch_size"]
                                 // n_data},
                "rule_config": {"n_model": n_model, "verbose": False},
                "steps": 2, "init": str(d / "init.pt"),
                "batches": str(d / "batches.npz"), "out": str(d / name)}

    # l2 on; dropout on where one data worker draws the one process's masks
    own = {(1, 4): {**LM, "l2": 1e-3, "dropout": 0.1},
           (2, 2): {**LM, "l2": 1e-3}}
    calls = [("tp_run", (job(f"ref{a}x{b}", LM, a, b),)) for a, b in LAYOUTS]
    calls += [("tp_run", (job(f"own{a}x{b}", own[a, b], a, b),))
              for a, b in LAYOUTS]
    layer_in = d / "layers.npz"
    rng = np.random.RandomState(0)
    layers = {"f/x": rng.randn(3, 8), "f/ct": rng.randn(N, 3, 8),
              "g/x": rng.randn(N, 3, 8), "g/ct": rng.randn(3, 8),
              "mlp/x": rng.randn(2, 3, 8), "mlp/up_w": rng.randn(8, 16),
              "mlp/up_b": rng.randn(16), "mlp/down_w": rng.randn(16, 8),
              "mlp/down_b": rng.randn(8), "mlp/ct": rng.randn(2, 3, 8)}
    layers = {k: v.astype(np.float32) for k, v in layers.items()}
    np.savez(layer_in, **layers)
    calls.append(("tp_layer_cases", (str(layer_in), str(d),
                                     ("f", "g", "mlp"))))
    ck = {"model_config": {**LM, "batch_size": 2, "n_val": 4},
          "modelfile": MODELFILE, "modelclass": "TransformerLM"}
    rc = {"n_model": 2, "verbose": False, "checkpoint_async": False}
    calls += [
        ("launch", ({**ck, "rule_config": {
            **rc, "checkpoint_dir": str(d / "ck1")}},)),
        ("launch", ({**ck, "model_config": {**ck["model_config"],
                                            "n_epochs": 2},
                     "rule_config": {**rc, "checkpoint_dir": str(d / "ck1"),
                                     "resume": True}},)),
        ("launch", ({**ck, "model_config": {**ck["model_config"],
                                            "n_epochs": 2},
                     "rule_config": {**rc,
                                     "checkpoint_dir": str(d / "ck2")}},)),
        ("launch", ({**ck, "rule_config": {"n_model": 2, "verbose": False,
                                           "exch_strategy": "zero1"}},)),
        ("loaded_modules", (("jax", "jaxlib", "theanompi_tpu"),))]
    port = tdist.spawn(run_all, N, "gloo", "cpu", (calls,), timeout_s=900)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = {lay: tp_run("cpu", {**job(f"one{lay[0]}x{lay[1]}", own[lay],
                                         1, 1), "rule_config": {
            "verbose": False}}) for lay in LAYOUTS}
    finally:
        torch.set_num_threads(prev)
    return {"d": d, "ref": ref, "port": port, "one": one, "params": params,
            "layers": layers}


def _load(d, name, r=0):
    return torch.load(d / f"{name}-r{r}.pt")


@pytest.mark.parametrize("n_data,n_model", LAYOUTS)
def test_transformer_against_the_reference_on_the_same_mesh(
        runs, n_data, n_model):
    i = LAYOUTS.index((n_data, n_model))
    jm, jp1 = runs["ref"][n_data, n_model]
    for r in range(N):
        mine = runs["port"][r][i]
        assert mine["layout"] == {"n_data": n_data, "n_model": n_model,
                                  "data_index": r // n_model,
                                  "model_index": r % n_model}
        for step, (m, want) in enumerate(zip(mine["metrics"], jm)):
            assert m.keys() == want.keys()
            for k in m:
                np.testing.assert_allclose(m[k], want[k], rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"rank {r} step {step}")
    out = _load(runs["d"], f"ref{n_data}x{n_model}")
    _close_tree(params_to_jax(out["params1"]), jp1, "params after step 1")
    _close_tree(params_to_jax(out["grads1"]), runs["ref"]["grads"],
                "exchanged grads of step 1", floor=1e-6)
    # the head is vocab-parallel: each rank held a quarter (a half) of it
    assert out["params0"]["head"]["w"].shape == (LM["dim"], LM["vocab"])


@pytest.mark.parametrize("n_data,n_model", LAYOUTS)
def test_transformer_equals_one_process_with_l2_and_dropout(
        runs, n_data, n_model):
    """Clipping's norm, the L2 term and (at 1x4) dropout under tensor
    parallelism are the one process's."""
    i = 2 + LAYOUTS.index((n_data, n_model))
    one = runs["one"][n_data, n_model]
    for r in range(N):
        mine = runs["port"][r][i]
        for m, want in zip(mine["metrics"], one["metrics"]):
            # the data workers' mean perplexity is a mean of exps, not the
            # exp of the global mean cost (the reference's pmean too)
            for k in set(m) - ({"perplexity"} if n_data > 1 else set()):
                np.testing.assert_allclose(m[k], want[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
        np.testing.assert_allclose(mine["grad_norm"], one["grad_norm"],
                                   rtol=RTOL)
    a = _load(runs["d"], f"own{n_data}x{n_model}")
    b = _load(runs["d"], f"one{n_data}x{n_model}")
    for key in ("grads1", "params1", "params"):
        _close_tree(a[key], b[key], key, floor=1e-6 if key == "grads1"
                    else 0.0)


def test_gathered_params_bit_equal_and_collectives_by_kind(runs):
    for i in range(4):
        digests = {tuple(runs["port"][r][i]["digests"]) for r in range(N)}
        assert len(digests) == 1, f"run {i}: ranks differ"
    # per step of the 2-layer model at 1x4: f on the attention's and up's
    # input per layer, g on o's and down's output per layer and on the
    # clip norm, the vocab-parallel loss's three per chunk (one chunk)
    # and its dh; no exchange at one data worker
    kinds = runs["port"][0][0]["per_step"][0]["kinds"]
    assert kinds == {"f": 4, "g": 5, "vp_max": 1, "vp_sum": 1,
                     "vp_rank": 1, "vp_dh": 1}
    calls = runs["port"][0][0]["per_step"][0]["calls"]
    assert calls == {"all_reduce": sum(kinds.values())}
    # at 2x2 the exchange adds one all-reduce a param leaf (psum) and the
    # metrics' mean one
    kinds2 = runs["port"][0][1]["per_step"][0]
    n_leaves = len(tree_leaves_with_path(runs["params"]))
    assert kinds2["calls"]["all_reduce"] == sum(
        kinds2["kinds"].values()) + n_leaves + 1


def test_f_and_g_forward_and_cotangents(runs):
    d, x = runs["d"], runs["layers"]
    for r in range(N):
        f = np.load(d / f"f-r{r}.npz")
        np.testing.assert_array_equal(f["y"], x["f/x"])
        np.testing.assert_allclose(f["d_x"], x["f/ct"].sum(0), rtol=RTOL,
                                   atol=ATOL)
        g = np.load(d / f"g-r{r}.npz")
        np.testing.assert_allclose(g["y"], x["g/x"].sum(0), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_array_equal(g["d_x"], x["g/ct"])


def test_column_and_row_dense_against_the_reference(runs):
    x = runs["layers"]
    up = jtensor.ColumnParallelDense(16)
    down = jtensor.RowParallelDense(8)
    mesh = make_mesh(n_data=1, n_model=N, devices=jax.devices()[:N])
    specs = {"x": P(), "up_w": P(None, "model"), "up_b": P("model"),
             "down_w": P("model", None), "down_b": P()}

    def obj(p):
        h, _ = up.apply({"w": p["up_w"], "b": p["up_b"]}, {}, p["x"])
        y, _ = down.apply({"w": p["down_w"], "b": p["down_b"]}, {},
                          jax.nn.gelu(h))
        return jnp.sum(y * x["mlp/ct"]), y

    def both(p):
        (_, y), g = jax.value_and_grad(obj, has_aux=True)(p)
        return y, g

    p = {k: x[f"mlp/{k}"] for k in specs}
    y, g = jax.jit(shard_map(both, mesh, in_specs=(specs,),
                             out_specs=(P(), specs)))(p)
    g = _np(g)
    # the float64 witness: the MLP's grads computed whole in float64
    t = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in p.items()}
    y64 = torch.nn.functional.gelu(t["x"] @ t["up_w"] + t["up_b"],
                                   approximate="tanh") @ t["down_w"] \
        + t["down_b"]
    g64 = dict(zip(t, (a.numpy() for a in torch.autograd.grad(
        (y64 * torch.tensor(x["mlp/ct"], dtype=torch.float64)).sum(),
        list(t.values())))))
    cut = {"up_w": (1, 16), "up_b": (0, 16), "down_w": (0, 16)}
    for r in range(N):
        got = np.load(runs["d"] / f"mlp-r{r}.npz")
        np.testing.assert_allclose(got["y"], np.asarray(y), rtol=RTOL,
                                   atol=ATOL)
        for k in specs:
            want, exact = g[k], g64[k]
            if k in cut:
                dim, width = cut[k]
                rows = range(r * width // N, (r + 1) * width // N)
                want = np.take(want, rows, axis=dim)
                exact = np.take(exact, rows, axis=dim)
            # the ranks' partials sum in another order than XLA's: both
            # sides are this far from float64, so the floor is 1e-6 of the
            # largest grad
            floor = 1e-6 * float(np.abs(want).max())
            for side in (got[f"d_{k}"], want):
                np.testing.assert_allclose(side, exact, rtol=RTOL,
                                           atol=floor, err_msg=k)
            np.testing.assert_allclose(got[f"d_{k}"], want, rtol=RTOL,
                                       atol=max(ATOL, floor),
                                       err_msg=f"rank {r} {k}")


def test_the_references_l2_gradient_of_a_cut_leaf_is_n_model_times():
    """The reference's ``global_sq_norm`` psums a cut leaf's square inside
    ``shard_map(check_vma=False)``, whose transpose sums the replicated
    cotangents: d/dp of ``|p|^2`` comes out ``n_model`` times ``2 p``.  The
    port's sum is Megatron's ``g`` (forward all-reduce, backward
    pass-through), which gives ``2 p`` (held in the one-process test)."""
    mesh = make_mesh(n_data=1, n_model=N, devices=jax.devices()[:N])
    specs = {"cut": P("model"), "whole": P()}
    p = {"cut": jnp.arange(8.0), "whole": jnp.arange(3.0)}
    g = jax.jit(shard_map(lambda q: jax.grad(
        lambda t: jax_sq_norm(t, specs))(q), mesh, in_specs=(specs,),
        out_specs=specs))(p)
    np.testing.assert_allclose(np.asarray(g["cut"]), N * 2 * np.arange(8.0))
    np.testing.assert_allclose(np.asarray(g["whole"]), 2 * np.arange(3.0))


def test_dropout_stream_is_keyed_by_the_data_index():
    one = tmesh.Layout(1, 1, 0, 0)
    assert one.replica_key() == ()
    # the ranks of one model group draw the one process's masks
    for m in range(4):
        assert tmesh.Layout(1, 4, 0, m).replica_key() == ()
        assert tmesh.Layout(2, 2, 1, m % 2).replica_key() == ("rank", 1)
    # at n_model 1 the data index is the rank: the streams of before
    for r in range(4):
        assert tmesh.Layout(4, 1, r, 0).replica_key() == ("rank", r)
    with tmesh.Layout(4, 1, 3, 0).bound():
        mine = _dropout_gen("cpu", 7, 5).initial_seed()
    assert mine == derive_seed("dropout", 7, 5, "rank", 3)
    with tmesh.Layout(1, 4, 0, 2).bound():
        assert _dropout_gen("cpu", 7, 5).initial_seed() == derive_seed(
            "dropout", 7, 5)
    assert tmesh.current().replica_key() == ()  # unbound: one process


def test_checkpoint_global_layout_resume_and_refusal(runs):
    d = runs["d"]
    a, b, c = (runs["port"][0][i] for i in (5, 6, 7))
    assert a[0] == b[0] == c[0] == 0, (a, b, c)
    with np.load(d / "ck1" / "ckpt_e0000.npz") as z:
        shapes = {k.split("::", 1)[1]: z[k].shape for k in z.files
                  if k.startswith("params::")}
    want = {k: v.shape for k, v in _flat(runs["params"]).items()}
    assert shapes == want
    # resumed at tp2 for the second epoch: the uninterrupted run's bytes
    with np.load(d / "ck1" / "ckpt_e0001.npz") as y, \
            np.load(d / "ck2" / "ckpt_e0001.npz") as z:
        assert sorted(y.files) == sorted(z.files)
        for k in y.files:
            if k.startswith(("params::", "opt_state::")):
                np.testing.assert_array_equal(y[k], z[k], err_msg=k)
    with pytest.raises(CheckpointReshardableMismatch, match="mesh"):
        BSP({"verbose": False, "resume": True,
             "checkpoint_dir": str(d / "ck1")}).init(
            devices=1, model_config={**LM, "batch_size": 2, "n_val": 4},
            device="cpu")


def test_refusals():
    # zero1 over cut params (rank 0's exit code; the ranks' log says why)
    # is held in the spawn below; n_seq and n_pipe name their item
    for key in ("n_seq", "n_pipe"):
        with pytest.raises(NotImplementedError, match="13b"):
            BSP({key: 2, "verbose": False}).init(
                devices=1, model_config=dict(LM), device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        BSP({"n_model": 2, "verbose": False}).init(
            model_config=dict(LM), device="cpu")


def test_zero1_over_cut_params_is_refused(runs):
    assert [runs["port"][r][8][0] for r in range(N)] == [78] * N


def test_ranks_import_no_jax(runs):
    assert [res[-1] for res in runs["port"]] == [[]] * N


def test_launcher_n_model_2_on_one_worker_trains_on_cpu(capsys):
    from theanompi_torch.launcher import main as launch

    argv = ["--device", "cpu", "--devices", "1", "--rule-set", "n_model=2",
            "--rule-set", "print_freq=2"]
    for k, v in {**LM, "n_val": 4}.items():
        argv += ["--set", f"{k}={v!r}"]
    assert launch(argv) == 0
    out = capsys.readouterr().out
    assert "tmlauncher: 2 ranks (1 data x 2 model), backend gloo" in out
    assert "tmlauncher: done. final val:" in out
    assert launch([*argv[:4], "--rule-set", "n_model=0"]) == 78
