"""Expert parallelism: the port's switch-routed ``MoEFFN`` and
``MoETransformerLM`` at 4 gloo ranks against the reference's ``model``
axis on the CPU (mirroring ``tests/test_moe.py``).

- The layer alone, at one rank: the port's index dispatch against the
  reference's dense ``[N, E, C]`` einsum, in the no-drop and the drop
  regime: outputs, aux, and the grads of the inputs and every weight.
- At ep4 (one module-scoped spawn of ``rank_jobs.tp_layer_cases``):
  nothing can drop at ``capacity_factor = n_experts``, and the outputs and
  aux equal the reference's ep4 and the one-rank layer; the grads equal
  the one-rank layer's.  In the drop regime capacity is per rank chunk
  (``test_moe.py:114``'s skew): the kept sets are the reference ep4's, and
  tokens kept by both equal the one-rank layer's.
- The Switch aux loss's gradient: the reference's ``pmean`` of ``P`` under
  ``shard_map(check_vma=False)`` transposes to a sum, so its ep4 gradient
  of the aux is 4 times its one-device one; the port's ep4 gradient is the
  one-device one (ROADMAP queue 3).
- ``MoETransformerLM`` at dp x tp 1x4 (the dryrun's dp x tp x ep family,
  ``__graft_entry__.py:163-180``, dropout 0: each package draws its own
  masks) and 2x2, two steps through ``BSP(config={"n_model": k})``:
  metrics and the params after step 1 against the reference on the same
  mesh, at ``moe_aux_weight`` 0 (the aux gradient above); and at the
  default weight, with the vocab-parallel loss and nothing dropping, 1x4
  against the port's one process, grads included.  Two all-to-alls a
  block a step forward and two backward.
- The reference's ``MoETransformerLM.param_specs`` leaves the head whole
  while its loss takes the vocab-parallel branch under a model axis, so
  each rank counts the whole vocabulary and the loss comes out ``ln
  n_model`` high; the port cuts the head (ROADMAP queue 3).

fp32, rtol 1e-5 / atol 1e-6; grads against a floor of 1e-6 of their
largest (the ranks' partial sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theanompi_tpu.models.transformer_lm import MoETransformerLM as JaxMoE
from theanompi_tpu.ops.moe import MoEFFN as JaxMoEFFN
from theanompi_tpu.parallel.bsp import BSPTrainer as JaxBSPTrainer
from theanompi_tpu.parallel.mesh import make_mesh, shard_map
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder

from theanompi_torch import dist as tdist
from theanompi_torch.convert import params_from_jax, params_to_jax
from theanompi_torch.models.transformer_lm import MoETransformerLM
from theanompi_torch.ops.moe import MoEFFN
from theanompi_torch.parallel.rank_jobs import run_all, tp_run
from theanompi_torch.tree import tree_leaves_with_path

N = 4
RTOL, ATOL = 1e-5, 1e-6
LR = 0.01
D, E = 8, 4
#: the dryrun's dp x tp x ep model at 4 devices, dropout 0
DRYRUN = {"batch_size": 2, "n_train": 32, "n_val": 16, "seq_len": 16,
          "vocab": 64, "dim": 32, "heads": 4, "n_layers": 2, "n_experts": 8,
          "dropout": 0.0, "n_epochs": 1, "precision": "fp32",
          "attn_impl": "blockwise", "lr": LR}
#: the 2x2 run, nothing dropping.  No l2 (the reference's L2 gradient of a
#: cut leaf is n_model times the one-process one,
#: test_torch_tensor_parallel.py) and no fused loss (the reference's
#: MoETransformerLM keeps the head whole under it: see
#: test_the_references_moe_head_is_whole_under_the_fused_loss)
TWO = {**DRYRUN, "batch_size": 4, "capacity_factor": 8.0}
EXPERT_KEYS = ("up_w", "up_b", "down_w", "down_b")
PSPECS = {"gate_w": P(), **{k: P("model") for k in EXPERT_KEYS}}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(map(str, p)): np.asarray(x)
            for p, x in tree_leaves_with_path(tree)}


def _close(a, b, what, floor=0.0):
    atol = max(ATOL, floor * float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)


def _layer_inputs(seed, cf, aux_w=0.01, ct=True, skew=False, n=32):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, n, D).astype(np.float32)
    w = {"gate_w": 0.5 * rng.randn(D, E), "up_w": 0.3 * rng.randn(E, D, 16),
         "up_b": 0.1 * rng.randn(E, 16), "down_w": 0.3 * rng.randn(E, 16, D),
         "down_b": 0.1 * rng.randn(E, D)}
    if skew:
        # test_moe.py:114's routing: feature 0 -> expert 0, feature 1 ->
        # expert 1; tokens 0..15 all want expert 0, 16..31 expert 1
        w["gate_w"] = np.zeros((D, E))
        w["gate_w"][0, 0] = w["gate_w"][1, 1] = 10.0
        x = np.zeros((1, n, D), np.float32)
        x[0, :16, 0] = 1.0
        x[0, 16:, 1] = 1.0
        x += 0.01 * rng.randn(1, n, D).astype(np.float32)
    out = {f"moe/{k}": np.asarray(v, np.float32) for k, v in w.items()}
    return {**out, "moe/x": x,
            "moe/ct": (rng.randn(1, n, D) if ct else np.zeros((1, n, D)))
            .astype(np.float32),
            "moe/aux_w": np.float32(aux_w),
            "moe/capacity_factor": np.float32(cf)}


def _ref_layer(x, ep):
    """The reference's layer at ``ep`` ranks -> (y, aux, grads of the
    objective against x and the weights, each whole)."""
    layer = JaxMoEFFN(dim=D, n_experts=E,
                      capacity_factor=float(x["moe/capacity_factor"]))

    def obj(p, xs):
        y, st = layer.apply({"gate": {"w": p["gate_w"]},
                             **{k: p[k] for k in EXPERT_KEYS}}, {}, xs)
        return (jnp.sum(y * x["moe/ct"]) + x["moe/aux_w"] * st["aux"],
                (y, st["aux"]))

    def both(p, xs):
        (_, (y, aux)), g = jax.value_and_grad(obj, argnums=(0, 1),
                                              has_aux=True)(p, xs)
        return y, aux, g

    p = {"gate_w": x["moe/gate_w"], **{k: x[f"moe/{k}"]
                                       for k in EXPERT_KEYS}}
    if ep == 1:
        y, aux, g = jax.jit(both)(p, x["moe/x"])
    else:
        mesh = make_mesh(n_data=1, n_model=ep, devices=jax.devices()[:ep])
        y, aux, g = jax.jit(shard_map(both, mesh, in_specs=(PSPECS, P()),
                                      out_specs=(P(), P(), (PSPECS, P()))))(
            p, x["moe/x"])
    grads = {**_np(g[0]), "x": np.asarray(g[1])}
    return np.asarray(y), float(aux), grads


def _port_layer(x):
    """The port's layer at one rank -> (y, aux, grads)."""
    layer = MoEFFN(D, E, capacity_factor=float(x["moe/capacity_factor"]))
    t = {"x": x["moe/x"], "gate_w": x["moe/gate_w"],
         **{k: x[f"moe/{k}"] for k in EXPERT_KEYS}}
    t = {k: torch.tensor(v, requires_grad=True) for k, v in t.items()}
    y, st = layer.apply_stateful({"gate": {"w": t["gate_w"]},
                                  **{k: t[k] for k in EXPERT_KEYS}}, {},
                                 t["x"], train=True)
    obj = (y * torch.tensor(x["moe/ct"])).sum() \
        + float(x["moe/aux_w"]) * st["aux"]
    grads = torch.autograd.grad(obj, list(t.values()))
    return (y.detach().numpy(), float(st["aux"].detach()),
            {k: g.numpy() for k, g in zip(t, grads)})


def _rank_grads(got):
    """A rank's grads by input name (its expert leaves: its rows)."""
    return {k[2:]: v for k, v in got.items() if k.startswith("d_")}


def _expert_rows(a, r):
    e = E // N
    return a[r * e:(r + 1) * e]


LAYER_CASES = {"nodrop": dict(seed=0, cf=float(E)),
               "skew": dict(seed=1, cf=0.5, skew=True),
               "aux_only": dict(seed=2, cf=float(E), aux_w=1.0, ct=False)}


def _ref_run(cfg, n_data, n_model, batches):
    mesh = make_mesh(n_data=n_data, n_model=n_model,
                     devices=jax.devices()[:n_data * n_model])
    jt = JaxBSPTrainer(JaxMoE({**cfg, "batch_size": cfg["batch_size"]
                               // n_data}), mesh=mesh,
                       recorder=JaxRecorder(verbose=False))
    jt.compile_iter_fns()
    jt.init_state()
    m1 = {k: float(v) for k, v in jt.train_iter(batches[0], LR).items()}
    p1 = _np(jt.params)
    m2 = {k: float(v) for k, v in jt.train_iter(batches[1], LR).items()}
    return [m1, m2], p1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    calls, layers = [], {}
    for name, kw in LAYER_CASES.items():
        layers[name] = _layer_inputs(**kw)
        (d / name).mkdir()
        np.savez(d / name / "in.npz", **layers[name])
        calls.append(("tp_layer_cases", (str(d / name / "in.npz"),
                                         str(d / name), ("moe",))))
    models, ref = {}, {}
    for tag, cfg, n_data in (("dryrun", {**DRYRUN, "moe_aux_weight": 0.0},
                              1),
                             ("two", {**TWO, "moe_aux_weight": 0.0}, 2)):
        jm = JaxMoE(dict(cfg))
        params, state = jm.init_params(jax.random.PRNGKey(1))
        gb = cfg["batch_size"]
        batches = list(jm.data.train_batches(gb, 0, seed=0))[:2]
        torch.save({"params": params_from_jax(_np(params)),
                    "state": {k: {"moe": {"aux": torch.zeros(())}}
                              for k in params if "moeblock" in k}},
                   d / f"{tag}.pt")
        np.savez(d / f"{tag}.npz", **{k: np.stack([b[k] for b in batches])
                                      for k in batches[0]})
        ref[tag] = _ref_run(cfg, n_data, N // n_data, batches)
        models[tag] = (cfg, n_data, _np(params))

    def job(tag, cfg, n_data, n_model, name):
        return {"modelfile": "theanompi_torch.models.transformer_lm",
                "modelclass": "MoETransformerLM",
                "model_config": {**cfg, "batch_size": cfg["batch_size"]
                                 // n_data},
                "rule_config": {"n_model": n_model, "verbose": False},
                "steps": 2, "init": str(d / f"{tag}.pt"),
                "batches": str(d / f"{tag}.npz"), "out": str(d / name)}

    for tag, (cfg, n_data, _) in models.items():
        calls.append(("tp_run", (job(tag, cfg, n_data, N // n_data, tag),)))
    # the default aux weight, the vocab-parallel loss, nothing dropping:
    # against one process
    own = {**DRYRUN, "capacity_factor": 8.0, "fused_loss": True}
    calls.append(("tp_run", (job("dryrun", own, 1, N, "own"),)))
    port = tdist.spawn(run_all, N, "gloo", "cpu", (calls,), timeout_s=900)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = tp_run("cpu", {**job("dryrun", own, 1, 1, "one"),
                             "rule_config": {"verbose": False}})
    finally:
        torch.set_num_threads(prev)
    return {"d": d, "layers": layers, "port": port, "ref": ref,
            "models": models, "one": one}


@pytest.mark.parametrize("case", ["nodrop", "skew"])
def test_index_dispatch_equals_the_dense_einsum(runs, case):
    x = runs["layers"][case]
    y, aux, g = _port_layer(x)
    ry, raux, rg = _ref_layer(x, 1)
    _close(y, ry, "y")
    _close(aux, raux, "aux")
    for k in g:
        _close(g[k], rg[k], k, floor=1e-6)
    if case == "skew":
        # one global pool: cap = ceil(32 * 0.5 / 4) = 4 of each expert
        kept = np.abs(y[0]).sum(-1) > 1e-9
        assert kept[:16].sum() == 4 and kept[16:].sum() == 4


def test_ep4_without_drops_is_the_one_rank_layer(runs):
    x = runs["layers"]["nodrop"]
    y, aux, g = _port_layer(x)
    ry, raux, _ = _ref_layer(x, N)
    for r in range(N):
        got = dict(np.load(runs["d"] / "nodrop" / f"moe-r{r}.npz"))
        _close(got["y"], ry, f"rank {r} y against the reference's ep4")
        _close(got["y"], y, f"rank {r} y against one rank")
        _close(float(got["aux"]), raux, "aux")
        _close(float(got["aux"]), aux, "aux")
        for k, v in _rank_grads(got).items():
            want = _expert_rows(g[k], r) if k in EXPERT_KEYS else g[k]
            _close(v, want, f"rank {r} d{k}", floor=1e-6)


def test_ep4_drop_regime_capacity_is_per_rank_chunk(runs):
    x = runs["layers"]["skew"]
    y1, _, _ = _port_layer(x)
    ry, _, _ = _ref_layer(x, N)
    kept1 = np.abs(y1[0]).sum(-1) > 1e-9
    for r in range(N):
        y4 = np.load(runs["d"] / "skew" / f"moe-r{r}.npz")["y"]
        _close(y4, ry, f"rank {r} y against the reference's ep4")
        kept4 = np.abs(y4[0]).sum(-1) > 1e-9
        # chunks of 8: cap = ceil(8 * 0.5 / 4) = 1 a chunk, so expert 0
        # keeps the first token of chunks 0 and 1 only, though the global
        # pool had room for 4
        assert kept4[:16].tolist() == [True] + [False] * 7 + [True] \
            + [False] * 7
        both = kept1 & kept4
        assert both.sum() > 0
        _close(y4[0][both], y1[0][both], "kept by both")


def test_aux_gradient_is_the_one_device_one(runs):
    """The objective is the aux alone: the reference's ep4 gate gradient
    is 4 times its one-device one; the port's ep4 one is the one-device
    one."""
    x = runs["layers"]["aux_only"]
    _, _, rg1 = _ref_layer(x, 1)
    _, _, rg4 = _ref_layer(x, N)
    np.testing.assert_allclose(rg4["gate_w"], N * rg1["gate_w"], rtol=1e-4,
                               atol=1e-7)
    _, _, g = _port_layer(x)
    _close(g["gate_w"], rg1["gate_w"], "one rank", floor=1e-6)
    for r in range(N):
        got = np.load(runs["d"] / "aux_only" / f"moe-r{r}.npz")
        _close(got["d_gate_w"], rg1["gate_w"], f"rank {r}", floor=1e-6)


@pytest.mark.parametrize("tag", ["dryrun", "two"])
def test_moe_transformer_against_the_reference_on_the_same_mesh(runs, tag):
    i = len(LAYER_CASES) + ["dryrun", "two"].index(tag)
    jm, jp1 = runs["ref"][tag]
    for r in range(N):
        mine = runs["port"][r][i]
        for step, (m, want) in enumerate(zip(mine["metrics"], jm)):
            assert m.keys() == want.keys() >= {"moe_aux"}
            for k in m:
                _close(m[k], want[k], f"rank {r} step {step} {k}")
    out = torch.load(runs["d"] / f"{tag}-r0.pt")
    mine, want = _flat(params_to_jax(out["params1"])), _flat(jp1)
    assert mine.keys() == want.keys()
    for k in mine:
        _close(mine[k], want[k], f"params after step 1 {k}")


def test_moe_transformer_equals_one_process_with_the_aux(runs):
    i = len(LAYER_CASES) + 2
    one = runs["one"]
    for r in range(N):
        mine = runs["port"][r][i]
        for m, want in zip(mine["metrics"], one["metrics"]):
            for k in m:
                _close(m[k], want[k], f"rank {r} {k}")
        np.testing.assert_allclose(mine["grad_norm"], one["grad_norm"],
                                   rtol=RTOL)
    a = torch.load(runs["d"] / "own-r0.pt")
    b = torch.load(runs["d"] / "one-r0.pt")
    for key in ("grads1", "params1", "params"):
        fa, fb = _flat(a[key]), _flat(b[key])
        for k in fa:
            _close(fa[k], fb[k], f"{key} {k}",
                   floor=1e-6 if key == "grads1" else 0.0)
    # two all-to-alls a block forward, two backward; the gathered params
    # bit-equal on every rank
    kinds = runs["port"][0][i]["per_step"][0]
    layers = DRYRUN["n_layers"]
    assert kinds["kinds"]["a2a"] == kinds["kinds"]["a2a_bwd"] == 2 * layers
    assert kinds["calls"]["all_to_all_single"] == 4 * layers
    assert len({tuple(runs["port"][r][i]["digests"]) for r in range(N)}) == 1


def test_param_specs_cut_the_experts_only():
    model = MoETransformerLM({**TWO, "fused_loss": True})
    params, state = model.init_params(torch.Generator().manual_seed(0))
    specs = model.param_specs(params)
    moe = specs["02__moeblock"]["moe"]
    assert {k: moe[k] for k in EXPERT_KEYS} == dict.fromkeys(EXPERT_KEYS, 0)
    assert moe["gate"]["w"] is None
    assert specs["02__moeblock"]["attn"]["q"]["w"] == 1
    assert specs["head"] == {"w": 1, "b": 0}  # vocab-parallel: fused loss
    assert state["02__moeblock"]["moe"]["aux"].shape == ()
    # the reference's table, key for key (the run fingerprint hashes it)
    mine, ref = MoETransformerLM.default_config, JaxMoE.default_config
    assert mine.keys() == ref.keys()
    for key in ("n_experts", "capacity_factor", "moe_aux_weight"):
        assert mine[key] == ref[key], key


def test_the_references_moe_head_is_whole_under_the_fused_loss():
    """The reference's MoE model keeps the head replicated (its
    ``param_specs`` skips ``_head_specs``) while ``loss_fn`` takes the
    vocab-parallel branch under a model axis; its dense model cuts it.
    The port cuts it in both."""
    from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM

    cfg = {**TWO, "fused_loss": True}
    shapes = jax.eval_shape(JaxMoE(dict(cfg)).init_params,
                            jax.random.PRNGKey(0))[0]
    assert JaxMoE(dict(cfg)).param_specs(shapes)["head"]["w"] == P()
    dense = jax.eval_shape(JaxLM(dict(cfg)).init_params,
                           jax.random.PRNGKey(0))[0]
    assert JaxLM(dict(cfg)).param_specs(dense)["head"]["w"] == P(
        None, "model")
    model = MoETransformerLM(dict(cfg))
    params, _ = model.init_params(torch.Generator().manual_seed(0))
    assert model.param_specs(params)["head"] == {"w": 1, "b": 0}
