"""The port's async rules at 4 gloo ranks against the reference's on the
4-device ``mesh4``, on the CPU.

The reference runs here; the port's ranks run in one module-scoped spawn
(``theanompi_torch.parallel.rank_jobs.run_all``) fed ``.npz`` and ``.pt``
files made from a numpy seed or from the reference's own init and
batches.

- the exchanges on per-rank inputs: EASGD's ``elastic_exchange``,
  LocalSGD's average, and ``gossip_merge`` at every shift 1..3 with all
  ranks pushing and with a mixed mask, under both transports (``p2p``,
  ``all_gather``), which must be bit-equal to each other;
- the gossip round draws equal to the reference's ``_round_draws`` for
  iterations 0..200 at n = 2, 4 and 8;
- the tiny WRN and the tiny ``TransformerLM`` through the ``EASGD`` (τ 2,
  the rule's default ``scale_lr``), ``LocalSGD`` (τ 2) and ``GOSGD``
  (default ``p_push``: rounds 1-3 push, round 4 has no pusher) rules, 4
  steps from the reference's init and batches: every rank's params, the
  center or the rank's weight, and the validation metrics on
  ``eval_args`` (the center, or the weighted consensus);
- both async rules refuse ``n_model``, ``n_seq`` and ``n_pipe`` above 1;
- the ranks import no JAX.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32, as the other parity tests.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from theanompi_tpu import EASGD as JaxEASGD
from theanompi_tpu import GOSGD as JaxGOSGD
from theanompi_tpu import LocalSGD as JaxLocalSGD
from theanompi_tpu.parallel.easgd import elastic_exchange as jax_elastic
from theanompi_tpu.parallel.gosgd import GOSGDTrainer as JaxGOSGDTrainer
from theanompi_tpu.parallel.gosgd import gossip_merge as jax_gossip
from theanompi_tpu.parallel.mesh import DATA_AXIS, shard_map
from theanompi_tpu.parallel.trainer import pmean_floats as jax_pmean

from theanompi_torch import EASGD, GOSGD
from theanompi_torch import dist as tdist
from theanompi_torch.convert import params_from_jax, state_from_jax
from theanompi_torch.convert import params_to_jax, state_to_jax
from theanompi_torch.parallel.easgd import EASGDTrainer
from theanompi_torch.parallel.gosgd import GOSGDTrainer, round_draws
from theanompi_torch.parallel.rank_jobs import run_all
from theanompi_torch.tree import tree_leaves_with_path

N = 4
RTOL, ATOL = 1e-5, 1e-6
STEPS = 4
WRN = {"depth": 10, "widen": 1, "batch_size": 4, "image_size": 8,
       "n_train": 64, "n_val": 16, "n_epochs": 1, "precision": "fp32",
       "augment": False, "lr": 0.05}
LM = {"n_layers": 2, "dim": 64, "heads": 2, "seq_len": 64, "vocab": 256,
      "batch_size": 2, "n_train": 32, "n_val": 8, "dropout": 0.0,
      "precision": "fp32", "attn_impl": "blockwise", "lr": 0.05,
      "momentum": 0.9, "grad_clip": 1.0, "n_epochs": 1}
MODELS = {"wrn": ("wide_resnet", "WideResNet", WRN),
          "lm": ("transformer_lm", "TransformerLM", LM)}
RULES = {"EASGD": (JaxEASGD, {"tau": 2}), "LocalSGD": (JaxLocalSGD,
                                                        {"tau": 2}),
         "GOSGD": (JaxGOSGD, {})}
TRAIN = [(m, r) for m in MODELS for r in RULES]
#: the exchange inputs: a worker tree per rank, a center, weights
SHAPES = {"a/w": (5, 3), "a/b": (7,), "conv/k": (3, 3, 2, 4)}
ALPHA = 0.1
MASKS = {"all": [1, 1, 1, 1], "mixed": [0, 1, 1, 0]}
GOSSIP = [(s, m) for s in (1, 2, 3) for m in MASKS]
TRANSPORTS = ("p2p", "all_gather")


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


def _close(mine, want, what):
    assert mine.keys() == want.keys(), what
    for k in mine:
        np.testing.assert_allclose(mine[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


def _ref_exchanges(mesh4, vals, center, weights):
    """The reference's elastic round, average and gossip rounds on mesh4;
    -> {name: (per-worker trees [n, ...], center or weights)}."""
    W = P(DATA_AXIS)
    sh = NamedSharding(mesh4, W)
    p = jax.device_put({k: v for k, v in vals.items()}, sh)
    unstack = lambda t: jax.tree.map(lambda x: x[0], t)  # noqa: E731
    restack = lambda t: jax.tree.map(lambda x: x[None], t)  # noqa: E731

    def elastic(p, c):
        new_p, new_c = jax_elastic(unstack(p), c, ALPHA)
        return restack(new_p), new_c

    def average(p):
        return restack(jax_pmean(unstack(p), DATA_AXIS))

    def gossip(p, w, push, shift):
        new_p, new_w = jax_gossip(unstack(p), unstack(w), push, shift, N)
        return restack(new_p), new_w[None]

    out = {}
    f = jax.jit(shard_map(elastic, mesh4, in_specs=(W, P()),
                          out_specs=(W, P())))
    out["elastic"] = _np(f(p, center))
    f = jax.jit(shard_map(average, mesh4, in_specs=(W,), out_specs=W))
    out["average"] = (_np(f(p)), None)
    f = jax.jit(shard_map(gossip, mesh4, in_specs=(W, W, P(), P()),
                          out_specs=(W, W)))
    for shift, mask in GOSSIP:
        out[f"gossip-{shift}-{mask}"] = _np(f(
            p, jax.device_put(weights, sh),
            jnp.asarray(MASKS[mask], jnp.float32), jnp.int32(shift)))
    return out


def _ref_rule(model, rule):
    """The reference rule through its facade on 4 devices: (its trainer,
    init params, init state, the global batches)."""
    mod, cls, cfg = MODELS[model]
    jcls, rcfg = RULES[rule]
    r = jcls(config={**rcfg, "seed": 0, "verbose": False})
    r.init(devices=N, modelfile=f"theanompi_tpu.models.{mod}",
           modelclass=cls, model_config=dict(cfg))
    t = r.trainer
    params0 = jax.tree.map(lambda x: np.asarray(x)[0], t.params)
    state0 = jax.tree.map(lambda x: np.asarray(x)[0], t.state)
    batches = list(t.model.data.train_batches(t.global_batch, 0,
                                              seed=0))[:STEPS]
    return t, params0, state0, batches


def _ref_train(t, batches, rule):
    """-> the reference's params, state, center or weights and
    validation metrics after its steps."""
    lr = t.model.adjust_hyperp(0)
    for b in batches:
        t.train_iter(b, lr)
    val = t.validate(0)
    extra = (_np(t.center) if rule != "GOSGD"
             else np.asarray(t.weights))
    return _np(t.params), _np(t.state), extra, val


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4):
    d = tmp_path_factory.mktemp("async4")
    rng = np.random.RandomState(0)
    vals = {k: rng.randn(N, *s).astype(np.float32)
            for k, s in SHAPES.items()}
    center = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    weights = rng.rand(N).astype(np.float32)
    weights /= weights.sum()
    ref_ex = _ref_exchanges(mesh4, vals, center, weights)
    np.savez(d / "exch.npz", w=weights,
             **{f"p/{k}": v for k, v in vals.items()},
             **{f"c/{k}": v for k, v in center.items()})
    cases = [("elastic", "elastic", ALPHA), ("average", "average")]
    cases += [(f"gossip-{s}-{m}-{t}", "gossip", MASKS[m], s, t)
              for s, m in GOSSIP for t in TRANSPORTS]
    calls = [("rule_exchange_cases", (str(d / "exch.npz"), str(d), cases))]
    trainers = {}
    for model, rule in TRAIN:
        mod, cls, cfg = MODELS[model]
        t, params0, state0, batches = _ref_rule(model, rule)
        name = f"{model}-{rule}"
        trainers[name] = (t, batches, rule)
        torch.save({"params": params_from_jax(params0),
                    "state": state_from_jax(state0)}, d / f"{name}.pt")
        np.savez(d / f"{name}.npz", **{k: np.stack([b[k] for b in batches])
                                       for k in batches[0]})
        calls.append(("async_run", ({
            "rule": rule, "modelfile": f"theanompi_torch.models.{mod}",
            "modelclass": cls, "model_config": dict(cfg),
            "rule_config": dict(RULES[rule][1]), "steps": STEPS,
            "init": str(d / f"{name}.pt"), "batches": str(d / f"{name}.npz"),
            "validate": True, "save_at": [STEPS],
            "out": str(d / name)},)))
    calls.append(("loaded_modules", (("jax", "jaxlib", "theanompi_tpu"),)))
    ref_train = {k: _ref_train(*v) for k, v in trainers.items()}
    port = tdist.spawn(run_all, N, "gloo", "cpu", (calls,), timeout_s=600)
    return {"d": d, "ref_ex": ref_ex, "ref_train": ref_train, "port": port,
            "calls": calls}


def _port_exchange(d, name, r):
    with np.load(d / f"{name}-r{r}.npz") as z:
        return {k: z[k] for k in z.files}


def test_elastic_exchange_against_the_reference(runs):
    ref_p, ref_c = runs["ref_ex"]["elastic"]
    for r in range(N):
        out = _port_exchange(runs["d"], "elastic", r)
        _close({k[2:]: v for k, v in out.items() if k.startswith("p/")},
               {k: v[r] for k, v in ref_p.items()}, f"rank {r} params")
        _close({k[2:]: v for k, v in out.items() if k.startswith("c/")},
               ref_c, f"rank {r} center")
        # the center is replicated: every rank's bit-equal to rank 0's
        first = _port_exchange(runs["d"], "elastic", 0)
        for k in out:
            if k.startswith("c/"):
                np.testing.assert_array_equal(out[k], first[k])


def test_localsgd_average_against_the_reference(runs):
    ref_p, _ = runs["ref_ex"]["average"]
    for r in range(N):
        out = _port_exchange(runs["d"], "average", r)
        _close({k[2:]: v for k, v in out.items()},
               {k: v[r] for k, v in ref_p.items()}, f"rank {r}")


@pytest.mark.parametrize("shift,mask", GOSSIP)
def test_gossip_merge_against_the_reference(runs, shift, mask):
    """Every rank's merged params and weight, under both transports,
    bit-equal to each other and within fp32 limits of the reference's;
    the weights still sum to 1."""
    ref_p, ref_w = runs["ref_ex"][f"gossip-{shift}-{mask}"]
    total = 0.0
    for r in range(N):
        outs = [_port_exchange(runs["d"], f"gossip-{shift}-{mask}-{t}", r)
                for t in TRANSPORTS]
        for k in outs[0]:
            np.testing.assert_array_equal(outs[0][k], outs[1][k],
                                          err_msg=f"transports, {k}")
        out = outs[0]
        _close({k[2:]: v for k, v in out.items() if k.startswith("p/")},
               {k: v[r] for k, v in ref_p.items()}, f"rank {r} params")
        np.testing.assert_allclose(out["w"], ref_w[r], rtol=RTOL, atol=0)
        total += float(out["w"])
    assert abs(total - 1.0) < 1e-6


@pytest.mark.parametrize("n", [2, 4, 8])
def test_round_draws_equal_the_reference(n):
    for p_push in (1.0 / n, 0.5):
        ref = SimpleNamespace(n_workers=n, seed=0, p_push=p_push)
        for it in range(201):
            push, shift = round_draws(0, it, n, p_push)
            jpush, jshift = JaxGOSGDTrainer._round_draws(ref, it)
            assert push.tolist() == jpush.tolist() and shift == jshift


@pytest.mark.parametrize("model,rule", TRAIN)
def test_four_steps_against_the_reference(runs, model, rule):
    name = f"{model}-{rule}"
    jparams, jstate, jextra, jval = runs["ref_train"][name]
    i = 1 + TRAIN.index((model, rule))
    assert runs["calls"][i][1][0]["out"].endswith(name)
    res = runs["port"]
    for r in range(N):
        out = torch.load(runs["d"] / f"{name}-r{r}-s{STEPS}.pt")
        _close(_flat(params_to_jax(out["params"])),
               _flat(jax.tree.map(lambda x, r=r: x[r], jparams)),
               f"rank {r} params")
        _close(_flat(state_to_jax(out["state"])),
               _flat(jax.tree.map(lambda x, r=r: x[r], jstate)),
               f"rank {r} state")
        if rule == "GOSGD":
            np.testing.assert_allclose(float(out["weights"]), jextra[r],
                                       rtol=RTOL, atol=0)
        else:
            _close(_flat(params_to_jax(out["center"])), _flat(jextra),
                   f"rank {r} center")
        val = res[r][i]["val"]
        assert set(val) == set(jval)
        for k in jval:
            np.testing.assert_allclose(val[k], jval[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)
    if rule == "GOSGD":
        weights = [res[r][i]["weights"] for r in range(N)]
        assert all(abs(sum(w[s] for w in weights) - 1) < 1e-6
                   for s in range(STEPS))
        # rounds 1-3 pushed, round 4 had no pusher: no collective
        assert [c > 0 for c in res[0][i]["comm_s"]] == [True] * 3 + [False]
    else:
        assert [c > 0 for c in res[0][i]["comm_s"]] == [False, True] * 2
        assert all(d > 0 for d in res[0][i]["drift"])
        assert len({res[r][i]["center_digests"][-1] for r in range(N)}) == 1
    # the workers differ between exchanges
    assert len({res[r][i]["digests"][0] for r in range(N)}) == N


@pytest.mark.parametrize("rule,trainer", [(EASGD, EASGDTrainer),
                                          (GOSGD, GOSGDTrainer)])
def test_async_rules_refuse_sharded_axes(rule, trainer):
    from theanompi_torch.models.wide_resnet import WideResNet

    for key, axis in (("n_model", "model"), ("n_seq", "seq"),
                      ("n_pipe", "pipe")):
        with pytest.raises(ValueError, match=f"data-parallel only: mesh "
                           f"axis '{axis}' has size 2"):
            rule({key: 2}).init(devices=1, device="cpu",
                                modelfile="theanompi_torch.models."
                                "wide_resnet", modelclass="WideResNet",
                                model_config=dict(WRN))
        with pytest.raises(ValueError, match="data-parallel only"):
            trainer(WideResNet(dict(WRN)), device="cpu", **{key: 2})
    # at 1 the axes shard nothing, and the rule trains
    rule({"n_model": 1, "verbose": False}).init(
        devices=1, device="cpu", modelfile="theanompi_torch.models."
        "wide_resnet", modelclass="WideResNet", model_config=dict(WRN))


def test_the_ranks_import_no_jax(runs):
    assert all(r[-1] == [] for r in runs["port"])
