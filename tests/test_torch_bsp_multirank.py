"""The port's BSP at 4 gloo ranks against the reference's ``BSPTrainer``
on the 4-device ``mesh4``, on the CPU.

The reference runs here; the port's ranks run in one module-scoped spawn
(``theanompi_torch.parallel.rank_jobs.run_all``), fed ``.pt`` and
``.npz`` files: the reference's initial params and state converted
(``params_from_jax``/``state_from_jax``) and its global batches.  Each
rank trains on its rows of each global batch, as the ``data`` axis shards
them.

- (e) two steps of the tiny WRN (batch 2 a rank) with sync-BN (the BSP
  rule sets ``bn_axis="data"`` above one worker; the reference is given
  it) and of the tiny ``TransformerLM`` (batch 2 a rank, T 64), at
  ``psum``, ``psum_bucket`` and ``ring_int8``: every step's metrics, the
  params and the BN state after two steps, and every rank equal to rank
  0.  fp32 rtol 1e-5 / atol 1e-6, as the single-process parity tests;
  ``ring_int8`` within the reference's 5e-2 (its stochastic rounding
  draws from other streams on the two sides);
- (f) without sync-BN (``bn_axis=None``) the BN state after two steps is
  the rank mean, against the reference's (its ``exchange_run`` fixture);
- 4 ranks with sync-BN equal one process at the global batch, the port
  against itself (what ``chip_smoke.py``'s phase 6 holds on the card);
- (g) ``launcher --devices 2 --device cpu`` trains the tiny WRN to its
  final validation line, printing from rank 0 only;
- a rank's rows of each dataset's batches are the rows of the global
  batch, and ``ImageNetData`` reads no shard a rank does not need;
- ``Rule.init(devices=N)`` outside a group of N ranks is refused.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM
from theanompi_tpu.models.wide_resnet import WideResNet as JaxWRN
from theanompi_tpu.parallel.bsp import BSPTrainer as JaxBSPTrainer
from theanompi_tpu.utils.recorder import Recorder as JaxRecorder

from theanompi_torch import BSP
from theanompi_torch import dist as tdist
from theanompi_torch.convert import (
    params_from_jax,
    params_to_jax,
    state_from_jax,
    state_to_jax,
)
from theanompi_torch.parallel.rank_jobs import bsp_run, run_all
from theanompi_torch.tree import tree_leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
RTOL, ATOL = 1e-5, 1e-6
INT8_TOL = 5e-2
LR = 0.05
WRN = {"depth": 10, "widen": 1, "batch_size": 2, "image_size": 8,
       "n_train": 32, "n_val": 16, "n_epochs": 1, "precision": "fp32",
       "augment": False, "lr": LR}
LM = {"n_layers": 2, "dim": 64, "heads": 2, "seq_len": 64, "vocab": 256,
      "batch_size": 2, "n_train": 16, "n_val": 8, "dropout": 0.0,
      "precision": "fp32", "attn_impl": "blockwise", "lr": LR,
      "momentum": 0.9, "grad_clip": 1.0, "n_epochs": 1}
MODELS = {"wrn": ("theanompi_torch.models.wide_resnet", "WideResNet", WRN,
                  JaxWRN),
          "lm": ("theanompi_torch.models.transformer_lm", "TransformerLM",
                 LM, JaxLM)}
CASES = [(m, s) for m in MODELS for s in ("psum", "psum_bucket",
                                           "ring_int8")]
#: the tiny WRN as the reference's ``exchange_run`` fixture trains it
#: (``tests/conftest.py``: EXCHANGE_TINY, lr 0.05, no sync-BN)
EXCHANGE_TINY = {"depth": 10, "widen": 1, "batch_size": 2, "image_size": 8,
                 "n_train": 32, "n_val": 16, "n_epochs": 1,
                 "precision": "fp32", "augment": False, "verbose": False}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {"/".join(p): np.asarray(x) for p, x in tree_leaves_with_path(
        tree)}


def _assert_close(port, ref, what, tol=None):
    """Leaf by leaf: rtol 1e-5 / atol 1e-6, or ``tol`` for both."""
    mine, want = _flat(port), _flat(_np(ref))
    assert mine.keys() == want.keys(), what
    rtol, atol = (RTOL, ATOL) if tol is None else (tol, tol)
    for k, x in mine.items():
        np.testing.assert_allclose(x, want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _write_inputs(d, name, params, state, batches):
    torch.save({"params": params_from_jax(_np(params)),
                "state": state_from_jax(_np(state))}, d / f"{name}.pt")
    np.savez(d / f"{name}.npz", **{k: np.stack([b[k] for b in batches])
                                   for k in batches[0]})


def _job(model, strategy, d, name):
    """Two steps of ``model`` from the files ``_write_inputs`` wrote."""
    modelfile, modelclass, cfg, _ = MODELS[model]
    return {"modelfile": modelfile, "modelclass": modelclass,
            "model_config": dict(cfg),
            "rule_config": {"exch_strategy": strategy, "verbose": False},
            "steps": 2, "init": str(d / f"{name}.pt"),
            "batches": str(d / f"{name}.npz"), "out": str(d / name)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, mesh4, exchange_run):
    """The reference's runs on mesh4 and the port's 4 ranks, one spawn."""
    d = tmp_path_factory.mktemp("bsp4")
    ref, calls = {}, []
    for model, strategy in CASES:
        _, _, cfg, jcls = MODELS[model]
        if model == "wrn":
            cfg = {**cfg, "bn_axis": "data"}
        jt = JaxBSPTrainer(jcls(dict(cfg)), mesh=mesh4,
                           exch_strategy=strategy,
                           recorder=JaxRecorder(verbose=False))
        jt.compile_iter_fns()
        jt.init_state()
        name = f"{model}-{strategy}"
        batches = list(jt.model.data.train_batches(jt.global_batch, 0,
                                                   seed=0))[:2]
        _write_inputs(d, name, jt.params, jt.state, batches)
        metrics = [{k: float(v) for k, v in jt.train_iter(b, LR).items()}
                   for b in batches]
        ref[name] = (metrics, _np(jt.params), _np(jt.state))
        calls.append(("bsp_run", (_job(model, strategy, d, name),)))
    # (f): the reference's exchange_run, no sync-BN
    jt, jparams = exchange_run(mesh4, "psum")
    init_p, init_s = JaxWRN(dict(EXCHANGE_TINY)).init_params(
        jax.random.PRNGKey(1))
    batches = list(jt.model.data.train_batches(jt.global_batch, 0,
                                               seed=0))[:2]
    _write_inputs(d, "nosync", init_p, init_s, batches)
    ref["nosync"] = (None, jparams, _np(jt.state))
    calls.append(("bsp_run", ({**_job("wrn", "psum", d, "nosync"),
                               "model_config": {**EXCHANGE_TINY, "lr": LR,
                                                "bn_axis": None}},)))
    # the global-batch run: 4 ranks with sync-BN, validated
    glob = {"modelfile": MODELS["wrn"][0], "modelclass": "WideResNet",
            "model_config": dict(WRN), "steps": 3, "validate": True,
            "rule_config": {"exch_strategy": "ring_bucket",
                            "verbose": False},
            "out": str(d / "global")}
    calls.append(("bsp_run", (glob,)))
    calls.append(("loaded_modules", (("jax", "jaxlib", "theanompi_tpu"),)))
    port = tdist.spawn(run_all, N, "gloo", "cpu", (calls,), timeout_s=900)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        one = bsp_run("cpu", {**glob, "model_config": {
            **WRN, "batch_size": WRN["batch_size"] * N},
            "out": str(d / "global1")})
    finally:
        torch.set_num_threads(prev)
    return {"d": d, "ref": ref, "port": port, "one": one}


def _load(d, name, r):
    return torch.load(d / f"{name}-r{r}.pt")


@pytest.mark.parametrize("model,strategy", CASES)
def test_two_steps_against_the_reference(runs, model, strategy):
    d, name = runs["d"], f"{model}-{strategy}"
    metrics, jparams, jstate = runs["ref"][name]
    i = CASES.index((model, strategy))
    mine = runs["port"][0][i]
    tol = INT8_TOL if strategy == "ring_int8" else None
    assert len(mine["metrics"]) == 2
    for step, (m, jm) in enumerate(zip(mine["metrics"], metrics)):
        assert m.keys() == jm.keys()
        for k in m:
            if tol is None or step == 0:
                np.testing.assert_allclose(m[k], jm[k], rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"step {step} {k}")
            elif k != "error":
                # (an error rate over 8 examples moves in steps of 1/8:
                # after a step through int8 rounding only the losses are
                # held to the tolerance)
                np.testing.assert_allclose(m[k], jm[k], rtol=tol,
                                           atol=tol, err_msg=k)
    out = _load(d, name, 0)
    _assert_close(params_to_jax(out["params"]), jparams, "params", tol)
    _assert_close(state_to_jax(out["state"]), jstate, "state", tol)
    if model == "wrn":
        assert _flat(state_to_jax(out["state"])), "the WRN has BN state"
    for r in range(1, N):
        other = _load(d, name, r)
        for key in ("params", "state"):
            for (p, a), (_, b) in zip(tree_leaves_with_path(out[key]),
                                      tree_leaves_with_path(other[key])):
                assert torch.equal(a, b), (r, key, p)


def test_state_is_the_rank_mean_without_sync_bn(runs):
    _, jparams, jstate = runs["ref"]["nosync"]
    out = _load(runs["d"], "nosync", 0)
    _assert_close(params_to_jax(out["params"]), jparams, "params")
    _assert_close(state_to_jax(out["state"]), jstate, "state")
    first = runs["port"][0][len(CASES)]
    assert first["global_batch"] == N * EXCHANGE_TINY["batch_size"]


def test_ranks_equal_one_process_at_the_global_batch(runs):
    """Sync-BN normalizes over the global batch and the exchange averages
    the ranks' grads of their shares of the mean loss, so 4 ranks of
    batch 2 take one process's steps at batch 8 (fp32 sums in another
    order)."""
    many, one = runs["port"][0][len(CASES) + 1], runs["one"]
    assert many["global_batch"] == one["global_batch"] == 8
    for a, b in zip(many["metrics"], one["metrics"]):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=ATOL)
    for k in many["val"]:
        np.testing.assert_allclose(many["val"][k], one["val"][k],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(many["grad_norm"], one["grad_norm"],
                               rtol=RTOL)
    a, b = _load(runs["d"], "global", 0), _load(runs["d"], "global1", 0)
    for key in ("params1", "state1", "params", "state"):
        for (p, x), (_, y) in zip(tree_leaves_with_path(a[key]),
                                  tree_leaves_with_path(b[key])):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{key} {p}")
    assert many["wire_bytes"] > 0 and one["wire_bytes"] == 0
    # the ranks import no JAX
    assert [res[-1] for res in runs["port"]] == [[]] * N


def test_launcher_devices_2_trains_the_tiny_wrn_on_cpu():
    argv = [sys.executable, "-m", "theanompi_torch.launcher", "--devices",
            "2", "--device", "cpu", "--modelfile",
            "theanompi_torch.models.wide_resnet", "--modelclass",
            "WideResNet", "--rule-set", "print_freq=2"]
    for k, v in {"depth": 10, "widen": 1, "image_size": 8,
                 "batch_size": 4, "n_train": 32, "n_val": 16,
                 "n_epochs": 1, "precision": "fp32"}.items():
        argv += ["--set", f"{k}={v!r}"]
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    # global batch 8: 4 steps, printed every 2, by rank 0 alone
    assert sum(line.startswith("iter ") for line in lines) == 2, r.stdout
    done = [line for line in lines if line.startswith(
        "tmlauncher: done. final val: ")]
    assert len(done) == 1 and "'cost'" in done[0]
    # more ranks than the group can have on the card: a config error
    assert subprocess.run(
        [sys.executable, "-m", "theanompi_torch.launcher", "--devices",
         "0", "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        timeout=120).returncode == 78


def _datasets():
    from theanompi_torch.models.data.cifar10 import Cifar10Data
    from theanompi_torch.models.data.imagenet import ImageNetData
    from theanompi_torch.models.lstm import PTBData

    return {
        "imagenet": lambda: ImageNetData({
            "image_size": 16, "n_classes": 5, "n_train": 40, "n_val": 24,
            "shard_size": 6}),
        "cifar-augment": lambda: Cifar10Data({"n_train": 40, "n_val": 24,
                                              "image_size": 8}),
        "cifar-plain": lambda: Cifar10Data({"n_train": 40, "n_val": 24,
                                            "image_size": 8,
                                            "augment": False}),
        "ptb": lambda: PTBData({"n_train": 40, "n_val": 24, "seq_len": 6,
                                "vocab": 11}),
    }


@pytest.mark.parametrize("name", ["imagenet", "cifar-augment",
                                  "cifar-plain", "ptb"])
def test_a_ranks_rows_are_the_global_batchs(name):
    data = _datasets()[name]()
    full = list(data.train_batches(8, 1, seed=3, start_batch=1))
    vfull = list(data.val_batches(8))
    assert len(full) == 4 and len(vfull) == 3
    for lo, hi in ((0, 2), (2, 4), (6, 8)):
        part = list(data.train_batches(8, 1, seed=3, start_batch=1,
                                       rows=(lo, hi)))
        vpart = list(data.val_batches(8, rows=(lo, hi)))
        for whole, mine in ((full, part), (vfull, vpart)):
            assert len(mine) == len(whole)
            for a, b in zip(whole, mine):
                for k in a:
                    np.testing.assert_array_equal(a[k][lo:hi], b[k])


def test_imagenet_reads_only_the_shards_a_rank_needs(monkeypatch):
    from theanompi_torch.models.data import imagenet

    data = imagenet.ImageNetData({"image_size": 16, "n_classes": 5,
                                  "n_train": 48, "n_val": 8,
                                  "shard_size": 4})
    loads = []
    real = imagenet._SyntheticShards.load
    monkeypatch.setattr(imagenet._SyntheticShards, "load",
                        lambda self, i: loads.append(i) or real(self, i))
    # shards of 4, global batches of 8: rank 0 of 2 needs every other one
    list(data.train_batches(8, 0, rows=(0, 4)))
    assert len(loads) == 6
    loads.clear()
    list(data.train_batches(8, 0))
    assert len(loads) == 12


def test_rule_init_refuses_a_worker_count_it_is_not_run_with():
    with pytest.raises(ValueError, match="devices=2 in a run of 1 rank"):
        BSP().init(devices=2, model_config={**LM, "n_train": 8},
                   device="cpu")
