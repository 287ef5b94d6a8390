"""The port's training slice against the reference, on the CPU.

A tiny ``TransformerLM`` (2 layers, dim 64, 2 heads, T=64, batch 2, fp32)
with the reference's ``init_params`` weights (through ``params_from_jax``)
and the same batch on both sides: the loss, every grad leaf, the params
after one SGD step and the loss after three steps, for

- (a) ``attn_impl="pallas"`` on both sides — the reference's Pallas
  kernels interpreted, the port's plain versions of kernels 1-3 — at vocab
  8192, so the fused chunked loss is on;
- (b) ``attn_impl="blockwise"``, vocab 256, the plain head and loss.

Also: ``n_subb=2`` equals the full batch; ``BSP().init(...)`` on
``device="cpu"`` trains 2 epochs through ``.wait()`` and validates below
its first train loss; the default configs agree; unported rule keys
raise, and the exchange's ``zero1``, overlap and ramp keys, the
prefetcher's and the token stream are not among them.

Tolerance: rtol 1e-5 / atol 1e-6 in fp32 unless a reason is written.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from theanompi_tpu.models.transformer_lm import TransformerLM as JaxLM

from theanompi_torch import BSP
from theanompi_torch.convert import params_from_jax
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.parallel.trainer import (
    NOT_PORTED_KEYS,
    loss_and_grads,
    make_train_step,
)
from theanompi_torch.parallel.exchanger import Exchanger
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils.helper_funcs import to_device

RTOL, ATOL = 1e-5, 1e-6
TINY = {"n_layers": 2, "dim": 64, "heads": 2, "seq_len": 64,
        "batch_size": 2, "dropout": 0.0, "precision": "fp32",
        "n_train": 8, "n_val": 4, "lr": 0.05, "momentum": 0.9,
        "grad_clip": 1.0}
VARIANTS = {"pallas-fused": {"attn_impl": "pallas", "vocab": 8192},
            "blockwise": {"attn_impl": "blockwise", "vocab": 256}}


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _flat(tree):
    return {"/".join(p): np.asarray(x) for p, x in tree_leaves_with_path(
        jax.tree.map(np.asarray, tree))}


def _assert_tree(t_tree, j_tree, what):
    ref = _flat(j_tree)
    mine = {"/".join(p): x.detach().numpy()
            for p, x in tree_leaves_with_path(t_tree)}
    assert mine.keys() == ref.keys(), what
    for k, x in mine.items():
        np.testing.assert_allclose(x, ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    cfg = {**TINY, **VARIANTS[request.param]}
    jm = JaxLM(dict(cfg))
    jp, js = jm.init_params(jax.random.PRNGKey(1))
    tm = TransformerLM(dict(cfg))
    assert tm.fused_loss_enabled() == jm.fused_loss_enabled()
    batches = list(jm.data.train_batches(cfg["batch_size"], 0, seed=0))
    return jm, jp, js, tm, params_from_jax(jax.tree.map(np.asarray, jp)), \
        batches


def _jax_step(jm, opt, p, s, batch, lr):
    """The reference's local step without a mesh: value_and_grad of
    ``loss_fn`` (dropout off, so no rng), then ``opt.update``."""
    def lossw(p):
        return jm.loss_fn(p, {}, batch, None, train=True)

    (loss, (_, metrics)), g = jax.value_and_grad(lossw, has_aux=True)(p)
    new_p, new_s = opt.update(g, s, p, jnp.float32(lr))
    return loss, metrics, g, new_p, new_s


def test_loss_metrics_and_every_grad_leaf(pair):
    jm, jp, _, tm, tp, batches = pair
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    loss, metrics, g, _, _ = _jax_step(jm, jm.build_optimizer(), jp,
                                       jm.build_optimizer().init(jp), jb,
                                       0.05)
    _, tmet, tg = loss_and_grads(tm, tp, {}, to_device(batches[0], "cpu"),
                                 None)
    np.testing.assert_allclose(float(tmet["cost"]), float(loss), rtol=RTOL,
                               atol=ATOL)
    for k in ("error", "error_top5", "perplexity"):
        np.testing.assert_allclose(float(tmet[k]), float(metrics[k]),
                                   rtol=RTOL, atol=ATOL)
    _assert_tree(tg, g, "grad")


def test_params_after_one_step_and_loss_after_three(pair):
    jm, jp, _, tm, tp, batches = pair
    lr = TINY["lr"]
    jo = jm.build_optimizer()
    js = jo.init(jp)
    step = make_train_step(tm, tm.build_optimizer(), Exchanger("psum"), 0,
                           torch.device("cpu"))
    ts = tm.init_opt_state(tm.build_optimizer(), tp)
    for i in range(3):
        jb = {k: jnp.asarray(v) for k, v in batches[i].items()}
        jloss, _, _, jp, js = _jax_step(jm, jo, jp, js, jb, lr)
        tp, _, ts, tmet = step(tp, {}, ts, to_device(batches[i], "cpu"), lr,
                               i)
        np.testing.assert_allclose(float(tmet["cost"]), float(jloss),
                                   rtol=RTOL, atol=ATOL)
        if i == 0:
            _assert_tree(tp, jp, "params after one step")
    # the loss after three steps, on the next batch
    jb = {k: jnp.asarray(v) for k, v in batches[3].items()}
    jl, _ = jm.loss_fn(jp, {}, jb, None, train=False)
    tl, _ = tm.loss_fn(tp, {}, to_device(batches[3], "cpu"), None,
                       train=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_n_subb_2_equals_the_full_batch(variant):
    cfg = {**TINY, **VARIANTS[variant], "batch_size": 4}
    full = TransformerLM(dict(cfg))
    micro = TransformerLM({**cfg, "n_subb": 2})
    params, state = full.init_params(torch.Generator().manual_seed(3))
    batch = to_device(next(full.data.train_batches(4, 0, seed=0)), "cpu")
    outs = []
    for model in (full, micro):
        step = make_train_step(model, model.build_optimizer(),
                               Exchanger("psum"), 0, torch.device("cpu"))
        outs.append(step(params, state, model.init_opt_state(
            model.build_optimizer(), params), batch, 0.05, 0))
    (pf, _, _, mf), (pm, _, _, mm) = outs
    for k in ("cost", "error", "perplexity"):
        np.testing.assert_allclose(float(mm[k]), float(mf[k]), rtol=RTOL,
                                   atol=ATOL)
    for (path, a), (_, b) in zip(tree_leaves_with_path(pm),
                                 tree_leaves_with_path(pf)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg="/".join(path))


def test_bsp_trains_two_epochs_on_cpu_through_wait():
    cfg = {**TINY, "vocab": 256, "batch_size": 8, "n_train": 64,
           "n_val": 16, "n_epochs": 2, "dropout": 0.1}
    rule = BSP({"print_freq": 4, "seed": 3, "verbose": False}).init(
        devices=1, model_config=cfg, device="cpu")
    assert rule.trainer.device == torch.device("cpu")
    assert all(x.device.type == "cpu"
               for _, x in tree_leaves_with_path(rule.trainer.params))
    rec = rule.wait()
    assert rule.trainer.iteration == 16 and rec.val_history["epoch"] == [0, 1]
    first_train = rec.train_history["cost"][0]
    assert all(np.isfinite(rec.train_history["cost"]))
    assert rec.val_history["cost"][-1] < first_train
    assert np.isclose(rec.val_history["perplexity"][-1],
                      np.exp(rec.val_history["cost"][-1]))


def test_rule_refuses_what_it_does_not_carry():
    cfg = {**TINY, "vocab": 64}
    for key in ("telemetry_dir", "fault_plan", "profile_dir"):
        assert key in NOT_PORTED_KEYS
        with pytest.raises(NotImplementedError, match="not yet ported"):
            BSP({key: "x"}).init(devices=1, model_config=cfg, device="cpu")
    # the checkpoint keys are carried: they reach the trainer
    for key in ("checkpoint_dir", "checkpoint_keep", "checkpoint_async",
                "checkpoint_verify", "checkpoint_every_n_iters", "resume",
                "resume_force"):
        assert key not in NOT_PORTED_KEYS
    assert "resume_reshard" in NOT_PORTED_KEYS
    # the exchange's sharded update, overlap and ramp, and the
    # prefetcher, are carried: their keys reach the trainer, which refuses
    # only what the reference does
    for key in ("exch_overlap", "exch_ramp", "prefetch",
                "prefetch_stall_timeout"):
        assert key not in NOT_PORTED_KEYS
    tr = BSP({"prefetch": 3, "prefetch_stall_timeout": 9}).init(
        devices=1, model_config=cfg, device="cpu").trainer
    assert (tr.prefetch_depth, tr.prefetch_stall_timeout) == (3, 9.0)
    rule = BSP({"exch_strategy": "zero1"}).init(devices=1, model_config=cfg,
                                                device="cpu")
    assert rule.trainer.exchanger.fuses_update
    with pytest.raises(ValueError, match="not bucketed"):
        BSP({"exch_overlap": True}).init(devices=1, model_config=cfg,
                                         device="cpu")
    with pytest.raises(ValueError, match="zero1"):
        BSP({"exch_strategy": "zero1", "exch_ramp": "ring_int8:1"}).init(
            devices=1, model_config=cfg, device="cpu")
    # the token stream is carried too
    assert type(TransformerLM({**cfg, "dataset": "stream"}).data
                ).__name__ == "StreamTokenDataset"


def test_default_configs_agree_on_every_key_the_port_reads():
    mine, ref = TransformerLM.default_config, JaxLM.default_config
    for key in ("batch_size", "n_epochs", "lr", "momentum", "grad_clip",
                "seq_len", "dim", "heads", "n_layers", "dropout",
                "attn_impl", "dataset"):
        assert mine[key] == ref[key], key
    # the same key set (the run fingerprint hashes the whole config);
    # the keys the reference reads with a default rather than from its
    # table are read so here too
    assert mine.keys() == ref.keys()
    assert "fused_loss" not in mine and "vocab" not in mine
    assert TransformerLM(dict(TINY)).fused_loss_enabled() is False
    assert TransformerLM({**TINY, "vocab": 8192}).fused_loss_enabled()
    assert mine["dropout"] == 0.1
    # serving still runs with dropout off: train=False never drops
    m = TransformerLM({**TINY, "vocab": 64, "dropout": 0.5})
    p, _ = m.init_params(torch.Generator().manual_seed(0))
    toks = torch.arange(32).reshape(2, 16) % 64
    a = m.apply_logits(p, toks)
    assert torch.equal(a, m.apply_logits(p, toks))
