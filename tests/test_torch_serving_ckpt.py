"""Serving a trained checkpoint: the port's read-only verified restore,
held against the reference's.

- ``load_for_inference`` verifies and writes nothing: the directory's
  listing, sizes and mtimes are unchanged after a load (a ``dirty``
  marker and crash debris included); a corrupt newest epoch is stepped
  over and left in place; an all-corrupt chain raises, nothing moved; a
  fingerprint mismatch (model class and config sha only) raises and
  ``force`` warns; a missing or empty directory gives None;
- interop both ways: a checkpoint of the reference's ``Checkpointer``
  served by the port's engine, one of the port's launcher served by the
  reference's engine; each engine's first-token logits against the other
  package's on the same directory within rtol 1e-5 / atol 1e-6 (fp32),
  and greedy streams equal;
- ``swap_params`` under int8 re-quantizes exactly as a fresh engine does
  (bit-equal), ``restore_params`` puts the previous tree back as it was;
  against the reference's re-quantized tree: the same leaves, scales
  within rtol 1e-6, payloads within one rounding step (stochastic
  rounding draws from each package's own generator);
- ``python -m theanompi_torch.serving``'s exit codes 0, 77 and 78.

Weights: the session ``dense_model`` (the reference's tiny
``TransformerLM``, lightly trained so greedy argmaxes are decided),
converted with ``params_from_jax``.  Every engine runs ``device="cpu"``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from theanompi_tpu.ops.quant import QuantizedTensor as JaxQT
from theanompi_tpu.serving import InferenceEngine as JaxEngine
from theanompi_tpu.serving import Request as JaxRequest
from theanompi_tpu.serving import Scheduler as JaxScheduler
from theanompi_tpu.serving import run_open_loop as jax_run_open_loop
from theanompi_tpu.utils import checkpoint as JC

from theanompi_torch.convert import params_from_jax
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.ops.quant import QuantizedTensor
from theanompi_torch.serving import (
    BlockPool,
    InferenceEngine,
    Request,
    Scheduler,
    blocks_for,
    run_open_loop,
)
from theanompi_torch.serving.cli import main as serve_main
from theanompi_torch.tree import tree_leaves_with_path
from theanompi_torch.utils import checkpoint as C

from chip_smoke import flip_leaf_byte
from conftest import SERVING_TINY

VOCAB = SERVING_TINY["vocab"]
GEOMETRY = dict(block_size=4, max_batch=4, num_blocks=21, seed=0)
#: fp32 logits of the two packages' engines on the same weights
RTOL, ATOL = 1e-5, 1e-6
#: the CLI flags that reproduce SERVING_TINY (the fingerprint's config)
_SETS = [a for k, v in SERVING_TINY.items() for a in ("--set", f"{k}={v!r}")]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port_model(dense_model):
    _, params, _ = dense_model
    return (TransformerLM(dict(SERVING_TINY)),
            params_from_jax(jax.tree.map(np.asarray, params)))


def _fingerprint(model):
    return {"mesh": {"data": 1, "pipe": 1, "model": 1, "seq": 1},
            "exchange": "psum", "n_subb": 1, **C.model_fingerprint(model)}


def _port_publish(d, model, params, epoch, shift=0.0):
    """One epoch published by the port's checkpointer, the trainer's way
    (a writer holds the ``dirty`` marker until it exits cleanly)."""
    ck = C.Checkpointer(d, fingerprint=_fingerprint(model))
    trees = {"params": _shifted(params, shift)}
    ck.save(epoch, 10 * (epoch + 1), trees).join()
    return trees


def _shifted(params, shift):
    from theanompi_torch.tree import tree_map

    return tree_map(lambda t: t + shift, params)


def _listing(d):
    """Every file under ``d``: (relative path, size, mtime_ns)."""
    out = []
    for root, _, files in os.walk(d):
        for f in files:
            st = os.stat(os.path.join(root, f))
            out.append((os.path.relpath(os.path.join(root, f), d),
                        st.st_size, st.st_mtime_ns))
    return sorted(out)


def _leaves(tree):
    return {"/".join(map(str, p)): x for p, x in tree_leaves_with_path(tree)}


def _prompts(seed, n, length):
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(0, VOCAB, length)] for _ in range(n)]


def _streams(engine, scheduler_cls, request_cls, run, prompts, new_tokens):
    reqs = [request_cls(rid=i, prompt=list(p), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    results, _ = run(scheduler_cls(engine), reqs)
    return {i: list(r.generated) for i, r in results.items()}


def _first_logits(engine, prompt, to_numpy):
    row = BlockPool(engine.num_blocks).alloc(
        blocks_for(len(prompt), engine.block_size))
    _, last = engine.prefill(row, prompt, 0.0, 0)
    return to_numpy(last)


# -- the read-only chain ------------------------------------------------------

def test_load_is_verified_and_writes_nothing(tmp_path, port_model):
    model, params = port_model
    d = str(tmp_path / "ck")
    _port_publish(d, model, params, 0)
    saved = _port_publish(d, model, params, 1, shift=0.5)
    # what a live writer leaves: its dirty marker and in-flight debris
    for f in ("dirty", "ckpt_e0002.tmp.npz", "ckpt_e0003.manifest.json"):
        with open(os.path.join(d, f), "w") as fh:
            fh.write("x")
    before = _listing(d)
    got = C.load_for_inference(d, {"params": params}, verify="full",
                               model=model)
    assert _listing(d) == before
    epoch, it, trees = got
    assert (epoch, it) == (1, 20)
    want, have = _leaves(saved["params"]), _leaves(trees["params"])
    assert want.keys() == have.keys()
    for k in want:
        assert torch.equal(want[k], have[k]), k
    with pytest.raises(RuntimeError, match="read-only"):
        C.Checkpointer(d, read_only=True).save(2, 30, saved)
    assert _listing(d) == before


def test_corrupt_newest_is_stepped_over_and_left_in_place(tmp_path,
                                                          port_model,
                                                          capsys):
    model, params = port_model
    d = str(tmp_path / "ck")
    first = _port_publish(d, model, params, 0)
    _port_publish(d, model, params, 1, shift=0.5)
    flip_leaf_byte(os.path.join(d, "ckpt_e0001.npz"), "params::head/w.npy")
    before = _listing(d)
    epoch, _, trees = C.load_for_inference(d, {"params": params},
                                           verify="full", model=model)
    assert epoch == 0
    assert torch.equal(trees["params"]["head"]["w"],
                       first["params"]["head"]["w"])
    assert _listing(d) == before
    assert not os.path.exists(os.path.join(d, "corrupt"))
    assert not os.path.exists(os.path.join(d, "resilience.json"))
    assert "left in place" in capsys.readouterr().err


def test_all_corrupt_raises_chain_exhausted_nothing_moved(tmp_path,
                                                          port_model):
    model, params = port_model
    d = str(tmp_path / "ck")
    for ep in (0, 1):
        _port_publish(d, model, params, ep)
        flip_leaf_byte(os.path.join(d, f"ckpt_e{ep:04d}.npz"))
    before = _listing(d)
    with pytest.raises(C.CheckpointChainExhausted, match="left in place"):
        C.load_for_inference(d, {"params": params}, verify="full",
                             model=model)
    assert _listing(d) == before


def test_fingerprint_mismatch_raises_and_force_warns(tmp_path, port_model,
                                                     capsys):
    model, params = port_model
    d = str(tmp_path / "ck")
    _port_publish(d, model, params, 0)
    # the same shapes under another config: only the sha tells them apart
    other = TransformerLM({**SERVING_TINY, "n_train": 128})
    with pytest.raises(C.CheckpointFingerprintError,
                       match="different model class/config"):
        C.load_for_inference(d, {"params": params}, model=other)
    got = C.load_for_inference(d, {"params": params}, model=other,
                               force=True)
    assert got[0] == 0
    assert "WARNING" in capsys.readouterr().err
    # the training keys of the manifest (mesh, exchange) are not compared
    assert C.load_for_inference(d, {"params": params}, model=model)[0] == 0


def test_missing_or_empty_directory_gives_none(tmp_path, port_model):
    _, params = port_model
    assert C.load_for_inference(str(tmp_path / "nope"),
                                {"params": params}) is None
    assert not os.path.exists(tmp_path / "nope")
    os.makedirs(tmp_path / "empty")
    assert C.load_for_inference(str(tmp_path / "empty"),
                                {"params": params}) is None
    assert os.listdir(tmp_path / "empty") == []


# -- interop: either package's checkpoint, either package's engine ------------

def _both_engines(d, jmodel, jtemplate, model, template):
    jep, _, jtrees = JC.load_for_inference(d, {"params": jtemplate},
                                           model=jmodel)
    ep, _, trees = C.load_for_inference(d, {"params": template},
                                        model=model)
    assert ep == jep
    return (JaxEngine(jmodel, jtrees["params"], **GEOMETRY),
            InferenceEngine(model, trees["params"], device="cpu",
                            **GEOMETRY))


def _hold(jengine, engine):
    for p in _prompts(3, 4, 9):
        ref = _first_logits(jengine, p, np.asarray)
        got = _first_logits(engine, p, lambda t: t.numpy())
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    prompts = _prompts(0, 8, 8)
    ref = _streams(jengine, JaxScheduler, JaxRequest, jax_run_open_loop,
                   prompts, 12)
    got = _streams(engine, Scheduler, Request, run_open_loop, prompts, 12)
    assert got == ref


def test_reference_checkpoint_served_by_the_port(tmp_path, dense_model,
                                                 port_model):
    jmodel, jparams, _ = dense_model
    model, params = port_model
    d = str(tmp_path / "ck")
    writer = JC.Checkpointer(d, fingerprint=_fingerprint(model))
    writer.save(0, 10, {"params": jax.tree.map(np.asarray, jparams)}).join()
    writer.mark_clean()
    _hold(*_both_engines(d, jmodel, jparams, model, params))


def test_port_launcher_checkpoint_served_by_the_reference(tmp_path,
                                                          dense_model,
                                                          port_model):
    from theanompi_torch.launcher import main as launch

    jmodel, jparams, _ = dense_model
    model, params = port_model
    d = str(tmp_path / "ck")
    assert launch(["--device", "cpu", "--quiet", *_SETS, "--rule-set",
                   "checkpoint_async=False", "--checkpoint-dir", d]) == 0
    assert os.path.exists(os.path.join(d, "ckpt_e0000.npz"))
    _hold(*_both_engines(d, jmodel, jparams, model, params))


# -- the live swap under int8 -------------------------------------------------

def _qt_equal(a, b):
    if isinstance(a, QuantizedTensor):
        return (isinstance(b, QuantizedTensor) and torch.equal(a.q, b.q)
                and torch.equal(a.scales, b.scales) and a.shape == b.shape
                and a.dtype == b.dtype)
    return torch.equal(a, b)


def test_int8_swap_requantizes_as_init_and_restore_is_exact(dense_model,
                                                            port_model):
    jmodel, jparams, _ = dense_model
    model, params = port_model
    new = _shifted(params, 0.25)
    geometry = dict(GEOMETRY, quantize_int8=True, decode_kernel="on")
    engine = InferenceEngine(model, params, device="cpu", **geometry)
    first = engine.params
    prev = engine.swap_params(new)
    assert prev is first and engine.params_version == 1
    fresh = InferenceEngine(model, new, device="cpu", **geometry)
    got, want = _leaves(engine.params), _leaves(fresh.params)
    assert got.keys() == want.keys()
    assert all(_qt_equal(got[k], want[k]) for k in got)
    # kernel 5's tree is the swapped int8 one, prefill's its dequantized
    assert engine._decode_params["head"]["w"] is engine.params["head"]["w"]
    assert torch.equal(engine._prefill_params["head"]["w"],
                       engine.params["head"]["w"].dequantize())
    engine.restore_params(prev)
    assert engine.params is first and engine.params_version == 2
    assert engine._decode_params["head"]["w"] is first["head"]["w"]

    # the reference's engine swapped to the same weights
    jengine = JaxEngine(jmodel, jparams, quantize_int8=True, **GEOMETRY)
    jengine.swap_params(jax.tree.map(lambda a: np.asarray(a) + 0.25,
                                     jparams))
    ref = {"/".join(str(getattr(p, "key", p)) for p in path): x
           for path, x in jax.tree_util.tree_flatten_with_path(
               jengine.params,
               is_leaf=lambda x: isinstance(x, JaxQT))[0]}
    assert ref.keys() == got.keys()
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, JaxQT):
            assert isinstance(g, QuantizedTensor), k
            np.testing.assert_allclose(g.scales.numpy(),
                                       np.asarray(r.scales), rtol=1e-6)
            dq = np.abs(g.q.numpy().astype(np.int32)
                        - np.asarray(r.q).astype(np.int32))
            assert dq.max() <= 1, k
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)


# -- the CLI's exit codes -----------------------------------------------------

def _cli_case(tmp_path, model, params, case, monkeypatch):
    d = str(tmp_path / "ck")
    args = ["--device", "cpu", *_SETS, "--requests", "2", "--prompt-len",
            "5", "--max-new-tokens", "3", "--block-size", "4",
            "--max-batch", "2", "--out", str(tmp_path / "SERVE.json")]
    if case == "empty":
        os.makedirs(d)
        return args + ["--checkpoint-dir", d]
    if case == "rollout_without_dir":
        return args + ["--rollout-watch"]
    _port_publish(d, model, params, 0)
    if case == "ok":
        _port_publish(d, model, params, 1, shift=0.1)
    elif case == "corrupt":
        flip_leaf_byte(os.path.join(d, "ckpt_e0000.npz"))
        args += ["--serve-verify", "full"]
    elif case == "mismatch":
        args += ["--set", "n_train=128"]
    elif case == "unhooked_fault":
        monkeypatch.setenv("THEANOMPI_FAULT_PLAN", "checkpoint:fail@0")
    return args + ["--checkpoint-dir", d]


@pytest.mark.parametrize("case,code,phase", [
    ("ok", 0, None), ("corrupt", 77, "checkpoint"), ("mismatch", 78, "load"),
    ("empty", 78, "config"), ("rollout_without_dir", 78, "config"),
    ("unhooked_fault", 78, "config")])
def test_cli_exit_codes(tmp_path, port_model, monkeypatch, capsys, case,
                        code, phase):
    model, params = port_model
    monkeypatch.delenv("THEANOMPI_FAULT_PLAN", raising=False)
    argv = _cli_case(tmp_path, model, params, case, monkeypatch)
    assert serve_main(argv) == code
    err = capsys.readouterr().err
    if code:
        # the chain's own progress lines come first, the error line last
        last = err.strip().splitlines()[-1]
        assert last.startswith(f"tmserve: error: {phase}:"), err
        assert not os.path.exists(tmp_path / "SERVE.json")
        return
    with open(tmp_path / "SERVE.json") as f:
        rep = json.load(f)
    assert rep["checkpoint_epoch"] == 1 and rep["attempt"] == 1
    assert rep["terminal_states"]["done"] == 2
