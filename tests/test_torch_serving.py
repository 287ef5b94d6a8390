"""The port's serving stack on the CPU, held against the reference engine.

Weights: the session ``dense_model`` fixture (the reference's tiny
``TransformerLM`` lightly trained, so greedy argmaxes are decided, not
coin flips), converted with ``params_from_jax``.  The port's engine runs
``device="cpu"``, where every kernel wrapper runs its plain version.

- continuous batching with eviction and preemption gives greedy streams
  IDENTICAL to the reference engine's;
- preemption + recompute is deterministic, sampled requests included (the
  port's own replay determinism: ``jax.random`` bits are not reproduced);
- int8: the reference's quantized payload, converted, agrees with the
  reference's int8 engine on >= 99 % of greedy tokens;
- BlockPool and prefix-cache units mirror the reference's tests;
- ``python -m theanompi_torch.serving --device cpu`` prints one JSON line.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from theanompi_tpu.ops.quant import QuantizedTensor as JaxQT
from theanompi_tpu.serving import InferenceEngine as JaxEngine
from theanompi_tpu.serving import Request as JaxRequest
from theanompi_tpu.serving import Scheduler as JaxScheduler
from theanompi_tpu.serving import run_open_loop as jax_run_open_loop

from theanompi_torch.convert import params_from_jax, quantized_from_jax
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.ops.quant import QuantizedTensor
from theanompi_torch.serving import (
    BlockPool,
    InferenceEngine,
    PrefixCache,
    Request,
    Scheduler,
    blocks_for,
    run_open_loop,
    sample_tokens,
    serve_report,
)
from theanompi_torch.serving.cli import synthetic_requests

from conftest import SERVING_TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = SERVING_TINY["vocab"]


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


def _prompts(seed, n, length):
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(0, VOCAB, length)] for _ in range(n)]


def _serve(engine, scheduler_cls, request_cls, run, prompts, new_tokens,
           temps=None):
    sched = scheduler_cls(engine)
    reqs = [request_cls(rid=i, prompt=list(p), max_new_tokens=new_tokens,
                        temperature=(temps[i] if temps else 0.0))
            for i, p in enumerate(prompts)]
    results, wall = run(sched, reqs)
    return results, sched, wall


def _streams(results):
    return {i: list(r.generated) for i, r in results.items()}


def _port_serve(engine, prompts, new_tokens, temps=None):
    return _serve(engine, Scheduler, Request, run_open_loop, prompts,
                  new_tokens, temps)


def _jax_serve(engine, prompts, new_tokens):
    return _serve(engine, JaxScheduler, JaxRequest, jax_run_open_loop,
                  prompts, new_tokens)


# -- continuous batching ------------------------------------------------------

def test_continuous_batching_smoke_equals_reference_engine(dense_model,
                                                            port_model):
    """12 requests through 4 slots and a pool of ~40 % of worst case:
    joins, leaves and preemption, with the port's greedy streams token
    for token the reference engine's and its own full forward's argmax."""
    jmodel, jparams, _ = dense_model
    model, params = port_model
    prompts = _prompts(0, 12, 8)
    geometry = dict(block_size=4, max_batch=4, num_blocks=21, seed=0)
    ref, _, _ = _jax_serve(JaxEngine(jmodel, jparams, **geometry),
                           prompts, 16)
    engine = InferenceEngine(model, params, device="cpu", **geometry)
    results, sched, wall = _port_serve(engine, prompts, 16)
    assert sched.n_preemptions > 0 and sched.n_steps > 16
    got = _streams(results)
    assert got == _streams(ref)
    for i, p in enumerate(prompts):
        seq = p + got[i]
        toks = torch.zeros((1, SERVING_TINY["seq_len"]), dtype=torch.long)
        toks[0, :len(seq)] = torch.tensor(seq)
        am = model.apply_logits(params, toks)[0].argmax(-1)
        assert am[len(p) - 1:len(seq) - 1].tolist() == seq[len(p):]
    rep = serve_report(results, wall, sched)
    assert rep["value"] > 0 and rep["unit"] == "tokens/sec"
    assert rep["device"] == "cpu" and rep["generated_tokens"] == 12 * 16
    assert "p50" in rep["ttft_ms"] and "p99" in rep["decode_step_ms"]
    assert rep["terminal_states"]["done"] == 12


def test_preemption_recompute_is_deterministic(port_model):
    """Tight and roomy pools give identical streams, sampled requests
    included: seeds derive from (seed, request, position) only."""
    model, params = port_model
    prompts = _prompts(7, 6, 6)
    temps = [0.8 if i % 2 else 0.0 for i in range(6)]

    def serve_all(num_blocks):
        engine = InferenceEngine(model, params, block_size=4, max_batch=3,
                                 num_blocks=num_blocks, seed=0,
                                 device="cpu")
        results, sched, _ = _port_serve(engine, prompts, 12, temps)
        return _streams(results), sched

    tight, s_tight = serve_all(12)
    roomy, s_roomy = serve_all(3 * 5 + 1)
    assert s_tight.n_preemptions > 0 and s_roomy.n_preemptions == 0
    assert tight == roomy


def test_scheduler_refuses_oversized_and_impossible_requests(port_model):
    model, params = port_model
    engine = InferenceEngine(model, params, block_size=4, max_batch=2,
                             num_blocks=5, seed=0, device="cpu")
    sched = Scheduler(engine)
    with pytest.raises(ValueError, match="max context"):
        sched.submit(Request(rid=0, prompt=[1] * 30, max_new_tokens=16))
    with pytest.raises(ValueError, match="num_blocks too small"):
        sched.submit(Request(rid=1, prompt=[1] * 8, max_new_tokens=12))
    with pytest.raises(ValueError, match="empty prompt"):
        sched.submit(Request(rid=2, prompt=[], max_new_tokens=4))


def test_auto_means_the_kernels_on_the_card_and_plain_elsewhere(port_model):
    from theanompi_torch.ops.attention import resolve_attn_impl

    assert resolve_attn_impl("auto", torch.device("cuda")) == "pallas"
    assert resolve_attn_impl("auto", "cpu") == "blockwise"
    assert resolve_attn_impl("blockwise", "cuda") == "blockwise"
    assert resolve_attn_impl("pallas", "cpu") == "pallas"
    with pytest.raises(ValueError, match="attn_impl"):
        resolve_attn_impl("flash", "cuda")
    model, params = port_model
    modes = {mode: InferenceEngine(model, params, block_size=4, max_batch=2,
                                   quantize_int8=True, decode_kernel=mode,
                                   device="cpu")
             for mode in ("auto", "on", "off")}
    assert {m: e.decode_impl for m, e in modes.items()} == {
        "auto": "fallback", "on": "kernel", "off": "fallback"}
    # the kernel path keeps every int8 leaf, the odd-vocab head included
    # (kernel 5 would refuse it on the card; its plain version dequantizes)
    assert isinstance(modes["on"]._decode_params["head"]["w"],
                      QuantizedTensor)
    assert isinstance(modes["off"]._decode_params["head"]["w"], torch.Tensor)


def test_sample_tokens_greedy_temperature_topk():
    logits = torch.from_numpy(
        np.random.RandomState(0).randn(4, 16).astype(np.float32))
    am = logits.argmax(-1).numpy()
    assert (sample_tokens(logits, [0.0] * 4, [1, 2, 3, 4]) == am).all()
    s1 = sample_tokens(logits, [1.0] * 4, [1, 2, 3, 4])
    s2 = sample_tokens(logits, [1.0] * 4, [1, 2, 3, 4])
    assert (s1 == s2).all()
    assert (sample_tokens(logits, [5.0] * 4, [1, 2, 3, 4], top_k=1)
            == am).all()
    draws = {int(sample_tokens(logits[:1], [1.0], [s])[0])
             for s in range(40)}
    assert len(draws) > 1  # temperature actually samples


# -- int8 ---------------------------------------------------------------------

def _port_tree(tree):
    """The reference engine's int8 tree -> the port's (same payload)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _port_tree(v)
        elif isinstance(v, JaxQT):
            out[k] = quantized_from_jax(np.asarray(v.q),
                                        np.asarray(v.scales), v.shape,
                                        v.dtype)
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True))
    return out


def test_int8_reference_payload_agrees_with_reference_int8_engine(
        dense_model, port_model):
    jmodel, jparams, _ = dense_model
    model, _ = port_model
    geometry = dict(block_size=4, max_batch=4, num_blocks=21, seed=0)
    jengine = JaxEngine(jmodel, jparams, quantize_int8=True, **geometry)
    assert jengine.quantized
    engine = InferenceEngine(model, _port_tree(jengine.params),
                             decode_kernel="on", device="cpu", **geometry)
    assert engine.quantized and engine.decode_impl == "kernel"
    prompts = _prompts(0, 10, 8)
    ref = _streams(_jax_serve(jengine, prompts, 16)[0])
    got = _streams(_port_serve(engine, prompts, 16)[0])
    agree = sum(a == b for i in ref for a, b in zip(ref[i], got[i]))
    total = sum(len(v) for v in ref.values())
    assert agree / total >= 0.99, f"int8 agreement {agree}/{total}"


def test_int8_quantize_tree_selects_matmul_weights(port_model):
    from theanompi_torch.serving.quant import dequantize_tree, quantize_tree

    _, params = port_model
    qtree, stats = quantize_tree(params, torch.Generator().manual_seed(0))
    assert stats["quantized_leaves"] == 2 * 6 + 1  # q,k,v,o,up,down + head
    assert stats["bytes_after"] < 0.35 * stats["bytes_before"]
    assert isinstance(qtree["00_embedding"]["w"], torch.Tensor)
    assert isinstance(qtree["02__block"]["ln1"]["scale"], torch.Tensor)
    w = params["head"]["w"]
    wq = dequantize_tree(qtree)["head"]["w"]
    assert wq.shape == w.shape and wq.dtype == w.dtype
    assert (wq - w).abs().max() <= 1.2 * w.abs().max() / 127.0


# -- block pool and prefix cache ----------------------------------------------

def test_block_pool_alloc_free_refcounts():
    pool = BlockPool(6)  # block 0 reserved -> 5 usable
    got = pool.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert pool.alloc(3) is None  # all-or-nothing
    pool.acquire(got)
    pool.free(got)  # first holder leaves: blocks stay live
    assert all(pool.ref(b) == 1 for b in got) and pool.free_blocks == 2
    pool.free(got)
    assert pool.free_blocks == 5
    with pytest.raises(ValueError, match="double free"):
        pool.free([got[0]])
    with pytest.raises(ValueError, match="outside pool"):
        pool.free([0])
    with pytest.raises(ValueError, match="acquiring free block"):
        pool.acquire([got[1]])
    assert blocks_for(5, 4) == 2 and blocks_for(8, 4) == 2


def test_prefix_cache_match_insert_evict_and_version():
    pool = BlockPool(16)
    cache = PrefixCache(pool, 4)
    row = pool.alloc(2)
    assert cache.insert([1, 2, 3, 4, 5, 6, 7, 8], row) == 2
    assert cache.match([1, 2, 3, 4, 5, 6, 7, 8, 9]) == row
    assert cache.match([1, 2, 3, 4, 5, 6, 7, 8]) == row[:1]
    assert cache.match([9, 9, 9, 9, 9]) == []
    pool.free(row + row[:1])
    assert cache.evict(5) == 2 and cache.n_nodes == 0
    assert pool.free_blocks == 15
    assert cache.check_version(0) is False
    cache.insert([1, 2, 3, 4], pool.alloc(1))
    assert cache.check_version(1) is True and cache.n_nodes == 0


def test_prefix_cache_on_off_streams_equal(port_model):
    """Multi-turn shared-prefix traffic through a tight pool: partial
    prefill over cached blocks changes the work, not the tokens."""
    model, params = port_model

    def run(prefix_cache):
        engine = InferenceEngine(model, params, block_size=4, max_batch=3,
                                 num_blocks=14, seed=0, device="cpu")
        sched = Scheduler(engine, prefix_cache=prefix_cache)
        reqs = synthetic_requests(9, VOCAB, 4, 6, 0.0, 3, turns=3,
                                  shared_prefix=4)
        results, _ = run_open_loop(sched, reqs)
        return {i: r.generated for i, r in results.items()}, sched

    off, _ = run(False)
    on, sched = run(True)
    assert on == off
    assert sched.n_prefix_hits > 0 and sched.prefix_tokens_saved > 0


# -- CLI ----------------------------------------------------------------------

_TINY_SETS = ["--set", "dim=32", "--set", "heads=2", "--set", "n_layers=2",
              "--set", "seq_len=32", "--set", "vocab=61",
              "--set", "precision='fp32'"]


def _cli(*args, timeout=240):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "theanompi_torch.serving", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_cpu_prints_one_json_line():
    r = _cli("--device", "cpu", *_TINY_SETS, "--requests", "4",
             "--prompt-len", "6", "--max-new-tokens", "5",
             "--block-size", "4", "--max-batch", "2", "--quantize-int8")
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    rep = json.loads(lines[0])
    assert rep["metric"] == "serve_tokens_per_sec" and rep["value"] > 0
    assert rep["terminal_states"]["done"] == 4
    assert rep["quantized_int8"] and rep["device"] == "cpu"


def test_cli_serve_reports_each_terminal_request():
    from theanompi_torch.serving.cli import build_parser, serve

    args = build_parser().parse_args([
        "--device", "cpu", *_TINY_SETS, "--requests", "3", "--prompt-len",
        "5", "--max-new-tokens", "4", "--block-size", "4", "--max-batch",
        "2"])
    seen = []
    report = serve(args, on_terminal=seen.append)
    assert sorted(r.rid for r in seen) == [0, 1, 2]
    assert all(r.state == "done" and len(r.generated) == 4 for r in seen)
    assert report["terminal_states"]["done"] == 3


def test_cli_unported_flag_exits_78():
    from theanompi_torch.serving.cli import main

    assert main(["--device", "cpu", *_TINY_SETS,
                 "--telemetry-dir", "/nonexistent"]) == 78
