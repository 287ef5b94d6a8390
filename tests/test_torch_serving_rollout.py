"""The port's verified live rollout, mirroring the reference's tests
(``tests/test_serving_resilience.py:320-475``).

- a half-published candidate (manifest visible, ``.npz`` not yet
  replaced) is refused, never quarantined, and the same epoch adopts once
  its bytes verify;
- ``serve:rollout_corrupt@0`` flips a byte of the first candidate: it is
  refused, the old weights keep serving, the next candidate adopts;
- a critical ``slo`` verdict inside probation rolls back and blacklists
  the epoch; a quiet probation commits (the clock is injected);
- under int8 a rollback reinstalls the previous engine tree exactly, its
  int8 payloads and kernel 5's tree included;
- a swap preempts the active slots, and each replayed stream equals a
  fresh run at the new weights from the same prefix;
- ``--rollout-watch`` adopts a newer epoch while a queue replica serves,
  and the requests after it are served at the new weights.

Weights: the session ``dense_model`` converted; checkpoints published by
the port's ``Checkpointer``; engines ``device="cpu"``.  Weight
comparisons are exact.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from theanompi_torch.convert import params_from_jax
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.ops.quant import QuantizedTensor
from theanompi_torch.resilience.faults import FaultPlan
from theanompi_torch.serving import (
    InferenceEngine,
    Request,
    RolloutManager,
    Scheduler,
    newest_manifest_epoch,
    run_open_loop,
)
from theanompi_torch.serving.lifecycle import (
    append_queue,
    request_drain,
    terminal_rids,
)
from theanompi_torch.tree import tree_leaves_with_path, tree_map
from theanompi_torch.utils import checkpoint as C

from conftest import SERVING_TINY

VOCAB = SERVING_TINY["vocab"]
GEOMETRY = dict(block_size=4, max_batch=2, seed=0)


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.delenv("THEANOMPI_FAULT_PLAN", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port_model(dense_model):
    _, params, _ = dense_model
    return (TransformerLM(dict(SERVING_TINY)),
            params_from_jax(jax.tree.map(np.asarray, params)))


def _publish(ckpt, model, params, epoch, shift=0.0):
    """One verified publish, the training writer's way."""
    writer = C.Checkpointer(ckpt, fingerprint={
        "mesh": {"data": 1, "pipe": 1, "model": 1, "seq": 1},
        "exchange": "psum", "n_subb": 1, **C.model_fingerprint(model)})
    trees = {"params": tree_map(lambda t: t + shift, params)}
    writer.save(epoch, 10 * (epoch + 1), trees).join()
    writer.mark_clean()
    return trees


class _SchedStub:
    """``preempt_all()`` is the rollout's barrier; count the calls."""

    def __init__(self):
        self.n_preempt_calls = 0

    def preempt_all(self):
        self.n_preempt_calls += 1
        return 2


def _manager(engine, ckpt, model, params, **kw):
    kw.setdefault("poll_s", 0.0)
    return RolloutManager(engine, ckpt, {"params": params}, model=model,
                          current_epoch=0, **kw)


def _head(engine):
    return engine.params["head"]["w"].clone()


def test_rollout_tolerates_half_published_then_adopts(port_model, tmp_path):
    model, params = port_model
    ckpt = str(tmp_path / "ckpt")
    _publish(ckpt, model, params, 0)
    engine = InferenceEngine(model, params, device="cpu", **GEOMETRY)
    mgr = _manager(engine, ckpt, model, params)
    sched = _SchedStub()
    assert newest_manifest_epoch(ckpt) == 0
    assert mgr.poll(sched) is None  # nothing newer than what serves

    # epoch 1 half-published: the manifest is there, the npz not yet
    man = os.path.join(ckpt, "ckpt_e0001.manifest.json")
    npz = os.path.join(ckpt, "ckpt_e0001.npz")
    with open(os.path.join(ckpt, "ckpt_e0000.manifest.json")) as f:
        text = f.read()
    with open(man, "w") as f:
        f.write(text)
    with open(npz, "wb") as f:
        f.write(b"PK-but-not-really")
    assert mgr.poll(sched) == "refused"
    assert mgr.poll(sched) == "refused"  # polls again, still patient
    assert mgr.n_refused == 1            # one refusal a candidate
    assert mgr.current_epoch == 0 and sched.n_preempt_calls == 0
    assert os.path.exists(man) and os.path.exists(npz)
    assert not os.path.exists(os.path.join(ckpt, "corrupt"))

    # the writer finishes its publish: the same epoch adopts
    os.remove(man)
    os.remove(npz)
    p1 = _publish(ckpt, model, params, 1, shift=1.0)
    assert mgr.poll(sched) == "rollout"
    assert mgr.current_epoch == 1 and mgr.n_rollouts == 1
    assert sched.n_preempt_calls == 1, "adopt must preempt before swapping"
    assert torch.equal(engine.params["head"]["w"], p1["params"]["head"]["w"])
    assert engine.params_version == 1


def test_rollout_corrupt_fault_refused_old_weights_keep_serving(port_model,
                                                                tmp_path):
    model, params = port_model
    ckpt = str(tmp_path / "ckpt")
    _publish(ckpt, model, params, 0)
    engine = InferenceEngine(model, params, device="cpu", **GEOMETRY)
    w0 = _head(engine)
    mgr = _manager(engine, ckpt, model, params,
                   fault_plan=FaultPlan.parse("serve:rollout_corrupt@0"))
    sched = _SchedStub()
    _publish(ckpt, model, params, 1, shift=1.0)
    assert mgr.poll(sched) == "refused"  # the fault took candidate 0
    assert torch.equal(engine.params["head"]["w"], w0)
    assert os.path.exists(os.path.join(ckpt, "ckpt_e0001.npz"))
    assert not os.path.exists(os.path.join(ckpt, "corrupt"))
    p2 = _publish(ckpt, model, params, 2, shift=2.0)
    assert mgr.poll(sched) == "rollout"  # ordinal 1: no spec
    assert mgr.current_epoch == 2 and mgr.n_refused == 1
    assert torch.equal(engine.params["head"]["w"], p2["params"]["head"]["w"])


def test_rollout_probation_rollback_and_commit(port_model, tmp_path):
    model, params = port_model
    ckpt = str(tmp_path / "ckpt")
    _publish(ckpt, model, params, 0)
    engine = InferenceEngine(model, params, device="cpu", **GEOMETRY)
    w0 = _head(engine)
    t = [0.0]
    verdicts = []
    mgr = _manager(engine, ckpt, model, params, probation_s=100.0,
                   health_verdicts=lambda: verdicts, clock=lambda: t[0])
    sched = _SchedStub()

    _publish(ckpt, model, params, 1, shift=1.0)
    t[0] = 1.0
    assert mgr.poll(sched) == "rollout" and mgr.current_epoch == 1
    # a warning is not enough, nor another detector's critical verdict
    verdicts[:] = [{"detector": "slo", "severity": "warn"},
                   {"detector": "loss", "severity": "critical"}]
    t[0] = 2.0
    assert mgr.poll(sched) != "rollback"
    verdicts[:] = [{"detector": "slo", "severity": "critical",
                    "reason": "ttft p99 over the SLO"}]
    t[0] = 3.0
    assert mgr.poll(sched) == "rollback"
    assert mgr.current_epoch == 0 and mgr.n_rollbacks == 1
    assert sched.n_preempt_calls == 2  # once on adopt, once on rollback
    assert torch.equal(engine.params["head"]["w"], w0)
    t[0] = 4.0
    assert mgr.poll(sched) is None, "a rolled-back epoch was adopted again"

    # a new epoch adopts, survives probation quietly and commits
    verdicts[:] = []
    p2 = _publish(ckpt, model, params, 2, shift=2.0)
    t[0] = 5.0
    assert mgr.poll(sched) == "rollout" and mgr.current_epoch == 2
    t[0] = 200.0  # past the probation window
    assert mgr.poll(sched) is None
    verdicts[:] = [{"detector": "throughput", "severity": "critical"}]
    t[0] = 201.0
    assert mgr.poll(sched) != "rollback", "probation already committed"
    assert mgr.current_epoch == 2
    assert torch.equal(engine.params["head"]["w"], p2["params"]["head"]["w"])


def _snapshot(tree):
    """Every leaf's bytes (int8 payloads and scales apart)."""
    out = {}
    for path, x in tree_leaves_with_path(tree):
        key = "/".join(map(str, path))
        if isinstance(x, QuantizedTensor):
            out[key + ":q"], out[key + ":s"] = x.q.clone(), x.scales.clone()
        else:
            out[key] = x.clone()
    return out


def test_int8_rollback_restores_the_previous_tree_exactly(port_model,
                                                          tmp_path):
    model, params = port_model
    ckpt = str(tmp_path / "ckpt")
    _publish(ckpt, model, params, 0)
    engine = InferenceEngine(model, params, device="cpu", quantize_int8=True,
                             decode_kernel="on", **GEOMETRY)
    first, decode_first = engine.params, engine._decode_params
    before = _snapshot(first)
    verdicts = []
    mgr = _manager(engine, ckpt, model, params, probation_s=100.0,
                   health_verdicts=lambda: verdicts, clock=lambda: 1.0)
    _publish(ckpt, model, params, 1, shift=0.5)
    assert mgr.poll(_SchedStub()) == "rollout"
    swapped = engine.params
    assert isinstance(swapped["head"]["w"], QuantizedTensor)
    assert not torch.equal(swapped["head"]["w"].q, first["head"]["w"].q)
    verdicts[:] = [{"detector": "throughput", "severity": "critical"}]
    assert mgr.poll(_SchedStub()) == "rollback"
    assert engine.params is first
    after = _snapshot(engine.params)
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert engine._decode_params["head"]["w"] is decode_first["head"]["w"]
    assert engine.params_version == 2


def _prompts(seed, n, length):
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(0, VOCAB, length)] for _ in range(n)]


def _fresh_continuation(model, params, prefix, n_new):
    engine = InferenceEngine(model, params, device="cpu", **GEOMETRY)
    results, _ = run_open_loop(Scheduler(engine), [
        Request(rid=0, prompt=list(prefix), max_new_tokens=n_new)])
    return results[0].generated


def test_swap_preempts_active_and_replays_at_the_new_weights(port_model,
                                                             tmp_path):
    model, params = port_model
    ckpt = str(tmp_path / "ckpt")
    _publish(ckpt, model, params, 0)
    new = _publish(ckpt, model, params, 1, shift=0.05)["params"]
    engine = InferenceEngine(model, params, device="cpu", **GEOMETRY)
    mgr = RolloutManager(engine, ckpt, {"params": params}, model=model,
                         current_epoch=0, poll_s=0.0)
    at_swap = {}

    def between(sched):
        # swap once, after the first two requests have decoded a while
        if not at_swap and sched.n_steps == 3:
            at_swap.update({r.rid: list(r.generated)
                            for r in sched.slots if r is not None})
            assert mgr.poll(sched) == "rollout"

    prompts = _prompts(11, 4, 6)
    sched = Scheduler(engine)
    results, _ = run_open_loop(
        sched, [Request(rid=i, prompt=p, max_new_tokens=10)
                for i, p in enumerate(prompts)], between_steps=between)
    assert sorted(at_swap) == [0, 1] and sched.n_preemptions == 2
    assert all(r.state == "done" and len(r.generated) == 10
               for r in results.values())
    for rid, req in results.items():
        head = at_swap.get(rid, [])
        assert req.generated[:len(head)] == head
        assert req.generated[len(head):] == _fresh_continuation(
            model, new, prompts[rid] + head, 10 - len(head)), rid


def test_cli_rollout_watch_adopts_while_serving_the_queue(port_model,
                                                          tmp_path,
                                                          monkeypatch):
    from theanompi_torch.serving import rollout
    from theanompi_torch.serving.cli import build_parser, serve

    managers = []

    class Watched(rollout.RolloutManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            managers.append(self)

    monkeypatch.setattr(rollout, "RolloutManager", Watched)
    model, params = port_model
    ckpt = str(tmp_path / "ckpt")
    _publish(ckpt, model, params, 0)
    q = str(tmp_path / "queue.jsonl")
    prompts = _prompts(4, 4, 6)
    entries = [{"rid": i, "prompt": p, "max_new_tokens": 5}
               for i, p in enumerate(prompts)]
    append_queue(q, entries[:2])
    sets = [a for k, v in SERVING_TINY.items()
            for a in ("--set", f"{k}={v!r}")]
    args = build_parser().parse_args([
        "--device", "cpu", *sets, "--block-size", "4", "--max-batch", "2",
        "--checkpoint-dir", ckpt, "--queue-file", q, "--rollout-watch",
        "--rollout-poll-s", "0"])
    done, box = {}, {}

    def run():
        box["report"] = serve(args,
                              on_terminal=lambda r: done.__setitem__(r.rid,
                                                                     r))

    log = os.path.join(str(tmp_path), "REQUESTS.jsonl")
    t = threading.Thread(target=run, name="serve-replica", daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 120

        def wait_for(cond):
            while not cond():
                assert t.is_alive() and time.monotonic() < deadline
                time.sleep(0.02)

        wait_for(lambda: len(terminal_rids(log)) >= 2)
        new = _publish(ckpt, model, params, 1, shift=0.05)["params"]
        # the idle loop polls every pass: wait for the adoption
        wait_for(lambda: managers and managers[0].n_rollouts == 1)
        append_queue(q, entries[2:])
        wait_for(lambda: len(terminal_rids(log)) >= 4)
    finally:
        request_drain(q)
        t.join(60)
    assert not t.is_alive(), "the replica never drained"
    rep = box["report"]
    assert rep["rollout"] == {"rollouts": 1, "rollbacks": 0, "refused": 0,
                              "serving_epoch": 1}
    assert rep["checkpoint_epoch"] == 1
    for rid in (2, 3):
        assert done[rid].generated == _fresh_continuation(
            model, new, prompts[rid], 5), rid
