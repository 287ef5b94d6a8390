"""The port's serving lifecycle, held against the reference's.

- the durable files (``serving/lifecycle.py``): byte-offset tailing with
  torn tails, the drain sentinel, atomic snapshots and their throttle,
  the request log and its torn tail (mirrors of ``tests/test_router.py``
  and ``tests/test_serving_resilience.py``), and the same bytes as the
  reference's writers, each package reading the other's files;
- the drain: in-process through an injected ``drain`` callable, and the
  signal path through a ``python -m theanompi_torch.serving`` subprocess
  (SIGTERM goes to the child only, every wait has a timeout);
- ``run_queue_loop`` on the same queue entries gives the reference's
  terminal states and greedy tokens (exactly), with ``answered`` rids
  neither served nor recorded; late arrivals, both drain paths and the
  live snapshot;
- a rerun of the CLI with the same ``--requests-log`` skips every
  answered rid, after a clean run and after an injected crash;
- ``serve:raise`` and ``serve:stall`` fire at the reference's decode-step
  ordinals; a plan naming a site the port has not hooked is refused
  ("not yet ported", exit 78).

Units run the scheduler over a host-only engine double; the queue-loop
parity runs both packages' engines (``device="cpu"``) on the session
``dense_model``.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from theanompi_tpu.resilience import faults as jfaults
from theanompi_tpu.serving import InferenceEngine as JaxEngine
from theanompi_tpu.serving import lifecycle as jlife
from theanompi_tpu.serving import scheduler as jsched

from theanompi_torch.convert import params_from_jax
from theanompi_torch.models.transformer_lm import TransformerLM
from theanompi_torch.resilience.faults import (
    FaultInjected,
    FaultPlan,
    FaultPlanError,
)
from theanompi_torch.serving import InferenceEngine, blocks_for
from theanompi_torch.serving.cli import main as serve_main
from theanompi_torch.serving.lifecycle import (
    DRAIN_OP,
    RequestLog,
    SnapshotPublisher,
    append_queue,
    drain_entry,
    publish_snapshot,
    read_jsonl_since,
    read_snapshot,
    request_drain,
    terminal_records,
    terminal_rids,
)
from theanompi_torch.serving.scheduler import (
    TERMINAL_STATES,
    Request,
    Scheduler,
    run_open_loop,
    run_queue_loop,
    serve_report,
)

from conftest import SERVING_TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = SERVING_TINY["vocab"]
_TINY_SETS = ["--set", "dim=32", "--set", "heads=2", "--set", "n_layers=2",
              "--set", "seq_len=32", "--set", "vocab=61",
              "--set", "precision='fp32'"]
_GEOM = ["--block-size", "4", "--max-batch", "2", "--prompt-len", "5",
         "--max-new-tokens", "4"]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.delenv("THEANOMPI_FAULT_PLAN", raising=False)
    monkeypatch.delenv("THEANOMPI_ATTEMPT", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class FakeEngine:
    """Host-only engine double: the scheduler's surface (pool geometry,
    prefill/decode) for either package's scheduler, with no model behind
    it.  Emits a fixed token, so nothing ever hits EOS."""

    def __init__(self, max_batch=2, block_size=4, num_blocks=9,
                 max_context=64):
        self.max_batch = max_batch
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_context = max_context
        self.max_blocks_per_seq = blocks_for(max_context, block_size)
        self.n_prefills = 0
        self.quant_stats = None
        self.decode_impl = "fallback"
        self.device = torch.device("cpu")
        self.params_version = 0

    @property
    def quantized(self):
        return False

    def prefill(self, row, tokens, temperature=0.0, rid=0, prefix_len=0):
        self.n_prefills += 1
        return 7, None

    def decode(self, tables, lengths, tokens, temps, rids):
        return np.full((self.max_batch,), 5, np.int32), None


def _req(rid, prompt_len=4, new=8, **kw):
    return Request(rid=rid, prompt=[1] * prompt_len, max_new_tokens=new,
                   **kw)


def _entry(rid, new=4, **kw):
    return {"rid": rid, "prompt": [1, 2, 3], "max_new_tokens": new, **kw}


# -- the durable files --------------------------------------------------------

def test_read_jsonl_since_tails_only_complete_lines(tmp_path):
    p = str(tmp_path / "q.jsonl")
    append_queue(p, [{"rid": 0}, {"rid": 1}])
    recs, off = read_jsonl_since(p, 0)
    assert [r["rid"] for r in recs] == [0, 1]
    assert read_jsonl_since(p, off) == ([], off)  # nothing new: parks
    with open(p, "a") as f:
        f.write('{"rid": 2')  # a torn tail is "not there yet"
    assert read_jsonl_since(p, off) == ([], off)
    with open(p, "a") as f:
        f.write('}\n')
    recs4, off4 = read_jsonl_since(p, off)
    assert [r["rid"] for r in recs4] == [2] and off4 > off
    with open(p, "a") as f:  # complete but corrupt: skipped and consumed
        f.write('{"rid": oops}\n')
        f.write('{"rid": 3}\n')
    assert [r["rid"] for r in read_jsonl_since(p, off4)[0]] == [3]
    assert read_jsonl_since(str(tmp_path / "nope"), 7) == ([], 7)


def test_queue_drain_sentinel_and_request_drain(tmp_path):
    p = str(tmp_path / "q.jsonl")
    assert drain_entry() == {"op": DRAIN_OP}
    append_queue(p, [{"rid": 5}])
    request_drain(p)
    assert read_jsonl_since(p, 0)[0] == [{"rid": 5}, {"op": DRAIN_OP}]


def test_snapshot_publish_read_and_absent(tmp_path):
    p = str(tmp_path / "SERVE_SNAPSHOT.json")
    assert read_snapshot(p) is None
    publish_snapshot(p, {"backlog_tokens": 12, "token_rate": 80.0})
    assert read_snapshot(p)["backlog_tokens"] == 12
    assert not os.path.exists(p + ".tmp")  # atomic: no debris
    with open(p, "w") as f:
        f.write("{torn")
    assert read_snapshot(p) is None


def test_snapshot_publisher_throttles_on_steps_and_wall(tmp_path):
    p = str(tmp_path / "snap.json")
    pub = SnapshotPublisher(p, every_steps=4, min_interval_s=3600.0)
    calls = []

    def snap_fn():
        calls.append(1)
        return {"n": len(calls)}

    assert pub.maybe(snap_fn, 0)          # the first call is always due
    assert not pub.maybe(snap_fn, 1)
    assert not pub.maybe(snap_fn, 3)
    assert pub.maybe(snap_fn, 4)          # the step cadence
    assert pub.maybe(snap_fn, 4, force=True)
    assert read_snapshot(p) == {"n": 3}
    pub2 = SnapshotPublisher(p, every_steps=10**9, min_interval_s=0.0)
    assert pub2.maybe(snap_fn, 0) and pub2.maybe(snap_fn, 0)


def test_request_log_records_latency_and_extras(tmp_path):
    p = str(tmp_path / "REQUESTS.jsonl")
    log = RequestLog(p, attempt=2)
    req = Request(rid=7, prompt=[1, 2], max_new_tokens=4)
    req.state, req.reason, req.generated = "done", None, [5, 5]
    req.t_submit, req.t_first_token = 10.0, 10.25
    log.record(req, queue_wait_ms=33.5)
    log.close()
    (rec,) = terminal_records(p)
    assert rec["rid"] == 7 and rec["attempt"] == 2
    assert rec["ttft_ms"] == pytest.approx(250.0)
    assert rec["queue_wait_ms"] == 33.5 and rec["n_generated"] == 2
    assert terminal_rids(p) == {7}


def test_request_log_roundtrip_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "REQUESTS.jsonl")
    assert terminal_rids(path) == set()
    log = RequestLog(path, attempt=1)
    done = _req(3, new=2)
    done.state, done.generated = "done", [5, 5]
    shed = _req(7, new=2)
    shed.state, shed.reason = "shed", "draining"
    log.record(done)
    log.record(shed)
    log.close()
    with open(path, "a") as f:
        f.write('{"rid": 9, "state": "do')  # the SIGKILL-torn tail
    assert terminal_rids(path) == {3, 7}
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip().endswith("}")]
    assert recs[0] == {"rid": 3, "state": "done", "reason": None,
                       "n_generated": 2, "attempt": 1}
    assert recs[1]["reason"] == "draining"


def test_files_are_the_reference_s_byte_for_byte(tmp_path):
    """The same records through either package's writers give the same
    bytes, and each package reads the other's files."""
    def write(mod, req_cls, d):
        os.makedirs(d)
        log = mod.RequestLog(os.path.join(d, "R.jsonl"), attempt=3)
        for rid, state in ((4, "done"), (9, "expired")):
            r = req_cls(rid=rid, prompt=[1, 2, 3], max_new_tokens=2)
            r.state, r.generated = state, [6]
            r.reason = None if state == "done" else "ttft deadline exceeded"
            r.t_submit, r.t_first_token = 1.0, 1.0123
            log.record(r, queue_wait_ms=2.5)
        log.close()
        mod.append_queue(os.path.join(d, "q.jsonl"),
                         [_entry(0, enq_wall=1.5), _entry(1)])
        mod.request_drain(os.path.join(d, "q.jsonl"))
        mod.publish_snapshot(os.path.join(d, "S.json"),
                             {"n_done": 2, "token_rate": None})

    from theanompi_torch.serving import lifecycle as plife

    write(jlife, jsched.Request, str(tmp_path / "ref"))
    write(plife, Request, str(tmp_path / "port"))
    for f in ("R.jsonl", "q.jsonl", "S.json"):
        with open(tmp_path / "ref" / f, "rb") as a, \
                open(tmp_path / "port" / f, "rb") as b:
            assert a.read() == b.read(), f
    for reader, d in ((jlife, "port"), (plife, "ref")):
        assert reader.terminal_rids(str(tmp_path / d / "R.jsonl")) == {4, 9}
        recs, _ = reader.read_jsonl_since(str(tmp_path / d / "q.jsonl"))
        assert [r.get("rid", r.get("op")) for r in recs] == [0, 1, "drain"]
        assert reader.read_snapshot(str(tmp_path / d / "S.json")) == {
            "n_done": 2, "token_rate": None}


# -- the drain, in process ----------------------------------------------------

def test_drain_sheds_queued_finishes_active_in_process():
    sched = Scheduler(FakeEngine(max_batch=2, num_blocks=40))
    reqs = [_req(i, new=12) for i in range(6)]
    results, _ = run_open_loop(sched, reqs, drain=lambda: sched.n_steps >= 2,
                               drain_s=30.0)
    assert len(results) == 6, "a request was lost in the drain"
    assert {r.state for r in results.values()} <= set(TERMINAL_STATES)
    done = [r for r in results.values() if r.state == "done"]
    shed = [r for r in results.values() if r.state == "shed"]
    assert len(done) == 2 and all(len(r.generated) == 12 for r in done)
    assert len(shed) == 4 and all(r.reason == "draining" for r in shed)
    assert serve_report(results, 1.0, sched)["drained"] is True
    late = _req(9, new=4)
    assert sched.submit(late) is False and late.state == "shed"


def test_drain_deadline_force_expires_stragglers():
    sched = Scheduler(FakeEngine(max_batch=2, num_blocks=40))
    results, _ = run_open_loop(sched, [_req(i, new=50) for i in range(2)],
                               drain=lambda: sched.n_steps >= 1, drain_s=0.0)
    assert len(results) == 2
    assert all(r.state == "expired" and "drain deadline" in r.reason
               for r in results.values())


# -- the queue loop -----------------------------------------------------------

@pytest.fixture
def logs():
    """Request logs a test opens, closed at teardown whatever happens."""
    opened = []
    yield opened.append
    for log in opened:
        log.close()


def test_run_queue_loop_matches_the_reference_and_skips_answered(
        tmp_path, dense_model, logs):
    jmodel, jparams, _ = dense_model
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    geometry = dict(block_size=4, max_batch=2, num_blocks=13, seed=0)
    rng = np.random.RandomState(5)
    entries = [_entry(i, new=6, enq_wall=time.time() - 0.05,
                      prompt=[int(x) for x in rng.randint(0, VOCAB, 5 + i)])
               for i in range(6)]
    q = str(tmp_path / "queue.jsonl")
    append_queue(q, entries)
    request_drain(q)
    answered = {1, 4}

    jlog = jlife.RequestLog(str(tmp_path / "ref.jsonl"))
    logs(jlog)
    ref, _ = jsched.run_queue_loop(
        jsched.Scheduler(JaxEngine(jmodel, jparams, **geometry)), q,
        poll_s=0.001, answered=answered, on_terminal=jlog.record)
    log = RequestLog(str(tmp_path / "port.jsonl"))
    logs(log)
    engine = InferenceEngine(TransformerLM(dict(SERVING_TINY)), params,
                             device="cpu", **geometry)
    got, _ = run_queue_loop(Scheduler(engine), q, poll_s=0.001,
                            answered=answered, on_terminal=log.record)
    jlog.close()
    log.close()
    assert set(got) == set(ref) == {0, 2, 3, 5}
    assert {i: (r.state, r.generated) for i, r in got.items()} == {
        i: (r.state, r.generated) for i, r in ref.items()}
    recs = terminal_records(str(tmp_path / "port.jsonl"))
    assert sorted(r["rid"] for r in recs) == [0, 2, 3, 5]
    assert all(r["queue_wait_ms"] >= 0 and "ttft_ms" in r for r in recs)
    assert [{k: r[k] for k in ("rid", "state", "n_generated")}
            for r in recs] == [
        {k: r[k] for k in ("rid", "state", "n_generated")}
        for r in terminal_records(str(tmp_path / "ref.jsonl"))]


def test_run_queue_loop_picks_up_late_arrivals_then_drains(tmp_path):
    q = str(tmp_path / "queue.jsonl")
    append_queue(q, [_entry(0)])
    box = {}

    def run():
        box["out"] = run_queue_loop(Scheduler(FakeEngine()), q, poll_s=0.001)

    t = threading.Thread(target=run, name="queue-loop", daemon=True)
    t.start()
    try:
        time.sleep(0.15)
        append_queue(q, [_entry(1)])  # a late arrival while the loop idles
        time.sleep(0.15)
    finally:
        request_drain(q)
        t.join(20)
    assert not t.is_alive(), "queue loop never drained"
    results, _ = box["out"]
    assert set(results) == {0, 1}
    assert all(r.state == "done" for r in results.values())


def test_run_queue_loop_drain_callable_sheds_as_give_back(tmp_path):
    q = str(tmp_path / "queue.jsonl")
    append_queue(q, [_entry(0, new=64), _entry(1), _entry(2)])
    flag = threading.Event()
    sched = Scheduler(FakeEngine(max_batch=1, num_blocks=40,
                                 max_context=128))
    passes = []

    def trip(_s):
        passes.append(1)
        if len(passes) == 3:
            flag.set()

    results, _ = run_queue_loop(sched, q, poll_s=0.001, drain=flag.is_set,
                                drain_s=10.0, between_steps=trip)
    assert set(results) == {0, 1, 2}
    assert results[0].state == "done"
    assert results[1].state == "shed" and results[1].reason == "draining"
    assert results[2].state == "shed"


def test_scheduler_snapshot_shape_and_queue_loop_publishing(tmp_path):
    q = str(tmp_path / "queue.jsonl")
    snap_path = str(tmp_path / "SERVE_SNAPSHOT.json")
    append_queue(q, [_entry(0), _entry(1)])
    request_drain(q)
    run_queue_loop(Scheduler(FakeEngine()), q, poll_s=0.001,
                   snapshot=SnapshotPublisher(snap_path, every_steps=1))
    snap = read_snapshot(snap_path)
    want = set(jsched.Scheduler(FakeEngine()).snapshot())
    assert set(snap) == want
    assert snap["n_done"] == 2 and snap["backlog_tokens"] == 0
    assert snap["draining"] is False


# -- the CLI: reruns, faults, the signal --------------------------------------

def _cli_args(log, *extra):
    return ["--device", "cpu", *_TINY_SETS, *_GEOM, "--requests-log", log,
            *extra]


def test_cli_rerun_skips_answered_after_a_clean_run_and_a_crash(
        tmp_path, monkeypatch, capsys):
    log = str(tmp_path / "REQUESTS.jsonl")
    assert serve_main(_cli_args(log, "--requests", "3")) == 0
    first = json.loads(capsys.readouterr().out)
    assert first["requests"] == 3 and "skipped_already_answered" not in first
    # an injected crash at decode step 4 of the rerun (attempt 2), after
    # its first two requests finished
    monkeypatch.setenv("THEANOMPI_FAULT_PLAN", "serve:raise@4")
    monkeypatch.setenv("THEANOMPI_ATTEMPT", "2")
    assert serve_main(_cli_args(log, "--requests", "7")) == 70
    assert "FaultInjected" in capsys.readouterr().err
    monkeypatch.delenv("THEANOMPI_FAULT_PLAN")
    monkeypatch.setenv("THEANOMPI_ATTEMPT", "3")
    crashed = {r["rid"] for r in terminal_records(log) if r["attempt"] == 2}
    assert crashed == {3, 4}
    assert serve_main(_cli_args(log, "--requests", "7")) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["skipped_already_answered"] == 3 + len(crashed)
    assert rep["requests"] == 4 - len(crashed) and rep["attempt"] == 3
    rids = [r["rid"] for r in terminal_records(log)]
    assert sorted(rids) == list(range(7)), "a rid answered twice or never"


@pytest.mark.parametrize("spec", ["serve:raise@0", "serve:raise@3",
                                  "serve:raise@2@1"])
def test_serve_raise_fires_at_the_reference_s_ordinal(spec):
    def steps_until_raise(sched_mod, plan_mod, exc):
        sched = sched_mod.Scheduler(FakeEngine(max_batch=1, num_blocks=20),
                                    fault_plan=plan_mod.FaultPlan.parse(spec))
        sched.submit(sched_mod.Request(rid=0, prompt=[1] * 4,
                                       max_new_tokens=30))
        for _ in range(10):
            try:
                sched.step()
            except exc as e:
                return sched.n_steps, str(e)
        return None

    import theanompi_torch.resilience.faults as pfaults
    import theanompi_torch.serving.scheduler as psched

    got = steps_until_raise(psched, pfaults, FaultInjected)
    assert got is not None
    assert got == steps_until_raise(jsched, jfaults, jfaults.FaultInjected)


def test_serve_stall_fires_once_at_its_ordinal(monkeypatch):
    monkeypatch.setenv("THEANOMPI_SERVE_STALL_S", "0.5")
    sched = Scheduler(FakeEngine(max_batch=1, num_blocks=20),
                      fault_plan=FaultPlan.parse("serve:stall@1"))
    sched.submit(_req(1, new=6))
    took = []
    for _ in range(3):
        t0 = time.perf_counter()
        sched.step()
        took.append(time.perf_counter() - t0)
    assert took[1] >= 0.5, took  # decode-step ordinal 1
    assert took[0] < 0.5 and took[2] < 0.5, took  # one-shot


def test_fault_plan_refuses_what_is_not_hooked(tmp_path, monkeypatch,
                                               capsys):
    for spec in ("step:kill@3@1", "checkpoint:bitflip@1", "fleet:kill_job@0"):
        jfaults.FaultPlan.parse(spec)  # the reference's grammar takes it
        with pytest.raises(FaultPlanError, match="not yet ported"):
            FaultPlan.parse(spec)
    with pytest.raises(FaultPlanError, match="unknown fault site"):
        FaultPlan.parse("bogus:raise@1")
    with pytest.raises(FaultPlanError, match="invalid for site"):
        FaultPlan.parse("serve:explode@1")
    with pytest.raises(FaultPlanError, match="missing @INDEX"):
        FaultPlan.parse("serve:raise")
    plan = FaultPlan.parse("serve:raise@2@2; serve:rollout_corrupt@0")
    ref = jfaults.FaultPlan.parse("serve:raise@2@2; serve:rollout_corrupt@0")
    assert [(s.site, s.action, s.index, s.attempt) for s in plan.specs] == [
        (s.site, s.action, s.index, s.attempt) for s in ref.specs]
    assert plan.fire("serve", 2, "raise") is None  # attempt 1, not 2
    monkeypatch.setenv("THEANOMPI_ATTEMPT", "2")
    assert plan.fire("serve", 0, "raise") is None
    assert plan.fire("serve", 2, "raise") == "raise"
    assert plan.fire("serve", 2, "raise") is None  # one-shot
    monkeypatch.setenv("THEANOMPI_FAULT_PLAN", "step:kill@3@1")
    assert serve_main(_cli_args(str(tmp_path / "R.jsonl"))) == 78
    assert "not yet ported" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "R.jsonl")


def test_sigterm_drains_the_queue_replica_and_exits_clean(tmp_path):
    """The signal path, in a child process: the replica serves its queue,
    idles waiting for more, takes SIGTERM, drains and exits 0."""
    q = str(tmp_path / "queue.jsonl")
    append_queue(q, [_entry(i) for i in range(3)])
    log = str(tmp_path / "REQUESTS.jsonl")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("THEANOMPI_FAULT_PLAN", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "theanompi_torch.serving", "--device", "cpu",
         *_TINY_SETS, *_GEOM, "--queue-file", q, "--drain-s", "30"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120
        while len(terminal_rids(log)) < 3:
            assert proc.poll() is None, proc.communicate(timeout=30)
            assert time.monotonic() < deadline, "the replica never served"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    rep = json.loads(out.strip().splitlines()[-1])
    assert rep["drained"] is True and rep["queue_file"] == q
    assert rep["terminal_states"]["done"] == 3 and rep["requests_log"] == log
    assert read_snapshot(str(tmp_path / "SERVE_SNAPSHOT.json"))["n_done"] == 3
    assert sorted(terminal_rids(log)) == [0, 1, 2]
