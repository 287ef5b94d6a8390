"""Continuous batching: admission, per-step join/evict, preemption.

Counterpart of ``theanompi_tpu/serving/scheduler.py`` (Orca-style
continuous batching, Yu et al., OSDI 2022): finished sequences evict and
free their cache blocks the step they finish, queued requests join
(prefill) the moment a slot and blocks are free, and the decode step always
runs the full fixed batch with inactive slots masked.

Block-pool pressure preempts the LONGEST active sequence (frees the most
blocks); preemption is recompute-style: the re-prefilled prefix is
``prompt + tokens generated so far``, and because sampling seeds derive
from ``(request id, position)`` only (:mod:`theanompi_torch.serving.engine`),
the replayed sequence continues exactly where it left off.

Every request ends in exactly one typed terminal state: ``done``,
``expired`` (a TTFT or total deadline passed), ``shed`` (refused at
admission: load shedding or a drain) or ``failed`` (can never fit the KV
pool).

Two drive loops: :func:`run_open_loop` (seeded synthetic arrivals) and
:func:`run_queue_loop` (a replica tailing its durable queue file, see
:mod:`theanompi_torch.serving.lifecycle`).  Both offer the scheduler to a
``between_steps`` hook every pass (the rollout watcher, whose weight swap
runs behind :meth:`Scheduler.preempt_all`) and its live load to a
snapshot publisher.  The ``serve:raise`` and ``serve:stall`` fault sites
fire at decode-step ordinals (:meth:`Scheduler._fire_faults`).  Telemetry
comes with a later slice.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from dataclasses import field

import numpy as np
import torch

from theanompi_torch.resilience.faults import FaultInjected
from theanompi_torch.serving.kv_cache import BlockPool, PagedKVCache, blocks_for
from theanompi_torch.serving.lifecycle import DRAIN_OP, read_jsonl_since
from theanompi_torch.serving.prefix_cache import PrefixCache

#: every request ends in exactly one of these
TERMINAL_STATES = ("done", "expired", "shed", "failed")


@dataclasses.dataclass
class Request:
    """One generation request.  ``arrival_s`` is the open-loop arrival
    offset (seconds from traffic start) — :func:`run_open_loop` submits
    the request when the clock passes it, regardless of server state.
    Deadlines are milliseconds from ``t_submit`` (None = no deadline)."""

    rid: int
    prompt: list[int]
    max_new_tokens: int
    temperature: float = 0.0
    arrival_s: float = 0.0
    ttft_deadline_ms: float | None = None
    total_deadline_ms: float | None = None
    # -- filled in by the scheduler -----------------------------------------
    state: str = "queued"       # queued | active | done|expired|shed|failed
    reason: str | None = None   # why a non-done terminal state was reached
    generated: list[int] = field(default_factory=list)
    n_preemptions: int = 0
    t_submit: float | None = None
    t_first_token: float | None = None
    t_done: float | None = None


class Scheduler:
    """Continuous-batching scheduler over one :class:`InferenceEngine`.

    ``shed=True`` refuses, at admission, deadline-carrying requests the
    queue's backlog provably cannot meet at the recent token rate;
    ``prefix_cache=True`` turns on the radix prefix cache over the block
    pool (admissions reuse cached full-block prompt-prefix K/V through
    partial prefill; token streams are unchanged).  ``fault_plan``
    (:class:`theanompi_torch.resilience.faults.FaultPlan`) arms the
    ``serve:raise`` and ``serve:stall`` sites.
    """

    def __init__(self, engine, eos_token: int | None = None,
                 shed: bool = False, prefix_cache: bool = False,
                 fault_plan=None):
        self.engine = engine
        self.eos_token = eos_token
        self.shed = shed
        self.fault_plan = fault_plan
        self.pool = BlockPool(engine.num_blocks)
        self.prefix_cache = (PrefixCache(self.pool, engine.block_size)
                             if prefix_cache else None)
        self.n_prefix_hits = 0
        self.n_prefix_lookups = 0
        self.prefix_tokens_saved = 0
        self.queue: deque[Request] = deque()
        b, nb = engine.max_batch, engine.max_blocks_per_seq
        self.slots: list[Request | None] = [None] * b
        self._blocks: list[list[int]] = [[] for _ in range(b)]
        self._tables = np.zeros((b, nb), np.int32)
        self._lengths = np.zeros((b,), np.int32)
        self._tokens = np.zeros((b,), np.int32)
        self._temps = np.zeros((b,), np.float32)
        self._rids = np.zeros((b,), np.int32)
        self.n_steps = 0
        self.token_ms: list[float] = []
        self.step_ms: list[float] = []  # one entry per decode step
        self.ttft_ms: list[float] = []
        self.n_preemptions = 0
        self.n_done = 0
        self.n_expired = 0
        self.n_shed = 0
        self.n_failed = 0
        self.draining = False
        # recent decode throughput: (host time, tokens emitted that step)
        self._rate: deque[tuple[float, int]] = deque(maxlen=64)

    # -- introspection -------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def idle(self) -> bool:
        return self.n_active == 0 and not self.queue

    def recent_token_rate(self) -> float | None:
        """Decoded tokens/sec over the recent window; None until 4 decode
        steps spanning a measurable interval exist."""
        if len(self._rate) < 4:
            return None
        span = self._rate[-1][0] - self._rate[0][0]
        if span <= 1e-6:
            return None
        return sum(n for _, n in self._rate) / span

    def _backlog_tokens(self) -> int:
        owed = 0
        for req in list(self.queue) + [r for r in self.slots if r]:
            owed += max(req.max_new_tokens - len(req.generated), 0)
        return owed

    def snapshot(self) -> dict:
        """Live load for a router's balancer (the reference's keys):
        backlog, recent rate, terminal tallies, prefix-hit rate.  Plain
        host ints and floats, for
        :func:`theanompi_torch.serving.lifecycle.publish_snapshot`."""
        rate = self.recent_token_rate()
        return {
            # wall clock, so another process can judge freshness
            "updated": time.time(),
            "backlog_tokens": self._backlog_tokens(),
            "queue_len": len(self.queue),
            "n_active": self.n_active,
            "token_rate": round(rate, 3) if rate is not None else None,
            "decode_steps": self.n_steps,
            "n_done": self.n_done,
            "n_expired": self.n_expired,
            "n_shed": self.n_shed,
            "n_failed": self.n_failed,
            "draining": self.draining,
            "prefix_hit_rate": (
                round(self.n_prefix_hits / self.n_prefix_lookups, 4)
                if self.n_prefix_lookups else 0.0),
        }

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue ``req``; -> True when admitted, False when it was shed.
        Structurally invalid requests raise ValueError."""
        total = len(req.prompt) + req.max_new_tokens
        if not req.prompt:
            raise ValueError(f"request {req.rid}: empty prompt")
        if total > self.engine.max_context:
            raise ValueError(
                f"request {req.rid}: prompt+max_new_tokens = {total} > "
                f"max context {self.engine.max_context}")
        if blocks_for(total, self.engine.block_size) > self.pool.num_blocks - 1:
            raise ValueError(
                f"request {req.rid}: needs "
                f"{blocks_for(total, self.engine.block_size)} blocks, pool "
                f"has {self.pool.num_blocks - 1} — num_blocks too small for "
                f"even one sequence")
        req.t_submit = time.perf_counter()
        if self.draining:
            self.mark_shed(req, "draining")
            return False
        if self.shed:
            est_ms = self._shed_estimate_ms(req)
            if est_ms is not None:
                self.mark_shed(
                    req, f"backlog needs ~{est_ms:.0f}ms at the recent "
                    f"token rate, past the deadline")
                return False
        req.state = "queued"
        self.queue.append(req)
        return True

    def _shed_estimate_ms(self, req: Request) -> float | None:
        """Estimated wait (ms) when it provably exceeds the request's
        deadline budget, else None (admit)."""
        budget = min((d for d in (req.ttft_deadline_ms,
                                  req.total_deadline_ms) if d is not None),
                     default=None)
        rate = self.recent_token_rate()
        if budget is None or rate is None or rate <= 0:
            return None
        est_ms = self._backlog_tokens() / rate * 1e3
        return est_ms if est_ms > budget else None

    # -- terminal states -----------------------------------------------------
    def _clear_slot(self, slot: int) -> None:
        self.slots[slot] = None
        self._blocks[slot] = []
        self._tables[slot, :] = PagedKVCache.NULL_BLOCK
        self._lengths[slot] = 0
        self._tokens[slot] = 0
        self._temps[slot] = 0.0
        self._rids[slot] = 0

    def _evict(self, slot: int) -> Request:
        """Release a slot's blocks; with the prefix cache on, its FULL
        blocks are offered to the radix tree first and only the partial
        tail block frees."""
        req = self.slots[slot]
        blocks = self._blocks[slot]
        if self.prefix_cache is not None and blocks:
            n_full = int(self._lengths[slot]) // self.engine.block_size
            tokens = (req.prompt + req.generated)[
                :n_full * self.engine.block_size]
            self.prefix_cache.insert(tokens, blocks[:n_full])
            self.pool.free(blocks[n_full:])
        else:
            self.pool.free(blocks)
        self._clear_slot(slot)
        return req

    def _finish(self, slot: int, finished: list[Request]) -> None:
        req = self._evict(slot)
        req.state = "done"
        req.t_done = time.perf_counter()
        self.n_done += 1
        finished.append(req)

    def _expire(self, req: Request, which: str, where: str,
                finished: list[Request]) -> None:
        req.state = "expired"
        req.reason = f"{which} deadline exceeded ({where})"
        req.t_done = time.perf_counter()
        self.n_expired += 1
        finished.append(req)

    def mark_shed(self, req: Request, reason: str) -> None:
        """Refused at admission: never queued, no blocks, no tokens."""
        now = time.perf_counter()
        if req.t_submit is None:
            req.t_submit = now
        req.state = "shed"
        req.reason = reason
        req.t_done = now
        self.n_shed += 1

    def _fail(self, req: Request, need: int,
              finished: list[Request]) -> None:
        """The livelock guard: a request whose prefix can never fit the
        pool is refused instead of preempted around forever."""
        req.state = "failed"
        req.reason = (f"needs {need} KV blocks, pool has "
                      f"{self.pool.num_blocks - 1} — can never be admitted")
        req.t_done = time.perf_counter()
        self.n_failed += 1
        finished.append(req)

    def _deadline_overrun(self, req: Request,
                          now: float | None = None) -> str | None:
        """Which deadline ``req`` has blown ("ttft" | "total"), or None."""
        if req.t_submit is None:
            return None
        now = time.perf_counter() if now is None else now
        elapsed_ms = (now - req.t_submit) * 1e3
        if (req.total_deadline_ms is not None
                and elapsed_ms > req.total_deadline_ms):
            return "total"
        if (req.t_first_token is None and req.ttft_deadline_ms is not None
                and elapsed_ms > req.ttft_deadline_ms):
            return "ttft"
        return None

    def _sweep_deadlines(self, finished: list[Request]) -> None:
        """Expire overrun queued and active requests between steps."""
        now = time.perf_counter()
        kept: deque[Request] = deque()
        while self.queue:
            req = self.queue.popleft()
            which = self._deadline_overrun(req, now)
            if which:
                self._expire(req, which, "queued", finished)
            else:
                kept.append(req)
        self.queue = kept
        for slot in range(self.engine.max_batch):
            req = self.slots[slot]
            if req is not None:
                which = self._deadline_overrun(req, now)
                if which:
                    self._evict(slot)
                    self._expire(req, which, "active", finished)

    def _preempt(self, slot: int) -> None:
        req = self._evict(slot)
        req.n_preemptions += 1
        self.n_preemptions += 1
        req.state = "queued"
        self.queue.appendleft(req)  # rejoin first: it already holds work

    def preempt_all(self) -> int:
        """Evict every active request back to the queue front (recompute
        preemption): the weight swap's barrier, since the KV cache was
        computed under the old weights and the active sequences re-prefill
        under the new ones.  -> the number preempted."""
        n = 0
        for slot in range(self.engine.max_batch):
            if self.slots[slot] is not None:
                self._preempt(slot)
                n += 1
        return n

    def _alloc(self, n: int) -> list[int] | None:
        """Pool allocation; when the free list can't cover ``n``, the radix
        tree evicts LRU zero-ref leaves first."""
        row = self.pool.alloc(n)
        if row is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.pool.free_blocks)
            row = self.pool.alloc(n)
        return row

    def _admit(self, finished: list[Request]) -> None:
        """Prefill queued requests into free slots while blocks last."""
        if self.prefix_cache is not None:
            self.prefix_cache.check_version(self.engine.params_version)
        while self.queue:
            req = self.queue[0]
            which = self._deadline_overrun(req)
            if which:  # before any prefill work is burned on it
                self.queue.popleft()
                self._expire(req, which, "queued", finished)
                continue
            try:
                slot = self.slots.index(None)
            except ValueError:
                return
            prefix = req.prompt + req.generated
            need = blocks_for(len(prefix), self.engine.block_size)
            if need > self.pool.num_blocks - 1:
                self.queue.popleft()
                self._fail(req, need, finished)
                continue
            matched: list[int] = []
            prefix_len = 0
            if self.prefix_cache is not None:
                self.n_prefix_lookups += 1
                matched = self.prefix_cache.match(prefix)
                prefix_len = len(matched) * self.engine.block_size
            new = self._alloc(need - len(matched))
            if new is None:
                if matched:
                    self.pool.free(matched)
                if self.n_active == 0 and (self.prefix_cache is None
                                           or self.prefix_cache.n_nodes
                                           == 0):
                    # an empty server that still can't allocate: refuse
                    # THIS request instead of stalling every other one
                    self.queue.popleft()
                    self._fail(req, need, finished)
                    continue
                return
            row = matched + new
            self.queue.popleft()
            tok, _ = self.engine.prefill(row, prefix, req.temperature,
                                         req.rid, prefix_len=prefix_len)
            if prefix_len:
                self.n_prefix_hits += 1
                self.prefix_tokens_saved += prefix_len
            now = time.perf_counter()
            if req.t_first_token is None:
                req.t_first_token = now
                self.ttft_ms.append((now - req.t_submit) * 1e3)
            req.generated.append(tok)
            req.state = "active"
            self.slots[slot] = req
            self._blocks[slot] = row
            self._tables[slot, :] = PagedKVCache.NULL_BLOCK
            self._tables[slot, :need] = row
            self._lengths[slot] = len(prefix)
            self._tokens[slot] = tok
            self._temps[slot] = req.temperature
            self._rids[slot] = req.rid
            if self._done(req):
                self._finish(slot, finished)

    def _done(self, req: Request) -> bool:
        if len(req.generated) >= req.max_new_tokens:
            return True
        return (self.eos_token is not None and bool(req.generated)
                and req.generated[-1] == self.eos_token)

    def _ensure_capacity(self) -> None:
        """Every active slot whose NEXT token starts a new block gets one
        before the decode step; exhaustion preempts the longest active
        sequence and retries."""
        for slot in range(self.engine.max_batch):
            if self.slots[slot] is None:
                continue
            if self._lengths[slot] % self.engine.block_size != 0:
                continue
            while self.slots[slot] is not None:
                got = self.pool.alloc(1)
                if got is not None:
                    n_used = blocks_for(int(self._lengths[slot]),
                                        self.engine.block_size)
                    self._blocks[slot].extend(got)
                    self._tables[slot, n_used] = got[0]
                    break
                victim = max(
                    (s for s in range(self.engine.max_batch)
                     if self.slots[s] is not None),
                    key=lambda s: int(self._lengths[s]))
                self._preempt(victim)

    def _fire_faults(self) -> None:
        """The ``serve:raise`` and ``serve:stall`` sites, indexed by the
        decode-step ordinal, fired just before the step's decode.  The
        fires are narrowed by action: the rollout watcher counts another
        ordinal (candidates) for ``serve:rollout_corrupt``."""
        if self.fault_plan is None:
            return
        if self.fault_plan.fire("serve", self.n_steps, "stall"):
            time.sleep(float(os.environ.get("THEANOMPI_SERVE_STALL_S",
                                            "2.0")))
        if self.fault_plan.fire("serve", self.n_steps, "raise"):
            raise FaultInjected(
                f"serve:raise at decode step {self.n_steps}")

    def step(self) -> list[Request]:
        """One iteration: enforce deadlines, admit, secure blocks, decode
        the fixed batch, account the new tokens; -> every request that
        reached a terminal state this step."""
        finished: list[Request] = []
        self._sweep_deadlines(finished)
        self._admit(finished)
        if self.n_active == 0:
            return finished
        self._ensure_capacity()
        active = [s for s in range(self.engine.max_batch)
                  if self.slots[s] is not None]
        if not active:  # capacity pressure preempted everyone admitted
            return finished
        self._fire_faults()
        t0 = time.perf_counter()
        # decode() returns host token ids: the device work is done
        nxt, _ = self.engine.decode(self._tables, self._lengths,
                                    self._tokens, self._temps, self._rids)
        t1 = time.perf_counter()
        step_ms = (t1 - t0) * 1e3
        self.step_ms.append(step_ms)
        self.n_steps += 1
        self._rate.append((t1, len(active)))
        for slot in active:
            req = self.slots[slot]
            self._lengths[slot] += 1  # the fed token is now cached
            tok = int(nxt[slot])
            req.generated.append(tok)
            self._tokens[slot] = tok
            self.token_ms.append(step_ms)
            if self._done(req):
                self._finish(slot, finished)
        return finished

    # -- graceful drain --------------------------------------------------------
    def begin_drain(self) -> list[Request]:
        """Stop admitting: every queued request is shed ("draining");
        active requests keep decoding.  -> the newly shed requests."""
        self.draining = True
        shed: list[Request] = []
        while self.queue:
            req = self.queue.popleft()
            self.mark_shed(req, "draining")
            shed.append(req)
        return shed

    def expire_all_active(self, reason: str) -> list[Request]:
        """Force every in-flight request terminal (drain deadline)."""
        out: list[Request] = []
        for slot in range(self.engine.max_batch):
            if self.slots[slot] is not None:
                req = self._evict(slot)
                self._expire(req, "drain", reason, out)
        return out

    def end_drain(self) -> None:
        """The drain's end (the reference's telemetry instant; the port's
        telemetry is a later slice, so nothing is recorded yet)."""


def run_open_loop(scheduler: Scheduler, requests: list[Request],
                  poll_s: float = 0.002, *, drain=None,
                  drain_s: float = 5.0, on_terminal=None,
                  between_steps=None,
                  snapshot=None) -> tuple[dict[int, Request], float]:
    """Drive open-loop traffic: each request is submitted when the clock
    passes its ``arrival_s``, and the scheduler steps until every request
    is terminal.  ``drain``: a zero-arg callable polled every pass; once
    true, admission stops (queued and not-yet-arrived requests shed), the
    in-flight requests decode for up to ``drain_s`` seconds, the rest
    expire.  ``on_terminal(req)`` fires once per terminal request.
    ``between_steps(scheduler)`` runs every pass (the rollout watcher's
    poll point); ``snapshot``: a
    :class:`~theanompi_torch.serving.lifecycle.SnapshotPublisher` offered
    the live load every pass and, forced, at the end.
    -> ({rid: terminal request}, wall seconds)."""
    pending = deque(sorted(requests, key=lambda r: r.arrival_s))
    results: dict[int, Request] = {}

    def _terminal(req: Request) -> None:
        results[req.rid] = req
        if on_terminal is not None:
            on_terminal(req)

    draining = False
    drain_deadline = 0.0
    t0 = time.perf_counter()
    while len(results) < len(requests):
        if between_steps is not None:
            between_steps(scheduler)
        if snapshot is not None:
            snapshot.maybe(scheduler.snapshot, scheduler.n_steps)
        if drain is not None and not draining and drain():
            draining = True
            drain_deadline = time.perf_counter() + drain_s
            for req in scheduler.begin_drain():
                _terminal(req)
            while pending:
                req = pending.popleft()
                scheduler.mark_shed(req, "draining")
                _terminal(req)
        now = time.perf_counter() - t0
        if not draining:
            while pending and pending[0].arrival_s <= now:
                req = pending.popleft()
                if not scheduler.submit(req):
                    _terminal(req)
        if scheduler.idle:
            if draining:
                break
            if pending:
                time.sleep(min(poll_s, max(pending[0].arrival_s - now, 0.0)))
            continue
        for req in scheduler.step():
            _terminal(req)
        if draining and time.perf_counter() >= drain_deadline:
            for req in scheduler.expire_all_active("drain deadline"):
                _terminal(req)
            break
    if draining:
        scheduler.end_drain()
    if snapshot is not None:  # the final publish: terminal tallies land
        snapshot.maybe(scheduler.snapshot, scheduler.n_steps, force=True)
    return results, time.perf_counter() - t0


def run_queue_loop(scheduler: Scheduler, queue_path: str,
                   poll_s: float = 0.002, *, drain=None,
                   drain_s: float = 5.0, on_terminal=None,
                   between_steps=None, snapshot=None,
                   answered: set[int] | None = None,
                   ) -> tuple[dict[int, Request], float]:
    """Drive a replica off its durable admission queue (the reference's
    :743).

    A router appends request entries to ``queue_path``
    (:func:`theanompi_torch.serving.lifecycle.append_queue`); this loop
    tails the file by byte offset, submits each entry as it appears, and
    runs until a ``{"op": "drain"}`` sentinel arrives (finish what is in
    flight, then return) or the ``drain`` callable trips (the SIGTERM
    path: shed queued work with reason "draining", decode in-flight
    requests for up to ``drain_s``, expire the rest).

    ``answered``: rids already terminal in a previous attempt (from
    REQUESTS.jsonl); their entries are skipped, neither served nor
    recorded again.  ``on_terminal(req, queue_wait_ms=...)`` gets the wall
    time from the entry's ``enq_wall`` stamp to its submission, so a
    router can rebuild the TTFT it sees without a shared clock.

    -> ({rid: terminal request}, wall seconds)."""
    results: dict[int, Request] = {}
    answered = set() if answered is None else set(answered)
    queue_wait_ms: dict[int, float] = {}

    def _terminal(req: Request) -> None:
        results[req.rid] = req
        if on_terminal is not None:
            extra = {}
            if req.rid in queue_wait_ms:
                extra["queue_wait_ms"] = queue_wait_ms[req.rid]
            on_terminal(req, **extra)

    def _entry_to_request(e: dict) -> Request:
        return Request(
            rid=int(e["rid"]),
            prompt=list(e["prompt"]),
            max_new_tokens=int(e.get("max_new_tokens", 16)),
            temperature=float(e.get("temperature", 0.0)),
            ttft_deadline_ms=e.get("ttft_deadline_ms"),
            total_deadline_ms=e.get("total_deadline_ms"),
        )

    offset = 0
    drain_seen = False        # the durable sentinel: finish, then return
    sig_draining = False      # SIGTERM: shed, bounded decode, expire
    drain_deadline = 0.0
    t0 = time.perf_counter()
    while True:
        if between_steps is not None:
            between_steps(scheduler)
        if snapshot is not None:
            snapshot.maybe(scheduler.snapshot, scheduler.n_steps)
        if not sig_draining:
            entries, offset = read_jsonl_since(queue_path, offset)
            for e in entries:
                if e.get("op") == DRAIN_OP:
                    drain_seen = True
                    continue
                if "rid" not in e or int(e["rid"]) in answered:
                    continue
                req = _entry_to_request(e)
                if "enq_wall" in e:
                    # wall clock: the stamp came from the router's process
                    queue_wait_ms[req.rid] = round(
                        max(time.time() - float(e["enq_wall"]), 0.0) * 1e3,
                        3)
                answered.add(req.rid)  # one submission a rid an attempt
                if not scheduler.submit(req):
                    _terminal(req)
        if drain is not None and not sig_draining and drain():
            sig_draining = True
            drain_deadline = time.perf_counter() + drain_s
            for req in scheduler.begin_drain():
                _terminal(req)
        if scheduler.idle:
            if drain_seen or sig_draining:
                break
            time.sleep(poll_s)
            continue
        for req in scheduler.step():
            _terminal(req)
        if sig_draining and time.perf_counter() >= drain_deadline:
            for req in scheduler.expire_all_active("drain deadline"):
                _terminal(req)
            break
    if sig_draining:
        scheduler.end_drain()
    if snapshot is not None:
        snapshot.maybe(scheduler.snapshot, scheduler.n_steps, force=True)
    return results, time.perf_counter() - t0


def serve_report(results: dict[int, Request], wall_s: float,
                 scheduler: Scheduler) -> dict:
    """The SERVE.json report: throughput and latency percentiles (the
    reference's keys), plus the device that produced them."""
    eng = scheduler.engine
    n_tokens = sum(len(r.generated) for r in results.values())

    def pct(xs):
        if not xs:
            return {}
        arr = np.asarray(xs)
        return {"p50": round(float(np.percentile(arr, 50)), 3),
                "p99": round(float(np.percentile(arr, 99)), 3)}

    states = {s: 0 for s in TERMINAL_STATES}
    for r in results.values():
        states[r.state] = states.get(r.state, 0) + 1
    dev = eng.device
    return {
        "metric": "serve_tokens_per_sec",
        "value": round(n_tokens / wall_s, 2) if wall_s > 0 else 0.0,
        "unit": "tokens/sec",
        "device": (f"cuda:{torch.cuda.get_device_name(dev)}"
                   if dev.type == "cuda" else "cpu"),
        "requests": len(results),
        "generated_tokens": n_tokens,
        "wall_s": round(wall_s, 3),
        "ttft_ms": pct(scheduler.ttft_ms),
        "token_ms": pct(scheduler.token_ms),
        "preemptions": scheduler.n_preemptions,
        "decode_steps": scheduler.n_steps,
        "decode_kernel": eng.decode_impl,
        "decode_step_ms": pct(scheduler.step_ms),
        "terminal_states": states,
        "drained": scheduler.draining,
        "quantized_int8": eng.quantized,
        "prefix_cache": scheduler.prefix_cache is not None,
        "prefix_hit_rate": (
            round(scheduler.n_prefix_hits / scheduler.n_prefix_lookups, 4)
            if scheduler.n_prefix_lookups else 0.0),
        "prefill_tokens_saved": scheduler.prefix_tokens_saved,
        "config": {
            "block_size": eng.block_size,
            "num_blocks": eng.num_blocks,
            "max_batch": eng.max_batch,
            "max_context": eng.max_context,
        },
    }
