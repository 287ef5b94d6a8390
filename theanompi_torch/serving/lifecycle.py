"""Durable serving lifecycle files: request log, queue, live snapshot.

The port's copy of ``theanompi_tpu/serving/lifecycle.py``, standard
library only, with the same file formats byte for byte, so the
reference's router can read a port replica's files and the port's
replica can serve a queue the reference's router writes:

- ``REQUESTS.jsonl``: the durable witness that every request id reached
  exactly one terminal state across ALL attempts.  The replica appends
  one JSON line the moment a request turns terminal
  (``done|expired|shed|failed``); a restarted attempt reads the log back
  to skip already-answered ids, and a router tails it for terminal
  records (first record per rid wins across replicas).
- ``queue.jsonl``: the per-replica durable admission queue.  A router
  appends request entries (plain dicts: rid, prompt, token budget,
  ``enq_wall``); the replica polls it by byte offset and serves in
  order.  A ``{"op": "drain"}`` sentinel asks the replica to drain and
  exit clean — durable, so a replica that restarts mid-drain still
  drains.
- ``SERVE_SNAPSHOT.json``: the replica's live load published atomically
  (tmp → ``os.replace``) every N scheduler steps, so a router balances
  on *current* backlog/rate instead of the end-of-drive SERVE.json.

Append-mode JSONL files are flushed per line: a SIGKILL can lose at most
the in-flight line, and readers tolerate (skip) a torn tail.  Byte-offset
tailing (:func:`read_jsonl_since`) never consumes a line that does not
yet end in a newline — a half-written tail is simply "not there yet".
"""

from __future__ import annotations

import json
import os
import time

REQUESTS_LOG = "REQUESTS.jsonl"
QUEUE_LOG = "queue.jsonl"
SNAPSHOT = "SERVE_SNAPSHOT.json"

#: queue sentinel asking the replica to drain and exit clean
DRAIN_OP = "drain"


class RequestLog:
    """Append-only terminal-state writer for one serving attempt."""

    def __init__(self, path: str, attempt: int = 1):
        self.path = path
        self.attempt = attempt
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # append-only JSONL: readers parse per line and drop an
        # unparseable torn tail
        self._f = open(path, "a")

    def record(self, req, **extra) -> None:
        """One line per terminal request: rid, state, reason, tokens.

        The replica-side latency breakdown rides along when known:
        ``ttft_ms`` from the request's own submit/first-token
        stamps, plus caller extras (``queue_wait_ms`` — the durable-queue
        dwell the replica never sees in perf-counter time), so a router
        can aggregate router-visible TTFT without a shared clock.
        """
        rec = {"rid": req.rid, "state": req.state,
               "reason": req.reason,
               "n_generated": len(req.generated),
               "attempt": self.attempt}
        if req.t_submit is not None and req.t_first_token is not None:
            rec["ttft_ms"] = round(
                (req.t_first_token - req.t_submit) * 1e3, 3)
        rec.update(extra)
        json.dump(rec, self._f)
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def terminal_rids(path: str) -> set[int]:
    """Request ids already recorded terminal (any attempt); a restarted
    replica excludes them from its request stream.  Partial trailing
    lines (the SIGKILL race) are skipped, not fatal."""
    return {int(rec["rid"]) for rec in terminal_records(path)}


def terminal_records(path: str) -> list[dict]:
    """Every terminal record in a REQUESTS.jsonl, in append order (all
    attempts).  Torn/partial lines are skipped, missing file -> []."""
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn final line from a killed attempt
                if isinstance(rec, dict) and "rid" in rec:
                    out.append(rec)
    except OSError:
        return []
    return out


# -- the durable per-replica admission queue -----------------------------------

def append_queue(path: str, entries: list[dict]) -> None:
    """Append request entries (or the drain sentinel) to a replica's
    durable queue.  One JSON line per entry, flushed once at the end —
    the reader side never consumes a line without its newline, so a
    torn append is invisible rather than corrupt."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    # append-only JSONL: read_jsonl_since only consumes
    # newline-complete lines, a torn tail stays pending
    with open(path, "a") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


def drain_entry() -> dict:
    return {"op": DRAIN_OP}


def request_drain(path: str) -> None:
    """Ask the replica owning ``path`` to drain and exit clean (durable:
    a replica restarting mid-drain re-reads the sentinel)."""
    append_queue(path, [drain_entry()])


def read_jsonl_since(path: str, offset: int = 0) -> tuple[list[dict], int]:
    """Tail a JSONL file from byte ``offset``; -> (new records, new
    offset).  Only newline-complete lines are consumed — a half-written
    tail keeps the offset parked before it (it is "not there yet", and
    the writer's per-line flush means it will complete or never will).
    A complete-but-unparseable line (a torn write the process died past)
    is skipped AND consumed: it can never become valid.  Missing file ->
    ([], offset)."""
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read()
    except OSError:
        return [], offset
    out: list[dict] = []
    consumed = 0
    while True:
        nl = data.find(b"\n", consumed)
        if nl < 0:
            break
        line = data[consumed:nl]
        consumed = nl + 1
        if not line.strip():
            continue
        try:
            rec = json.loads(line.decode("utf-8", errors="replace"))
        except ValueError:
            continue  # torn-but-terminated line: skip, never valid
        if isinstance(rec, dict):
            out.append(rec)
    return out, offset + consumed


# -- the live load snapshot ----------------------------------------------------

def publish_snapshot(path: str, snap: dict) -> None:
    """Atomically publish a replica's live-load snapshot (tmp →
    ``os.replace``): the router reads either the previous generation or
    this one, never a torn file."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(snap, f)
    os.replace(path + ".tmp", path)


def read_snapshot(path: str) -> dict | None:
    """The last published snapshot, or None (absent/unreadable — the
    replica may not have published yet; callers fall back to their own
    bookkeeping)."""
    try:
        with open(path) as f:
            snap = json.load(f)
    except (OSError, ValueError):
        return None
    return snap if isinstance(snap, dict) else None


class SnapshotPublisher:
    """Throttled snapshot publishing for a serving drive loop.

    Publishes when either ``every_steps`` scheduler steps elapsed since
    the last publish or ``min_interval_s`` wall seconds did (the
    idle-loop case: a replica with an empty queue still refreshes its
    ``updated`` stamp so the router can tell live-and-idle from dead).
    """

    def __init__(self, path: str, every_steps: int = 8,
                 min_interval_s: float = 0.25):
        self.path = path
        self.every_steps = max(1, int(every_steps))
        self.min_interval_s = float(min_interval_s)
        self._last_step = -1
        self._last_wall = 0.0

    def maybe(self, snap_fn, n_steps: int, force: bool = False) -> bool:
        """Publish ``snap_fn()`` when due; -> whether it published."""
        now = time.time()  # wall clock: a cross-process freshness stamp
        due = (force
               or n_steps - self._last_step >= self.every_steps
               or now - self._last_wall >= self.min_interval_s)
        if not due:
            return False
        self._last_step = n_steps
        self._last_wall = now
        publish_snapshot(self.path, snap_fn())
        return True
