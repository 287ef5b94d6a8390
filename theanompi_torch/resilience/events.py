"""Crash-safe event log inside ``resilience.json``.

The port's copy of ``theanompi_tpu/resilience/events.py``: the
checkpoint recovery chain appends ``ckpt.quarantine`` and
``ckpt.fallback`` events to the ``events`` list of
``<checkpoint dir>/resilience.json``, read-modify-write with an atomic
``os.replace``, keeping every other key of the file (a supervisor's
attempt summary) as it found it.  Standard library only.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


def read_events(path: str) -> list[dict]:
    """The ``events`` list of a resilience.json, or ``[]``."""
    events = _read(path).get("events")
    return events if isinstance(events, list) else []


def _read(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            loaded = json.load(f)
    except (OSError, ValueError) as e:
        print(f"resilience: unreadable {path} ({e}); starting a fresh "
              f"event list", file=sys.stderr, flush=True)
        return {}
    return loaded if isinstance(loaded, dict) else {}


def record_event(path: str, name: str, **fields) -> None:
    """Append one event (``ts`` wall-clock seconds, ``name``, ``fields``),
    atomically rewriting the file.  Best-effort: a failure to write is
    reported on stderr and does not abort the recovery it records."""
    data = _read(path)
    data.setdefault("events", []).append(
        {"ts": time.time(), "name": name, **fields})
    # a per-writer temporary name: two writers never publish each other's
    # half-written file
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
    except OSError as e:
        print(f"resilience: could not record {name!r} in {path}: {e}",
              file=sys.stderr, flush=True)
