"""Checkpoints and resume: one verified ``.npz`` an epoch in the
reference's format, written off the training thread.

The port's copy of ``theanompi_tpu/utils/checkpoint.py``, without JAX.
A directory holds ``ckpt_eNNNN.npz`` files, each beside its
``ckpt_eNNNN.manifest.json``, a ``latest.json`` pointer, the ``dirty``
marker while a writing run lives, ``corrupt/`` for quarantined files,
``resilience.json`` for the recovery chain's events and the recorder's
``*_history.npy`` / ``summary.json``.  The files are the reference's:
leaves under ``"<tree>::<path joined by />"`` keys, the manifest's
per-leaf CRC32, shapes, dtypes and byte counts, the epoch's iteration,
the LR factor, the data plane's position and the run fingerprint.  A
directory written by either package resumes in the other (the trainer's
codec, :func:`theanompi_torch.convert.train_state_to_jax`, puts conv
kernels HWIO and ``zero1``'s buckets in the reference's element order).

- **The save** (:meth:`Checkpointer.save`) is split as the reference's
  (:985-1131).  On the training thread, :func:`snapshot` takes a copy
  that owns its bytes: a CUDA leaf is copied into its view of one pinned
  host block on a side stream that first waits for the training stream
  (so it reads the finished values), each source tensor marked used on
  that stream (``record_stream``, so the caching allocator cannot hand
  its memory to the next step while the copy reads it), and one event
  recorded after the last copy.  The block is allocated once, by
  :meth:`Checkpointer.reserve` before the first step (else by the first
  save, or by a save whose leaves changed shape), is this checkpointer's,
  and is refilled only by the next save, which first joins the writer
  that reads it: at most one save is in flight.  A CPU leaf is cloned.
  The writer
  (a thread with ``async_save``, else inline: one code path, so both
  publish the same bytes) waits on the event, encodes the trees to numpy
  (the codec), serializes to a temporary file, then publishes
  atomically: the manifest first, then the ``.npz``, then
  ``latest.json``, the recorder's histories, the scrub of one older file
  and the retention prune.  A writer's exception is re-raised at the
  next join (the next save, a load, the end of the run).
- **Verification** (:func:`verify_file`): ``fast`` checks the manifest
  and the archive's member set, ``full`` also every leaf's shape, dtype
  and CRC32.  A resume verifies ``full`` after an unclean exit (the
  ``dirty`` marker) and ``fast`` otherwise.
- **The recovery chain** (:meth:`Checkpointer.load_latest_verified`):
  a file that fails verification is moved under ``corrupt/``, the chain
  steps back to the newest verifiable one and records ``ckpt.fallback``
  in ``resilience.json``; when none survives it raises
  :class:`CheckpointChainExhausted` (the launcher's exit 77).  A
  fingerprint mismatch raises :class:`CheckpointFingerprintError` (exit
  78) unless ``resume_force``.
- **The read-only consumer** (:func:`load_for_inference`, serving's
  ``--checkpoint-dir``): the same chain, which steps over a corrupt file
  without moving it and writes nothing to the directory, and a
  fingerprint check of the model class and config only.
- **The scrubber**: ``python -m theanompi_torch.utils.checkpoint --verify
  DIR`` full-verifies every retained file, exit 0 or 77.

Not carried here (ROADMAP): the elastic reshard family, the fault plan's
corruption sites and the multi-host broadcast.
A run of several ranks on one host agrees on a resume through
:func:`theanompi_torch.parallel.trainer.BaseTrainer.try_resume` (rank 0
runs the chain and restores, then every other rank reads the epoch it
broadcasts).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
import zipfile
import zlib

import numpy as np

from theanompi_torch.tree import tree_leaves_with_path, tree_map_with_path

#: manifest schema version (the reference's)
MANIFEST_VERSION = 1

#: the data plane's position as a payload leaf: JSON bytes as uint8, so
#: the CRC and the member-set check cover it like any model leaf
DATA_STATE_LEAF = "__data_state__"


class CheckpointError(RuntimeError):
    """Base class for typed checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint failed verification (torn write, bit-flip, missing or
    malformed manifest, unreadable archive)."""


class CheckpointChainExhausted(CheckpointCorruptError):
    """Checkpoints existed, but none survived verification: there is
    nothing trustworthy to resume from (the launcher exits 77)."""


class CheckpointFingerprintError(CheckpointError):
    """The checkpoint was written under another run topology (mesh,
    exchange strategy, ``n_subb``) or model config.  A refusal, not a
    corruption: an older checkpoint would mismatch too.  Overridden by
    ``--resume-force`` / the ``resume_force`` rule key."""


class CheckpointReshardableMismatch(CheckpointFingerprintError):
    """A fingerprint mismatch confined to the topology keys (mesh,
    exchange strategy, ``n_subb``): the model is the same, and the
    reference's ``--resume-reshard`` could re-lay it out (the port's
    reshard is ROADMAP item 14).  Still a refusal (exit 78)."""


#: the fingerprint keys a topology change moves (the reference's :357)
RESHARDABLE_FP_KEYS = ("mesh", "exchange", "n_subb")


# -- leaves ------------------------------------------------------------------

def _leaf_key(path) -> str:
    """A tree path (dict keys and list indices) as the reference's leaf
    key: its parts joined by ``/``."""
    return "/".join(str(p) for p in path)


def flat_leaves(name: str, tree) -> dict:
    """``{"<name>::<path>": leaf}`` of one named tree."""
    return {f"{name}::{_leaf_key(p)}": x
            for p, x in tree_leaves_with_path(tree)}


def _as_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a host tensor
        if str(x.dtype) == "torch.bfloat16":
            raise TypeError("checkpoint: a bfloat16 leaf has no numpy "
                            "dtype (params and optimizer state are fp32)")
        return x.detach().numpy()
    return np.asarray(x)


def encode_plain(trees: dict) -> dict[str, np.ndarray]:
    """The default codec's encode: every leaf under its key, as is."""
    out = {}
    for name, tree in trees.items():
        out.update({k: _as_numpy(x) for k, x in flat_leaves(name,
                                                           tree).items()})
    return out


def restore_into(template, arrays: dict, convert=None):
    """A tree shaped like ``template`` from ``arrays`` (``{"<path>":
    ndarray}``): each leaf's shape must equal the template's
    (``ValueError``; a missing leaf is a ``KeyError``), and takes its
    dtype and, for a tensor, its device.  ``convert(arr)`` maps a stored
    array to the template's layout first."""
    import torch

    def leaf(path, t):
        key = _leaf_key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key] if convert is None else convert(arrays[key])
        want = tuple(getattr(t, "shape", ()))
        if tuple(arr.shape) != want:
            raise ValueError(f"checkpoint leaf {key!r} shape "
                             f"{tuple(arr.shape)} != expected {want}")
        if isinstance(t, torch.Tensor):
            return torch.from_numpy(np.array(arr, copy=True)).to(
                device=t.device, dtype=t.dtype)
        return np.array(arr, dtype=getattr(t, "dtype", None), copy=True)

    return tree_map_with_path(leaf, template)


def decode_plain(arrays: dict, templates: dict) -> dict:
    """The default codec's decode: each named template restored from its
    ``"<name>::"`` leaves."""
    return {name: restore_into(t, {k.split("::", 1)[1]: v
                                   for k, v in arrays.items()
                                   if k.startswith(f"{name}::")})
            for name, t in templates.items()}


# -- the snapshot -------------------------------------------------------------

class Snapshot:
    """Host copies of a save's trees that own their bytes, and the event
    that says the card's copies into them are done (None: nothing was
    copied from a card)."""

    __slots__ = ("trees", "event")

    def __init__(self, trees: dict, event):
        self.trees = trees
        self.event = event

    def wait(self) -> dict:
        """The trees, once every copy into them has landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.trees


#: byte alignment of each leaf's view in the pinned block
_STAGE_ALIGN = 256


def _card_specs(trees: dict) -> dict:
    """``{key: (shape, dtype)}`` of the leaves a snapshot stages through
    pinned memory: tensors on a card, and meta tensors standing for card
    tensors that do not exist yet."""
    import torch

    specs = {}
    for name, tree in trees.items():
        for path, x in tree_leaves_with_path(tree):
            if isinstance(x, torch.Tensor) and (x.is_cuda or x.is_meta):
                specs[f"{name}::{_leaf_key(path)}"] = (tuple(x.shape),
                                                       x.dtype)
    return specs


class _Stager:
    """The training-thread half of a save: CUDA leaves copied into their
    views of one pinned host block on a side stream, CPU tensors cloned,
    numpy arrays copied."""

    def __init__(self):
        self._specs: dict = {}
        self._views: dict[str, object] = {}
        self._streams: dict = {}

    def _stream(self, device):
        import torch

        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
        return s

    def reserve(self, trees: dict) -> None:
        """Allocate the pinned block for ``trees``' card leaves, one view
        a leaf, unless the current block already fits them."""
        import torch

        specs = _card_specs(trees)
        if specs == self._specs:
            return
        self._views = {}  # the old block goes when its views do
        sizes = {k: int(np.prod(shape)) * dtype.itemsize
                 for k, (shape, dtype) in specs.items()}
        offsets, total = {}, 0
        for k, n in sizes.items():
            offsets[k] = total
            total += -(-n // _STAGE_ALIGN) * _STAGE_ALIGN
        block = torch.empty(total, dtype=torch.uint8, pin_memory=total > 0)
        for k, (shape, dtype) in specs.items():
            lo = offsets[k]
            self._views[k] = block[lo:lo + sizes[k]].view(dtype).view(shape)
        self._specs = specs

    def snapshot(self, trees: dict, handed_over=()) -> Snapshot:
        import torch

        self.reserve(trees)
        handed = {id(x) for x in handed_over}
        stream = event = None
        out = {}
        for name, tree in trees.items():
            def leaf(path, x, name=name):
                nonlocal stream
                if not isinstance(x, torch.Tensor):
                    return np.array(x, copy=True)
                if not x.is_cuda:
                    # a host leaf handed over is this save's own already
                    return x if id(x) in handed else x.detach().clone()
                x = x.detach()
                if stream is None:
                    stream = self._stream(x.device)
                    # the copies read what the training stream wrote
                    stream.wait_stream(torch.cuda.current_stream(x.device))
                buf = self._views[f"{name}::{_leaf_key(path)}"]
                with torch.cuda.stream(stream):
                    buf.copy_(x, non_blocking=True)
                # the step that frees x must not hand its memory on while
                # this copy reads it
                x.record_stream(stream)
                return buf

            out[name] = tree_map_with_path(leaf, tree)
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        return Snapshot(out, event)


# -- integrity primitives -----------------------------------------------------

def _manifest_path(npz_path: str) -> str:
    """``.../ckpt_e0001.npz`` -> ``.../ckpt_e0001.manifest.json``."""
    return npz_path[: -len(".npz")] + ".manifest.json"


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def build_manifest(epoch: int, iteration: int, flat: dict[str, np.ndarray],
                   fingerprint: dict | None, lr_scale: float = 1.0,
                   data_state: dict | None = None) -> dict:
    """The manifest of a flat leaf dict, deterministic (no timestamps;
    serialized with sorted keys), so an async and a sync save of the same
    state publish byte-identical manifests.  ``data_state`` is left out
    when None, as the reference's."""
    out = {"format": MANIFEST_VERSION, "epoch": int(epoch),
           "iteration": int(iteration), "lr_scale": float(lr_scale),
           "fingerprint": fingerprint}
    if data_state is not None:
        out["data_state"] = data_state
    out["leaves"] = {k: {"shape": list(a.shape), "dtype": str(a.dtype),
                         "nbytes": int(a.nbytes), "crc32": _leaf_crc(a)}
                     for k, a in flat.items()}
    return out


def read_manifest(npz_path: str) -> dict:
    """The manifest beside a checkpoint file."""
    with open(_manifest_path(npz_path)) as f:
        return json.load(f)


def _check_leaf(name: str, key: str, meta: dict, arr: np.ndarray) -> None:
    """One leaf against its manifest entry (shape, dtype, CRC32); raises
    :class:`CheckpointCorruptError`."""
    if (list(arr.shape) != list(meta["shape"])
            or str(arr.dtype) != meta["dtype"]):
        raise CheckpointCorruptError(
            f"{name}: leaf {key!r} is {arr.dtype}{tuple(arr.shape)}, "
            f"manifest says {meta['dtype']}{tuple(meta['shape'])}")
    crc = _leaf_crc(arr)
    if crc != int(meta["crc32"]):
        raise CheckpointCorruptError(
            f"{name}: leaf {key!r} CRC mismatch (manifest "
            f"{int(meta['crc32']):#010x}, file {crc:#010x}): bit-flip or "
            f"partial copy")


def _epoch_of(fname: str) -> int | None:
    """``ckpt_e0003.npz`` -> 3; None for a foreign file that matches the
    glob (``ckpt_e0003.bak.npz``), which is never verified, quarantined
    or pruned."""
    try:
        return int(fname[len("ckpt_e"):-len(".npz")])
    except ValueError:
        return None


def _is_ckpt(fname: str) -> bool:
    # crash debris (ckpt_e0003.npz.tmp.npz) is not a checkpoint
    return (fname.startswith("ckpt_e") and fname.endswith(".npz")
            and not fname.endswith(".tmp.npz")
            and _epoch_of(fname) is not None)


def verify_file(npz_path: str, level: str = "full") -> dict:
    """Verify one checkpoint against its manifest; -> the manifest.

    ``fast``: the manifest is present and well formed, and the archive's
    member set is its leaf set (catches truncation, torn publishes and a
    missing manifest).  ``full``: also every leaf's shape, dtype and CRC32
    (catches a bit-flip the zip structure survived).  Raises
    :class:`CheckpointCorruptError`; changes nothing."""
    if level not in ("fast", "full"):
        raise ValueError(f"verify level must be 'fast' or 'full', "
                         f"got {level!r}")
    name = os.path.basename(npz_path)
    mpath = _manifest_path(npz_path)
    if not os.path.exists(npz_path):
        raise CheckpointCorruptError(f"{name}: checkpoint file missing")
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(
            f"{name}: manifest {os.path.basename(mpath)} missing (torn "
            f"publish, or a checkpoint without one: resume once with "
            f"checkpoint_verify='none')")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"{name}: unreadable manifest: "
                                     f"{e}") from e
    leaves = manifest.get("leaves")
    if not isinstance(leaves, dict) or not leaves:
        raise CheckpointCorruptError(f"{name}: malformed manifest (no leaf "
                                     f"table)")
    try:
        with zipfile.ZipFile(npz_path) as z:
            members = {n[:-len(".npy")] if n.endswith(".npy") else n
                       for n in z.namelist()}
    except (OSError, zipfile.BadZipFile) as e:
        raise CheckpointCorruptError(
            f"{name}: unreadable archive (truncated or torn?): {e}") from e
    if members != set(leaves):
        raise CheckpointCorruptError(
            f"{name}: leaf set differs from manifest (missing "
            f"{sorted(set(leaves) - members)[:3]}, unexpected "
            f"{sorted(members - set(leaves))[:3]})")
    if level == "full":
        try:
            with np.load(npz_path) as z:
                for key, meta in leaves.items():
                    _check_leaf(name, key, meta, z[key])
        except CheckpointCorruptError:
            raise
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            # zipfile's own member CRC can fire first ("Bad CRC-32")
            raise CheckpointCorruptError(
                f"{name}: read failed during full verify: {e}") from e
    return manifest


def _normalize_fp(fp: dict) -> dict:
    """JSON round trip, so a fingerprint in memory (tuples, ints) compares
    equal to one read back from a manifest."""
    return json.loads(json.dumps(fp, sort_keys=True))


def check_fingerprint(manifest: dict, mine: dict | None, npz_path: str,
                      force: bool = False, subset: bool = False) -> None:
    """Refuse a checkpoint of another run (or warn, under ``force``).
    Skipped when either side has no fingerprint.  The refusal names the
    keys that differ, and is typed by them: a mismatch of the topology
    keys alone raises :class:`CheckpointReshardableMismatch`.
    ``subset=True`` compares only the keys ``mine`` provides: the serving
    consumer's mode (the reference's :379), which has no mesh or exchange
    to match but must match the model class and config."""
    theirs = manifest.get("fingerprint")
    if theirs is None or mine is None:
        return
    mine, theirs = _normalize_fp(mine), _normalize_fp(theirs)
    if subset:
        theirs = {k: v for k, v in theirs.items() if k in mine}
    if mine == theirs:
        return
    diffs = ", ".join(
        f"{k}: checkpoint={theirs.get(k)!r} != run={mine.get(k)!r}"
        for k in sorted(set(theirs) | set(mine))
        if theirs.get(k) != mine.get(k))
    if subset:
        msg = (f"{os.path.basename(npz_path)}: run fingerprint mismatch "
               f"({diffs}): this checkpoint was trained with a different "
               f"model class/config; serving it would mismap weights. "
               f"Reproduce the training --set flags, or pass --serve-force "
               f"to override")
    else:
        msg = (f"{os.path.basename(npz_path)}: run fingerprint mismatch "
               f"({diffs}): this checkpoint belongs to another run; pass "
               f"--resume-force (rule key resume_force=True) to override")
    if force:
        print(f"checkpoint: WARNING: {msg}; proceeding (force)",
              file=sys.stderr, flush=True)
        return
    if not subset and all(k in RESHARDABLE_FP_KEYS
                          for k in set(theirs) | set(mine)
                          if theirs.get(k) != mine.get(k)):
        raise CheckpointReshardableMismatch(msg)
    raise CheckpointFingerprintError(msg)


#: model-config keys left out of the identity sha (the reference's
#: :1715): ``n_epochs`` and ``verbose`` because extending or quieting a
#: run is a resume, ``bn_axis`` because the rule sets it from the worker
#: count, which the ``mesh`` key already covers
MODEL_FP_EXCLUDED = ("n_epochs", "verbose", "bn_axis")


def model_fingerprint(model) -> dict:
    """The model-identity part of the run fingerprint: the model's class
    name and the sha of its config (each value's ``repr``), as the
    reference's (:1718), so the same ``--set`` flags give the same sha in
    both packages."""
    cfg = {k: repr(v) for k, v in model.config.items()
           if k not in MODEL_FP_EXCLUDED}
    blob = json.dumps(cfg, sort_keys=True).encode()
    return {"model": type(model).__name__,
            "model_config_sha": hashlib.sha256(blob).hexdigest()[:16]}


# -- the checkpointer ---------------------------------------------------------

class SaveHandle:
    """One save, possibly in flight: ``join()`` waits for its publish and
    re-raises the writer's exception, once."""

    __slots__ = ("path", "epoch", "_thread", "_error")

    def __init__(self, path: str, epoch: int):
        self.path = path
        self.epoch = epoch
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def join(self) -> None:
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None:
            raise err


class Checkpointer:
    """A directory of ``ckpt_eNNNN.npz`` + ``.manifest.json`` pairs with
    a ``latest.json`` pointer, verified retention and a recovery chain.

    ``async_save``: the writer runs on a thread (the trainer's default);
    a bare checkpointer writes inline.  ``fingerprint``: a dict or a
    zero-argument callable (the trainer's ``_run_fingerprint``), resolved
    at each save and load.  ``encode(trees) -> {key: ndarray}`` and
    ``decode(arrays, templates) -> trees``: the codec between the caller's
    trees and the file's leaves (default: as they are;
    the trainer converts to the reference's layouts).  ``writer=False``:
    a rank other than 0 of a run, which never writes, sweeps nor marks
    the directory.  ``verbose``: the writer prints one line a publish
    (bytes, ``snapshot_ms``, ``write_ms``).

    ``read_only``: a consumer (:func:`load_for_inference`) that never
    changes the directory, which a live training writer may own: no
    debris sweep, no ``dirty`` marker, no quarantine move (a corrupt file
    is stepped over and left in place), no ``latest.json`` or
    ``resilience.json`` rewrite, and :meth:`save` (hence scrub and prune)
    refuses.  ``fingerprint_subset``: compare only the fingerprint's own
    keys (the model class and config sha, for serving)."""

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False, fingerprint=None,
                 resume_force: bool = False, sweep_debris: bool = True,
                 encode=None, decode=None, writer: bool = True,
                 verbose: bool = False, read_only: bool = False,
                 fingerprint_subset: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self.fingerprint = fingerprint
        self.resume_force = resume_force
        self.encode = encode or encode_plain
        self.decode = decode or decode_plain
        self.writer = writer
        self.verbose = verbose
        self.read_only = read_only
        self.fingerprint_subset = fingerprint_subset
        #: manifest of the latest :meth:`load_latest_verified` restore
        self.last_loaded_manifest: dict | None = None
        self._inflight: SaveHandle | None = None
        #: test seam: called on the writer between serialization and the
        #: publish (a raise stands for a crash mid-write)
        self._pre_publish_hook = None
        self._marked_dirty = False
        self._stager = _Stager()
        self._verify_cache: dict[str, tuple] = {}
        self._scrubbed: set[tuple] = set()
        if read_only:
            return
        os.makedirs(directory, exist_ok=True)
        if sweep_debris and writer:
            self._sweep_tmp()

    def _sweep_tmp(self) -> None:
        """Remove what a writer killed before its publish left behind:
        temporary files, and manifests without their ``.npz`` (the
        manifest is published first)."""
        for f in os.listdir(self.directory):
            if (f.endswith(".tmp.npz") or f == "latest.json.tmp"
                    or f.endswith(".manifest.json.tmp")):
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass  # best effort: a concurrent cleanup got there
        for f in os.listdir(self.directory):
            if f.endswith(".manifest.json") and not os.path.exists(
                    os.path.join(self.directory,
                                 f[: -len(".manifest.json")] + ".npz")):
                try:
                    os.remove(os.path.join(self.directory, f))
                except OSError:
                    pass

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_e{epoch:04d}.npz")

    def _resolved_fingerprint(self) -> dict | None:
        fp = self.fingerprint
        return fp() if callable(fp) else fp

    # -- the unclean-exit witness ---------------------------------------------
    def _dirty_path(self) -> str:
        return os.path.join(self.directory, "dirty")

    def _mark_dirty(self) -> None:
        """A run that writes here holds the ``dirty`` marker until it
        exits cleanly; found at a resume, it means the last writer died,
        when a ``full`` verify is worth its read."""
        if self._marked_dirty or self.read_only:
            return
        with open(self._dirty_path(), "w") as f:
            f.write("1")
        self._marked_dirty = True

    def mark_clean(self) -> None:
        """The clean-shutdown handshake: join the writer, drop the
        marker."""
        self.join_pending()
        if (self.writer and not self.read_only
                and os.path.exists(self._dirty_path())):
            os.remove(self._dirty_path())
        self._marked_dirty = False

    def was_unclean(self) -> bool:
        return os.path.exists(self._dirty_path())

    def join_pending(self) -> None:
        """Wait for the writer in flight, if any; re-raise its exception
        (once: the slot is cleared first)."""
        h, self._inflight = self._inflight, None
        if h is not None:
            h.join()

    # -- save -----------------------------------------------------------------
    def reserve(self, trees: dict) -> None:
        """Allocate the pinned staging that a save of ``trees`` copies its
        card leaves into, now (before the first step) rather than inside
        the first save's snapshot.  A meta tensor stands for a card leaf
        that the save will hold but that does not exist yet."""
        self._stager.reserve(trees)

    def save(self, epoch: int, iteration: int, trees: dict,
             recorder_snapshot: dict | None = None, lr_scale: float = 1.0,
             data_state: dict | None = None,
             handed_over=()) -> SaveHandle:
        """Save ``trees`` (name -> tree) as epoch ``epoch``; -> its
        handle.  The training thread pays the join of the previous save
        and the snapshot; the rest runs on the writer (see the module
        docstring).  ``data_state`` goes into the manifest and, as JSON
        bytes, into the ``__data_state__`` leaf.  ``handed_over``: host
        tensors among the leaves that were made for this save alone and
        that nothing else writes (``zero1``'s gathered buckets): the
        snapshot takes them as they are instead of cloning them."""
        if self.read_only:
            raise RuntimeError(
                "Checkpointer is read-only (load_for_inference): save() "
                "refused, the directory belongs to a training writer")
        self.join_pending()  # also: the pinned buffers are free again
        t0 = time.perf_counter()
        snap = self._stager.snapshot(trees, handed_over)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        fingerprint = self._resolved_fingerprint()
        handle = SaveHandle(self._path(epoch), epoch)
        self._mark_dirty()

        def work():
            self._write(handle, epoch, iteration, snap, recorder_snapshot,
                        lr_scale, data_state, fingerprint, snapshot_ms)

        if not self.async_save:
            work()
            return handle

        def guarded():
            try:
                work()
            except BaseException as e:  # delivered at the next join
                handle._error = e

        handle._thread = threading.Thread(
            target=guarded, name=f"ckpt-writer-e{epoch:04d}", daemon=True)
        self._inflight = handle
        handle._thread.start()
        return handle

    def _write(self, handle, epoch, iteration, snap, recorder_snapshot,
               lr_scale, data_state, fingerprint, snapshot_ms) -> None:
        """Encode, serialize, publish atomically, then the histories, one
        scrub and the prune."""
        t0 = time.perf_counter()
        flat = self.encode(snap.wait())
        if data_state is not None:
            flat[DATA_STATE_LEAF] = np.frombuffer(
                json.dumps(data_state, sort_keys=True).encode("utf-8"),
                dtype=np.uint8).copy()
        tmp = handle.path + ".tmp.npz"
        np.savez(tmp, **flat)
        manifest = build_manifest(epoch, iteration, flat, fingerprint,
                                  lr_scale=lr_scale, data_state=data_state)
        mpath = _manifest_path(handle.path)
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f, sort_keys=True, indent=1)
        if self._pre_publish_hook is not None:
            self._pre_publish_hook(epoch)
        # the manifest before the .npz: a published checkpoint always has
        # one (a torn publish leaves at most an orphan manifest)
        os.replace(mpath + ".tmp", mpath)
        os.replace(tmp, handle.path)
        self._write_latest(epoch, iteration)
        if recorder_snapshot is not None:
            from theanompi_torch.utils.recorder import write_history_snapshot

            write_history_snapshot(recorder_snapshot, self.directory)
        # the scrub before retention: the prune's protection of the newest
        # full-verified file holds only if rot is quarantined first
        self._scrub_one()
        self._prune()
        if self.verbose:
            nbytes = sum(int(a.nbytes) for a in flat.values())
            write_ms = (time.perf_counter() - t0) * 1e3
            print(f"checkpoint: published {os.path.basename(handle.path)} "
                  f"(epoch {epoch}, iteration {iteration}): {nbytes} bytes, "
                  f"snapshot_ms {snapshot_ms:.3f}, write_ms "
                  f"{write_ms:.3f}", flush=True)

    # -- retention and scrub --------------------------------------------------
    def _ckpt_files(self) -> list[str]:
        return sorted(f for f in os.listdir(self.directory) if _is_ckpt(f))

    def available_epochs(self) -> list[int]:
        """Epochs present in the directory, ascending."""
        return sorted(_epoch_of(f) for f in self._ckpt_files())

    def _fast_ok(self, fname: str) -> bool:
        """Cached fast-verify verdict for one retained file."""
        try:
            st = os.stat(os.path.join(self.directory, fname))
        except OSError:
            return False
        key = (st.st_mtime_ns, st.st_size)
        hit = self._verify_cache.get(fname)
        if hit is not None and hit[0] == key:
            return hit[1]
        try:
            verify_file(os.path.join(self.directory, fname), level="fast")
            ok = True
        except CheckpointCorruptError:
            ok = False
        self._verify_cache[fname] = (key, ok)
        return ok

    def _full_verified(self, fname: str) -> bool:
        try:
            st = os.stat(os.path.join(self.directory, fname))
        except OSError:
            return False
        return (fname, st.st_mtime_ns, st.st_size) in self._scrubbed

    def _prune(self) -> None:
        """Keep the ``keep`` newest files that pass fast verification, and
        never delete the newest full-verified one: unverifiable files are
        left for the scrub and the chain, never deleted."""
        ok = [f for f in self._ckpt_files() if self._fast_ok(f)]
        protected = next((f for f in reversed(ok) if self._full_verified(f)),
                         None)
        for f in ok[: max(0, len(ok) - self.keep)]:
            if f == protected:
                continue
            path = os.path.join(self.directory, f)
            os.remove(path)
            if os.path.exists(_manifest_path(path)):
                os.remove(_manifest_path(path))
            self._verify_cache.pop(f, None)

    def _scrub_one(self) -> None:
        """Full-verify at most one older, not yet scrubbed file a save
        (the newest, just written, is excluded); quarantine a failure."""
        for f in self._ckpt_files()[:-1]:
            path = os.path.join(self.directory, f)
            try:
                st = os.stat(path)
            except OSError:
                continue
            key = (f, st.st_mtime_ns, st.st_size)
            if key in self._scrubbed:
                continue
            try:
                verify_file(path, level="full")
                self._scrubbed.add(key)
            except CheckpointCorruptError as e:
                print(f"checkpoint scrub: {e}; quarantining",
                      file=sys.stderr, flush=True)
                self.quarantine(_epoch_of(f), reason=f"scrub: {e}")
            return

    def quarantine(self, epoch: int, reason: str) -> list[str]:
        """Move a bad checkpoint (``.npz`` and manifest) under
        ``<dir>/corrupt/``, out of the chain and retention but kept, and
        record ``ckpt.quarantine``.  A read-only consumer leaves the file
        in place for the writer that owns the directory."""
        if self.read_only:
            print(f"checkpoint: read-only consumer skipping epoch {epoch} "
                  f"({reason}), left in place for the owning writer",
                  file=sys.stderr, flush=True)
            return []
        qdir = os.path.join(self.directory, "corrupt")
        os.makedirs(qdir, exist_ok=True)
        moved = []
        for p in (self._path(epoch), _manifest_path(self._path(epoch))):
            if not os.path.exists(p):
                continue
            dst = os.path.join(qdir, os.path.basename(p))
            n = 1
            while os.path.exists(dst):  # a re-saved epoch rotted again
                dst = os.path.join(qdir, f"{os.path.basename(p)}.{n}")
                n += 1
            os.replace(p, dst)
            moved.append(os.path.basename(dst))
        self._verify_cache.pop(os.path.basename(self._path(epoch)), None)
        self._record_event("ckpt.quarantine", epoch=epoch, reason=reason,
                           files=moved)
        return moved

    def _record_event(self, name: str, **fields) -> None:
        from theanompi_torch.resilience.events import record_event

        record_event(os.path.join(self.directory, "resilience.json"), name,
                     **fields)

    def _record_fallback(self, skipped: list[int], epoch: int,
                         iteration: int, verify: str) -> None:
        """Record ``ckpt.fallback`` and repoint ``latest.json`` at the
        epoch the chain restored (a read-only consumer records and
        repoints nothing)."""
        if self.read_only:
            return
        self._record_event("ckpt.fallback", bad_epochs=skipped,
                           restored_epoch=epoch, verify=verify)
        self._write_latest(epoch, iteration)
        print(f"checkpoint: fell back to epoch {epoch} after quarantining "
              f"{len(skipped)} corrupt checkpoint(s) {skipped} under "
              f"corrupt/", file=sys.stderr, flush=True)

    # -- the latest pointer ---------------------------------------------------
    def _write_latest(self, epoch: int, iteration: int) -> None:
        latest = os.path.join(self.directory, "latest.json")
        with open(latest + ".tmp", "w") as f:
            json.dump({"epoch": epoch, "iteration": iteration}, f)
        os.replace(latest + ".tmp", latest)

    def _latest(self) -> tuple[int, int]:
        """(epoch, iteration) of ``latest.json``; (-1, 0) if none."""
        self.join_pending()  # read-your-writes
        p = os.path.join(self.directory, "latest.json")
        if not os.path.exists(p):
            return -1, 0
        with open(p) as f:
            meta = json.load(f)
        if not os.path.exists(self._path(meta["epoch"])):
            return -1, 0
        return meta["epoch"], meta.get("iteration", 0)

    def latest_epoch(self) -> int | None:
        ep, _ = self._latest()
        return None if ep < 0 else ep

    def latest_iteration(self) -> int:
        return self._latest()[1]

    # -- verified load --------------------------------------------------------
    def verify_epoch(self, epoch: int, level: str = "full") -> dict:
        """One retained epoch's file and fingerprint; -> its manifest."""
        man = verify_file(self._path(epoch), level=level)
        check_fingerprint(man, self._resolved_fingerprint(),
                          self._path(epoch), force=self.resume_force,
                          subset=self.fingerprint_subset)
        return man

    def _chain(self, attempt, verify: str):
        """The recovery chain: ``attempt(epoch) -> (manifest, result)`` on
        the newest epoch first; a :class:`CheckpointCorruptError` moves
        the file under ``corrupt/`` and steps back.  -> (epoch, iteration,
        manifest, result), or None when the directory holds no
        checkpoint; raises :class:`CheckpointChainExhausted` when none
        survived."""
        self.join_pending()
        skipped: list[int] = []
        for ep in reversed(self.available_epochs()):
            try:
                man, result = attempt(ep)
            except CheckpointCorruptError as e:
                print(f"checkpoint: {e}; stepping back to the previous "
                      f"checkpoint", file=sys.stderr, flush=True)
                self.quarantine(ep, reason=str(e))
                skipped.append(ep)
                continue
            it = int(man.get("iteration", 0))
            if skipped:
                self._record_fallback(skipped, ep, it, verify)
            return ep, it, man, result
        if skipped:
            where = ("left in place (read-only)" if self.read_only
                     else "quarantined under corrupt/")
            raise CheckpointChainExhausted(
                f"no verifiable checkpoint left in {self.directory}: all "
                f"{len(skipped)} candidate(s) {skipped} failed verification "
                f"and were {where}")
        return None

    def load_latest_verified(self, templates: dict, verify: str = "fast"):
        """The resume entry point of one process: restore the newest
        verifiable checkpoint (the recovery chain).  -> ``(epoch,
        iteration, restored trees)``, or None for a directory without
        checkpoints.  ``full`` hashes the leaves as the restore reads
        them (one read); ``none`` trusts ``latest.json``."""
        self.last_loaded_manifest = None
        if verify == "none":
            ep, it = self._latest()
            if ep < 0:
                return None
            return ep, it, self.load(ep, templates, verify="none")

        def attempt(ep):
            man = self.verify_epoch(ep, level="fast")
            return man, self.load(ep, templates, verify=verify,
                                  _verified_manifest=man)

        res = self._chain(attempt, verify)
        if res is None:
            return None
        ep, it, self.last_loaded_manifest, restored = res
        return ep, it, restored

    def load(self, epoch: int, templates: dict, verify: str = "fast",
             _verified_manifest: dict | None = None) -> dict:
        """Restore each named tree of ``templates`` (structure, dtypes,
        devices) from epoch ``epoch``, after verifying the file
        (``fast``, ``full`` or ``none``).  The archive is read once:
        ``full`` checks each leaf's CRC on the arrays the restore uses.
        A read failure is a :class:`CheckpointCorruptError` whatever
        ``verify`` says."""
        self.join_pending()
        man = _verified_manifest
        if man is None and verify != "none":
            man = self.verify_epoch(epoch, level="fast")
        fname = os.path.basename(self._path(epoch))
        try:
            with np.load(self._path(epoch)) as z:
                arrays = {k: z[k] for k in z.files}
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            raise CheckpointCorruptError(f"{fname}: unreadable checkpoint: "
                                         f"{e}") from e
        if verify == "full":
            for key, meta in man["leaves"].items():
                _check_leaf(fname, key, meta, arrays[key])
        return self.decode(arrays, templates)


# -- the read-only consumer (serving) -----------------------------------------

def load_for_inference(directory: str, templates: dict,
                       verify: str = "fast", model=None,
                       force: bool = False):
    """Read-only verified restore for serving (the reference's :1733).

    Restores the newest checkpoint that passes verification, stepping
    back over corrupt ones, without ever writing to the directory (see
    :class:`Checkpointer`'s ``read_only``), so it is safe against a
    directory a live training writer owns.  The leaves are read in the
    reference's layouts and restored into ``templates`` (their structure,
    dtypes and devices) by :func:`theanompi_torch.convert.
    train_state_from_jax`.

    ``model``: when given, the checkpoint's model class and config sha
    (:func:`model_fingerprint`) must match; mesh and exchange keys are
    ignored.  ``force=True`` (``--serve-force``) downgrades a mismatch to
    a warning.

    -> ``(epoch, iteration, restored trees)``, or None for a missing or
    empty directory; raises :class:`CheckpointChainExhausted` and
    :class:`CheckpointFingerprintError` as the training chain does."""
    from theanompi_torch.convert import train_state_from_jax

    if not os.path.isdir(directory):
        return None
    cp = Checkpointer(
        directory, read_only=True, fingerprint_subset=True,
        fingerprint=model_fingerprint(model) if model is not None else None,
        resume_force=force, decode=train_state_from_jax)
    return cp.load_latest_verified(templates, verify=verify)


# -- the scrubber CLI ---------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    """``python -m theanompi_torch.utils.checkpoint --verify DIR``: verify
    every retained checkpoint against its manifest (full by default,
    ``--fast`` for the structural check), one line a file.  Exit 0 when
    all verify, 77 when any fails; ``--quarantine`` moves failures under
    ``DIR/corrupt/``.  Never sweeps: a live writer may own the
    directory."""
    import argparse

    from theanompi_torch.resilience.codes import EXIT_CKPT

    p = argparse.ArgumentParser(
        prog="python -m theanompi_torch.utils.checkpoint",
        description="Checkpoint integrity scrubber: verify every retained "
        "checkpoint of a directory against its manifest.")
    p.add_argument("--verify", metavar="DIR", required=True,
                   help="checkpoint directory to scrub")
    p.add_argument("--fast", action="store_true",
                   help="structural check only (manifest and member set)")
    p.add_argument("--quarantine", action="store_true",
                   help="move failed checkpoints under DIR/corrupt/")
    args = p.parse_args(argv)
    if not os.path.isdir(args.verify):
        p.error(f"not a directory: {args.verify}")
    files = sorted(f for f in os.listdir(args.verify) if _is_ckpt(f))
    if not files:
        print(f"{args.verify}: no checkpoints")
        return 0
    level = "fast" if args.fast else "full"
    quarantiner = (Checkpointer(args.verify, sweep_debris=False)
                   if args.quarantine else None)
    bad = 0
    for f in files:
        try:
            man = verify_file(os.path.join(args.verify, f), level=level)
        except CheckpointCorruptError as e:
            bad += 1
            print(f"{f}: CORRUPT: {e}")
            if quarantiner is not None:
                moved = quarantiner.quarantine(_epoch_of(f),
                                               reason=f"scrubber CLI: {e}")
                print(f"{f}: quarantined -> corrupt/ ({', '.join(moved)})")
            continue
        mib = sum(m["nbytes"] for m in man["leaves"].values()) / 2**20
        print(f"{f}: OK ({len(man['leaves'])} leaves, {mib:.1f} MiB, epoch "
              f"{man['epoch']}, iteration {man['iteration']}, {level} "
              f"verify)")
    print(f"{len(files) - bad}/{len(files)} checkpoints verifiable "
          f"({level})")
    return EXIT_CKPT if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
