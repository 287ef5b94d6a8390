"""The streaming token dataset: windows of a weighted mixture of token
sources, with cursors a checkpoint can carry.

Counterpart of ``theanompi_tpu/models/data/stream.py``
(``load_token_shard`` :54, ``_FileTokenSource`` :61,
``_SyntheticTokenSource`` :111, ``StreamTokenDataset`` :150), numpy only:
the same config gives the reference's batches bit for bit.

- **Sources**: a directory of 1-D ``*.npy`` token shards, or a
  deterministic synthetic stream (a sparse bigram chain: every token has
  32 successors at ``(a*cur + c + j*j) % vocab``, ``j`` from one peaked
  categorical).  A source is read in fixed windows of ``seq_len + 1``
  tokens (the targets are the inputs shifted by one); each shard's ragged
  tail is dropped.
- **Mixture**: global sample ``s`` of an epoch draws its source from the
  weights through ``derive_seed("mix", seed, epoch, s)``, a function of
  the sample's position alone.
- **Cursors**: each source's window cursor carries across epochs (the
  stream does not rewind).  The start-of-epoch base advances only when an
  epoch's generator is exhausted, which a prefetcher's producer does up
  to its depth in batches before training reaches the end, so the
  trainer reads the state before it builds an epoch's generator;
  :meth:`StreamTokenDataset.state` is that base with the mixture's
  weights, and a mid-epoch resume (``start_batch``) replays only the
  integer mixture choices of the batches before it.
- **Ranks**: ``rows=(lo, hi)`` builds rows ``lo:hi`` of each global batch
  alone, while every rank advances the cursors over the whole batch.

Config keys: ``seq_len``; ``stream_sources``, a list of ``{"name",
"weight", "path"}`` (a directory of token shards) or ``{"name", "weight",
"tokens", "vocab", "seed"}`` (synthetic; without the key, two synthetic
sources weighted 0.75 / 0.25); ``n_train`` (sequences a nominal epoch),
``n_val``; ``loader_workers`` > 0 reads the file sources' shards in
parallel once, through :class:`ShmShardPool`'s token mode.
"""

from __future__ import annotations

import os

import numpy as np

from theanompi_torch.models.data.base import (
    Dataset,
    derive_seed,
    read_with_retry,
)


def load_token_shard(path: str) -> np.ndarray:
    """One token shard as a flat int32 array (read with retries)."""
    return read_with_retry(
        lambda: np.asarray(np.load(path)).astype(np.int32).ravel(),
        what=path)


def _shard_len(path: str) -> int:
    """A shard's token count from its header (mmap: no payload read)."""
    return int(read_with_retry(
        lambda: np.load(path, mmap_mode="r").shape[0], what=path))


class _FileTokenSource:
    """A directory of token shards, addressed by window."""

    def __init__(self, name: str, path: str, seq_len: int):
        self.name = name
        self.window_len = seq_len + 1
        shards = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
        if not shards:
            raise FileNotFoundError(f"no .npy token shards under {path}")
        self.shard_paths = [os.path.join(path, f) for f in shards]
        self.shard_windows = [_shard_len(p) // self.window_len
                              for p in self.shard_paths]
        self.n_windows = sum(self.shard_windows)
        if self.n_windows == 0:
            raise ValueError(
                f"source {name!r}: no shard holds a full window "
                f"({self.window_len} tokens)")
        self.vocab_hint = None  # unknown without reading payloads
        self._cache: dict[int, np.ndarray] = {}
        self._cache_order: list[int] = []

    def cache_shard(self, j: int, toks: np.ndarray) -> None:
        """Install a shard read elsewhere (the pool's warm load)."""
        self._cache[j] = toks
        self._cache_order.append(j)

    def _shard(self, j: int) -> np.ndarray:
        toks = self._cache.get(j)
        if toks is None:
            toks = load_token_shard(self.shard_paths[j])
            self.cache_shard(j, toks)
            # cursors move through a source in order: keep a few shards
            while len(self._cache_order) > 4:
                self._cache.pop(self._cache_order.pop(0), None)
        return toks

    def window(self, w: int) -> np.ndarray:
        w %= self.n_windows
        for j, nw in enumerate(self.shard_windows):
            if w < nw:
                start = w * self.window_len
                return self._shard(j)[start:start + self.window_len]
            w -= nw
        raise AssertionError("unreachable: window index out of range")


class _SyntheticTokenSource:
    """A procedural token stream: window ``w`` is a function of (seed,
    name, w) alone, drawn from its own keyed ``RandomState``."""

    def __init__(self, name: str, n_tokens: int, vocab: int, seed: int,
                 seq_len: int):
        self.name = name
        self.window_len = seq_len + 1
        self.vocab_hint = vocab
        self.vocab = vocab
        self.n_windows = max(1, int(n_tokens) // self.window_len)
        rng = np.random.RandomState(derive_seed("stream-synth", seed, name))
        self._a = 2 * rng.randint(1, max(2, vocab // 2)) + 1
        self._c = rng.randint(vocab)
        wl = np.sort(rng.randn(32) * 2.0)[::-1]
        w = np.exp(wl) / np.exp(wl).sum()
        self._cdf = w.cumsum()
        self._seed = seed

    def window(self, w: int) -> np.ndarray:
        w %= self.n_windows
        r = np.random.RandomState(derive_seed("window", self._seed,
                                              self.name, w))
        out = np.zeros(self.window_len, np.int32)
        out[0] = r.randint(0, self.vocab)
        # the reference draws one r.rand() a token; one call for the
        # window gives the same doubles in the same order
        u = r.rand(self.window_len - 1)
        j = np.minimum((u[:, None] > self._cdf).sum(1), 31)
        step = (np.arange(32, dtype=np.int64) ** 2)[j] + int(self._c)
        a, vocab, cur = int(self._a), int(self.vocab), int(out[0])
        for t, s in enumerate(step.tolist(), 1):
            cur = (a * cur + s) % vocab
            out[t] = cur
        return out


class StreamTokenDataset(Dataset):
    """A weighted mixture of windowed token sources for ``TransformerLM``."""

    def __init__(self, config: dict | None = None):
        config = config or {}
        self.seq_len = int(config.get("seq_len", 128))
        self.loader_workers = int(config.get("loader_workers", 0))
        specs = config.get("stream_sources")
        if not specs:
            vocab = int(config.get("vocab", 256))
            specs = [
                {"name": "syn-a", "weight": 0.75, "tokens": 65536,
                 "vocab": vocab, "seed": 11},
                {"name": "syn-b", "weight": 0.25, "tokens": 65536,
                 "vocab": vocab, "seed": 13},
            ]
        self._sources = []
        weights = []
        for s in specs:
            w = float(s.get("weight", 1.0))
            if w <= 0:
                raise ValueError(f"source {s.get('name')!r}: weight {w} <= 0")
            if "path" in s:
                src = _FileTokenSource(s["name"], s["path"], self.seq_len)
            else:
                src = _SyntheticTokenSource(
                    s["name"], int(s.get("tokens", 65536)),
                    int(s.get("vocab", config.get("vocab", 256))),
                    int(s.get("seed", 0)), self.seq_len)
            self._sources.append(src)
            weights.append(w)
        names = [s.name for s in self._sources]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate source names: {names}")
        self._names = names
        tot = sum(weights)
        self._weights = [w / tot for w in weights]
        hints = [s.vocab_hint for s in self._sources if s.vocab_hint]
        self.vocab = int(config.get("vocab", max(hints) if hints else 256))
        self.n_classes = self.vocab
        self.sample_shape = (self.seq_len,)
        self.n_train = int(config.get("n_train", 512))
        self.n_val = int(config.get("n_val", 128))
        # the start-of-epoch cursor base: iteration works on a copy
        self._base_cursors = {n: 0 for n in names}
        self._base_epoch = 0
        self._warmed = False

    # -- the state a checkpoint carries ---------------------------------------
    def state(self) -> dict:
        return {
            "version": 1,
            "weights": dict(zip(self._names, self._weights)),
            "cursors": dict(self._base_cursors),
            "base_epoch": int(self._base_epoch),
        }

    def set_state(self, state: dict) -> None:
        if not state:
            return
        weights = state.get("weights")
        if weights:
            missing = [n for n in self._names if n not in weights]
            if missing:
                raise ValueError(
                    f"stream state missing sources {missing} "
                    f"(have {sorted(weights)})")
            ws = [float(weights[n]) for n in self._names]
            tot = sum(ws)
            self._weights = [w / tot for w in ws]
        for n, c in (state.get("cursors") or {}).items():
            if n in self._base_cursors:
                self._base_cursors[n] = int(c)
        self._base_epoch = int(state.get("base_epoch", 0))

    def set_mixture_weights(self, weights: dict) -> None:
        """Re-weight the mixture from the next ``train_batches`` call on (an
        epoch's generator keeps the weights it started with)."""
        ws = [float(weights[n]) for n in self._names]
        if any(w <= 0 for w in ws):
            raise ValueError(f"weights must be positive: {weights}")
        tot = sum(ws)
        self._weights = [w / tot for w in ws]

    # -- iteration ------------------------------------------------------------
    def _choices(self, batch_size, epoch, seed, batch, weights):
        """Each sample's source index in batch ``batch``, keyed on the
        global sample index: a uniform draw from ``derive_seed`` itself."""
        cdf = np.cumsum(weights)
        out = np.empty(batch_size, np.int64)
        base = int(batch) * int(batch_size)
        for j in range(batch_size):
            u = derive_seed("mix", seed, epoch, base + j) / float(2**31)
            out[j] = min(int(np.searchsorted(cdf, u, side="right")),
                         len(self._sources) - 1)
        return out

    def _warm(self):
        """Read every file source's shards once, in parallel through the
        pool's token mode; the epochs then read the sources' caches."""
        self._warmed = True
        file_srcs = [s for s in self._sources
                     if isinstance(s, _FileTokenSource)]
        if self.loader_workers <= 0 or not file_srcs:
            return
        from theanompi_torch.models.data.shm_loader import ShmShardPool

        jobs = [(src, j) for src in file_srcs
                for j in range(len(src.shard_paths))]
        nbytes = max(4 * _shard_len(src.shard_paths[j]) for src, j in jobs)
        pool = ShmShardPool(1, 1, self.loader_workers, slot_nbytes=nbytes)
        try:
            tasks = [(("tokens", src.shard_paths[j]), 0) for src, j in jobs]
            for (src, j), (toks, _y) in zip(jobs, pool.run(tasks)):
                src.cache_shard(j, toks)
        finally:
            pool.close()

    def train_batches(self, batch_size, epoch, seed=0, start_batch=0,
                      rows=None):
        if not self._warmed:
            self._warm()
        weights = list(self._weights)  # one epoch, one mixture
        cursors = dict(self._base_cursors)
        names = self._names
        lo, hi = (0, batch_size) if rows is None else rows
        for i in range(int(start_batch)):
            for s in self._choices(batch_size, epoch, seed, i, weights):
                cursors[names[s]] += 1
        for i in range(int(start_batch), self.n_train // batch_size):
            choice = self._choices(batch_size, epoch, seed, i, weights)
            xs = np.empty((hi - lo, self.seq_len + 1), np.int32)
            for j, s in enumerate(choice):
                src = self._sources[int(s)]
                if lo <= j < hi:
                    xs[j - lo] = src.window(cursors[src.name])
                cursors[src.name] += 1
            yield {"x": xs[:, :-1], "y": xs[:, 1:]}
        # the epoch is complete; the next one continues from here
        self._base_cursors = cursors
        self._base_epoch = int(epoch) + 1

    def val_batches(self, batch_size, rows=None):
        """Fixed windows, round-robin over the sources at derived indices:
        no cursor moves, the same batches every call."""
        if not self._warmed:
            self._warm()
        lo, hi = (0, batch_size) if rows is None else rows
        n_srcs = len(self._sources)
        for i in range(self.n_val // batch_size):
            xs = np.empty((hi - lo, self.seq_len + 1), np.int32)
            for j in range(lo, hi):
                k = i * batch_size + j
                src = self._sources[k % n_srcs]
                # past the low windows that training reads first
                w = (src.n_windows // 2 + derive_seed("val", k)) \
                    % src.n_windows
                xs[j - lo] = src.window(w)
            yield {"x": xs[:, :-1], "y": xs[:, 1:]}
