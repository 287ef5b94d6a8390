"""Dataset protocol, stable seed derivation, the synthetic token stream.

Counterpart of ``theanompi_tpu/models/data/base.py`` (``derive_seed`` :27,
``read_with_retry`` :105, ``Dataset`` :149, ``ArrayDataset`` :199,
``_class_structured`` :236, ``SyntheticDataset`` :254,
``SyntheticSequenceDataset`` :266), numpy only, so the same seed gives the
reference's arrays bit for bit.  Iterators yield **global** batches as
numpy dicts ``{"x": [B, ...], "y": [B, ...]}`` with constant shapes;
ragged final batches are dropped.  The read-retry plane's telemetry and
fault-injection hooks come with later slices; the trainer's prefetcher
is :mod:`theanompi_torch.models.data.prefetch`.
"""

from __future__ import annotations

import hashlib
import sys
import time

import numpy as np


class DataReadError(RuntimeError):
    """A dataset read kept failing after the bounded retries."""


def derive_seed(*parts) -> int:
    """A 31-bit numpy seed from structured parts, stable across processes
    and interpreter restarts: sha256 of the parts' ``repr`` joined by an
    unambiguous separator (never ``hash``, which depends on
    ``PYTHONHASHSEED``)."""
    text = "\x1f".join(repr(p) for p in parts)
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") % (2**31)


def read_with_retry(fn, what: str, retries: int = 4,
                    backoff_s: float = 0.05, sleep=time.sleep):
    """Run the read ``fn()``, retrying ``OSError`` and numpy's torn-read
    ``ValueError`` up to ``retries`` times with doubling backoff; then
    raise :class:`DataReadError` carrying the last cause."""
    retries = max(1, int(retries))
    last: Exception | None = None
    for attempt in range(1, retries + 1):
        try:
            return fn()
        except (OSError, ValueError) as e:
            last = e
            if attempt < retries:
                print(f"data: read of {what} failed "
                      f"(attempt {attempt}/{retries}): {e}; retrying",
                      file=sys.stderr, flush=True)
                sleep(backoff_s * (2 ** (attempt - 1)))
    raise DataReadError(
        f"could not read {what} after {retries} attempts: {last}") from last


def row_slice(rows) -> slice:
    """``rows`` (a ``(lo, hi)`` pair, or None for all) as a slice."""
    return slice(None) if rows is None else slice(*rows)


class Dataset:
    """Duck-typed dataset: ``n_train``/``n_val`` counts and batch
    iterators.  ``train_batches(batch_size, epoch, seed, start_batch)``
    must give, from cursor ``start_batch`` on, exactly the batches an
    uninterrupted epoch would (randomness keyed on ``derive_seed(...,
    epoch)``).  ``rows=(lo, hi)`` (both iterators) gives rows ``lo:hi`` of
    each of those batches, the share of one data-parallel rank; a dataset
    builds only what those rows need where its randomness allows.
    ``state``/``set_state`` carry any position the (epoch, cursor) pair
    does not determine (the token stream's cursors and weights; the
    datasets here have none)."""

    n_train: int
    n_val: int
    sample_shape: tuple
    n_classes: int

    def n_train_batches(self, batch_size: int) -> int:
        return self.n_train // batch_size

    def n_val_batches(self, batch_size: int) -> int:
        return self.n_val // batch_size

    def train_batches(self, batch_size: int, epoch: int, seed: int = 0,
                      start_batch: int = 0, rows=None):
        raise NotImplementedError

    def val_batches(self, batch_size: int, rows=None):
        raise NotImplementedError

    def state(self) -> dict:
        return {}

    def set_state(self, state: dict) -> None:
        """Restore :meth:`state` output (no-op for stateless datasets)."""

    def cleanup(self) -> None:
        pass


class ArrayDataset(Dataset):
    """In-memory arrays with per-epoch shuffling and optional
    augmentation ``augment_fn(x, rng) -> x``."""

    def __init__(self, x_train, y_train, x_val, y_val, n_classes,
                 augment_fn=None):
        self.x_train, self.y_train = x_train, y_train
        self.x_val, self.y_val = x_val, y_val
        self.n_train, self.n_val = len(x_train), len(x_val)
        self.sample_shape = tuple(x_train.shape[1:])
        self.n_classes = n_classes
        self.augment_fn = augment_fn

    def epoch_order(self, epoch, seed=0):
        """The epoch's sample permutation, a pure function of (seed,
        epoch), so a cursor fast-forward re-derives it without replay."""
        rng = np.random.RandomState(derive_seed("shuffle", seed, epoch))
        return rng.permutation(self.n_train)

    def train_batches(self, batch_size, epoch, seed=0, start_batch=0,
                      rows=None):
        order = self.epoch_order(epoch, seed)
        sl = row_slice(rows)
        for i in range(int(start_batch), self.n_train_batches(batch_size)):
            idx = order[i * batch_size: (i + 1) * batch_size]
            if self.augment_fn is None:
                idx = idx[sl]
                x = self.x_train[idx]
            else:
                # keyed on the batch, not drawn from the permutation's
                # stream: batch i is recomputable alone.  The draws cover
                # the whole batch, so it is augmented whole
                rng = np.random.RandomState(
                    derive_seed("augment", seed, epoch, i))
                x = self.augment_fn(self.x_train[idx], rng)[sl]
                idx = idx[sl]
            yield {"x": x, "y": self.y_train[idx]}

    def val_batches(self, batch_size, rows=None):
        sl = row_slice(rows)
        for i in range(self.n_val_batches(batch_size)):
            b = self.x_val[i * batch_size: (i + 1) * batch_size]
            c = self.y_val[i * batch_size: (i + 1) * batch_size]
            yield {"x": b[sl], "y": c[sl]}


def _class_structured(n, shape, n_classes, seed, noise=0.3, means_seed=0):
    """Learnable synthetic data, one Gaussian blob per class (the stand-in
    for real datasets, which are not in the repository); ``means_seed``
    fixes the class means apart from the sample draw, so train and val
    share one distribution."""
    dim = int(np.prod(shape))
    means = np.random.RandomState(means_seed).randn(
        n_classes, dim).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = means[y] + noise * rng.randn(n, dim).astype(np.float32)
    return x.reshape(n, *shape), y


class SyntheticDataset(ArrayDataset):
    def __init__(self, n_train=1024, n_val=256, sample_shape=(8, 8, 3),
                 n_classes=10, seed=0, noise=0.3):
        xt, yt = _class_structured(n_train, sample_shape, n_classes, seed,
                                   noise, means_seed=seed)
        xv, yv = _class_structured(n_val, sample_shape, n_classes, seed + 1,
                                   noise, means_seed=seed)
        super().__init__(xt, yt, xv, yv, n_classes)


class SyntheticSequenceDataset(Dataset):
    """Synthetic token streams for LM models (PTB stand-in): sequences
    follow a fixed random bigram table, so there is structure to learn.
    Up to ``dense_vocab_limit`` the table is dense; above it (the 32k-vocab
    LM benches) every token has 32 successors at ``(a*cur + c + j*j) % V``
    drawn from one shared peaked categorical over ``j``."""

    def __init__(self, n_train=512, n_val=128, seq_len=32, vocab=64, seed=0,
                 dense_vocab_limit=4096):
        rng = np.random.RandomState(seed)
        self.vocab = vocab
        self.n_classes = vocab
        self.seq_len = seq_len
        self.sample_shape = (seq_len,)
        if vocab <= dense_vocab_limit:
            logits = rng.randn(vocab, vocab) * 2.0
            probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            self._probs = probs

            def gen(n, r):
                seqs = np.zeros((n, seq_len + 1), np.int32)
                seqs[:, 0] = r.randint(0, vocab, n)
                for t in range(seq_len):
                    cur = seqs[:, t]
                    u = r.rand(n, 1)
                    cdf = probs[cur].cumsum(1)
                    # clamp: the float cumsum can top out below 1.0
                    seqs[:, t + 1] = np.minimum((u > cdf).sum(1), vocab - 1)
                return seqs
        else:
            s_succ = 32
            a = 2 * rng.randint(1, vocab // 2) + 1  # odd -> bijective map
            c = rng.randint(vocab)
            wl = np.sort(rng.randn(s_succ) * 2.0)[::-1]
            w = np.exp(wl) / np.exp(wl).sum()
            cdf = w.cumsum()

            def gen(n, r):
                seqs = np.zeros((n, seq_len + 1), np.int32)
                seqs[:, 0] = r.randint(0, vocab, n)
                j2 = np.arange(s_succ, dtype=np.int64) ** 2
                for t in range(seq_len):
                    cur = seqs[:, t].astype(np.int64)
                    j = np.minimum((r.rand(n, 1) > cdf).sum(1), s_succ - 1)
                    seqs[:, t + 1] = (a * cur + c + j2[j]) % vocab
                return seqs

        self._train = gen(n_train, np.random.RandomState(seed + 1))
        self._val = gen(n_val, np.random.RandomState(seed + 2))
        self.n_train, self.n_val = n_train, n_val

    def train_batches(self, batch_size, epoch, seed=0, start_batch=0,
                      rows=None):
        return sequence_batches(self._train, self.n_train, batch_size,
                                epoch, seed, start_batch, rows)

    def val_batches(self, batch_size, rows=None):
        return sequence_batches(self._val, self.n_val, batch_size,
                                rows=rows)


def sequence_batches(seqs, n, batch_size, epoch=None, seed=0, start_batch=0,
                     rows=None):
    """Next-token batches ``{"x": s[:, :-1], "y": s[:, 1:]}`` of the
    ``[n, T + 1]`` sequences: shuffled per (seed, epoch) when ``epoch`` is
    given (training), in order otherwise; rows ``rows`` of each."""
    order = (np.random.RandomState(derive_seed("shuffle", seed, epoch))
             .permutation(n) if epoch is not None else np.arange(n))
    sl = row_slice(rows)
    for i in range(int(start_batch), n // batch_size):
        s = seqs[order[i * batch_size: (i + 1) * batch_size][sl]]
        yield {"x": s[:, :-1], "y": s[:, 1:]}
