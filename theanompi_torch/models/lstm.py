"""PTB-style token data: the LM models' data plane.

Counterpart of ``theanompi_tpu/models/lstm.py``'s ``PTBData`` (:32): a
contiguous token stream chopped into ``[B, T]`` next-token batches.  Real
PTB loads from ``config["data_path"]`` or ``$PTB_PATH`` (a directory with
``ptb.train.txt``/``ptb.valid.txt``); otherwise the synthetic bigram
stream of :class:`SyntheticSequenceDataset` stands in, with the
reference's seed, so both packages see the same arrays.  The LSTM model
itself comes with a later slice.
"""

from __future__ import annotations

import os

import numpy as np

from theanompi_torch.models.data.base import (
    Dataset,
    SyntheticSequenceDataset,
    sequence_batches,
)


def ptb_path(config: dict) -> str | None:
    """The real PTB directory the config (or ``$PTB_PATH``) names, if it
    holds ``ptb.train.txt``; else None (the synthetic stream)."""
    path = config.get("data_path") or os.environ.get("PTB_PATH")
    if path and os.path.exists(os.path.join(path, "ptb.train.txt")):
        return path
    return None


class PTBData(Dataset):
    """Contiguous token stream chopped into [B, T] next-word batches."""

    def __init__(self, config: dict | None = None):
        config = config or {}
        self.seq_len = config.get("seq_len", 35)
        path = ptb_path(config)
        if path is not None:
            self.synthetic = False
            with open(os.path.join(path, "ptb.train.txt")) as f:
                train_words = f.read().split()
            with open(os.path.join(path, "ptb.valid.txt")) as f:
                val_words = f.read().split()
            vocab = sorted(set(train_words)) + ["<unk2>"]
            self.word_to_id = {w: i for i, w in enumerate(vocab)}
            unk = len(vocab) - 1
            self.vocab = len(vocab)
            train_ids = np.array(
                [self.word_to_id.get(w, unk) for w in train_words], np.int32)
            val_ids = np.array(
                [self.word_to_id.get(w, unk) for w in val_words], np.int32)
            self._train_seqs = self._chop(train_ids)
            self._val_seqs = self._chop(val_ids)
        else:
            self.synthetic = True
            syn = SyntheticSequenceDataset(
                n_train=config.get("n_train", 512),
                n_val=config.get("n_val", 128),
                seq_len=self.seq_len,
                vocab=config.get("vocab", 256),
            )
            self.vocab = syn.vocab
            self._train_seqs = syn._train
            self._val_seqs = syn._val
        self.n_classes = self.vocab
        self.n_train = len(self._train_seqs)
        self.n_val = len(self._val_seqs)
        self.sample_shape = (self.seq_len,)

    def _chop(self, ids: np.ndarray) -> np.ndarray:
        t = self.seq_len + 1  # +1: targets are inputs shifted by one
        n = len(ids) // t
        return ids[: n * t].reshape(n, t)

    def train_batches(self, batch_size: int, epoch: int, seed: int = 0,
                      start_batch: int = 0, rows=None):
        return sequence_batches(self._train_seqs, self.n_train, batch_size,
                                epoch, seed, start_batch, rows)

    def val_batches(self, batch_size: int, rows=None):
        return sequence_batches(self._val_seqs, self.n_val, batch_size,
                                rows=rows)
