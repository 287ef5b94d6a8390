"""The PTB word-level LSTM language model and its token data.

Counterpart of ``theanompi_tpu/models/lstm.py``: ``PTBData`` (:32), a
contiguous token stream chopped into ``[B, T]`` next-token batches, and
``LSTM`` (:90), embedding -> ``n_layers`` x (dropout, LSTM) -> dropout
-> dense over the vocabulary, with the reference's param tree
(``00_embedding``, ``NN_lstm/{wx, wh, b}``, ``NN_dense``) and its
``perplexity`` metric (``exp`` of the cost); ``grad_clip`` (5.0) clips
the global norm in the optimizer.  Real PTB loads from
``config["data_path"]`` or ``$PTB_PATH`` (a directory with
``ptb.train.txt``/``ptb.valid.txt``); otherwise the synthetic bigram
stream of :class:`SyntheticSequenceDataset` stands in, with the
reference's seed, so both packages see the same arrays.  The recurrence
runs as :func:`theanompi_torch.ops.layers.lstm_fused` (ATen's LSTM;
cuDNN's in fp32 on the card).
"""

from __future__ import annotations

import os

import numpy as np

from theanompi_torch.models.contract import SupervisedModel
from theanompi_torch.models.data.base import (
    Dataset,
    SyntheticSequenceDataset,
    sequence_batches,
)
from theanompi_torch.ops import initializers as init_lib
from theanompi_torch.ops import layers as L


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


class LSTM(SupervisedModel):
    """PTB-style LM.  ``error`` is next-word top-1 error; ``perplexity``
    = exp(cost), the reference's headline LM metric."""

    default_config = {
        "batch_size": 32,
        "n_epochs": 13,
        "lr": 1.0,        # the tutorial-era SGD schedule
        "lr_decay_epochs": (4, 6, 8, 10, 12),
        "lr_decay_factor": 0.5,
        "momentum": 0.0,
        "seq_len": 35,
        "hidden": 650,
        "n_layers": 2,
        "embed_dim": 650,
        "dropout": 0.5,
        "grad_clip": 5.0,
    }

    def build_data(self):
        return PTBData(self.config)

    def build_net(self):
        cfg = self.config
        vocab = self.data.vocab
        layers: list[L.Layer] = [
            L.Embedding(vocab, cfg["embed_dim"],
                        w_init=init_lib.uniform(0.1))]
        for _ in range(cfg["n_layers"]):
            layers += [L.Dropout(cfg["dropout"]), L.LSTM(cfg["hidden"])]
        layers += [L.Dropout(cfg["dropout"]),
                   L.Dense(vocab, w_init=init_lib.glorot_normal)]
        return L.Sequential(layers), (cfg["seq_len"],)

    def loss_fn(self, params, state, batch, gen, train: bool):
        loss, (new_state, metrics) = super().loss_fn(params, state, batch,
                                                     gen, train)
        return loss, (new_state, {**metrics,
                                  "perplexity": metrics["cost"].exp()})
