"""Training traffic: a deterministic synthetic token stream.

A frozen copy of the port's ``SyntheticTokens`` (``repro_torch/train/data.py``):
hash-mixed token streams with a fixed random bigram successor table, so that a
loss can fall.  For one seed it gives the same batches byte for byte; every row
of every batch differs.  ``rewind`` starts it again.  The mix file gives ``batch``, ``seq_len``,
``structure`` (the share of tokens that follow the bigram table) and
``steps_per_flow``.
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.vocab = vocab_size
        self.batch = int(mix["batch"])
        self.seq = int(mix["seq_len"])
        self.structure = float(mix["structure"])
        self.seed = int(seed)
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, vocab_size, size=vocab_size)
        self._next = 0

    def batch_at(self, step: int) -> dict:
        """{"tokens", "labels"} int32 [batch, seq_len], labels the next token."""
        rng = np.random.default_rng((self.seed, step))
        stream = np.empty((self.batch, self.seq + 1), np.int32)
        stream[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        noise = rng.random((self.batch, self.seq))
        rand_tok = rng.integers(0, self.vocab, size=(self.batch, self.seq))
        for t in range(self.seq):
            follow = self._succ[stream[:, t]]
            stream[:, t + 1] = np.where(noise[:, t] < self.structure, follow, rand_tok[:, t])
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def rewind(self) -> None:
        """Every iterator over the stream gives batch 0 next."""
        self._next = 0

    def __iter__(self):
        while True:
            step, self._next = self._next, self._next + 1
            yield self.batch_at(step)


def make(mix: dict, vocab_size: int, seed: int) -> TokenStream:
    return TokenStream(mix, vocab_size, seed)
