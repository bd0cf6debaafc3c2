"""Data pipeline: deterministic synthetic token streams + file-backed shards.

A copy of ``repro/train/data.py`` (numpy only, no torch): for the same seed,
shards and batch size it gives the same batches, byte for byte, so that the
port and the reference train on the same data.

Two sources behind one iterator interface:

* :class:`SyntheticTokens` — deterministic pseudo-corpus (hash-mixed token
  streams with Zipf-ish marginals and learnable bigram structure, so losses
  actually decrease during the example runs);
* :class:`ShardedTokenFiles` — ``.npy`` token shards on disk (what the
  Transfer action provider stages between endpoints in the SSX-style flows);
  shards are claimed per data-parallel rank for multi-host layouts.

Both yield {"tokens": [B, S], "labels": [B, S]} (numpy int32) with labels =
next token; the caller moves them to its device.
"""

from __future__ import annotations

import os
import threading
from queue import Queue

import numpy as np


class SyntheticTokens:
    """Deterministic synthetic LM data with learnable structure."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                 structure: float = 0.8):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.structure = structure
        rng = np.random.default_rng(seed)
        # fixed random bigram successor table: next = succ[cur] with prob
        # `structure`, else uniform noise — gives a learnable signal
        self._succ = rng.integers(0, vocab_size, size=vocab_size)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        stream = np.empty((self.batch, self.seq + 1), np.int32)
        stream[:, 0] = rng.integers(0, self.vocab, size=self.batch)
        noise = rng.random((self.batch, self.seq))
        rand_tok = rng.integers(0, self.vocab, size=(self.batch, self.seq))
        for t in range(self.seq):
            follow = self._succ[stream[:, t]]
            stream[:, t + 1] = np.where(
                noise[:, t] < self.structure, follow, rand_tok[:, t]
            )
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class ShardedTokenFiles:
    """Token shards (.npy int32 [N, S+1]) from a directory; rank-sliced."""

    def __init__(self, directory: str, batch: int, seq_len: int,
                 rank: int = 0, world: int = 1, loop: bool = True):
        self.directory = directory
        self.batch = batch
        self.seq = seq_len
        self.rank = rank
        self.world = world
        self.loop = loop

    def shard_files(self) -> list[str]:
        files = sorted(
            f for f in os.listdir(self.directory) if f.endswith(".npy")
        )
        return [
            os.path.join(self.directory, f)
            for i, f in enumerate(files)
            if i % self.world == self.rank
        ]

    def __iter__(self):
        while True:
            files = self.shard_files()
            if not files:
                raise FileNotFoundError(
                    f"no .npy shards under {self.directory}"
                )
            for path in files:
                arr = np.load(path)
                if arr.shape[1] < self.seq + 1:
                    continue
                for i in range(0, arr.shape[0] - self.batch + 1, self.batch):
                    window = arr[i : i + self.batch, : self.seq + 1]
                    yield {
                        "tokens": window[:, :-1].astype(np.int32),
                        "labels": window[:, 1:].astype(np.int32),
                    }
            if not self.loop:
                return


def write_token_shards(
    directory: str, vocab: int, n_shards: int, rows: int, seq_len: int,
    seed: int = 0,
) -> list[str]:
    """Materialize synthetic shards to disk (used by data-staging flows)."""
    os.makedirs(directory, exist_ok=True)
    paths = []
    src = SyntheticTokens(vocab, rows, seq_len, seed=seed)
    for s in range(n_shards):
        b = src.batch_at(s)
        arr = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
        path = os.path.join(directory, f"shard_{s:05d}.npy")
        np.save(path, arr.astype(np.int32))
        paths.append(path)
    return paths


class Prefetcher:
    """Background-thread prefetch of a data iterator (depth-bounded)."""

    def __init__(self, iterator, depth: int = 2):
        self._queue: Queue = Queue(maxsize=depth)
        self._done = object()

        def work():
            try:
                for item in iterator:
                    self._queue.put(item)
            finally:
                self._queue.put(self._done)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            raise StopIteration
        return item
