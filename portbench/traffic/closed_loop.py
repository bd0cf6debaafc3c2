"""Serving traffic: a closed loop of clients, each sending its next prompt when
the reply to its last one is complete.

Prompt lengths follow a log-normal (``prompt_median``, ``prompt_sigma``)
clipped to ``prompt_min`` .. ``prompt_max``.  Every round of requests (one
from each client) holds the same set of lengths, the stratified quantiles
``(i + 0.5) / clients`` of that distribution, dealt to the clients in an order
drawn from the seed; the token ids are drawn from the seed.  So every seed
asks for the same amount of work, and the seed changes only which client
sends which length and what the tokens are.  Each request asks for
``new_tokens`` greedy tokens and stops at no end token.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

WARMUP_ROUND = 1 << 40  # a round index no window reaches


def prompt_lengths(mix: dict) -> list[int]:
    """The lengths of one round, longest last."""
    n = int(mix["clients"])
    lo, hi = int(mix["prompt_min"]), int(mix["prompt_max"])
    out = []
    for i in range(n):
        z = NormalDist().inv_cdf((i + 0.5) / n)
        length = round(mix["prompt_median"] * math.exp(mix["prompt_sigma"] * z))
        out.append(min(max(length, lo), hi))
    return sorted(out)


class ClosedLoop:
    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix = mix
        self.vocab = vocab_size
        self.seed = int(seed)
        self.clients = int(mix["clients"])
        self.new_tokens = int(mix["new_tokens"])
        self.lengths = prompt_lengths(mix)

    def round(self, k: int) -> list[np.ndarray]:
        """Round ``k``: client c's prompt (int32 token ids) at index c."""
        rng = np.random.default_rng((self.seed, k))
        lengths = rng.permutation(np.asarray(self.lengths))
        return [rng.integers(0, self.vocab, size=int(n)).astype(np.int32) for n in lengths]

    def warmup_round(self) -> list[np.ndarray]:
        return self.round(WARMUP_ROUND)


def make(mix: dict, vocab_size: int, seed: int) -> ClosedLoop:
    return ClosedLoop(mix, vocab_size, seed)
