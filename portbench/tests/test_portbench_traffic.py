"""The traffic generators repeat for a seed and change with it."""

import numpy as np

from portbench.traffic import closed_loop, token_stream

CHAT = {"kind": "closed_loop", "clients": 32, "prompt_median": 256, "prompt_sigma": 0.6,
        "prompt_min": 64, "prompt_max": 1024, "new_tokens": 128, "pad_token": 0}
TRAIN = {"kind": "token_stream", "batch": 4, "seq_len": 64, "steps_per_flow": 4,
         "structure": 0.8}
BIG_SEED = 2**31 + 987654321


def test_token_stream_repeats_for_a_seed():
    a, b = token_stream.make(TRAIN, 1000, BIG_SEED), token_stream.make(TRAIN, 1000, BIG_SEED)
    for step in (0, 1, 7):
        x, y = a.batch_at(step), b.batch_at(step)
        assert np.array_equal(x["tokens"], y["tokens"]) and np.array_equal(x["labels"], y["labels"])
    other = token_stream.make(TRAIN, 1000, BIG_SEED + 1).batch_at(0)
    assert not np.array_equal(other["tokens"], a.batch_at(0)["tokens"])


def test_token_stream_rewinds_every_iterator():
    stream = token_stream.make(TRAIN, 1000, BIG_SEED)
    it = iter(stream)
    first = [next(it)["tokens"] for _ in range(3)]
    stream.rewind()
    again = [next(it)["tokens"] for _ in range(3)]
    assert all(np.array_equal(x, y) for x, y in zip(first, again))
    assert np.array_equal(first[1], stream.batch_at(1)["tokens"])


def test_token_stream_labels_are_the_next_token_and_rows_differ():
    batch = token_stream.make(TRAIN, 1000, 3).batch_at(0)
    assert np.array_equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert len({row.tobytes() for row in batch["tokens"]}) == TRAIN["batch"]


def test_token_stream_matches_the_port_s_stream():
    from repro_torch.train.data import SyntheticTokens

    ours = token_stream.make(TRAIN, 1000, 42).batch_at(3)
    port = SyntheticTokens(1000, TRAIN["batch"], TRAIN["seq_len"], seed=42).batch_at(3)
    assert np.array_equal(ours["tokens"], port["tokens"])


def test_closed_loop_repeats_and_every_round_holds_the_same_lengths():
    a, b = closed_loop.make(CHAT, 32000, BIG_SEED), closed_loop.make(CHAT, 32000, BIG_SEED)
    lengths = sorted(len(p) for p in a.round(0))
    for k in (0, 1, 5):
        ra, rb = a.round(k), b.round(k)
        assert all(np.array_equal(x, y) for x, y in zip(ra, rb))
        assert sorted(len(p) for p in ra) == lengths
    other = closed_loop.make(CHAT, 32000, BIG_SEED + 1)
    assert sorted(len(p) for p in other.round(0)) == lengths
    assert [len(p) for p in other.round(0)] != [len(p) for p in a.round(0)]
    warm = a.warmup_round()
    assert sorted(len(p) for p in warm) == lengths
    assert not all(np.array_equal(x, y) for x, y in zip(warm, a.round(0)))


def test_closed_loop_lengths_follow_the_clipped_log_normal():
    lengths = closed_loop.prompt_lengths(CHAT)
    assert len(lengths) == 32 and lengths == sorted(lengths)
    assert 64 <= lengths[0] and lengths[-1] <= 1024
    assert lengths[15] <= 256 <= lengths[16]
    assert lengths[-1] == 932 and lengths[0] == 70
