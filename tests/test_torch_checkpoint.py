"""The port's data pipeline and checkpoints against the JAX package's.

The data sources are a copy of the reference's, so their batches must be
byte-equal for the same seed.  The checkpoints keep the reference's on-disk
layout and leaf order (``TrainState(params, AdamWState(step, m, v))``: params
in sorted-key order, the step, m, v), so a checkpoint written by either
package restores into the other with every leaf exactly equal.  The
reference's own data and checkpoint tests (``tests/train/test_data_checkpoint.py``)
are re-run on the port.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port's tests need torch beside jax; without it they are not collected
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models.model import Model as JaxModel
from repro.train import checkpoint as jax_ckpt
from repro.train import data as jax_data
from repro.train import loop as jax_loop
from repro_torch import bridge, configs
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data
from repro_torch.train import loop
from repro_torch.train import optimizer as opt

ARCH = "internlm2-1.8b"


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab,batch,seq", [(0, 512, 4, 16), (3, 97, 2, 33),
                                                  (7, 92544, 8, 64)])
def test_synthetic_tokens_equal_reference(seed, vocab, batch, seq):
    ours = data.SyntheticTokens(vocab, batch, seq, seed=seed)
    theirs = jax_data.SyntheticTokens(vocab, batch, seq, seed=seed)
    assert ours._succ.tobytes() == theirs._succ.tobytes()
    for step in (0, 1, 5, 10_000):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            assert a[key].tobytes() == b[key].tobytes()
    for a, b, _ in zip(ours, theirs, range(3)):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()


def test_synthetic_deterministic_and_learnable():
    src = data.SyntheticTokens(vocab_size=97, batch=4, seq_len=16, seed=3)
    a, b = src.batch_at(5), src.batch_at(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 16)
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert (src._succ[a["tokens"]] == a["labels"]).mean() > 0.5


def test_token_shards_equal_reference(tmp_path):
    kw = dict(vocab=50, n_shards=4, rows=8, seq_len=8, seed=2)
    ours = data.write_token_shards(str(tmp_path / "ours"), **kw)
    theirs = jax_data.write_token_shards(str(tmp_path / "theirs"), **kw)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()
    for rank in (0, 1):
        r_ours = data.ShardedTokenFiles(str(tmp_path / "ours"), batch=4, seq_len=8,
                                        rank=rank, world=2, loop=False)
        r_theirs = jax_data.ShardedTokenFiles(str(tmp_path / "theirs"), batch=4, seq_len=8,
                                              rank=rank, world=2, loop=False)
        got, want = list(r_ours), list(r_theirs)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes()


def test_sharded_files_rank_slicing(tmp_path):
    data.write_token_shards(str(tmp_path), vocab=50, n_shards=4, rows=8, seq_len=8)
    r0 = data.ShardedTokenFiles(str(tmp_path), batch=4, seq_len=8, rank=0, world=2)
    r1 = data.ShardedTokenFiles(str(tmp_path), batch=4, seq_len=8, rank=1, world=2)
    f0, f1 = r0.shard_files(), r1.shard_files()
    assert len(f0) == len(f1) == 2 and not set(f0) & set(f1)
    batch = next(iter(r0))
    assert batch["tokens"].shape == (4, 8)
    np.testing.assert_array_equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .npy shards"):
        next(iter(data.ShardedTokenFiles(str(tmp_path / "empty"), batch=4, seq_len=8)))


def test_prefetcher_matches_reference():
    src = data.SyntheticTokens(97, 2, 8, seed=1)
    ours = [b["tokens"].tobytes() for b, _ in zip(data.Prefetcher(iter(src), depth=3), range(6))]
    theirs = [b["tokens"].tobytes() for b, _ in
              zip(jax_data.Prefetcher(iter(jax_data.SyntheticTokens(97, 2, 8, seed=1)), depth=3),
                  range(6))]
    assert ours == theirs
    assert list(data.Prefetcher(iter(range(20)), depth=3)) == list(range(20))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "b": {"x": torch.ones(5)},
            "h": torch.randn(3, 2, dtype=torch.float64),
            "bf": torch.randn(4, generator=torch.Generator().manual_seed(0)).bfloat16(),
            "i": torch.tensor(7, dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 7, tree, {"note": "hi"})
    assert os.path.basename(path) == "step_00000007"
    target = L.map_tree(torch.zeros_like, tree)
    restored, meta = ckpt.restore(str(tmp_path), target)
    assert meta["step"] == 7 and meta["note"] == "hi" and meta["n_leaves"] == 5
    for (p1, a), (p2, b) in zip(L.flatten_specs(restored), L.flatten_specs(tree)):
        assert p1 == p2 and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_and_gc(tmp_path):
    tree = {"w": torch.ones(3)}
    for step in (1, 5, 3):
        ckpt.save(str(tmp_path), step, tree)
    assert ckpt.list_steps(str(tmp_path)) == [1, 3, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    _, meta = ckpt.restore(str(tmp_path), tree)
    assert meta["step"] == 5
    _, meta = ckpt.restore(str(tmp_path), tree, step=3)
    assert meta["step"] == 3
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nothing"), tree)


def test_checkpoint_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), {"w": torch.ones((3, 3))})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"w": torch.ones((2, 2)), "extra": torch.ones(1)})


def test_async_checkpointer_keeps_three(tmp_path):
    acp = ckpt.AsyncCheckpointer(str(tmp_path))
    assert acp.keep == 3
    tree = {"w": torch.zeros(4)}
    for step in range(5):
        tree["w"].fill_(float(step))
        acp.save(step, tree)
        tree["w"].fill_(-1.0)  # the snapshot was taken before save returned
    acp.wait()
    assert ckpt.list_steps(str(tmp_path)) == [2, 3, 4]
    restored, meta = ckpt.restore(str(tmp_path), {"w": torch.zeros(4)})
    assert meta["step"] == 4
    torch.testing.assert_close(restored["w"], torch.full((4,), 4.0), rtol=0, atol=0)
    assert acp.last_path == os.path.join(str(tmp_path), "step_00000004")


def test_save_leaves_no_tmp_directory(tmp_path):
    ckpt.save(str(tmp_path), 2, {"w": torch.ones(3)})
    ckpt.save(str(tmp_path), 2, {"w": torch.zeros(3)})  # overwrite in place
    assert sorted(os.listdir(tmp_path)) == ["step_00000002"]
    assert sorted(os.listdir(tmp_path / "step_00000002")) == ["METADATA.json", "leaf_00000.npy"]
    restored, _ = ckpt.restore(str(tmp_path), {"w": torch.ones(3)})
    assert torch.equal(restored["w"], torch.zeros(3))
    # a .tmp left by a crash mid-save is not a checkpoint
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 2


def _states(arch=ARCH):
    """The JAX and port train states of ``arch`` SMOKE (internlm2 unless
    given) after one step from the same bridged weights (so m and v are not
    zero)."""
    kw = dict(compute_dtype="float32")
    jcfg = jax_configs.get(arch, smoke=True).replace(**kw)
    tcfg = configs.get(arch, smoke=True).replace(**kw)
    tc = dict(total_steps=10, warmup_steps=1, learning_rate=1e-3)
    j_state, _ = jax_loop.init_state(JaxModel(jcfg), jax.random.PRNGKey(0))
    t_params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, j_state.params), tcfg,
                                      device="cpu")
    t_state = loop.TrainState(t_params, opt.init_adamw(t_params))
    batch = jax_data.SyntheticTokens(tcfg.vocab_size, 2, 8, seed=0).batch_at(0)
    j_state, _ = jax_loop.make_train_step(JaxModel(jcfg), JaxTrainConfig(**tc))(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()})
    t_state, _ = loop.make_train_step(Model(tcfg), TrainConfig(**tc))(
        t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return j_state, t_state, tcfg


def _assert_states_equal(t_state, j_state):
    t_leaves = ckpt._flatten(t_state)
    j_leaves = jax.tree_util.tree_leaves(j_state)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[-1] == str(j.dtype)
        assert t.numpy().tobytes() == j.tobytes()


def test_leaf_order_is_the_references():
    j_state, t_state, _ = _states()
    n_params = len(jax.tree_util.tree_leaves(j_state.params))
    leaves = ckpt._flatten(t_state)
    assert len(leaves) == 3 * n_params + 1
    assert leaves[n_params] is t_state.step
    assert leaves[:n_params] == [t for _, t in L.flatten_specs(t_state.params)]
    assert leaves[n_params + 1:2 * n_params + 1] == [t for _, t in L.flatten_specs(t_state.opt.m)]


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    j_state, t_state, tcfg = _states()
    jax_ckpt.save(str(tmp_path), 1, j_state)
    target = loop.init_state(Model(tcfg), torch.Generator().manual_seed(5), device="cpu")
    restored, meta = ckpt.restore(str(tmp_path), target)
    assert meta["step"] == 1 and isinstance(restored, loop.TrainState)
    assert isinstance(restored.opt, opt.AdamWState) and restored.step.dtype == torch.int32
    _assert_states_equal(restored, j_state)


def test_port_checkpoint_restores_into_jax(tmp_path):
    j_state, t_state, _ = _states()
    ckpt.save(str(tmp_path), 1, t_state)
    with open(tmp_path / "step_00000001" / "METADATA.json") as fh:
        meta = json.load(fh)
    assert meta["n_leaves"] == len(jax.tree_util.tree_leaves(j_state))
    target = jax.tree_util.tree_map(jnp.zeros_like, j_state)
    restored, _ = jax_ckpt.restore(str(tmp_path), target)
    _assert_states_equal(t_state, restored)


def test_xlstm_train_state_restores_across_packages_bitwise(tmp_path):
    """xlstm-1.3b's TrainState (mLSTM leaves stacked twice) restores both ways
    bit for bit, its leaves in jax.tree_util's order."""
    j_state, t_state, tcfg = _states("xlstm-1.3b")
    leaves = ckpt._flatten(t_state)
    assert len(leaves) == len(jax.tree_util.tree_leaves(j_state)) == 3 * 33 + 1
    jax_ckpt.save(str(tmp_path / "jax"), 1, j_state)
    target = loop.init_state(Model(tcfg), torch.Generator().manual_seed(5), device="cpu")
    restored, meta = ckpt.restore(str(tmp_path / "jax"), target)
    assert meta["step"] == 1
    _assert_states_equal(restored, j_state)
    ckpt.save(str(tmp_path / "port"), 1, t_state)
    back, _ = jax_ckpt.restore(str(tmp_path / "port"), jax.tree_util.tree_map(jnp.zeros_like,
                                                                              j_state))
    _assert_states_equal(t_state, back)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-medium"])
def test_bridge_round_trips_new_families_bitwise(arch):
    """params_from_jax / params_to_jax on the reference's own init of xlstm-1.3b
    and whisper-medium SMOKE: every leaf back bit for bit, in order."""
    jcfg = jax_configs.get(arch, smoke=True)
    tcfg = configs.get(arch, smoke=True)
    tree = jax.tree_util.tree_map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(3))[0])
    back = bridge.params_to_jax(bridge.params_from_jax(tree, tcfg, device="cpu"), tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(tree)
    bleaves = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in jleaves] == [p for p, _ in bleaves]
    for (_, j), (_, b) in zip(jleaves, bleaves):
        assert b.dtype == j.dtype and b.tobytes() == j.tobytes()
