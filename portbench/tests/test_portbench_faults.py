"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a chip (``bench.run`` on the CPU, at
SMOKE sizes, with the cells' own limits) and plants one fault that the cell
can have: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest), a token altered where it is produced.  One
chip runs each cell, so no exchange between chips can be left out."""

import time

import pytest
import torch

from portbench.harness import bench
from portbench.tests.smoke import smoke_root

SEED = 2**31 + 4242


def _run(tmp_path, cell):
    root = smoke_root(tmp_path)
    return bench.run(bench.load_cell(cell, root), SEED, 0.5, False, "cpu", time.perf_counter())


def test_sound_runs_are_correct(tmp_path):
    for cell in ("internlm2-train-2k", "mixtral-serve-decode"):
        out = _run(tmp_path / cell, cell)
        assert out["correct"], (cell, out["checks"])


def test_a_training_step_that_leaves_the_state_unchanged(tmp_path, monkeypatch):
    import repro_torch.train.optimizer as opt

    def unchanged(params, grads, state, cfg):
        step = state.step + 1
        zero = torch.zeros((), device=step.device)
        return params, opt.AdamWState(step, state.m, state.v), {"grad_norm": zero, "lr": zero}

    monkeypatch.setattr(opt, "adamw_update", unchanged)
    out = _run(tmp_path, "internlm2-train-2k")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    from repro_torch.models.model import Model

    real = Model.loss

    def half(self, params, batch):
        rows = batch["tokens"].shape[0] // 2
        return real(self, params, {k: v[:rows] for k, v in batch.items()})

    monkeypatch.setattr(Model, "loss", half)
    out = _run(tmp_path, "internlm2-train-2k")
    assert not out["correct"], out["checks"]


def test_a_served_token_altered_where_it_is_produced(tmp_path, monkeypatch):
    from repro_torch.serve.engine import ServeEngine

    real = ServeEngine._sample
    calls = {"n": 0}

    def altered(self, logits):
        out = real(self, logits)
        calls["n"] += 1
        if calls["n"] % 5 == 3:
            out[0] = (out[0] + 1) % logits.shape[-1]
        return out

    monkeypatch.setattr(ServeEngine, "_sample", altered)
    out = _run(tmp_path, "mixtral-serve-decode")
    assert not out["correct"], out["checks"]


def test_a_decode_step_that_leaves_the_cache_unchanged(tmp_path, monkeypatch):
    from repro_torch.models import attention

    real = attention.write_kv

    def skip_decode(cache, k, v, position):
        if k.shape[1] > 1:
            real(cache, k, v, position)

    monkeypatch.setattr(attention, "write_kv", skip_decode)
    out = _run(tmp_path, "mixtral-serve-decode")
    assert not out["correct"], out["checks"]


def test_a_training_step_that_goes_wrong_only_after_set_up(tmp_path, monkeypatch):
    """Sound through the set-up's warm-up flow run, the state left unchanged
    from then on: the check reads the window's own steps, so it fails."""
    import repro_torch.train.optimizer as opt

    real = opt.adamw_update
    calls = {"n": 0}
    steps_per_flow = 4

    def later_unchanged(params, grads, state, cfg):
        calls["n"] += 1
        if calls["n"] <= steps_per_flow:
            return real(params, grads, state, cfg)
        step = state.step + 1
        zero = torch.zeros((), device=step.device)
        return params, opt.AdamWState(step, state.m, state.v), {"grad_norm": zero, "lr": zero}

    monkeypatch.setattr(opt, "adamw_update", later_unchanged)
    out = _run(tmp_path, "internlm2-train-2k")
    assert not out["correct"], out["checks"]


def test_served_weights_rounded_in_place(tmp_path, monkeypatch):
    """The engine's weights rounded to float8 in place before it serves: the
    reference draws its own weights, so it does not follow the rounding."""
    from repro_torch.serve.engine import ServeEngine

    from portbench.reference.model import _fake_fp8

    real = ServeEngine.generate
    done = {"rounded": False}

    def rounded(self, *args, **kw):
        if not done["rounded"]:
            with torch.no_grad():
                for _, t in _leaves(self.params):
                    if t.dim() >= 2:
                        t.copy_(_fake_fp8(t))
            done["rounded"] = True
        return real(self, *args, **kw)

    monkeypatch.setattr(ServeEngine, "generate", rounded)
    out = _run(tmp_path, "mixtral-serve-decode")
    assert done["rounded"]
    assert not out["correct"], out["checks"]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_moe_calls_of_another_layout_are_counted_off():
    """The serve check keeps the checked round's routing from the port's
    dispatch; a call it cannot read, or a missing one, counts as off."""
    from portbench.drivers.serve_closed_loop import _Kept

    cell = bench.load_cell("mixtral-serve-decode")
    cfg = bench.model_config(dict(cell.config, n_layers=2, vocab_size=64))
    kept = _Kept(cfg, [[1, 2, 3], [4, 5]], 3, "cpu")
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    choice = torch.zeros((1, 6, k), dtype=torch.long)
    good = torch.zeros((1, 6, E, 8), dtype=torch.bool)
    for _ in range(2):  # the prefill's layers
        kept.add_call(choice, good)
    kept.add_call(choice[:, :2], good[:, :2])  # decode step 1, layer 0
    assert kept.calls_off() == 3  # three calls still due
    kept.add_call(choice[:, :2], good[:, :2].reshape(1, 2, -1))  # another layout
    assert kept.calls_off() == 3
    kept.add_call(choice[:, :2], good[:, :2])
    kept.add_call(choice[:, :2], good[:, :2])
    assert kept.calls_off() == 1  # the one call of another layout
