"""The plain reference agrees with the port's CPU path at SMOKE sizes, in
float32: forward logits (dense, and experts with capacity drops over two
groups), served tokens through prefill and decode, and three AdamW steps."""

import numpy as np
import pytest
import torch

from portbench.harness import bench, weights
from portbench.reference import model as M
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.reference.compare import serve_numbers, train_numbers, widest_gap
from portbench.traffic import token_stream

DENSE = dict(arch="internlm2-1.8b", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256, rope_theta=1e6,
             norm_type="rmsnorm", norm_eps=1e-5, mlp_type="swiglu", tie_embeddings=False,
             param_dtype="float32", compute_dtype="float32", remat_policy="none")
MOE = dict(DENSE, arch="mixtral-8x7b", family="moe", sliding_window=48,
           moe={"n_experts": 4, "top_k": 2, "d_ff": 32, "capacity_factor": 0.5})
F32 = M.Precision("float32")


def _model(cfg):
    from repro_torch.models.model import Model, param_shapes

    pc = bench.model_config(cfg, "xla")
    return Model(pc), weights.draw(param_shapes(pc), 5, "cpu")


@pytest.mark.parametrize("cfg", [DENSE, MOE], ids=["dense", "moe"])
def test_forward_logits_match_the_port(cfg):
    model, params = _model(cfg)
    B, S = (4, 1024) if "moe" in cfg else (2, 64)
    tokens = torch.randint(0, 256, (B, S), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        port, _ = model.forward(params, {"tokens": tokens})
        flat = torch.arange(B * S)
        groups = list(flat.view(M.group_count(B * S), -1))
        ref = M.logits(params, cfg, M.hidden(params, cfg, tokens, F32, M.Routing(groups)), F32)
    if "moe" in cfg:
        assert len(groups) == 2
        from repro_torch.models import moe

        # capacity 0.5 drops tokens: the comparison covers the drop rule
        assert moe.capacity_for(2048, bench.model_config(cfg)) < 2048 * 2 / 4
    err = (port - ref).abs().max() / ref.abs().max()
    assert err < 2e-5


def _served(cfg):
    """A SMOKE batch served through the port in f32, with its logits and
    routing as the serve cell records them."""
    from repro_torch.models import moe
    from repro_torch.serve.engine import BatchAccumulator, ServeEngine

    model, params = _model(cfg)
    engine = ServeEngine(model, params, max_len=64, device="cpu")
    accum = BatchAccumulator(engine, max_batch=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 17, 9, 30)]
    calls, logits = [], []
    real_dispatch, real_prefill, real_decode = moe.top_k_dispatch, model.prefill, model.decode_step

    def dispatch(lg, c, cap):
        out = real_dispatch(lg, c, cap)
        G, T, E = lg.shape
        calls.append((torch.topk(lg, 2, dim=-1).indices.reshape(G * T, -1),
                      out[0].any(-1).reshape(G * T, E)))
        return out

    def keep(fn):
        return lambda *a: (lambda out: (logits.append(out[0][:, -1]), out)[1])(fn(*a))

    model.prefill, model.decode_step = keep(real_prefill), keep(real_decode)
    moe.top_k_dispatch = dispatch
    try:
        for p in prompts:
            accum.submit(p)
        served = torch.as_tensor(np.stack([r["tokens"] for r in accum.flush(max_new_tokens=12)]))
    finally:
        moe.top_k_dispatch = real_dispatch
    tape = ref_serve.tape_of_calls(calls, 4, 30, 12, cfg["n_layers"])
    return params, prompts, served, torch.stack(logits, 1), tape


def test_served_tokens_are_the_reference_s_best():
    cfg = dict(MOE, moe=dict(MOE["moe"], capacity_factor=1.25))
    params, prompts, served, logits, tape = _served(cfg)
    for side_tape in (None, tape):
        ref, routing = ref_serve.served_logits(params, cfg, prompts, served, 0, F32, side_tape)
        assert ref.shape == (4, 12, 256)
        nums = serve_numbers(ref, served, logits)
        assert nums["served_gap"] < 1e-5 and nums["logits_rel_l2"] < 1e-5
        assert nums["served_not_argmax"] == 0
    # followed, the run's routing is the reference's own, slot for slot
    assert max(routing.margins) == 0.0 and routing.mismatches == 0 and routing.off_choices == 0
    # a token altered where it is produced lies far below the reference's best
    bad = served.clone()
    bad[2, 5] = (bad[2, 5] + 1) % 256
    assert widest_gap(ref, bad) > 0.1
    assert serve_numbers(ref, bad, logits)["served_not_argmax"] == 1
    # a slot placed past the capacity rule, and a choice off the top-k, show
    broken = [(c.clone(), p.clone()) for c, p in tape]
    broken[1][1][7] = ~broken[1][1][7]
    broken[0][0][3, 0] = (broken[0][0][3, 0] + 1) % 4  # row 0's pad
    broken[0][0][29, 0] = (broken[0][0][29, 0] + 1) % 4  # row 0's last prompt token
    _, routing = ref_serve.served_logits(params, cfg, prompts, served, 0, F32, broken)
    assert routing.mismatches > 0 and routing.margins[0] > 0 and routing.off_choices >= 1
    # the count is over the real tokens' choices alone, in every layer
    real = sum(len(p) for p in prompts) + len(prompts) * (served.shape[1] - 1)
    assert routing.n_choices == cfg["n_layers"] * 2 * real


def test_three_training_steps_match_the_port():
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.loop import TrainState, make_train_step
    from repro_torch.train.optimizer import init_adamw

    cfg = DENSE
    model, params = _model(cfg)
    tcfg = TrainConfig(warmup_steps=2, learning_rate=1e-3)
    data = token_stream.make({"batch": 4, "seq_len": 32, "structure": 0.8}, 256, 9)
    batches = [data.batch_at(i) for i in range(3)]
    p0 = weights.draw(_shapes(params), 5, "cpu")
    state = TrainState(params, init_adamw(params))
    step = make_train_step(model, tcfg)
    losses, grad_norms = [], None
    for i, b in enumerate(batches):
        state, metrics = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(metrics["loss"]))
        if i == 0:
            grad_norms = {"/".join(k): float(torch.linalg.vector_norm(m)) / (1 - tcfg.beta1)
                          for k, m in weights.leaves(state.opt.m)}
    named0 = {"/".join(k): t for k, t in weights.leaves(p0)}
    change = {"/".join(k): float(torch.linalg.vector_norm(t - named0["/".join(k)]))
              for k, t in weights.leaves(state.params)}
    tdict = {k: getattr(tcfg, k) for k in ("learning_rate", "weight_decay", "beta1", "beta2",
                                           "eps", "warmup_steps", "total_steps", "max_grad_norm")}
    ref = ref_train.follow(p0, cfg, tdict, batches, 3, F32)
    nums = train_numbers({"losses": losses, "grad_norms": grad_norms, "change_norms": change}, ref)
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-4


def _shapes(tree):
    return {k: _shapes(v) for k, v in tree.items()} if isinstance(tree, dict) else tuple(tree.shape)
