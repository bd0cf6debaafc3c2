"""The port's training slice against the JAX package, on the CPU in f32.

Covers the kernels' autograd guard (a backward through any of the three
kernel routes raises, as a gradient through a Pallas call does in the
reference), remat, the optimizer (the reference's own optimizer tests re-run
on the port, and one update on a random tree against the reference), and the
train step: a 20-step internlm2 SMOKE loss and grad-norm curve from bridged
weights, microbatching and bf16 gradients, each against the reference's
``make_train_step`` on the same ``SyntheticTokens`` batches.

Tolerances: a single f32 op at the reference's 2e-5; the first step's loss
and grad norm at 1e-4 (a layer stack's sums ordered differently, as in the
logits tests); later steps at 1e-3.  After one step Adam turns the sign of a
near-zero gradient into a whole +-lr step, so params are held at
atol 2 lr(step 0) + rtol 1e-4.  At lr 1e-3 (the integration test's and the
launcher's) the grad norm of SMOKE training is chaotic: the reference jitted
and the reference op by op drift 6.3e-3 apart in it by step 16 while their
losses stay within 1.3e-5 (PERF.md), so there the loss curve is held and the
grad norm only at step 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port's tests need torch beside jax; without it they are not collected
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.models.model import Model as JaxModel
from repro.testing import hypothesis_shim
from repro.train import loop as jax_loop
from repro.train import optimizer as jax_opt
from repro.train.data import SyntheticTokens
from repro_torch import bridge, configs
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.testing import redraw_params_
from repro_torch.train import loop
from repro_torch.train import optimizer as opt

given, settings, st = hypothesis_shim()

F32 = dict(rtol=2e-5, atol=2e-5)
ARCH = "internlm2-1.8b"
B, S, STEPS = 4, 16, 20


def _cfgs(arch=ARCH, **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (jax_configs.get(arch, smoke=True).replace(**kw),
            configs.get(arch, smoke=True).replace(**kw))


def _params(cfg, seed=0):
    params = Model(cfg).init(torch.Generator().manual_seed(seed), device="cpu")
    redraw_params_(params, seed)
    return params


def _batch(cfg, b=2, s=16, seed=1):
    t = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1)))
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


# ---------------------------------------------------------------------------
# the kernel routes refuse autograd, as the reference's Pallas calls do
# ---------------------------------------------------------------------------


def test_jax_grad_through_flash_raises():
    jcfg, _ = _cfgs(attention_impl="flash")
    model = JaxModel(jcfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    t = jnp.ones((2, 16), jnp.int32)
    model.loss(params, {"tokens": t, "labels": t})  # the forward runs
    with pytest.raises(AssertionError):
        jax.grad(model.loss)(params, {"tokens": t, "labels": t})


def _kernel_calls():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    xh = torch.randn(1, 8, 2, 4, generator=g)
    dt = torch.rand(1, 8, 2, generator=g)
    A = -torch.rand(2, generator=g)
    Bm, Cm = (torch.randn(1, 8, 4, generator=g) for _ in range(2))
    x, w = torch.randn(2, 3, 8, generator=g), torch.randn(2, 8, 5, generator=g)
    return {
        "flash_attention": ((q, k, v), lambda q, k, v: ops.flash_attention(q, k, v)),
        "mamba_scan": ((xh, dt, A, Bm, Cm),
                       lambda *a: ops.mamba_scan(*a, chunk=4)),
        "gmm": ((x, w), ops.gmm),
    }


@pytest.mark.parametrize("name", ["flash_attention", "mamba_scan", "gmm"])
def test_kernel_routes_refuse_autograd(name):
    inputs, call = _kernel_calls()[name]
    plain = call(*inputs)  # no input requires grad: the plain route runs
    for i in range(len(inputs)):
        leaf = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            call(*leaf)
        # without autograd recording, the same inputs run and agree
        with torch.no_grad():
            torch.testing.assert_close(call(*leaf), plain, rtol=0, atol=0)
        with torch.inference_mode():
            torch.testing.assert_close(call(*leaf), plain, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b", "mixtral-8x7b"])
def test_model_backward_through_kernel_routes_raises(arch):
    """Model.loss under attention_impl="flash" (the attention and scan
    kernels) and apply_moe(use_gmm=True) raise when their params require
    grad; inference_mode evaluation of the same params runs."""
    _, cfg = _cfgs(arch, attention_impl="flash", remat_policy="none")
    params = _params(cfg)
    batch = _batch(cfg)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        L.value_and_grad(Model(cfg).loss, params, batch)
    grad_params = L.map_tree(lambda p: p.detach().requires_grad_(), params)
    with pytest.raises(NotImplementedError):
        Model(cfg).loss(grad_params, batch).backward()
    loss = loop.make_eval_step(Model(cfg))(grad_params, batch)["loss"]
    xla = loop.make_eval_step(Model(cfg.replace(attention_impl="xla")))(params, batch)["loss"]
    torch.testing.assert_close(loss, xla, **F32)
    if cfg.moe is not None:
        p = tfm.layer_params(grad_params["blocks"], 0)["moe"]
        h = torch.randn(2, 16, cfg.d_model)
        with pytest.raises(NotImplementedError, match="gmm"):
            moe.apply_moe(p, cfg, h, use_gmm=True)
        with torch.inference_mode():
            out_k, _ = moe.apply_moe(p, cfg, h, use_gmm=True)
            out_e, _ = moe.apply_moe(p, cfg, h, use_gmm=False)
        torch.testing.assert_close(out_k, out_e, **F32)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-7b"])
def test_remat_gradients_equal_no_remat(arch, policy):
    _, cfg = _cfgs(arch, remat_policy="none")
    params, batch = _params(cfg), _batch(cfg)
    loss0, grads0 = L.value_and_grad(Model(cfg).loss, params, batch)
    loss, grads = L.value_and_grad(Model(cfg.replace(remat_policy=policy)).loss, params, batch)
    torch.testing.assert_close(loss, loss0, **F32)
    want = dict(L.flatten_specs(grads0))
    for path, g in L.flatten_specs(grads):
        torch.testing.assert_close(g, want[path], **F32, msg=lambda m, p=path: f"{p}: {m}")


def test_remat_checkpoints_only_under_autograd(monkeypatch):
    """"full" wraps each layer body in torch.utils.checkpoint when gradients
    are recorded, once per layer, and calls it plainly under inference_mode."""
    _, cfg = _cfgs(remat_policy="full")
    params, batch = _params(cfg), _batch(cfg)
    calls = []
    real = tfm.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(tfm, "checkpoint", spy)
    loop.make_eval_step(Model(cfg))(params, batch)
    assert calls == []
    L.value_and_grad(Model(cfg).loss, params, batch)
    assert calls == [False] * cfg.n_layers


# ---------------------------------------------------------------------------
# optimizer: the reference's tests (tests/train/test_optimizer.py) on the port
# ---------------------------------------------------------------------------


def quad_params():
    return {"a": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}


def quad_loss(p):
    return torch.sum(torch.square(p["a"])) + torch.square(p["b"])


def test_adamw_converges_on_quadratic():
    cfg = TrainConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=100_000, max_grad_norm=100.0)
    params = quad_params()
    state = opt.init_adamw(params)
    for _ in range(300):
        _, grads = L.value_and_grad(quad_loss, params)
        params, state, metrics = opt.adamw_update(params, grads, state, cfg)
    assert float(quad_loss(params)) < 1e-3
    assert int(state.step) == 300 and state.step.dtype == torch.int32


def test_weight_decay_shrinks_params():
    cfg = TrainConfig(learning_rate=0.1, weight_decay=0.5, warmup_steps=0, max_grad_norm=100.0)
    params = {"w": torch.tensor([10.0])}
    p1, _, _ = opt.adamw_update(params, {"w": torch.tensor([0.0])}, opt.init_adamw(params), cfg)
    assert float(p1["w"][0]) < 10.0
    assert p1["w"] is params["w"]  # the update runs in place


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 10.0)}
    clipped, norm = opt.clip_by_global_norm(grads, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(opt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    small = {"a": torch.full((4,), 0.1)}
    kept, _ = opt.clip_by_global_norm(small, 1.0)
    torch.testing.assert_close(kept["a"], small["a"], rtol=1e-6, atol=0)


def test_schedule_warmup_and_cosine():
    cfg = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=110)
    lr = opt.cosine_schedule(cfg)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.1)
    assert float(lr(torch.tensor(9))) == pytest.approx(1.0)
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0, abs=1e-3)
    assert float(lr(torch.tensor(60))) == pytest.approx(0.5, abs=1e-2)
    assert float(lr(torch.tensor(110))) == pytest.approx(0.0, abs=1e-3)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), lr=st.floats(1e-4, 1e-1))
def test_adamw_step_is_bounded(seed, lr):
    """Property: |dp| <= lr * (1 + wd*|p|) per element (Adam update bound)."""
    cfg = TrainConfig(learning_rate=lr, weight_decay=0.01, warmup_steps=0, max_grad_norm=1e9)
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.standard_normal(8).astype(np.float32))}
    grads = {"w": torch.from_numpy(rng.standard_normal(8).astype(np.float32)) * 100}
    before = params["w"].clone()
    new_params, _, _ = opt.adamw_update(params, grads, opt.init_adamw(params), cfg)
    delta = (new_params["w"] - before).abs().numpy()
    bound = lr * (1.0 + 0.011 * before.abs().numpy()) + 1e-6
    assert (delta <= bound * 1.05).all()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"blocks": {"w": rng.standard_normal((3, 8, 5)).astype(np.float32),
                       "b": rng.standard_normal((3, 5)).astype(np.float32)},
            "embed": {"table": rng.standard_normal((11, 8)).astype(np.float32)},
            "scale": rng.standard_normal(8).astype(np.float32)}


def _to_torch(tree):
    return L.map_tree(torch.from_numpy, tree)


def _close_tree(t_tree, j_tree, **tol):
    want = dict(L.flatten_specs(jax.tree_util.tree_map(np.asarray, j_tree)))
    got = dict(L.flatten_specs(t_tree))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[path], **tol, err_msg="/".join(path))


@pytest.mark.parametrize("step", [0, 3, 10, 60, 109, 200])
def test_schedule_matches_reference(step):
    cfg = dict(learning_rate=3e-4, warmup_steps=10, total_steps=110)
    want = jax_opt.cosine_schedule(JaxTrainConfig(**cfg))(jnp.asarray(step, jnp.int32))
    got = opt.cosine_schedule(TrainConfig(**cfg))(torch.tensor(step, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_matches_reference(max_norm):
    grads = _tree(1)
    j_clipped, j_norm = jax_opt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, grads),
                                                    max_norm)
    t_clipped, t_norm = opt.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(t_norm.numpy(), np.asarray(j_norm), rtol=2e-5)
    _close_tree(t_clipped, j_clipped, rtol=2e-5, atol=0)


@pytest.mark.parametrize("step", [0, 5])
def test_adamw_update_matches_reference(step):
    """One update of a random tree from a random state at step ``step``."""
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, warmup_steps=3, total_steps=20,
               max_grad_norm=1.0)
    params, grads, m = _tree(2), _tree(3), _tree(4)
    v = jax.tree_util.tree_map(np.abs, _tree(5))
    j_state = jax_opt.AdamWState(jnp.asarray(step, jnp.int32),
                                 *(jax.tree_util.tree_map(jnp.asarray, t) for t in (m, v)))
    j_params, j_new, j_metrics = jax_opt.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, grads),
        j_state, JaxTrainConfig(**cfg))
    t_state = opt.AdamWState(torch.tensor(step, dtype=torch.int32), _to_torch(m), _to_torch(v))
    t_params, t_new, t_metrics = opt.adamw_update(_to_torch(params), _to_torch(grads), t_state,
                                                  TrainConfig(**cfg))
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(t_metrics[key].numpy(), np.asarray(j_metrics[key]), rtol=2e-5)
    assert int(t_new.step) == int(j_new.step) == step + 1
    _close_tree(t_params, j_params, rtol=2e-5, atol=1e-7)
    _close_tree(t_new.m, j_new.m, rtol=2e-5, atol=1e-7)
    _close_tree(t_new.v, j_new.v, rtol=2e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# train step against the reference's make_train_step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init():
    jcfg, _ = _cfgs()
    state, _ = jax_loop.init_state(JaxModel(jcfg), jax.random.PRNGKey(0))
    return state


def _train_both(tcfg_kw: dict, steps: int):
    """(JAX metrics, port metrics) per step, and both param trees after the
    first step, from the same bridged weights on the same batches."""
    jcfg, tcfg = _cfgs()
    j_state = _jax_init()
    t_params = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, j_state.params), tcfg,
                                      device="cpu")
    t_state = loop.TrainState(t_params, opt.init_adamw(t_params))
    j_step = jax.jit(jax_loop.make_train_step(JaxModel(jcfg), JaxTrainConfig(**tcfg_kw)))
    t_step = loop.make_train_step(Model(tcfg), TrainConfig(**tcfg_kw))
    data = SyntheticTokens(tcfg.vocab_size, B, S, seed=0)
    metrics, first = [], None
    for i in range(steps):
        batch = data.batch_at(i)
        j_state, j_m = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()})
        t_state, t_m = t_step(t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append(({k: float(v) for k, v in j_m.items()},
                        {k: float(v) for k, v in t_m.items()}))
        if i == 0:  # a copy: the port's later steps update its params in place
            first = (j_state.params, L.map_tree(torch.clone, t_state.params))
    assert int(t_state.step) == steps
    return metrics, first


def _rel(a, b):
    return abs(a - b) / abs(b)


# the reference's TrainConfig defaults (lr 3e-4 with a 100-step warmup)
DEFAULTS = dict(total_steps=10_000)


def test_train_curve_matches_reference():
    metrics, (j_params, t_params) = _train_both(DEFAULTS, STEPS)
    gaps = [(_rel(t["loss"], j["loss"]), _rel(t["grad_norm"], j["grad_norm"]))
            for j, t in metrics]
    assert max(gaps[0]) <= 1e-4, gaps[0]
    assert max(max(g) for g in gaps) <= 1e-3, gaps
    for j, t in metrics:
        assert t["lr"] == pytest.approx(j["lr"], rel=2e-5)
    lr0 = metrics[0][0]["lr"]
    _close_tree(t_params, j_params, rtol=1e-4, atol=2 * lr0)


def test_train_loss_curve_at_lr_1e3_matches_reference():
    metrics, (j_params, t_params) = _train_both(
        dict(total_steps=STEPS, warmup_steps=2, learning_rate=1e-3), STEPS)
    j, t = metrics[0]
    assert _rel(t["loss"], j["loss"]) <= 1e-4 and _rel(t["grad_norm"], j["grad_norm"]) <= 1e-4
    assert max(_rel(t["loss"], j["loss"]) for j, t in metrics) <= 1e-3
    _close_tree(t_params, j_params, rtol=1e-4, atol=2 * j["lr"])


@pytest.mark.parametrize("extra,tol", [({"microbatches": 2}, 1e-3),
                                       ({"microbatches": 4}, 1e-3),
                                       ({"grad_compression": "bf16"}, 2e-2)],
                         ids=["microbatches2", "microbatches4", "bf16_grads"])
def test_train_variants_match_reference(extra, tol):
    metrics, _ = _train_both({**DEFAULTS, **extra}, 5)
    for j, t in metrics:
        assert _rel(t["loss"], j["loss"]) <= tol, metrics
        assert _rel(t["grad_norm"], j["grad_norm"]) <= tol, metrics


def test_microbatches_must_divide_the_batch():
    _, tcfg = _cfgs()
    state = loop.init_state(Model(tcfg), torch.Generator().manual_seed(0), device="cpu")
    step = loop.make_train_step(Model(tcfg), TrainConfig(microbatches=3))
    with pytest.raises(AssertionError, match="microbatches"):
        step(state, _batch(tcfg, b=4))


def test_train_step_updates_the_state_in_place():
    _, tcfg = _cfgs()
    state = loop.init_state(Model(tcfg), torch.Generator().manual_seed(0), device="cpu")
    before = {path: t.clone() for path, t in L.flatten_specs(state.params)}
    new, metrics = loop.make_train_step(Model(tcfg), TrainConfig(warmup_steps=1))(
        state, _batch(tcfg))
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in metrics.values())
    assert int(new.step) == 1 and new.step.dtype == torch.int32
    assert new.params is state.params and new.opt.m is state.opt.m
    changed = [not torch.equal(t, before[path]) for path, t in L.flatten_specs(new.params)]
    assert all(changed)
    assert not any(t.requires_grad for _, t in L.flatten_specs(new.params))


def _jax_jit_vs_eager(tcfg_kw: dict, steps: int):
    """The reference against itself: jitted against op by op (jax.disable_jit),
    the spread that rounding alone gives the curve."""
    jcfg, _ = _cfgs()
    fn = jax_loop.make_train_step(JaxModel(jcfg), JaxTrainConfig(**tcfg_kw))
    jitted = jax.jit(fn)
    a = b = _jax_init()
    data = SyntheticTokens(jcfg.vocab_size, B, S, seed=0)
    out = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in data.batch_at(i).items()}
        a, ma = jitted(a, batch)
        with jax.disable_jit():
            b, mb = fn(b, batch)
        out.append(({k: float(v) for k, v in ma.items()}, {k: float(v) for k, v in mb.items()}))
    return out


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py
    # prints the relative loss and grad-norm gaps of each step (PERF.md)
    for name, kw in (("defaults", DEFAULTS),
                     ("lr 1e-3", dict(total_steps=STEPS, warmup_steps=2, learning_rate=1e-3))):
        runs = [("port vs reference", _train_both(kw, STEPS)[0])]
        if name == "lr 1e-3":
            runs.append(("reference jitted vs op by op", _jax_jit_vs_eager(kw, STEPS)))
        for label, metrics in runs:
            print(f"{name}, {label}: step, loss, |d loss|/loss, grad norm, |d norm|/norm")
            for i, (j, t) in enumerate(metrics):
                print(f"  {i + 1:2d} {j['loss']:.6f} {_rel(t['loss'], j['loss']):.2e} "
                      f"{j['grad_norm']:.4f} {_rel(t['grad_norm'], j['grad_norm']):.2e}")
