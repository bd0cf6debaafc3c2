"""Training's causal self-attention on the ``xla`` route: the kernels' plain
versions (``ref.causal_attention_fwd_ref`` / ``_bwd_ref``) and
``ops.causal_attention`` on the CPU against ``jax.vjp`` of the reference's
``repro.models.attention.attend_xla`` and against autograd through the
port's, the dispatch in ``attention.attend`` and ``attention.apply_mla``
(fake CUDA tensors stand in for the card's), and ``ops.causal_attention``
under remat.  Each at one width for q, k and v and at latent attention's
(q.k 192, v 128: ``DV`` below).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.models import attention as jax_attn  # noqa: E402
from repro_torch import configs, tracing  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.testing import redraw_params_  # noqa: E402

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _qkv(B, S, H, K, D, dtype=torch.float32, seed=0, device="cpu", DV=None):
    """q, k [.., D] and v, dout [.., DV] (DV = D unless given)."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(B, S, n, d, generator=gen).to(dtype).to(device)
                   for n, d in ((H, D), (K, D), (K, DV or D), (H, DV or D)))
    return q, k, v, do


def _autograd(q, k, v, do):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = attn.attend_xla(q, k, v, causal=True)
    return (out, *torch.autograd.grad(out, (q, k, v), do))


# (dtype, tolerance, S, H, K, D, DV): one width, then latent attention's
TRAIN_CASES = [
    (torch.float32, F32, S, H, K, D, D)
    for H, K in ((4, 2), (4, 4)) for D in (64, 128) for S in (64, 100)
] + [(torch.bfloat16, BF16, 100, 4, 2, 128, 128)] + [
    (torch.float32, F32, S, H, K, 192, 128) for H, K in ((4, 2), (4, 4)) for S in (64, 100)
] + [(torch.bfloat16, BF16, 100, 4, 4, 192, 128)]


@pytest.mark.parametrize("dtype,tol,S,H,K,D,DV", TRAIN_CASES)
def test_plain_versions_match_autograd_through_attend_xla(dtype, tol, S, H, K, D, DV):
    """The plain forward is attend_xla's arithmetic and its log-sum-exp is the
    rows' of the scaled, masked scores; the closed-form backward from it
    gives autograd's dq, dk and dv (GQA's group summed into dk and dv)."""
    q, k, v, do = _qkv(2, S, H, K, D, dtype, DV=DV)
    want_out, *want = _autograd(q, k, v, do)
    out, lse = ref.causal_attention_fwd_ref(q, k, v)
    assert out.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (2, H, S)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    grads = ref.causal_attention_bwd_ref(do, q, k, v, out, lse)
    for name, got, exp in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dtype and got.shape == exp.shape
        torch.testing.assert_close(got.float(), exp.float(), **tol,
                                   msg=lambda m, n=name: f"{n}: {m}")


def _jax(t):
    """A CPU tensor as a JAX array of the same dtype and values."""
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _reference_vjp(q, k, v, do):
    """The reference's output and (dq, dk, dv): jax.vjp of its attend_xla.
    The reference takes one width for q, k and v, so a narrower v enters
    with zero columns up to q's width and the output leaves without them:
    the same function of (q, k, v), whose v gradient is the padded one's
    first DV columns."""
    D, DV = q.shape[-1], v.shape[-1]

    def fn(q, k, v):
        v_wide = jnp.pad(v, [(0, 0)] * 3 + [(0, D - DV)])
        return jax_attn.attend_xla(q, k, v_wide, causal=True)[..., :DV]

    out, vjp = jax.vjp(fn, _jax(q), _jax(k), _jax(v))
    return (out, *vjp(_jax(do)))


def _close_to_jax(got, want, tol, name):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol,
                               err_msg=name)


@pytest.mark.parametrize("dtype,tol,S,H,K,D,DV", TRAIN_CASES)
def test_plain_versions_and_the_function_match_the_reference_vjp(dtype, tol, S, H, K, D, DV):
    """The plain forward and the closed-form backward, and the Function
    through autograd on the CPU, give the reference's attend_xla output and
    its gradient under jax.vjp on the same q, k, v and dout."""
    q, k, v, do = _qkv(2, S, H, K, D, dtype, seed=4, DV=DV)
    want_out, *want = _reference_vjp(q, k, v, do)
    out, lse = ref.causal_attention_fwd_ref(q, k, v)
    _close_to_jax(out, want_out, tol, "out")
    grads = ref.causal_attention_bwd_ref(do, q, k, v, out, lse)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fn_out = ops.causal_attention(*leaves)
    fn_grads = torch.autograd.grad(fn_out, leaves, do)
    _close_to_jax(fn_out.detach(), want_out, tol, "Function out")
    for name, got, fn_got, exp in zip(("dq", "dk", "dv"), grads, fn_grads, want):
        assert got.dtype == dtype and tuple(got.shape) == exp.shape
        _close_to_jax(got, exp, tol, name)
        _close_to_jax(fn_got, exp, tol, f"Function {name}")


def test_causal_attention_is_the_plain_pair_on_the_cpu():
    """On CPU tensors the Function's forward and backward are the plain
    versions, bit for bit."""
    q, k, v, do = _qkv(2, 100, 4, 2, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.causal_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    want_out, lse = ref.causal_attention_fwd_ref(q, k, v)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for got, exp in zip(grads, ref.causal_attention_bwd_ref(do, q, k, v, want_out, lse)):
        torch.testing.assert_close(got, exp, rtol=0, atol=0)


@pytest.mark.parametrize("D,DV", [(64, 64), (192, 128)])
def test_causal_attention_under_checkpoint_gives_the_same_gradients(monkeypatch, D, DV):
    """Under remat's non-reentrant checkpoint the forward runs again before
    the backward, and the gradients are those without it."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.causal_attention_fwd_ref, ref.causal_attention_bwd_ref

    def counted(name, fn):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call

    monkeypatch.setattr(ref, "causal_attention_fwd_ref", counted("fwd", fwd))
    monkeypatch.setattr(ref, "causal_attention_bwd_ref", counted("bwd", bwd))
    q, k, v, do = _qkv(2, 64, 4, 2, D, DV=DV)
    x = torch.randn(2, 64, 4, D, generator=torch.Generator().manual_seed(3))

    def block(q, k, v):
        return torch.tanh(ops.causal_attention(q * x, k, v))

    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(block(*leaves), leaves, do)
    assert calls == {"fwd": 1, "bwd": 1}
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(checkpoint(block, *leaves, use_reentrant=False), leaves, do)
    assert calls == {"fwd": 3, "bwd": 2}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("D,DV", [(64, 64), (192, 128)])
def test_flop_formulas_count_the_causal_products(D, DV):
    """FlopCounterMode counts the forward's two products (S over D, PV over
    DV) and the backward's five (S, dQ and dK over D; dP and dV over DV)
    over the causal pairs: 4 D and 10 D a pair and head at DV = D."""
    B, S, H, K = 2, 100, 4, 2
    q, k, v, do = _qkv(B, S, H, K, D, DV=DV)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    pairs = S * (S + 1) // 2
    with FlopCounterMode(display=False) as fwd:
        out = ops.causal_attention(*leaves)
    assert fwd.get_total_flops() == 2 * (D + DV) * B * H * pairs
    with FlopCounterMode(display=False) as bwd:
        out.backward(do)
    assert bwd.get_total_flops() == 2 * (3 * D + 2 * DV) * B * H * pairs


@pytest.mark.parametrize("D,DV", [(64, 64), (192, 128)])
def test_spans_count_the_pairs_of_each_launch(D, DV):
    """With tracing on, each forward of the Function (again in remat's
    recompute) is an ``attention.causal_fwd`` span and its backward an
    ``attention.causal_bwd`` span, each counting the unmasked pairs of every
    head times the q.k width (``qk_pairs``) and times v's (``v_pairs``); with
    tracing off nothing is recorded."""
    B, S, H, K = 2, 100, 4, 2
    q, k, v, do = _qkv(B, S, H, K, D, DV=DV)
    pairs = B * H * S * (S + 1) // 2

    def step():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = checkpoint(ops.causal_attention, *leaves, use_reentrant=False)
        torch.autograd.grad(out, leaves, do)

    tracing.drain()
    step()
    assert tracing.drain() == []
    tracing.enable()
    try:
        step()
    finally:
        tracing.disable()
    spans = tracing.drain()
    names = sorted(s["name"] for s in spans)
    assert names == ["attention.causal_bwd"] + 2 * ["attention.causal_fwd"]
    for s in spans:
        assert s["attrs"] == {"qk_pairs": pairs * D, "v_pairs": pairs * DV}


# --- dispatch -------------------------------------------------------------------------

_CFG = configs.get("internlm2-1.8b", smoke=True)


def _routes(q, k, v, **kw):
    """(training kernels' calls, attend_xla calls) that one attend() call
    made, counted at the two functions it dispatches to."""
    calls = {"fused": 0, "plain": 0}
    fused, plain = ops.causal_attention, attn.attend_xla

    def count(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    with pytest.MonkeyPatch.context() as m:
        m.setattr(ops, "causal_attention", count("fused", fused))
        m.setattr(attn, "attend_xla", count("plain", plain))
        attn.attend(_CFG, q, k, v, **kw)
    return calls["fused"], calls["plain"]


def _fake_cuda(B, S, H, K, D, dtype=torch.bfloat16, T=None, DV=None, device="cuda"):
    T = S if T is None else T
    return (torch.empty(B, S, H, D, dtype=dtype, device=device),
            torch.empty(B, T, K, D, dtype=dtype, device=device),
            torch.empty(B, T, K, DV or D, dtype=dtype, device=device))


# what causal_attention_takes is given beside fake bf16 CUDA self-attention
# (B 2, S 64, H 4, K 2), and whether it takes it
TAKES = {
    "dims_64_64": (dict(D=64), True),
    "dims_128_128": (dict(D=128), True),
    "dims_192_128": (dict(D=192, DV=128), True),
    "float32": (dict(D=128, dtype=torch.float32), False),
    "cpu": (dict(D=128, device="cpu"), False),
    "dtensor": (dict(D=128, dtensor=True), False),
    "cross_length": (dict(D=128, T=96), False),
    "dims_192_192": (dict(D=192, DV=192), False),
    "dims_96_128": (dict(D=96, DV=128), False),
}


@pytest.mark.parametrize("case", list(TAKES))
def test_causal_attention_takes_what_the_kernels_take(case):
    """``ops.causal_attention_takes``: plain (not DTensor) bf16 CUDA tensors,
    S = T, (q.k, v) head dims in ``ops.CAUSAL_HEAD_DIMS``.  The DTensor is
    one of CUDA tensors on a one-rank CUDA mesh, so that only its being a
    DTensor is refused."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import dryrun

    shape, takes = TAKES[case]
    shape = dict(shape)
    dtensor = shape.pop("dtensor", False)
    with dryrun.fake_world(1) if dtensor else contextlib.nullcontext(), FakeTensorMode():
        qkv = _fake_cuda(2, 64, 4, 2, **shape)
        if dtensor:
            mesh = DeviceMesh("cuda", [0], _init_backend=False)
            qkv = [DTensor.from_local(t, mesh, (Replicate(),), run_check=False) for t in qkv]
            assert all(t.device.type == "cuda" for t in qkv)
        assert ops.causal_attention_takes(*qkv) == takes


def test_positions_other_than_one_shared_1d_tensor_keep_attend_xla():
    """Queries and keys with position tensors of their own, or 2-D ones,
    keep attend_xla: the kernels take one arange(S) for both."""
    with FakeTensorMode(), pytest.MonkeyPatch.context() as m:
        m.setattr(attn, "attend_xla", lambda q, k, v, **kw: torch.empty_like(q))
        qkv = _fake_cuda(2, 64, 4, 2, 128)
        pos = torch.arange(64, device="cuda")
        assert _routes(*qkv, causal=True, q_positions=pos, kv_positions=pos) == (1, 0)
        assert _routes(*qkv, causal=True, q_positions=pos, kv_positions=pos.clone()) == (0, 1)
        pos2 = pos.expand(2, 64)
        assert _routes(*qkv, causal=True, q_positions=pos2, kv_positions=pos2) == (0, 1)


def test_causal_self_attention_of_cuda_bf16_takes_the_kernels():
    """Causal self-attention of plain bf16 CUDA tensors (a window at least S
    wide is no window) goes through the training kernels' ops (their fake
    implementations here: no autograd, whose engine would need a card)."""
    with FakeTensorMode():
        for D, DV in ops.CAUSAL_HEAD_DIMS:
            assert _routes(*_fake_cuda(2, 64, 4, 2, D, DV=DV), causal=True) == (1, 0)
        assert _routes(*_fake_cuda(2, 64, 4, 2, 128), causal=True, window=64) == (1, 0)
        out = attn.attend(_CFG, *_fake_cuda(2, 64, 4, 2, 128), causal=True)
        assert out.shape == (2, 64, 4, 128) and out.dtype == torch.bfloat16


BYPASSES = {
    "kv_valid": dict(kv_valid=True),
    "noncausal": dict(causal=False),
    "softcap": dict(logit_softcap=30.0),
    "narrow_window": dict(window=16),
    "cross_length": dict(T=96),
    "float32": dict(dtype=torch.float32),
    "head_dim_96": dict(D=96),
    "head_dims_192_192": dict(D=192, DV=192),
    "head_dims_96_128": dict(D=96, DV=128),
}


@pytest.mark.parametrize("case", sorted(BYPASSES) + ["cpu"])
def test_bypasses_keep_attend_xla(case, monkeypatch):
    """Each input the kernels do not take keeps attend_xla: on fake CUDA
    tensors that meet every other condition the plain route is counted (its
    attend_xla stubbed: a constant on a CUDA device cannot be made here), and
    on CPU tensors attend() computes attend_xla's output bit for bit."""
    kw = dict(BYPASSES.get(case, {}))
    shape = dict(B=2, S=64, H=4, K=2, D=kw.pop("D", 128), T=kw.pop("T", None),
                 DV=kw.pop("DV", None))
    dtype = kw.pop("dtype", torch.bfloat16)
    kw = {"causal": True, **kw}

    def valid(q, k):
        return torch.ones(q.shape[0], k.shape[1], dtype=torch.bool, device=q.device)

    if case != "cpu":
        with FakeTensorMode(), monkeypatch.context() as m:
            m.setattr(attn, "attend_xla", lambda q, k, v, **kw: torch.empty_like(q))
            q, k, v = _fake_cuda(**shape, dtype=dtype)
            if kw.get("kv_valid") is True:
                kw["kv_valid"] = valid(q, k)
            assert _routes(q, k, v, **kw) == (0, 1)
    q, k, v, _ = _qkv(shape["B"], shape["S"], shape["H"], shape["K"], shape["D"],
                      torch.bfloat16 if case == "cpu" else dtype, DV=shape["DV"])
    if shape["T"] is not None:
        k, v = (torch.cat([t, t[:, :shape["T"] - shape["S"]]], dim=1) for t in (k, v))
    if kw.get("kv_valid") is not None:
        kw["kv_valid"] = valid(q, k)
    assert _routes(q, k, v, **kw) == (0, 1)
    torch.testing.assert_close(attn.attend(_CFG, q, k, v, **kw), attn.attend_xla(q, k, v, **kw),
                               rtol=0, atol=0)


# moonlight's block at SMOKE width, its latent attention at the published
# head widths (q.k 128 + 64, v 128), which the kernels take
_MLA_CFG = configs.get("moonlight-16b-a3b", smoke=True).replace(
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)


@pytest.mark.parametrize("device,want", [("cuda", (1, 0)), ("cpu", (0, 1))])
def test_latent_attention_of_cuda_bf16_takes_the_kernels_once(device, want, monkeypatch):
    """``apply_mla`` at q.k 192 and v 128 goes through ``attend`` once over
    the whole batch of 3 rows: on bf16 CUDA tensors (fake ones) to the
    training kernels' op, on CPU tensors, which the kernels do not take, to
    one attend_xla call."""
    from torch.utils._pytree import tree_map

    from repro_torch.models.transformer import layer_params

    cfg = _MLA_CFG
    p = layer_params(Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")["blocks"],
                     0)["attn"]
    B, S = 3, 64
    calls = {"attend": 0, "fused": 0, "plain": 0}
    plain, attend = attn.attend_xla, attn.attend

    def count_fused(q, k, v):  # the op's output; autograd on fake tensors would need a card
        calls["fused"] += 1
        return q.new_empty(q.shape[:-1] + (v.shape[-1],))

    def count(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(ops, "causal_attention", count_fused)
    monkeypatch.setattr(attn, "attend_xla", count("plain", plain))
    monkeypatch.setattr(attn, "attend", count("attend", attend))
    # RoPE makes a constant on the device, which a fake CUDA tensor cannot be
    # made from here; the route does not depend on it
    monkeypatch.setattr(L, "apply_rope", lambda x, positions, theta: x)
    with FakeTensorMode() if device == "cuda" else contextlib.nullcontext():
        pc = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), p)
        x = torch.zeros(B, S, cfg.d_model, dtype=torch.bfloat16, device=device)
        out = attn.apply_mla(pc, cfg, x, torch.arange(S, device=device))
    assert (calls["fused"], calls["plain"]) == want
    assert calls["attend"] == 1
    assert out.shape == (B, S, cfg.d_model) and out.dtype == torch.bfloat16


SITES = ("apply_attention", "flash_prefill", "apply_mla")


@pytest.mark.parametrize("site", SITES)
def test_each_self_attention_site_goes_through_attend_once(site, monkeypatch):
    """Each self-attention site runs one ``attend`` call a layer, and on the
    CPU that call returns, bit for bit, what the site's own call returned
    before it went through ``attend``: attend_xla over the whole batch
    (``apply_attention`` without a cache, ``apply_mla``), or the flash entry
    point over the fresh K/V (a prefill into an empty cache under flash:
    causal, the layer's window and softcap, no cache mask)."""
    from repro_torch.models.transformer import layer_params

    arch = "moonlight-16b-a3b" if site == "apply_mla" else "internlm2-1.8b"
    cfg = configs.get(arch, smoke=True).replace(
        attention_impl="flash" if site == "flash_prefill" else "xla")
    p = layer_params(Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")["blocks"],
                     0)["attn"]
    B, S = 2, 24
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(S)
    calls = []
    attend = attn.attend

    def spy(cfg, q, k, v, **kw):
        out = attend(cfg, q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    monkeypatch.setattr(attn, "attend", spy)
    with torch.no_grad():
        if site == "apply_mla":
            attn.apply_mla(p, cfg, x, pos, window=cfg.sliding_window)
        elif site == "apply_attention":
            attn.apply_attention(p, cfg, x, pos, window=cfg.sliding_window)
        else:
            cache = layer_params(attn.init_kv_cache(cfg, 1, B, S + 8, torch.float32, "cpu"), 0)
            attn.apply_attention(p, cfg, x, pos, cache=cache, cache_position=0,
                                 window=cfg.sliding_window)
        assert len(calls) == 1
        q, k, v, kw, got = calls[0]
        assert k.shape[1] == S and kw.get("kv_valid") is None and kw["causal"]
        if site == "flash_prefill":
            want = ops.flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                       logit_softcap=cfg.attn_logit_softcap)
        else:
            want = attn.attend_xla(q, k, v, causal=True, q_positions=pos, kv_positions=pos,
                                   window=cfg.sliding_window,
                                   logit_softcap=cfg.attn_logit_softcap)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_latent_attention_under_flash_is_refused(mode, monkeypatch):
    """Under ``attention_impl="flash"`` ``apply_mla`` takes the flash route,
    as every attention does, and is refused there: training for want of a
    backward kernel; evaluation because the flash kernel takes one width up
    to 128 for q, k and v (on the CPU its plain version cannot shape v's
    narrower output either)."""
    from repro_torch.models.transformer import layer_params

    cfg = _MLA_CFG.replace(attention_impl="flash")
    p = layer_params(Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")["blocks"],
                     0)["attn"]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    widths = []
    flash = ops.flash_attention

    def spy(q, k, v, **kw):
        widths.append((q.shape[-1], v.shape[-1]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    if mode == "train":
        x.requires_grad_()
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            attn.apply_mla(p, cfg, x, torch.arange(16))
    else:
        with torch.no_grad(), pytest.raises(RuntimeError):
            attn.apply_mla(p, cfg, x, torch.arange(16))
    assert widths == [(192, 128)]


def test_dtensors_keep_attend_xla():
    """DTensor attention (a model under a mesh) runs attend_xla per shard."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    q, k, v, _ = _qkv(2, 64, 4, 2, 128, torch.bfloat16)
    want = attn.attend_xla(q, k, v, causal=True)
    with dryrun.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        dq, dk, dv = (distribute_tensor(t, mesh, (Replicate(), Replicate())) for t in (q, k, v))
        fused, plain = _routes(dq, dk, dv, causal=True)
        assert fused == 0 and plain >= 1  # attend_xla, then per shard
        out = attn.attend(_CFG, dq, dk, dv, causal=True)
        torch.testing.assert_close(out.full_tensor(), want, rtol=0, atol=0)


def test_flash_attention_still_raises_under_grad():
    q, k, v, _ = _qkv(2, 64, 4, 2, 64)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.flash_attention(q.requires_grad_(), k, v, causal=True)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "moonlight-16b-a3b"])
def test_a_remat_train_step_through_the_kernels_matches_attend_xla(monkeypatch, arch):
    """A SMOKE internlm2 or moonlight gradient under remat "full" with the
    training kernels' route taken on the CPU (their plain versions; moonlight's
    latent attention at q.k 24, v 16) runs their forward twice a layer
    (forward and recompute) and their backward once, and gives the einsum
    route's (attend_xla's) loss and gradients in f32."""
    cfg = configs.get(arch, smoke=True).replace(compute_dtype="float32", remat_policy="full")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    redraw_params_(params, 0)
    t = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    want_loss, want = L.value_and_grad(Model(cfg).loss, params, batch)

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.causal_attention_fwd_ref, ref.causal_attention_bwd_ref

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(ref, "causal_attention_fwd_ref", count_fwd)
    monkeypatch.setattr(ref, "causal_attention_bwd_ref", count_bwd)
    monkeypatch.setattr(attn, "fused_causal", lambda q, k, v, **kw: kw.get("causal", False))
    loss, grads = L.value_and_grad(Model(cfg).loss, params, batch)
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}
    torch.testing.assert_close(loss, want_loss, **F32)
    exp = dict(L.flatten_specs(want))
    for path, g in L.flatten_specs(grads):
        torch.testing.assert_close(g, exp[path], **F32, msg=lambda m, p=path: f"{p}: {m}")
