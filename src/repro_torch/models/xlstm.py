"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar
memory, strictly recurrent), per arXiv:2405.04517.

Counterpart of ``repro/models/xlstm.py``.  It is plain PyTorch, as the reference is plain
JAX: no kernel of its own.  The mLSTM's parallel form is computed chunkwise:
the O(Q^2) intra-chunk part is dense products, and the (C, n, m) state is
carried across chunks by a loop (the reference's ``lax.scan``).  Exponential
gating is stabilised with the running max ``m`` as in the paper (eq. 15/26).
The sLSTM has recurrent (block-diagonal) weights and runs as a loop over
time, one step at a time in f32.

Each of the two loops is one ``torch.library`` op with a FLOP formula
(``repro_torch::mlstm_chunkwise``, ``repro_torch::slstm_scan``, and their
backward ops), so that a traced step records a loop as one node, as XLA
keeps a scan as one loop; on real tensors each runs the same loop of plain
ops.  Under a mesh each runs per rank on its batch rows and heads.

Cell equations (mLSTM, per head; q,k in R^K, v in R^V):
    logf_t = logsigmoid(f~_t)
    m_t   = max(m_{t-1} + logf_t, i~_t)
    C_t   = e^{logf_t + m_{t-1} - m_t} C_{t-1} + e^{i~_t - m_t} k_t v_t^T
    n_t   = e^{logf_t + m_{t-1} - m_t} n_{t-1} + e^{i~_t - m_t} k_t
    h_t   = (q~_t C_t) / max(|q~_t . n_t|, e^{-m_t}),   q~ = q / sqrt(K)
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import pointwise, shard
from repro_torch.models.ssm import _causal_conv, _conv_window

# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel form
# ---------------------------------------------------------------------------


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    return pointwise(F.logsigmoid, x)


def _denom(den: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Stabilised output denominator ``max(|q~.n|, e^{-m})`` (eq. 17/26).

    ``e^{-m}`` overflows f32 to +inf once ``m < -88.7`` (strongly negative
    gate pre-activations reach it).  The forward value stays clean (num/inf =
    0) but the backward of ``maximum(|den|, inf)`` gives 0 * inf = NaN.  The
    exponent is clamped at 80, still far above any attainable |den|, so the
    selected branch and h are unchanged up to f32 underflow
    (``repro/models/xlstm.py:36-50``; ``tests/models/test_xlstm_regression.py``)."""
    return torch.maximum(den.abs(), torch.exp(torch.clamp(-m, max=80.0)))


def mlstm_chunkwise(
    q: torch.Tensor,       # [B, H, S, K]
    k: torch.Tensor,       # [B, H, S, K]
    v: torch.Tensor,       # [B, H, S, V]
    i_gate: torch.Tensor,  # [B, H, S] pre-activation input gate
    f_gate: torch.Tensor,  # [B, H, S] pre-activation forget gate
    chunk: int,
    state: tuple | None = None,   # (C [B,H,K,V], n [B,H,K], m [B,H])
    return_state: bool = False,
):
    """h [B,H,S,V] in v's dtype (and the final (C, n, m) in f32 if asked).

    The chunk loop is one op, ``torch.ops.repro_torch.mlstm_chunkwise``
    (:func:`_mlstm_chunks` on real tensors), whose gradient is autograd's
    through the same loop, run again in the op's backward: a traced step
    (:mod:`repro_torch.launch.dryrun`) records the loop as one node with the
    FLOPs of its products, where its ops one by one would be hundreds of
    thousands at 32k tokens.  On DTensors it runs per rank on its batch rows
    and heads (:func:`_mlstm_per_shard`)."""
    if sharding.is_dtensor(q):
        return _mlstm_per_shard(q, k, v, i_gate, f_gate, chunk, state, return_state)
    if state is None:
        state = initial_mlstm_state(q.shape[0], q.shape[1], q.shape[3], v.shape[3], q.device)
    h, *final = torch.ops.repro_torch.mlstm_chunkwise(q, k, v, i_gate, f_gate, *state, chunk)
    return (h, tuple(final)) if return_state else h


def initial_mlstm_state(batch: int, heads: int, K: int, V: int, device):
    """The zero state (C, n, m = -inf) in f32."""
    f32 = torch.float32
    return (torch.zeros((batch, heads, K, V), dtype=f32, device=device),
            torch.zeros((batch, heads, K), dtype=f32, device=device),
            torch.full((batch, heads), -torch.inf, dtype=f32, device=device))


def _mlstm_chunks(q, k, v, i_gate, f_gate, chunk: int, state: tuple):
    """The chunkwise-parallel mLSTM of plain tensors: (h, (C, n, m))."""
    Bsz, H, S, K = q.shape
    V = v.shape[-1]
    f32 = torch.float32
    orig_S = S
    if S % chunk:
        pad = chunk - S % chunk
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        # padded steps must not perturb the carried state: i = -1e9 (no
        # input), f~ = +1e9 (forget gate 1.0, i.e. no decay)
        i_gate = F.pad(i_gate, (0, pad), value=-1e9)
        f_gate = F.pad(f_gate, (0, pad), value=1e9)
        S = q.shape[2]
    nc = S // chunk
    scale = 1.0 / math.sqrt(K)

    def chunks(x):
        return x.reshape(x.shape[0], x.shape[1], nc, chunk, *x.shape[3:])

    qc = chunks(q).to(f32) * scale
    kc = chunks(k).to(f32)
    vc = chunks(v).to(f32)
    ic = chunks(i_gate).to(f32)                  # [B,H,nc,Q]
    b = torch.cumsum(_logsigmoid(chunks(f_gate).to(f32)), dim=-1)  # inclusive
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()

    C0, n0, m0 = (s.to(f32) for s in state)

    hs = []
    for c in range(nc):
        qq, kk, vv, ii, bb = (t[:, :, c] for t in (qc, kc, vc, ic, b))
        r = ii - bb                                          # [B,H,Q]
        m_intra = bb + torch.cummax(r, dim=-1).values
        m_inter = m0[..., None] + bb
        m = torch.maximum(m_inter, m_intra)                  # [B,H,Q] stabiliser
        # intra-chunk decay D[t,s] = exp(b_t - b_s + i_s - m_t), s <= t
        expo = bb[..., :, None] - bb[..., None, :] + ii[..., None, :]
        expo = expo.masked_fill(~causal, -torch.inf)
        D = torch.exp(expo - m[..., :, None])
        Smat = torch.einsum("bhtk,bhsk->bhts", qq, kk) * D
        num = torch.einsum("bhts,bhsv->bhtv", Smat, vv)
        den = Smat.sum(dim=-1)                               # q~.n, intra part
        # inter-chunk contribution
        w = torch.exp(m_inter - m)                           # [B,H,Q]
        num = num + w[..., None] * torch.einsum("bhtk,bhkv->bhtv", qq, C0)
        den = den + w * torch.einsum("bhtk,bhk->bht", qq, n0)
        hs.append(num / _denom(den, m)[..., None])
        # chunk-final state
        b_last = bb[..., -1]
        m_new = torch.maximum(m0 + b_last, b_last + r.max(dim=-1).values)  # [B,H]
        g = torch.exp(b_last[..., None] - bb + ii - m_new[..., None])     # [B,H,Q]
        decay = torch.exp(m0 + b_last - m_new)
        C0 = decay[..., None, None] * C0 + torch.einsum("bhs,bhsk,bhsv->bhkv", g, kk, vv)
        n0 = decay[..., None] * n0 + torch.einsum("bhs,bhsk->bhk", g, kk)
        m0 = m_new

    h = torch.stack(hs, dim=2).reshape(Bsz, H, S, V)[:, :, :orig_S].to(v.dtype)
    return h, (C0, n0, m0)


@torch.library.custom_op("repro_torch::mlstm_chunkwise", mutates_args=())
def _mlstm_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
              f_gate: torch.Tensor, C: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
              chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    h, final = _mlstm_chunks(q, k, v, i_gate, f_gate, chunk, (C, n, m))
    return (h, *final)


@_mlstm_op.register_fake
def _(q, k, v, i_gate, f_gate, C, n, m, chunk):
    f32 = torch.float32
    return (torch.empty_like(v), torch.empty(C.shape, dtype=f32, device=C.device),
            torch.empty(n.shape, dtype=f32, device=n.device),
            torch.empty(m.shape, dtype=f32, device=m.device))


@torch.library.custom_op("repro_torch::mlstm_chunkwise_backward", mutates_args=())
def _mlstm_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_gate: torch.Tensor, f_gate: torch.Tensor, C: torch.Tensor,
                       n: torch.Tensor, m: torch.Tensor, chunk: int, dh: torch.Tensor,
                       dC: torch.Tensor, dn: torch.Tensor, dm: torch.Tensor) -> list[torch.Tensor]:
    # torch.func's vjp, since an op's implementation runs below autograd
    def fwd(q, k, v, i_gate, f_gate, C, n, m):
        h, final = _mlstm_chunks(q, k, v, i_gate, f_gate, chunk, (C, n, m))
        return (h, *final)

    _, vjp = torch.func.vjp(fwd, q, k, v, i_gate, f_gate, C, n, m)
    return list(vjp((dh, dC, dn, dm)))


@_mlstm_backward_op.register_fake
def _(q, k, v, i_gate, f_gate, C, n, m, chunk, dh, dC, dn, dm):
    return [torch.empty_like(t) for t in (q, k, v, i_gate, f_gate, C, n, m)]


def _mlstm_setup(ctx, inputs, output):
    ctx.chunk = inputs[8]
    ctx.save_for_backward(*inputs[:8])


def _mlstm_grad(ctx, dh, dC, dn, dm):
    saved = ctx.saved_tensors
    grads = [torch.zeros_like(like) if g is None else g
             for g, like in zip((dh, dC, dn, dm), (saved[2], saved[5], saved[6], saved[7]))]
    return (*torch.ops.repro_torch.mlstm_chunkwise_backward(*saved, ctx.chunk, *grads), None)


torch.library.register_autograd("repro_torch::mlstm_chunkwise", _mlstm_grad,
                                setup_context=_mlstm_setup)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunkwise)
def _mlstm_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    B, H, S, K = q_shape
    V = v_shape[-1]
    chunk = args[-1]
    Q = chunk
    nc = -(-S // chunk)
    # per chunk: q k^T and S v (intra), q C and q n (inter), the C and n updates
    return B * H * nc * (2 * Q * Q * K + 2 * Q * Q * V + 4 * Q * K * V + 4 * Q * K)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunkwise_backward)
def _mlstm_backward_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    # the forward again, and the gradient of each product (two of its size)
    return 3 * _mlstm_flops(q_shape, k_shape, v_shape, *args[:6])


def _mlstm_per_shard(q, k, v, i_gate, f_gate, chunk, state, return_state):
    """:func:`mlstm_chunkwise` on DTensors, per rank on its batch rows and
    heads (every input and output is ``[B, H, ...]``): the cell is
    independent across both.  Left to DTensor, the chunk loop's einsums come
    back in the backward with the chunk's time dim split over "model" (2
    heads on 4 model ranks, replicated there), which the block projection's
    backward cannot view into its product shape; per rank there is no plan
    to make, and each rank's gradients are its own slices."""
    qp = sharding.act_placements(q, "batch", "lstm_heads", "seq", None)
    p = sharding.follow(qp, {0: 0, 1: 1})
    inputs = (q, k, v, i_gate, f_gate) + tuple(state or ())

    def local(q, k, v, i_gate, f_gate, *st):
        out = mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk, st or None, return_state)
        return (out[0], *out[1]) if return_state else out

    n_out = 4 if return_state else 1
    out = sharding.local_map(local, (p,) * n_out if return_state else p,
                             (p,) * len(inputs), q.device_mesh)(*inputs)
    return (out[0], tuple(out[1:])) if return_state else out


def mlstm_step(q, k, v, i_gate, f_gate, state):
    """Single-token decode step.  q,k [B,H,K]; v [B,H,V]; gates [B,H]."""
    C0, n0, m0 = state
    f32 = torch.float32
    qf = q.to(f32) / math.sqrt(q.shape[-1])
    logf = _logsigmoid(f_gate.to(f32))
    i32 = i_gate.to(f32)
    m = torch.maximum(m0 + logf, i32)
    fw = torch.exp(logf + m0 - m)
    iw = torch.exp(i32 - m)
    C1 = fw[..., None, None] * C0 + iw[..., None, None] * torch.einsum(
        "bhk,bhv->bhkv", k.to(f32), v.to(f32))
    n1 = fw[..., None] * n0 + iw[..., None] * k.to(f32)
    num = torch.einsum("bhk,bhkv->bhv", qf, C1)
    den = torch.einsum("bhk,bhk->bh", qf, n1)
    h = num / _denom(den, m)[..., None]
    return h.to(v.dtype), (C1, n1, m)


def mlstm_reference(q, k, v, i_gate, f_gate):
    """Sequential oracle (tests): the step-by-step recurrence."""
    Bsz, H, S, K = q.shape
    state = initial_mlstm_state(Bsz, H, K, v.shape[-1], q.device)
    hs = []
    for t in range(S):
        h, state = mlstm_step(q[:, :, t], k[:, :, t], v[:, :, t], i_gate[:, :, t],
                              f_gate[:, :, t], state)
        hs.append(h)
    return torch.stack(hs, dim=2), state


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig):
    x = cfg.xlstm
    d_inner = int(x.proj_factor * cfg.d_model)
    n_heads = cfg.n_heads  # 4 for xlstm-1.3b
    head_v = d_inner // n_heads
    head_qk = max(int(head_v * x.qk_factor), 4)
    return d_inner, n_heads, head_qk, head_v


def init_mlstm_block(cfg: ModelConfig):
    x = cfg.xlstm
    d = cfg.d_model
    d_inner, H, Kd, Vd = mlstm_dims(cfg)
    # q/k/v are block-diagonal per head (the paper's BlockLinear): d_inner^2 / H
    # weights instead of d_inner^2, which keeps xlstm-1.3b at 1.3 B
    return {
        "norm": L.init_norm(d, cfg.norm_type),
        "up": {"w": ParamSpec((d, 2 * d_inner), ("embed", "lstm_inner"))},
        "conv_w": ParamSpec((x.conv_width, d_inner), ("conv", "lstm_inner")),
        "conv_b": ParamSpec((d_inner,), ("lstm_inner",), init="zeros"),
        "wq": ParamSpec((H, Vd, Kd), ("lstm_heads", None, None)),
        "wk": ParamSpec((H, Vd, Kd), ("lstm_heads", None, None)),
        "wv": ParamSpec((H, Vd, Vd), ("lstm_heads", None, None)),
        "w_if": {"w": ParamSpec((d_inner, 2 * H), ("lstm_inner", None)),
                 "b": ParamSpec((2 * H,), (None,), init="zeros")},
        "head_norm": ParamSpec((d_inner,), ("lstm_inner",), init="ones"),
        "skip": ParamSpec((d_inner,), ("lstm_inner",), init="ones"),
        "down": {"w": ParamSpec((d_inner, d), ("lstm_inner", "embed"))},
    }


def _conv_silu(x, w, b, cache=None):
    """Causal depthwise conv + silu; with ``cache`` (decode, S = 1) the rolling
    window [B, W-1, C].  Returns (out, new window or None)."""
    if cache is None:
        return F.silu(_causal_conv(x, w, b)), None
    window = torch.cat([cache, x], dim=1)
    out = torch.einsum("bwc,wc->bc", window, w) + b
    return F.silu(out)[:, None, :], window[:, 1:]


def apply_mlstm_block(params, cfg: ModelConfig, x: torch.Tensor, cache=None,
                      return_cache: bool = False):
    """x [B,S,D].  cache (decode): {"conv": [B,W-1,Di], "C", "n", "m"};
    ``return_cache`` (prefill) builds that cache from the parallel pass.
    Returns (x + block(x), new cache or None); the cache is a new dict."""
    d_inner, H, Kd, Vd = mlstm_dims(cfg)
    y = L.apply_norm(params["norm"], x, cfg.norm_type, cfg.norm_eps)
    # the product sharded along its columns, then gathered for the split:
    # DTensor would otherwise gather the weight and run it whole (as F5 found
    # for Mamba2's in-projection)
    u, z = torch.chunk(sharding.unshard_dims(L.apply_dense(params["up"], y), -1), 2, dim=-1)
    c, new_conv = _conv_silu(u, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype),
                             cache["conv"] if cache is not None else None)
    B, S = x.shape[0], x.shape[1]

    def block_proj(t, w):
        # block-diagonal per-head projection: [B,S,H,Vd] x [H,Vd,out]
        return torch.einsum("bshv,hvo->bhso", attn._split_heads(t, H, Vd), w.to(t.dtype))

    q = block_proj(c, params["wq"])
    k = block_proj(c, params["wk"])
    v = block_proj(u, params["wv"])
    q = shard(q, "batch", "lstm_heads", "seq", None)
    k = shard(k, "batch", "lstm_heads", "seq", None)
    v = shard(v, "batch", "lstm_heads", "seq", None)
    gates = L.apply_dense(params["w_if"], c)  # [B,S,2H]
    i_gate = gates[..., :H].transpose(1, 2)
    f_gate = gates[..., H:].transpose(1, 2)

    new_cache = None
    if cache is None:
        if return_cache:
            h, (C1, n1, m1) = mlstm_chunkwise(q, k, v, i_gate, f_gate,
                                              chunk=cfg.xlstm.chunk_size, return_state=True)
            new_cache = {"conv": _conv_window(u, cfg.xlstm.conv_width),
                         "C": C1, "n": n1, "m": m1}
        else:
            h = mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=cfg.xlstm.chunk_size)
    else:
        h, (C1, n1, m1) = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], i_gate[:, :, 0],
                                     f_gate[:, :, 0], (cache["C"], cache["n"], cache["m"]))
        h = h[:, :, None, :]
        new_cache = {"conv": new_conv, "C": C1, "n": n1, "m": m1}

    # per-head norm in f32, then the learnable skip from the conv path
    h32 = h.transpose(1, 2).float().reshape(B, S, H, Vd)
    var = torch.mean(torch.square(h32), dim=-1, keepdim=True)
    h = attn._merge_heads(h32 * torch.rsqrt(var + cfg.norm_eps))
    h = h.to(x.dtype) * params["head_norm"].to(x.dtype)
    h = h + params["skip"].to(x.dtype) * c
    out = L.apply_dense(params["down"], h * F.silu(z))
    return x + out, new_cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype, device):
    """One mLSTM layer's zeroed decode cache: conv window in ``dtype``, f32
    C, n and m = -inf."""
    d_inner, H, Kd, Vd = mlstm_dims(cfg)
    C, n, m = initial_mlstm_state(batch, H, Kd, Vd, device)
    return {
        "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, d_inner), dtype=dtype,
                            device=device),
        "C": C, "n": n, "m": m,
    }


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

GATES = ("z", "i", "f", "o")


def mlstm_cache_axes():
    return {
        "conv": ("batch", None, "lstm_inner"),
        "C": ("batch", "lstm_heads", None, None),
        "n": ("batch", "lstm_heads", None),
        "m": ("batch", "lstm_heads"),
    }


def slstm_dims(cfg: ModelConfig):
    H = cfg.n_heads
    return H, cfg.d_model // H


def init_slstm_block(cfg: ModelConfig):
    d = cfg.d_model
    H, dh = slstm_dims(cfg)
    d_ff = int(4 * d / 3)
    gates = {}
    for g in GATES:
        gates[f"w_{g}"] = ParamSpec((d, d), ("embed", "lstm_inner"))
        gates[f"r_{g}"] = ParamSpec((H, dh, dh), ("lstm_heads", None, None), scale=1.0)
        gates[f"b_{g}"] = ParamSpec((d,), ("lstm_inner",), init="zeros")
    return {
        "norm": L.init_norm(d, cfg.norm_type),
        **gates,
        "head_norm": ParamSpec((d,), ("lstm_inner",), init="ones"),
        "ffn_norm": L.init_norm(d, cfg.norm_type),
        "ffn": L.init_mlp(d, d_ff, "swiglu"),
    }


def _slstm_steps(wx, R, state):
    """The sLSTM recurrence over time, one step at a time in f32 (the
    reference's ``lax.scan``).  wx: the four gates' input projections
    (z, i, f, o) [B,S,H,dh] f32; R: their recurrent weights [H,dh,dh] f32;
    state: (h, c, n, m) [B,H,dh] f32.  Returns the states after every step,
    (h, c, n, m) each stacked [B,S,H,dh]."""
    h, c, n, m = state
    one = torch.ones((), dtype=h.dtype, device=h.device)
    hs, cs, ns, ms = [], [], [], []
    for t in range(wx[0].shape[1]):
        pz, pi, pf, po = (w[:, t] + torch.einsum("bhd,hde->bhe", h, r) for w, r in zip(wx, R))
        logf = F.logsigmoid(pf)
        m_new = torch.maximum(logf + m, pi)
        iw = torch.exp(pi - m_new)
        fw = torch.exp(logf + m - m_new)
        c = fw * c + iw * torch.tanh(pz)
        n = fw * n + iw
        # maximum, not clamp: at a tie (n is exactly 1 at the first step) both
        # split the gradient in half, as jnp.maximum does
        h = torch.sigmoid(po) * c / torch.maximum(n, one)
        m = m_new
        for out, v in zip((hs, cs, ns, ms), (h, c, n, m)):
            out.append(v)
    return tuple(torch.stack(v, dim=1) for v in (hs, cs, ns, ms))


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan_op(wz: torch.Tensor, wi: torch.Tensor, wf: torch.Tensor, wo: torch.Tensor,
                   rz: torch.Tensor, ri: torch.Tensor, rf: torch.Tensor, ro: torch.Tensor,
                   h: torch.Tensor, c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _slstm_steps((wz, wi, wf, wo), (rz, ri, rf, ro), (h, c, n, m))


@_slstm_scan_op.register_fake
def _(wz, wi, wf, wo, rz, ri, rf, ro, h, c, n, m):
    return tuple(torch.empty_like(wz) for _ in range(4))


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=())
def _slstm_scan_backward_op(wz: torch.Tensor, wi: torch.Tensor, wf: torch.Tensor,
                            wo: torch.Tensor, rz: torch.Tensor, ri: torch.Tensor,
                            rf: torch.Tensor, ro: torch.Tensor, h: torch.Tensor,
                            c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                            dhs: torch.Tensor, dcs: torch.Tensor, dns: torch.Tensor,
                            dms: torch.Tensor) -> list[torch.Tensor]:
    # torch.func's vjp of the same loop, as for the mLSTM
    def fwd(*a):
        return _slstm_steps(a[:4], a[4:8], a[8:])

    _, vjp = torch.func.vjp(fwd, wz, wi, wf, wo, rz, ri, rf, ro, h, c, n, m)
    return list(vjp((dhs, dcs, dns, dms)))


@_slstm_scan_backward_op.register_fake
def _(wz, wi, wf, wo, rz, ri, rf, ro, h, c, n, m, dhs, dcs, dns, dms):
    return [torch.empty_like(t) for t in (wz, wi, wf, wo, rz, ri, rf, ro, h, c, n, m)]


def _slstm_scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _slstm_scan_grad(ctx, dhs, dcs, dns, dms):
    saved = ctx.saved_tensors
    grads = [torch.zeros_like(saved[0]) if g is None else g for g in (dhs, dcs, dns, dms)]
    return tuple(torch.ops.repro_torch.slstm_scan_backward(*saved, *grads))


torch.library.register_autograd("repro_torch::slstm_scan", _slstm_scan_grad,
                                setup_context=_slstm_scan_setup)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_scan_flops(wz_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, H, dh = wz_shape
    return 4 * 2 * B * S * H * dh * dh            # the recurrent products


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _slstm_scan_backward_flops(wz_shape, *args, out_shape=None, **kwargs) -> int:
    # the forward again, and the gradient of each product (two of its size)
    return 3 * _slstm_scan_flops(wz_shape)


def slstm_scan(wx, R, state):
    """:func:`_slstm_steps` as one op (``torch.ops.repro_torch.slstm_scan``),
    with torch.func's vjp of the same loop as its gradient: a traced step
    (:mod:`repro_torch.launch.dryrun`) records the whole loop as one node
    with the FLOPs of its products, where the steps one by one would be
    thousands of nodes a layer.  On DTensors it runs per rank on its batch
    rows and heads: the recurrence is independent across both, and each
    rank's gradient of the recurrent weights is a partial sum over the ranks
    that split the batch."""
    if sharding.is_dtensor(wx[0]):
        xp = sharding.act_placements(wx[0], "batch", "seq", "lstm_heads", None)
        wp = sharding.follow(xp, {0: 0, 2: 2})
        rp = sharding.follow(xp, {2: 0})
        sp = sharding.follow(xp, {0: 0, 2: 1})
        r_grad = sharding.grad_placements(xp, {2: 0}, {0})
        # a zero state made on the fly is the same on every rank
        state = tuple(sharding.replicated(t, wx[0].device_mesh) for t in state)
        return sharding.local_map(
            lambda *a: slstm_scan(a[:4], a[4:8], a[8:]), (wp,) * 4,
            (wp,) * 4 + (rp,) * 4 + (sp,) * 4, wx[0].device_mesh,
            in_grad_placements=(None,) * 4 + (r_grad,) * 4 + (None,) * 4)(*wx, *R, *state)
    return torch.ops.repro_torch.slstm_scan(*wx, *R, *state)


def slstm_cell(params, cfg: ModelConfig, x: torch.Tensor, state: tuple):
    """The sLSTM over time in f32 (:func:`slstm_scan`).  x [B,S,D]; state
    (h, c, n, m) each [B,H,dh] f32.  Returns (h [B,S,D] in x's dtype, final
    state)."""
    H, dh = slstm_dims(cfg)
    f32 = torch.float32
    wx = tuple(attn._split_heads(L.apply_dense({"w": params[f"w_{g}"], "b": params[f"b_{g}"]},
                                               x), H, dh).to(f32) for g in GATES)
    R = tuple(params[f"r_{g}"].to(f32) for g in GATES)
    stacks = slstm_scan(wx, R, tuple(s.to(f32) for s in state))
    final = tuple(st[:, -1] for st in stacks)
    return attn._merge_heads(stacks[0]).to(x.dtype), final


def init_slstm_state(cfg: ModelConfig, batch: int, device):
    H, dh = slstm_dims(cfg)
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return (z, z, z, torch.full((batch, H, dh), -torch.inf, dtype=torch.float32,
                                device=device))


def slstm_state_axes():
    a = ("batch", "lstm_heads", None)
    return (a, a, a, a)


def apply_slstm_block(params, cfg: ModelConfig, x: torch.Tensor, cache=None,
                      return_cache: bool = False):
    """cache (decode): {"state": (h, c, n, m)}.  Returns (x, new cache or None)."""
    y = L.apply_norm(params["norm"], x, cfg.norm_type, cfg.norm_eps)
    state = cache["state"] if cache is not None else init_slstm_state(cfg, x.shape[0], x.device)
    h, final = slstm_cell(params, cfg, y, state)
    # the residual's partial sum reduced first: the add would otherwise turn
    # the scaled h, sharded along "lstm_inner", into a partial sum, which
    # some DTensor versions cannot (torch 2.11, xlstm-1.3b long_500k)
    x = sharding.reduce_partial(x) + h * params["head_norm"].to(x.dtype)
    # the FFN's input in its rules' placement: DTensor carries the sum above
    # in with the sequence split over "model" (a reduce-scatter of the
    # residual's partial sum), and the products' gradient, computed on the
    # flattened rows, cannot be unflattened where the batch does not divide
    y = shard(L.apply_norm(params["ffn_norm"], x, cfg.norm_type, cfg.norm_eps),
              "batch", "seq", "embed")
    x = x + L.apply_mlp(params["ffn"], y, "swiglu")
    return x, ({"state": final} if (cache is not None or return_cache) else None)
