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
ops.  Under a mesh each runs per rank on its batch rows and heads or, where
the heads do not take the model axis but divide it, on a rank's block of
one head's columns: the mLSTM's value dim (its state kept so sliced in the
decode cache), the sLSTM's head dim (its loop gathering h among the head's
ranks every step).

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
    (:func:`_mlstm_chunks` on real tensors); where a gradient is needed it
    also returns each chunk's residuals, which its backward op
    (:func:`_mlstm_chunks_backward`) reads in place of running the
    forward's products again, as XLA's scan saves them: a traced step
    (:mod:`repro_torch.launch.dryrun`) records the loop as one node with the
    FLOPs of its products, where its ops one by one would be hundreds of
    thousands at 32k tokens.  On DTensors it runs per rank on its batch rows
    and heads (:func:`_mlstm_per_shard`)."""
    if sharding.is_dtensor(q):
        return _mlstm_per_shard(q, k, v, i_gate, f_gate, chunk, state, return_state)
    if state is None:
        state = initial_mlstm_state(q.shape[0], q.shape[1], q.shape[3], v.shape[3], q.device)
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, i_gate, f_gate, *state))
    h, *final = torch.ops.repro_torch.mlstm_chunkwise(q, k, v, i_gate, f_gate, *state, chunk,
                                                      save)[:4]
    return (h, tuple(final)) if return_state else h


def initial_mlstm_state(batch: int, heads: int, K: int, V: int, device):
    """The zero state (C, n, m = -inf) in f32."""
    f32 = torch.float32
    return (torch.zeros((batch, heads, K, V), dtype=f32, device=device),
            torch.zeros((batch, heads, K), dtype=f32, device=device),
            torch.full((batch, heads), -torch.inf, dtype=f32, device=device))


def _chunked(q, k, v, i_gate, f_gate, chunk: int):
    """The loop's inputs in f32, padded to whole chunks and cut into them:
    (qc scaled, kc, vc [B,H,nc,Q,K|V], ic, the forget pre-activations fc, b
    their inclusive cumulative log-sigmoid [B,H,nc,Q])."""
    f32 = torch.float32
    S = q.shape[2]
    if S % chunk:
        pad = chunk - S % chunk
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        # padded steps must not perturb the carried state: i = -1e9 (no
        # input), f~ = +1e9 (forget gate 1.0, i.e. no decay)
        i_gate = F.pad(i_gate, (0, pad), value=-1e9)
        f_gate = F.pad(f_gate, (0, pad), value=1e9)
    nc = q.shape[2] // chunk

    def chunks(x):
        return x.reshape(x.shape[0], x.shape[1], nc, chunk, *x.shape[3:]).to(f32)

    fc = chunks(f_gate)
    return (chunks(q) * (1.0 / math.sqrt(q.shape[-1])), chunks(k), chunks(v), chunks(i_gate),
            fc, torch.cumsum(_logsigmoid(fc), dim=-1))


def _chunk_stabiliser(ii, bb, m0):
    """The stabiliser m [B,H,Q] of one chunk and the terms it is the larger
    of: (r, the cummax of r, m_inter, m_intra, m)."""
    r = ii - bb                                          # [B,H,Q]
    cm = torch.cummax(r, dim=-1)
    m_inter = m0[..., None] + bb
    m_intra = bb + cm.values
    return r, cm, m_inter, m_intra, torch.maximum(m_inter, m_intra)


def _intra_decay(ii, bb, m, causal):
    """D[t,s] = exp(b_t - b_s + i_s - m_t), s <= t, else 0."""
    expo = bb[..., :, None] - bb[..., None, :] + ii[..., None, :]
    expo = expo.masked_fill(~causal, -torch.inf)
    return torch.exp(expo - m[..., :, None])


def _chunk_final(ii, bb, m0, r):
    """What the chunk-final state needs: (r's max with its index, m_new,
    g [B,H,Q], decay [B,H])."""
    b_last = bb[..., -1]
    rmax = r.max(dim=-1)
    m_new = torch.maximum(m0 + b_last, b_last + rmax.values)         # [B,H]
    g = torch.exp(b_last[..., None] - bb + ii - m_new[..., None])   # [B,H,Q]
    return rmax, m_new, g, torch.exp(m0 + b_last - m_new)


def _mlstm_chunks(q, k, v, i_gate, f_gate, chunk: int, state: tuple, saved: list | None = None):
    """The chunkwise-parallel mLSTM of plain tensors: (h, (C, n, m)).  With
    ``saved`` (a list), each chunk appends what its backward reads
    (:func:`_mlstm_chunks_backward`): the state it starts from (C0, n0, m0),
    and its products q k^T, q C0 and q n0 and its output h, in f32."""
    Bsz, H, S, _ = q.shape
    V = v.shape[-1]
    qc, kc, vc, ic, _, b = _chunked(q, k, v, i_gate, f_gate, chunk)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    C0, n0, m0 = (s.to(torch.float32) for s in state)

    hs = []
    for c in range(qc.shape[2]):
        qq, kk, vv, ii, bb = (t[:, :, c] for t in (qc, kc, vc, ic, b))
        r, _, m_inter, _, m = _chunk_stabiliser(ii, bb, m0)
        qk = torch.einsum("bhtk,bhsk->bhts", qq, kk)
        Smat = qk * _intra_decay(ii, bb, m, causal)
        num = torch.einsum("bhts,bhsv->bhtv", Smat, vv)
        den = Smat.sum(dim=-1)                               # q~.n, intra part
        # inter-chunk contribution
        w = torch.exp(m_inter - m)                           # [B,H,Q]
        qC = torch.einsum("bhtk,bhkv->bhtv", qq, C0)
        qn = torch.einsum("bhtk,bhk->bht", qq, n0)
        num = num + w[..., None] * qC
        den = den + w * qn
        hs.append(num / _denom(den, m)[..., None])
        if saved is not None:
            saved.append((C0, n0, m0, qk, qC, qn, hs[-1]))
        # chunk-final state
        _, m_new, g, decay = _chunk_final(ii, bb, m0, r)
        C0 = decay[..., None, None] * C0 + torch.einsum("bhs,bhsk,bhsv->bhkv", g, kk, vv)
        n0 = decay[..., None] * n0 + torch.einsum("bhs,bhsk->bhk", g, kk)
        m0 = m_new

    h = torch.stack(hs, dim=2).reshape(Bsz, H, -1, V)[:, :, :S].to(v.dtype)
    return h, (C0, n0, m0)


def _max_share(a, b):
    """The share of ``torch.maximum(a, b)``'s gradient that goes to ``a``:
    1 where a is larger, 1/2 at a tie, 0 elsewhere (as autograd splits it)."""
    return torch.where(a > b, 1.0, torch.where(a == b, 0.5, 0.0))


def _mlstm_chunks_backward(q, k, v, i_gate, f_gate, chunk: int, residuals: tuple, dh,
                           dC, dn, dm):
    """The gradient of :func:`_mlstm_chunks` with respect to q, k, v, the
    gates and the initial state, through the chunks in reverse.  Each chunk
    reads what its forward saved (``residuals``, stacked along the chunk dim
    [B,H,nc,...]) and recomputes only elementwise terms (the decay D, the
    stabiliser, the gates), so none of the forward's products runs again.
    Each product's gradient is two products of its size, but q n0's in q
    (an outer product) and the n update's (a broadcast and a row sum)."""
    f32 = torch.float32
    S = q.shape[2]
    qc, kc, vc, ic, fc, b = _chunked(q, k, v, i_gate, f_gate, chunk)
    nc = qc.shape[2]
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    pad = nc * chunk - S
    dhc = F.pad(dh.to(f32), (0, 0, 0, pad)).reshape(*qc.shape[:4], dh.shape[-1])

    dq, dk, dv, di, db = (torch.empty_like(t) for t in (qc, kc, vc, ic, b))
    dC1, dn1, dm1 = dC.to(f32), dn.to(f32), dm.to(f32)
    for c in reversed(range(nc)):
        qq, kk, vv, ii, bb = (t[:, :, c] for t in (qc, kc, vc, ic, b))
        C0, n0, m0, qk, qC, qn, h = (t[:, :, c] for t in residuals)
        r, cm, m_inter, m_intra, m = _chunk_stabiliser(ii, bb, m0)
        D = _intra_decay(ii, bb, m, causal)
        Smat = qk * D
        w = torch.exp(m_inter - m)
        den = Smat.sum(dim=-1) + w * qn
        floor = torch.exp(torch.clamp(-m, max=80.0))
        rmax, m_new, g, decay = _chunk_final(ii, bb, m0, r)

        # the chunk-final state: C1 = decay C0 + sum_s g_s k_s v_s^T,
        # n1 = decay n0 + sum_s g_s k_s, m1 = max(m0 + b_last, b_last + max r)
        ddecay = (dC1 * C0).sum(dim=(-2, -1)) + (dn1 * n0).sum(dim=-1)
        dgk = torch.einsum("bhkv,bhsv->bhsk", dC1, vv) + dn1[..., None, :]
        dvv = torch.einsum("bhsk,bhkv->bhsv", g[..., None] * kk, dC1)
        dkk = dgk * g[..., None]
        dg = (dgk * kk).sum(dim=-1) * g                  # into g's exponent
        dC0, dn0 = decay[..., None, None] * dC1, decay[..., None] * dn1
        ddecay = ddecay * decay                          # into decay's exponent
        dm_new = dm1 - dg.sum(dim=-1) - ddecay
        share = _max_share(m0 + bb[..., -1], bb[..., -1] + rmax.values)
        dm0 = ddecay + dm_new * share
        db_last = dg.sum(dim=-1) + ddecay + dm_new
        dr = torch.zeros_like(r).scatter_(-1, rmax.indices[..., None],
                                          (dm_new * (1 - share))[..., None])
        dii = dg.clone()
        dbb = -dg
        dbb[..., -1] += db_last

        # h = num / max(|den|, floor), num = (q k^T * D) v + w q C0,
        # den = rowsum(q k^T * D) + w q n0
        dnorm = _denom(den, m)
        dnum = dhc[:, :, c] / dnorm[..., None]
        ddnorm = -(dhc[:, :, c] * h).sum(dim=-1) / dnorm
        share = _max_share(den.abs(), floor)
        dden = ddnorm * share * torch.sign(den)
        dmc = -(ddnorm * (1 - share) * floor) * (-m <= 80.0)  # into m, through the floor
        dSm = torch.einsum("bhtv,bhsv->bhts", dnum, vv) + dden[..., None]
        dvv = dvv + torch.einsum("bhts,bhtv->bhsv", Smat, dnum)
        dw = ((dnum * qC).sum(dim=-1) + dden * qn) * w   # into w's exponent
        dqC, dqn = w[..., None] * dnum, w * dden
        dqq = torch.einsum("bhtv,bhkv->bhtk", dqC, C0) + dqn[..., None] * n0[..., None, :]
        dC0 = dC0 + torch.einsum("bhtk,bhtv->bhkv", qq, dqC)
        dn0 = dn0 + torch.einsum("bhtk,bht->bhk", qq, dqn)
        dqk = dSm * D
        dqq = dqq + torch.einsum("bhts,bhsk->bhtk", dqk, kk)
        dkk = dkk + torch.einsum("bhts,bhtk->bhsk", dqk, qq)
        dE = dSm * qk * D                                # into D's exponent
        dmc = dmc - dE.sum(dim=-1) - dw
        dbb = dbb + dE.sum(dim=-1) - dE.sum(dim=-2)
        dii = dii + dE.sum(dim=-2)
        # m = max(m_inter, m_intra), m_inter = m0 + b, m_intra = b + cummax(r)
        share = _max_share(m_inter, m_intra)
        dm_inter = dw + dmc * share
        dm_intra = dmc * (1 - share)
        dm0 = dm0 + dm_inter.sum(dim=-1)
        dbb = dbb + dm_inter + dm_intra
        dr = dr.scatter_add_(-1, cm.indices, dm_intra)
        # r = i - b
        dq[:, :, c], dk[:, :, c], dv[:, :, c] = dqq, dkk, dvv
        di[:, :, c], db[:, :, c] = dii + dr, dbb - dr
        dC1, dn1, dm1 = dC0, dn0, dm0

    # b = cumsum(logsigmoid(f)): a reverse cumulative sum, then logsigmoid's
    dlogf = torch.flip(torch.cumsum(torch.flip(db, dims=(-1,)), dim=-1), dims=(-1,))
    dfc = dlogf * torch.sigmoid(-fc)

    def unchunk(x, like):
        x = x.reshape(x.shape[0], x.shape[1], nc * chunk, *x.shape[4:])
        return x[:, :, :S].to(like.dtype)

    return (unchunk(dq * (1.0 / math.sqrt(q.shape[-1])), q), unchunk(dk, k), unchunk(dv, v),
            unchunk(di, i_gate), unchunk(dfc, f_gate), dC1, dn1, dm1)


#: the residuals the mLSTM op saves for its backward, by name
_MLSTM_SAVED = ("C", "n", "m", "qk", "qC", "qn", "h")


def _mlstm_saved_shapes(B, H, nc, Q, K, V) -> tuple:
    return ((B, H, nc, K, V), (B, H, nc, K), (B, H, nc), (B, H, nc, Q, Q), (B, H, nc, Q, V),
            (B, H, nc, Q), (B, H, nc, Q, V))


@torch.library.custom_op("repro_torch::mlstm_chunkwise", mutates_args=())
def _mlstm_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_gate: torch.Tensor,
              f_gate: torch.Tensor, C: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
              chunk: int, save: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor]:
    """(h, C, n, m), then, with ``save``, the residuals of each chunk
    (``_MLSTM_SAVED``, stacked [B,H,nc,...]), else empty tensors."""
    saved = [] if save else None
    h, final = _mlstm_chunks(q, k, v, i_gate, f_gate, chunk, (C, n, m), saved)
    if save:
        residuals = [torch.stack(t, dim=2) for t in zip(*saved)]
    else:
        residuals = [q.new_empty(0, dtype=torch.float32) for _ in _MLSTM_SAVED]
    return (h, *final, *residuals)


@_mlstm_op.register_fake
def _(q, k, v, i_gate, f_gate, C, n, m, chunk, save):
    f32 = torch.float32
    B, H, S, K = q.shape
    shapes = (_mlstm_saved_shapes(B, H, -(-S // chunk), chunk, K, v.shape[-1]) if save
              else ((0,),) * len(_MLSTM_SAVED))
    return (torch.empty_like(v), *(torch.empty(t.shape, dtype=f32, device=t.device)
                                   for t in (C, n, m)),
            *(torch.empty(s, dtype=f32, device=q.device) for s in shapes))


@torch.library.custom_op("repro_torch::mlstm_chunkwise_backward", mutates_args=())
def _mlstm_backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_gate: torch.Tensor, f_gate: torch.Tensor, Cs: torch.Tensor,
                       ns: torch.Tensor, ms: torch.Tensor, qk: torch.Tensor, qC: torch.Tensor,
                       qn: torch.Tensor, h32: torch.Tensor, chunk: int, dh: torch.Tensor,
                       dC: torch.Tensor, dn: torch.Tensor, dm: torch.Tensor) -> list[torch.Tensor]:
    return list(_mlstm_chunks_backward(q, k, v, i_gate, f_gate, chunk,
                                       (Cs, ns, ms, qk, qC, qn, h32), dh, dC, dn, dm))


@_mlstm_backward_op.register_fake
def _(q, k, v, i_gate, f_gate, Cs, ns, ms, qk, qC, qn, h32, chunk, dh, dC, dn, dm):
    return [*(torch.empty_like(t) for t in (q, k, v, i_gate, f_gate)),
            *(torch.empty_like(t) for t in (dC, dn, dm))]


def _mlstm_setup(ctx, inputs, output):
    ctx.chunk = inputs[8]
    ctx.dtypes = tuple(t.dtype for t in inputs[5:8])
    ctx.save_for_backward(*inputs[:5], *output[4:])


def _mlstm_grad(ctx, dh, dC, dn, dm, *_):
    saved = ctx.saved_tensors
    if saved[5].numel() == 0:
        raise RuntimeError("mlstm_chunkwise: run with save=False where a gradient is needed")
    # an output no loss reads has no gradient: zero, in the shape of the
    # output (h like v; the final state like a chunk's saved one)
    dh = torch.zeros_like(saved[2]) if dh is None else dh
    dC, dn, dm = (torch.zeros_like(st[:, :, 0]) if g is None else g
                  for g, st in zip((dC, dn, dm), saved[5:8]))
    out = torch.ops.repro_torch.mlstm_chunkwise_backward(*saved, ctx.chunk, dh, dC, dn, dm)
    state = [g.to(dt) for g, dt in zip(out[5:], ctx.dtypes)]
    return (*out[:5], *state, None, None)


torch.library.register_autograd("repro_torch::mlstm_chunkwise", _mlstm_grad,
                                setup_context=_mlstm_setup)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunkwise)
def _mlstm_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    B, H, S, K = q_shape
    V = v_shape[-1]
    Q = args[5]  # chunk
    nc = -(-S // Q)
    # per chunk: q k^T and S v (intra), q C and q n (inter), the C and n updates
    return B * H * nc * (2 * Q * Q * K + 2 * Q * Q * V + 4 * Q * K * V + 4 * Q * K)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunkwise_backward)
def _mlstm_backward_flops(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs) -> int:
    B, H, S, K = q_shape
    V = v_shape[-1]
    Q = args[9]  # chunk
    nc = -(-S // Q)
    # per chunk: two products for each of q k^T, S v, q C and the C update,
    # one for q n (its gradient in q is an outer product), none for the n
    # update (its gradient is a broadcast)
    return B * H * nc * (4 * Q * Q * K + 4 * Q * Q * V + 8 * Q * K * V + 2 * Q * K)


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
    # the product sharded along its rows and columns, then gathered for the
    # split: DTensor would otherwise gather the weight and run it whole (as F5
    # found for Mamba2's in-projection), and at decode it contracts the embed
    # dim where the weight is (FSDP), leaving every batch row on every data
    # rank as a partial sum, which the value projection would then run whole
    up = shard(L.apply_dense(params["up"], y), "batch", "seq", "lstm_inner")
    u, z = torch.chunk(sharding.unshard_dims(up, -1), 2, dim=-1)
    c, new_conv = _conv_silu(u, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype),
                             cache["conv"] if cache is not None else None)
    B, S = x.shape[0], x.shape[1]
    gates = L.apply_dense(params["w_if"], c)  # [B,S,2H]
    i_gate = gates[..., :H].transpose(1, 2)
    f_gate = gates[..., H:].transpose(1, 2)

    split = _head_split(_mesh_of(c), H, Vd)
    if split is not None:
        h, final = _mlstm_value_split(params, cfg, split, c, u, i_gate, f_gate, cache,
                                      return_state=return_cache)
    else:
        h, final = _mlstm_heads(params, cfg, c, u, i_gate, f_gate, cache, return_cache)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "C": final[0], "n": final[1], "m": final[2]}
    elif return_cache:
        new_cache = {"conv": _conv_window(u, cfg.xlstm.conv_width),
                     "C": final[0], "n": final[1], "m": final[2]}

    h = h.to(x.dtype) * params["head_norm"].to(x.dtype)
    h = h + params["skip"].to(x.dtype) * c
    out = L.apply_dense(params["down"], h * F.silu(z))
    return x + out, new_cache


def _mlstm_heads(params, cfg: ModelConfig, c, u, i_gate, f_gate, cache, return_cache):
    """The mLSTM cell over whole heads: the per-head projections, the chunk
    loop (or, with ``cache``, one step) and the per-head norm.  Returns (h
    normed [B,S,Di] f32, the final (C, n, m) or None)."""
    d_inner, H, Kd, Vd = mlstm_dims(cfg)
    B, S = c.shape[0], c.shape[1]

    def block_proj(t, w):
        # block-diagonal per-head projection: [B,S,H,Vd] x [H,Vd,out]
        return torch.einsum("bshv,hvo->bhso", attn._split_heads(t, H, Vd), w.to(t.dtype))

    q = block_proj(c, params["wq"])
    k = block_proj(c, params["wk"])
    v = block_proj(u, params["wv"])
    q = shard(q, "batch", "lstm_heads", "seq", None)
    k = shard(k, "batch", "lstm_heads", "seq", None)
    v = shard(v, "batch", "lstm_heads", "seq", None)

    final = None
    if cache is None:
        out = mlstm_chunkwise(q, k, v, i_gate, f_gate, chunk=cfg.xlstm.chunk_size,
                              return_state=return_cache)
        h, final = out if return_cache else (out, None)
    else:
        h, final = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], i_gate[:, :, 0],
                              f_gate[:, :, 0], (cache["C"], cache["n"], cache["m"]))
        h = h[:, :, None, :]

    # per-head norm in f32
    h32 = h.transpose(1, 2).float().reshape(B, S, H, Vd)
    var = torch.mean(torch.square(h32), dim=-1, keepdim=True)
    return attn._merge_heads(h32 * torch.rsqrt(var + cfg.norm_eps)), final


def _mesh_of(x):
    return x.device_mesh if sharding.is_dtensor(x) else None


def _head_split(mesh, H: int, width: int) -> tuple[int, int] | None:
    """(d, r): the mesh dim d whose ranks split each of an xLSTM block's H
    heads, r = M / H of them a head (ROADMAP F9).  It is the one dim the
    rules give the heads (``"lstm_heads"``) where the heads cannot take it,
    if H divides its size M and each head's ``width`` (the mLSTM's value
    dim, the sLSTM's head dim) divides by r.  Rank j along it then holds
    head j // r and the (j % r)-th block of its columns, which the rules'
    ``"lstm_inner"`` split of the H * width columns gives it.  None on no
    mesh and on every other mesh."""
    if mesh is None:
        return None
    rules = sharding.active_rules()[1] or sharding.ACT_RULES
    spec = sharding.assign_spec(("lstm_heads",), (H,), rules, sharding.mesh_axis_sizes(mesh))
    dims = sharding.untaken_axes(sharding.placements(spec, mesh, (H,)), mesh, "lstm_heads")
    if len(dims) != 1:
        return None
    size = mesh.size(dims[0])
    r = size // H
    return (dims[0], r) if size % H == 0 and width % r == 0 else None


def _head_mesh(mesh, dim: int, r: int):
    """``mesh`` with dim ``dim`` unflattened into (heads, run of r): its
    coordinate j becomes (j // r, j % r).  On it a DTensor shards two
    tensor dims, the heads and a head's columns, where one mesh dim cannot
    (DTensor puts one placement on a mesh dim); torch's ``DeviceMesh`` does
    the unflattening (checked on 2.11 and 2.13).  Made once a mesh, by
    every rank."""
    from torch.utils._python_dispatch import _disable_current_modes

    meshes = mesh.__dict__.setdefault("_head_meshes", {})
    if (dim, r) not in meshes:
        name = mesh.mesh_dim_names[dim]
        with _disable_current_modes():  # the mesh's own tensors are real under a trace
            meshes[dim, r] = mesh._unflatten(dim, (mesh.size(dim) // r, r),
                                             (f"{name}_heads", f"{name}_run"))
    return meshes[dim, r]


def mlstm_state_sharding(cfg: ModelConfig, name: str, shape: tuple, mesh):
    """Where a decode cache leaf of the mLSTM (``name`` "C", "n" or "m", of
    ``shape``, its leading dims stacking layers) lives on ``mesh`` when the
    value split is taken: on :func:`_head_mesh`, its batch dim as the rules
    place it, its heads dim over the heads and, for C, its value dim over a
    head's run, so that each rank keeps the [B, 1, Kd, Vd / r] slice its
    decode steps update (n and m whole on a head's ranks, which compute the
    same values for them).  The view of C as prefill's [B, Kd, H * Vd],
    sharded along its last dim, would need a reshape at every boundary of
    the cache, and a DTensor's reshape across a sharded dim gathers it; on
    the unflattened mesh C keeps the reference's [B, H, Kd, Vd] as it is,
    and ``full_tensor()`` gives its values.  None where the split is not
    taken (the rules place the leaf)."""
    from torch.distributed.tensor import Replicate, Shard

    d_inner, H, Kd, Vd = mlstm_dims(cfg)
    split = _head_split(mesh, H, Vd)
    if split is None:
        return None
    dim, r = split
    axes = mlstm_cache_axes()[name]
    lead = len(shape) - len(axes)
    rules = sharding.active_rules()[1] or sharding.ACT_RULES
    p = sharding.placements(sharding.assign_spec((None,) * lead + axes, tuple(shape), rules,
                                                 sharding.mesh_axis_sizes(mesh)),
                            mesh, tuple(shape))
    run = Shard(lead + 3) if name == "C" else Replicate()
    return sharding.Sharding(_head_mesh(mesh, dim, r),
                             p[:dim] + (Shard(lead + 1), run) + p[dim + 1:])


def distribute_mlstm_cache(cfg: ModelConfig, name: str, t: torch.Tensor, *lead_axes):
    """A decode cache leaf of the mLSTM (``name`` of :func:`mlstm_cache_axes`,
    the same on every rank, its leading dims stacking layers by
    ``lead_axes``) placed on the active mesh: where the value split keeps it
    (:func:`mlstm_state_sharding`), else by its cache axes.  Without a mesh,
    ``t`` as it is."""
    mesh = sharding.active_mesh()
    where = (mlstm_state_sharding(cfg, name, tuple(t.shape), mesh)
             if name != "conv" and sharding.active_rules()[1] is not None else None)
    if where is None:
        return sharding.distribute_input(t, *lead_axes, *mlstm_cache_axes()[name])
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, where.mesh, where.placements, src_data_rank=None)


def _mlstm_value_split(params, cfg: ModelConfig, split: tuple[int, int], c, u, i_gate, f_gate,
                       cache=None, return_state: bool = False):
    """:func:`_mlstm_heads` where the H heads do not take the model axis but
    divide it (``split`` = (mesh dim, r), :func:`_head_split`): rank j
    holds head j // r and the (j % r)-th slice of its value dim, the
    columns of the inner dim [B,S,Di] that the rules' ``"lstm_inner"``
    split gives it.  The mLSTM is independent across the value dim but for
    the per-head norm.  Per rank (``local_map``), from c and u, which are
    whole on every rank: the head's q and k, the rank's columns of its v,
    the chunk loop (or, with ``cache``, one step on the rank's slice of the
    state) and the norm by the head's variance, summed over the head's
    ranks (a run, :func:`sharding.split_group`).  In the backward the
    gradients of c, u, wq and wk are partial sums over the run and are
    reduce-scattered over it alone (:func:`sharding.run_grad`).  Where XLA
    splits the contraction of q and k over the run and sums them there,
    each rank here projects its head's q and k whole: r times XLA's
    products, and no sum of them in the forward or of their gradients in
    the backward.

    The state (the cache's at decode, the final one with ``return_state``)
    stays sliced where the step leaves it (:func:`mlstm_state_sharding`):
    no state is summed or gathered between steps.  Returns (h normed
    [B,S,Di] f32, the final (C, n, m) or None)."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    d_inner, H, Kd, Vd = mlstm_dims(cfg)
    dim, r = split
    mesh = c.device_mesh
    group = sharding.split_group(mesh, dim, r)
    inner = sharding.act_placements(c, "batch", "seq", "lstm_inner")  # Shard(2) on dim
    head = sharding.local_rank_along(mesh, inner, 2)[0] // r
    rows = sharding.follow(inner, {0: 0})           # the batch split alone
    summed = tuple(Partial() if i == dim else p for i, p in enumerate(rows))
    whole = sharding.follow(inner, {})
    run_rows = tuple(Shard(0) if i == dim else p for i, p in enumerate(whole))
    w_grad = tuple(Partial() if i == dim or p.is_shard() else p for i, p in enumerate(rows))
    wv_grad = tuple(Shard(0) if i == dim else pg for i, pg in enumerate(w_grad))
    # a rank's slice of a state leaf, with a heads dim of 1, side by side
    # along that dim over the mesh dim's M ranks
    slot = sharding.follow(inner, {0: 0, 2: 1})

    def cell(c_, u_, wq, wk, wv, ig, fg, *state):
        B_, S_ = c_.shape[0], c_.shape[1]
        heads = slice(head * Vd, (head + 1) * Vd)
        q, k = (torch.einsum("bsv,vo->bso", c_[..., heads], w[heads].to(c_.dtype))[:, None]
                for w in (wq, wk))
        v = torch.einsum("bsv,ov->bso", u_[..., heads], wv.to(u_.dtype))[:, None]
        one = slice(head, head + 1)
        if state:
            h, final = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0], ig[:, one, 0],
                                  fg[:, one, 0], state)
            h = h[:, :, None]
        else:
            out = mlstm_chunkwise(q, k, v, ig[:, one], fg[:, one], chunk=cfg.xlstm.chunk_size,
                                  return_state=return_state)
            h, final = out if return_state else (out, None)
        h32 = h.transpose(1, 2).float().reshape(B_, S_, -1)
        var = sharding.group_sum(torch.square(h32).sum(dim=-1, keepdim=True), group) / Vd
        h32 = h32 * torch.rsqrt(var + cfg.norm_eps)
        return h32 if final is None else (h32, *final)

    # the weights by heads: wq, wk [H * Vd (in), Kd], wv [H * Vd (out), Vd (in)],
    # whose rank j's rows are its own head's v columns
    # (their gradients whole again before the views' backward splits the heads)
    wq, wk = (sharding.run_grad(sharding.grad_as_forward(params[w].reshape(H * Vd, Kd)),
                                0, dim, r) for w in ("wq", "wk"))
    wv = sharding.grad_as_forward(params["wv"].transpose(1, 2).reshape(H * Vd, Vd))
    wv = sharding.grad_as_forward(wv.redistribute(mesh, run_rows))  # summed on the slice
    # whole gates, whose gradients come back whole: a partial one would make
    # c's gradient through w_if a partial sum of the whole inner dim
    i_gate, f_gate = (sharding.reduce_partial(t) for t in (i_gate, f_gate))
    # the cache's slices as they are (on the head mesh, which local_map
    # leaves alone: it redistributes only where the placements differ)
    state = () if cache is None else (cache["C"], cache["n"], cache["m"])
    state_p = tuple(tuple(t.placements) for t in state)
    final = cache is not None or return_state
    res = sharding.local_map(
        cell, (inner, slot, slot, slot) if final else inner,
        (rows, rows, whole, whole, run_rows, rows, rows, *state_p), mesh,
        in_grad_placements=(summed, summed, w_grad, w_grad, wv_grad, summed, summed, *state_p))(
        *(sharding.run_grad(t, -1, dim, r) for t in (c, u)), wq, wk, wv, i_gate, f_gate, *state)
    if not final:
        return res, None
    h, *leaves = res
    B = c.shape[0]
    shapes = ((B, H, Kd, Vd), (B, H, Kd), (B, H))
    out = []
    for name, t, shape in zip(("C", "n", "m"), leaves, shapes):
        where = mlstm_state_sharding(cfg, name, shape, mesh)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        out.append(DTensor.from_local(t.to_local(), where.mesh, where.placements,
                                      run_check=False, shape=shape, stride=stride))
    return h, tuple(out)


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


def _slstm_steps(wx, R, state, pre: list | None = None, gather=None, hprev: list | None = None):
    """The sLSTM recurrence over time, one step at a time in f32 (the
    reference's ``lax.scan``).  wx: the four gates' input projections
    (z, i, f, o) [B,S,H,w] f32; R: their recurrent weights [H,dh,w] f32;
    state: (h, c, n, m) [B,H,w] f32.  Each step's pre-activations read the
    whole of each head's h_prev [B,H,dh]: w = dh, or, where each head's
    columns are split over ranks, ``gather`` makes it from the rank's w
    columns.  Returns the states after every step, (h, c, n, m) each
    stacked [B,S,H,w].  With ``pre`` (a list), each step appends its four
    pre-activations, and with ``hprev`` (a list) the whole h_prev it read,
    which the backward reads (:func:`_slstm_steps_backward`)."""
    h, c, n, m = state
    one = torch.ones((), dtype=h.dtype, device=h.device)
    hs, cs, ns, ms = [], [], [], []
    for t in range(wx[0].shape[1]):
        hp = h if gather is None else gather(h)
        pz, pi, pf, po = (w[:, t] + torch.einsum("bhd,hde->bhe", hp, r) for w, r in zip(wx, R))
        if pre is not None:
            pre.append((pz, pi, pf, po))
        if hprev is not None:
            hprev.append(hp)
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


def _slstm_steps_backward(R, state, pre, stacks, grads, hprev=None, scatter=None):
    """The gradient of :func:`_slstm_steps` with respect to wx, R and the
    initial state, through time in reverse, from the pre-activations the
    forward saved (``pre``, (z, i, f, o) each [B,S,H,w]), its stacked
    states and their gradients ``grads``: two products for each of the
    forward's, the recurrent weights' gradient one product a gate over every
    step at the end.  Where each head's columns are split over ranks,
    ``hprev`` is the whole h_prev the forward read [B,S,H,dh], and each
    step's gradient into it, a partial sum over the head's ranks,
    ``scatter`` sums over them and cuts to the rank's w columns."""
    one = torch.ones((), dtype=stacks[0].dtype, device=stacks[0].device)
    prev = [torch.cat([s0[:, None], st[:, :-1]], dim=1) for s0, st in zip(state, stacks)]
    hprev = prev[0] if hprev is None else hprev
    dh, dc, dn, dm = (torch.zeros_like(s) for s in state)
    dpre = [torch.empty_like(p) for p in pre]
    for t in reversed(range(stacks[0].shape[1])):
        pz, pi, pf, po = (p[:, t] for p in pre)
        _, c_prev, n_prev, m_prev = (p[:, t] for p in prev)
        _, c_new, n_new, m_new = (st[:, t] for st in stacks)
        dh_t, dc_t, dn_t, dm_t = (g[:, t] + d for g, d in zip(grads, (dh, dc, dn, dm)))
        # h = sigmoid(o~) c / max(n, 1)
        o, den = torch.sigmoid(po), torch.maximum(n_new, one)
        dpo = dh_t * c_new / den * o * (1 - o)
        dc_t = dc_t + dh_t * o / den
        dn_t = dn_t - dh_t * o * c_new / den ** 2 * _max_share(n_new, one)
        # c = fw c + iw tanh(z~), n = fw n + iw
        logf, z = F.logsigmoid(pf), torch.tanh(pz)
        iw, fw = torch.exp(pi - m_new), torch.exp(logf + m_prev - m_new)
        dpz = dc_t * iw * (1 - z * z)
        dc, dn = dc_t * fw, dn_t * fw
        dfw = (dc_t * c_prev + dn_t * n_prev) * fw      # into fw's exponent
        diw = (dc_t * z + dn_t) * iw                     # into iw's exponent
        dm_t = dm_t - dfw - diw
        # m = max(logf + m_prev, i~)
        share = _max_share(logf + m_prev, pi)
        dlogf = dfw + dm_t * share
        dm = dfw + dm_t * share
        dpi = diw + dm_t * (1 - share)
        dpf = dlogf * torch.sigmoid(-pf)
        for d, g in zip(dpre, (dpz, dpi, dpf, dpo)):
            d[:, t] = g
        # each pre-activation is w_t + h_prev R
        dh = sum(torch.einsum("bhe,hde->bhd", g, r) for g, r in zip((dpz, dpi, dpf, dpo), R))
        if scatter is not None:
            dh = scatter(dh)
    dR = tuple(torch.einsum("bshd,bshe->hde", hprev, d) for d in dpre)
    return (*dpre, *dR, dh, dc, dn, dm)


def _run_collective(group: str, R: torch.Tensor, collective):
    """``collective`` (:func:`sharding.run_all_gather` or
    :func:`sharding.run_reduce_scatter`) over the ranks of the group named
    ``group``, dh / w of them for R [H,dh,w]; None for no group ("")."""
    if not group:
        return None
    size = R.shape[1] // R.shape[2]
    return lambda x: collective(x, group, size)


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan_op(wz: torch.Tensor, wi: torch.Tensor, wf: torch.Tensor, wo: torch.Tensor,
                   rz: torch.Tensor, ri: torch.Tensor, rf: torch.Tensor, ro: torch.Tensor,
                   h: torch.Tensor, c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                   group: str, save: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                    torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stacked states (h, c, n, m), then, with ``save``, the four
    pre-activations stacked [4,B,S,H,w] and, on a ``group``, the whole
    h_prev of every step [B,S,H,dh], else empty tensors.  ``group`` names
    the process group of the ranks that split each head's columns, which
    gather h every step (a ``str``: an op's schema takes no group); ""
    for none, w = dh."""
    pre = [] if save else None
    hprev = [] if save and group else None
    stacks = _slstm_steps((wz, wi, wf, wo), (rz, ri, rf, ro), (h, c, n, m), pre,
                          _run_collective(group, rz, sharding.run_all_gather), hprev)
    saved = torch.stack([torch.stack(p, dim=1) for p in zip(*pre)]) if save else wz.new_empty(0)
    whole = torch.stack(hprev, dim=1) if hprev is not None else wz.new_empty(0)
    return (*stacks, saved, whole)


@_slstm_scan_op.register_fake
def _(wz, wi, wf, wo, rz, ri, rf, ro, h, c, n, m, group, save):
    B, S, H, _ = wz.shape
    return (*(torch.empty_like(wz) for _ in range(4)),
            wz.new_empty((4, *wz.shape) if save else (0,)),
            wz.new_empty((B, S, H, rz.shape[1]) if save and group else (0,)))


@torch.library.custom_op("repro_torch::slstm_scan_backward", mutates_args=())
def _slstm_scan_backward_op(rz: torch.Tensor, ri: torch.Tensor, rf: torch.Tensor,
                            ro: torch.Tensor, h: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                            m: torch.Tensor, hs: torch.Tensor, cs: torch.Tensor,
                            ns: torch.Tensor, ms: torch.Tensor, pre: torch.Tensor,
                            hprev: torch.Tensor, dhs: torch.Tensor, dcs: torch.Tensor,
                            dns: torch.Tensor, dms: torch.Tensor, group: str) -> list[torch.Tensor]:
    return list(_slstm_steps_backward((rz, ri, rf, ro), (h, c, n, m), tuple(pre),
                                      (hs, cs, ns, ms), (dhs, dcs, dns, dms),
                                      hprev if group else None,
                                      _run_collective(group, rz, sharding.run_reduce_scatter)))


@_slstm_scan_backward_op.register_fake
def _(rz, ri, rf, ro, h, c, n, m, hs, cs, ns, ms, pre, hprev, dhs, dcs, dns, dms, group):
    return [torch.empty_like(t) for t in (hs, hs, hs, hs, rz, ri, rf, ro, h, c, n, m)]


def _slstm_scan_setup(ctx, inputs, output):
    ctx.group = inputs[12]
    ctx.save_for_backward(*inputs[4:12], *output)


def _slstm_scan_grad(ctx, dhs, dcs, dns, dms, *_):
    saved = ctx.saved_tensors
    if saved[12].numel() == 0:
        raise RuntimeError("slstm_scan: run with save=False where a gradient is needed")
    grads = [torch.zeros_like(saved[8]) if g is None else g for g in (dhs, dcs, dns, dms)]
    return (*torch.ops.repro_torch.slstm_scan_backward(*saved, *grads, ctx.group), None, None)


torch.library.register_autograd("repro_torch::slstm_scan", _slstm_scan_grad,
                                setup_context=_slstm_scan_setup)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_scan_flops(wz_shape, wi_shape, wf_shape, wo_shape, rz_shape, *args, out_shape=None,
                      **kwargs) -> int:
    B, S, H, w = wz_shape
    return 4 * 2 * B * S * H * rz_shape[1] * w    # the recurrent products: dh into w a gate


@register_flop_formula(torch.ops.repro_torch.slstm_scan_backward)
def _slstm_scan_backward_flops(rz_shape, *args, out_shape=None, **kwargs) -> int:
    # two products for each recurrent one: into h_prev a step, into R at the end
    return 2 * _slstm_scan_flops(args[7], None, None, None, rz_shape)  # hs: [B,S,H,w]


@sharding.register_collective_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_scan_collectives(wz, wi, wf, wo, rz, *args, **kwargs) -> list:
    """On a group: an all-gather of h [B,H,w] into [B,H,dh] a step."""
    if not args[7]:  # group
        return []
    B, S, H, w = wz.shape
    size = wz.element_size()
    return [("all-gather", S, B * H * w * size, B * H * rz.shape[1] * size)]


@sharding.register_collective_formula(torch.ops.repro_torch.slstm_scan_backward)
def _slstm_scan_backward_collectives(rz, *args, **kwargs) -> list:
    """On a group: a reduce-scatter of the gradient into h_prev a step."""
    if not args[-1]:  # group
        return []
    B, S, H, w = args[7].shape  # hs
    size = args[7].element_size()
    return [("reduce-scatter", S, B * H * rz.shape[1] * size, B * H * w * size)]


def slstm_scan(wx, R, state, group: str = ""):
    """:func:`_slstm_steps` as one op (``torch.ops.repro_torch.slstm_scan``),
    which, where a gradient is needed, also returns its pre-activations for
    its backward op (:func:`_slstm_steps_backward`): a traced step
    (:mod:`repro_torch.launch.dryrun`) records the whole loop as one node
    with the FLOPs of its products, where the steps one by one would be
    thousands of nodes a layer.  On plain tensors with ``group`` (the
    name of a process group, :func:`_slstm_value_split`) each rank holds
    w of each head's dh columns (R [H,dh,w], the rest [B,...,H,w]).  On
    DTensors it runs per rank on its batch rows and heads: the recurrence
    is independent across both, and each rank's gradient of the recurrent
    weights is a partial sum over the ranks that split the batch."""
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
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (*wx, *R, *state))
    return torch.ops.repro_torch.slstm_scan(*wx, *R, *state, group, save)[:4]


def _slstm_value_split(wx, R, state, split: tuple[int, int], return_state: bool):
    """:func:`slstm_scan` where the H heads do not take the model axis but
    divide it (``split`` = (mesh dim, r), :func:`_head_split`), as XLA
    splits each head's output dim over the r ranks the head gets: rank j
    holds head j // r and the (j % r)-th block of w = dh / r of its
    columns.  wx [B,S,d] arrive so (the gate projections are
    ``("embed", "lstm_inner")``).  Per rank (``local_map``) the op runs on
    the rank's columns of wx, of its head's R (sliced from R, whole on
    every rank, as [dh, H * dh]) and of the state, and gathers h among
    the head's ranks every step (a run, :func:`sharding.split_group`,
    which the op reaches by its name); its backward reduce-scatters the
    gradient into h_prev over them every step.  The gradient of R comes
    back as the rank's [dh, w] block, summed over the batch split and then
    gathered into R's placement (fewer bytes than a zero-padded partial
    sum, or than summing the gathered whole); the state's is
    reduce-scattered over the run (:func:`sharding.run_grad`).

    Returns (h [B,S,d] f32, placed as wx, and, with ``return_state``, the
    final (h, c, n, m) [B,H,dh] gathered once into the cache's placement,
    else None)."""
    from torch.distributed.tensor import Partial

    dim, r = split
    mesh = wx[0].device_mesh
    H, dh, _ = R[0].shape
    w = dh // r
    group = sharding.split_group(mesh, dim, r).group_name
    cols = sharding.act_placements(wx[0], "batch", "seq", "lstm_inner")  # Shard(2) on dim
    head, part = divmod(sharding.local_rank_along(mesh, cols, 2)[0], r)
    rows = sharding.follow(cols, {0: 0})            # the batch split alone
    summed = tuple(Partial() if i == dim else p for i, p in enumerate(rows))
    r_cols = sharding.follow(cols, {2: 1})
    r_grad = sharding.grad_placements(cols, {2: 1}, {0})
    slot = sharding.follow(cols, {0: 0, 2: 1})      # a final state [B, d], the rank's columns

    def cell(wz, wi, wf, wo, rz, ri, rf, ro, *st):
        one, mine = slice(head, head + 1), slice(part * w, (part + 1) * w)
        st = tuple(t.reshape(t.shape[0], H, dh)[:, one, mine] for t in st)
        out = slstm_scan(tuple(t[:, :, None] for t in (wz, wi, wf, wo)),
                         tuple(t[None] for t in (rz, ri, rf, ro)), st, group)
        h = out[0][:, :, 0]
        return (h, *(t[:, -1, 0] for t in out)) if return_state else h

    # the state as [B, H * dh], whose gradient each run writes in its head's
    # block (whole again before the view's backward splits the heads)
    state = tuple(sharding.run_grad(sharding.grad_as_forward(
        sharding.replicated(t, mesh).flatten(1)), 1, dim, r) for t in state)
    # R as [dh, H * dh], a rank's block of columns its own; the block's
    # gradient summed over the batch split before it is gathered
    R = tuple(sharding.grad_as_forward(t.permute(1, 0, 2).reshape(dh, H * dh)
                                       .redistribute(mesh, r_cols)) for t in R)
    res = sharding.local_map(
        cell, (cols, *(slot,) * 4) if return_state else cols,
        (cols,) * 4 + (r_cols,) * 4 + (rows,) * 4, mesh,
        in_grad_placements=(None,) * 4 + (r_grad,) * 4 + (summed,) * 4)(*wx, *R, *state)
    if not return_state:
        return res, None
    h, *final = res
    return h, tuple(sharding.unshard_dims(t, -1).reshape(t.shape[0], H, dh) for t in final)


def slstm_cell(params, cfg: ModelConfig, x: torch.Tensor, state: tuple,
               return_state: bool = True):
    """The sLSTM over time in f32 (:func:`slstm_scan`).  x [B,S,D]; state
    (h, c, n, m) each [B,H,dh] f32.  Returns (h [B,S,D] in x's dtype, the
    final state, or None without ``return_state``).

    Where the heads do not take the model axis but divide it, each head's
    columns are split over its ranks (:func:`_slstm_value_split`), a single
    step (decode) too.  There the split gathers h among a head's ranks and
    the final state into the cache's placement, where the heads whole
    reduce the step's input projections, partial sums over the embed dim
    that FSDP splits, and gather them; which moves fewer bytes depends on
    the sizes.  At xlstm-1.3b decode_32k on (16, 16), traced with torch 2.11
    on a mesh of device type cuda, the split moves fewer: 248.5 MiB a card
    against 281.0 with the sLSTM's heads whole (2.968e9 against 3.345e9
    FLOPs).  At d 256, 4 rows a rank, it moves more."""
    H, dh = slstm_dims(cfg)
    f32 = torch.float32
    proj = tuple(L.apply_dense({"w": params[f"w_{g}"], "b": params[f"b_{g}"]}, x) for g in GATES)
    R = tuple(params[f"r_{g}"].to(f32) for g in GATES)
    state = tuple(s.to(f32) for s in state)
    split = _head_split(_mesh_of(proj[0]), H, dh)
    if split is not None:
        h, final = _slstm_value_split(tuple(t.to(f32) for t in proj), R, state, split,
                                      return_state)
    else:
        stacks = slstm_scan(tuple(attn._split_heads(t, H, dh).to(f32) for t in proj), R, state)
        h = attn._merge_heads(stacks[0])
        final = tuple(st[:, -1] for st in stacks) if return_state else None
    return h.to(x.dtype), final


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
    keep = cache is not None or return_cache
    h, final = slstm_cell(params, cfg, y, state, return_state=keep)
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
    # the block's output in its rules' placement, whole on the model ranks.
    # With h split over them the sum above stays sharded, and the FFN runs
    # on it split (a whole sum runs one of the FFN's products whole on
    # every model rank); left so, every later block's products and their
    # gradients would run on a sharded residual (xlstm-1.3b train_4k:
    # 337868.5 MiB a card on the wire against 250951.2 with the heads whole)
    x = shard(x + L.apply_mlp(params["ffn"], y, "swiglu"), "batch", "seq", "embed")
    return x, ({"state": final} if keep else None)
