"""Public entry points of the kernels.

A CUDA tensor always launches the hand-written kernel; a CPU tensor always
takes the kernel's plain version in :mod:`repro_torch.kernels.ref`.  The
reference's block- and chunk-halving loops (``repro/kernels/ops.py:28-31,
43-44``) are a TPU tiling workaround and have no counterpart: the CUDA kernels
mask ragged edges themselves.  For the same reason ``gmm`` takes any C, D and
F, where the reference's raises unless they tile by its 128-wide blocks
(``repro/kernels/moe_gmm.py:59-60``).

None of the three Pallas kernels' counterparts has a backward kernel, and
neither has the reference's: a gradient through a Pallas call raises under
``jax.grad``.  So each of their entry points raises ``NotImplementedError``
when autograd would record it (grad mode on and an input that requires grad),
on either route, rather than hand back an output that silently carries no
gradient.  Evaluation (``torch.inference_mode``) and serving (parameters that
do not require grad) are unaffected; training runs the ``xla`` route
(``attention_impl="xla"``), ``ssd_chunked`` and the einsum expert FFN, as the
reference's does.  The ``xla`` route's causal self-attention, whose gradient
the reference has (``jax.grad`` through XLA's fused einsums), runs on the
card as :func:`causal_attention`: a ``torch.autograd.Function`` whose forward
and backward are hand-written kernels (``csrc/flash_attention.cu``).

Each entry point also takes DTensors (a model run under
:class:`repro_torch.parallel.sharding.use_rules` with a mesh).  It then
runs its own plain-tensor route on each rank's local shards through
``local_map``: attention with the batch over the data axes and the heads
over "model", the scan with ``ssm_heads`` over "model" (``Bm``/``Cm``
whole on every rank), the grouped matmul with the experts over "model"
where x and w hold the same ones, so that ``e % Ew`` indexes the local
slabs.  No tensor is gathered whole to feed a kernel; what is
gathered is what the local computation needs (the kv heads of a rank's
query heads when they are not sharded with them, an expert weight's
FSDP-sharded ``embed`` dim).

On plain tensors each entry point calls a ``torch.library.custom_op``
(``torch.ops.repro_torch.flash_attention``, ``.mamba_scan``, ``.gmm``,
``.causal_attention_fwd`` and ``.causal_attention_bwd``) whose
implementation picks the route by the tensor's device, as above.  Each op
also has a fake implementation (the output's shape and dtype), so that a step
traced on fake tensors (:mod:`repro_torch.launch.dryrun`) passes through the
kernels without launching one, and a FLOP formula
(``torch.utils.flop_counter.register_flop_formula``) that counts the work the
kernel's bound counts in ``chip_smoke.py``: attention's QK^T and PV products
over the unmasked pairs (and the backward's five), the scan's intra-chunk,
inter-chunk and state products, the grouped matmul's 2 E C D F.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import tracing
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.parallel import sharding


def _no_backward(name: str, *inputs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError(
            f"{name}: no backward kernel; the reference has none either.  Train "
            f"through the plain route (attention_impl='xla', ssd_chunked, the "
            f"einsum expert FFN)"
        )


def _kv_heads_for(kl: torch.Tensor, h0: int, n_q: int, group: int) -> torch.Tensor:
    """The kv heads that query heads ``h0 .. h0+n_q`` (of a GQA layer with
    ``group`` query heads per kv head) read, from all the kv heads ``kl``,
    laid out so that local query head ``h`` reads local kv head
    ``h // (n_q / K_local)``, the kernel's pairing."""
    if n_q % group == 0:
        return kl[:, :, h0 // group:(h0 + n_q) // group]
    if group % n_q == 0:
        return kl[:, :, h0 // group:h0 // group + 1]
    return kl.repeat_interleave(group, dim=2)[:, :, h0:h0 + n_q]


def attention_per_shard(fn, q, k, v, *batched) -> torch.Tensor:
    """``fn(q, k, v, *batched)`` (an attention of plain tensors, GQA q
    ``[B,S,H,D]``, k/v ``[B,T,K,D]``) on DTensors, per rank on its batch rows
    and query heads.  ``batched``: extra tensors whose dim 0 is the batch (a
    1-D or plain tensor is taken whole by every rank), or None.

    When the kv heads shard with the query heads (K divides by the ranks
    along the heads), each rank's kv shard is exactly the groups of its query
    heads.  Otherwise (``assign_spec`` left "kv_heads" replicated, e.g. 2 kv
    heads on a model axis of 4) every rank gets all K kv heads and keeps the
    ones its query heads read: an attention that pairs local query head ``h``
    with local kv head ``h // (H_local / K_local)``, as the kernel does, would
    on all K heads be right on the first rank only.  Each rank's gradient of
    the whole k and v is then a partial sum over the ranks along the heads."""
    from torch.distributed.tensor import distribute_tensor

    mesh = q.device_mesh
    qp = sharding.act_placements(q, "batch", "seq", "heads", "head_dim")
    H, K = q.shape[2], k.shape[2]
    index, count = sharding.local_rank_along(mesh, qp, 2)
    bp = sharding.follow(qp, {0: 0})
    args, places = [], []
    for x in batched:
        if x is not None:
            p = bp if x.dim() > 1 else sharding.follow(qp, {})
            if not sharding.is_dtensor(x):
                x = distribute_tensor(x, mesh, p, src_data_rank=None)
        args.append(x)
        places.append(None if x is None else p)
    kvp = sharding.follow(qp, {0: 0, 2: 2}) if K % count == 0 else bp
    # whole kv heads, read in part: each rank's kv gradient is a partial sum
    kv_grad = None if K % count == 0 else sharding.grad_placements(qp, {0: 0}, {2})

    def local(ql, kl, vl, *rest):
        if K % count:
            n_q, group = ql.shape[2], H // K
            h0 = index * n_q
            kl = _kv_heads_for(kl, h0, n_q, group)
            vl = _kv_heads_for(vl, h0, n_q, group)
        return fn(ql, kl, vl, *rest)

    return sharding.local_map(local, qp, (qp, kvp, kvp, *places), mesh,
                              in_grad_placements=(None, kv_grad, kv_grad, *places))(
        q, k, v, *args)


# --- the three kernels as custom ops ------------------------------------------


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        window: int | None, logit_softcap: float | None) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 logit_softcap=logit_softcap)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               logit_softcap=logit_softcap)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, logit_softcap):
    return torch.empty_like(q)


def attended_pairs(S: int, T: int, causal: bool, window: int | None) -> int:
    """Query-key pairs the attention scores: query i reads key j when
    ``j <= i`` (causal) and ``i - j < window`` (a window), as the kernel's
    mask and ``chip_smoke.py``'s bound count them."""
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(S, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window, logit_softcap,
                           *args, out_shape=None, **kwargs) -> int:
    B, S, H, D = q_shape
    return 4 * B * H * D * attended_pairs(S, k_shape[1], causal, window)


@torch.library.custom_op("repro_torch::causal_attention_fwd", mutates_args=())
def _causal_attention_fwd_op(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return ref.causal_attention_fwd_ref(q, k, v)
    return _fa.flash_attention_fwd_lse(q, k, v)


@_causal_attention_fwd_op.register_fake
def _(q, k, v):
    B, S, H, _ = q.shape
    return q.new_empty((B, S, H, v.shape[-1])), q.new_empty((B, H, S), dtype=torch.float32)


@torch.library.custom_op("repro_torch::causal_attention_bwd", mutates_args=())
def _causal_attention_bwd_op(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return ref.causal_attention_bwd_ref(dout, q, k, v, out, lse)
    return _fa.flash_attention_bwd(dout, q, k, v, out, lse)


@_causal_attention_bwd_op.register_fake
def _(dout, q, k, v, out, lse):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.causal_attention_fwd)
def _causal_attention_fwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                                **kwargs) -> int:
    # S = Q K^T over D, O = P V over DV
    B, S, H, D = q_shape
    return 2 * B * H * (D + v_shape[-1]) * attended_pairs(S, S, True, None)


@register_flop_formula(torch.ops.repro_torch.causal_attention_bwd)
def _causal_attention_bwd_flops(dout_shape, q_shape, *args, out_shape=None, **kwargs) -> int:
    # S = Q K^T again, dQ = dS K, dK = dS^T Q over D; dP = dO V^T, dV = P^T dO
    # over DV (dout's width)
    B, S, H, D = q_shape
    return 2 * B * H * (3 * D + 2 * dout_shape[-1]) * attended_pairs(S, S, True, None)


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=())
def _mamba_scan_op(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    if xh.device.type == "cpu":
        return ref.mamba_scan_ref(xh, dt, A, Bm, Cm)[0]
    return _ms.mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk)


@_mamba_scan_op.register_fake
def _(xh, dt, A, Bm, Cm, chunk):
    return torch.empty(xh.shape, dtype=xh.dtype, device=xh.device)


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _mamba_scan_flops(xh_shape, dt_shape, a_shape, bm_shape, cm_shape, chunk,
                      *args, out_shape=None, **kwargs) -> int:
    B, S, H, P = xh_shape
    N = bm_shape[-1]
    n_chunks = -(-S // chunk)
    return B * n_chunks * (2 * chunk * chunk * N
                           + H * (2 * chunk * chunk * P + 4 * chunk * P * N))


@torch.library.custom_op("repro_torch::gmm", mutates_args=())
def _gmm_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return ref.gmm_ref(x, w)
    return _gmm.gmm(x, w)


@_gmm_op.register_fake
def _(x, w):
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.gmm)
def _gmm_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    E, C, D = x_shape
    return 2 * E * C * D * w_shape[2]


# --- entry points ---------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    logit_softcap: float | None = None) -> torch.Tensor:
    _no_backward("flash_attention", q, k, v)
    if sharding.is_dtensor(q):
        return attention_per_shard(functools.partial(
            flash_attention, causal=causal, window=window, logit_softcap=logit_softcap),
            q, k, v)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window, logit_softcap)


def _pairs_span(name: str, q: torch.Tensor, v: torch.Tensor):
    """The span ``name`` around one launch of the training pair, counting the
    unmasked (query, key) pairs of every head times the q.k width
    (``qk_pairs``) and times v's (``v_pairs``); tracing off, the no-op span."""
    if not tracing.enabled():
        return tracing.span(name)
    B, S, H, D = q.shape
    pairs = B * H * attended_pairs(S, S, True, None)
    return tracing.span(name, qk_pairs=pairs * D, v_pairs=pairs * v.shape[-1])


class _CausalAttention(torch.autograd.Function):
    """Causal self-attention whose forward keeps each row's log-sum-exp and
    whose backward recomputes P from it.  Under a non-reentrant
    ``checkpoint`` (remat) its forward runs again before its backward.  Each
    runs inside a span of its own (``attention.causal_fwd``,
    ``attention.causal_bwd``) that holds the launches alone."""

    @staticmethod
    def forward(ctx, q, k, v):
        with _pairs_span("attention.causal_fwd", q, v):
            out, lse = torch.ops.repro_torch.causal_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        saved = ctx.saved_tensors  # unpacked once: a checkpoint allows no second unpack
        with _pairs_span("attention.causal_bwd", saved[0], saved[2]):
            return tuple(torch.ops.repro_torch.causal_attention_bwd(dout, *saved))


#: (q.k, v) head dims :func:`causal_attention` takes on the card
CAUSAL_HEAD_DIMS = _fa.CAUSAL_HEAD_DIMS


def causal_attention_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether :func:`causal_attention` runs the training kernels on q, k, v:
    plain (not DTensor) bf16 CUDA tensors, as many keys as queries (S = T)
    and (q.k, v) head dims in :data:`CAUSAL_HEAD_DIMS`."""
    return (not any(sharding.is_dtensor(t) for t in (q, k, v))
            and all(t.device.type == "cuda" and t.dtype == torch.bfloat16 for t in (q, k, v))
            and k.shape[1] == q.shape[1]
            and (q.shape[-1], v.shape[-1]) in CAUSAL_HEAD_DIMS)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of plain tensors, positions from 0: q [B,S,H,D],
    k [B,S,K,D], v [B,S,K,DV] -> [B,S,H,DV], differentiable.  A CUDA tensor
    runs the training kernels (bf16, (D, DV) in :data:`CAUSAL_HEAD_DIMS`), a
    CPU tensor their plain versions."""
    return _CausalAttention.apply(q.contiguous(), k.contiguous(), v.contiguous())


def mamba_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunked SSD scan forward: y [B,S,H,P] in xh's dtype, no final state.
    The result does not depend on ``chunk`` beyond rounding."""
    _no_backward("mamba_scan", xh, dt, A, Bm, Cm)
    if sharding.is_dtensor(xh):
        xp = sharding.act_placements(xh, "batch", "seq", "ssm_heads", None)
        dtp = sharding.follow(xp, {0: 0, 2: 2})
        ap = sharding.follow(xp, {2: 0})
        bp = sharding.follow(xp, {0: 0})
        return sharding.local_map(functools.partial(mamba_scan, chunk=chunk), xp,
                                  (xp, dtp, ap, bp, bp), xh.device_mesh)(xh, dt, A, Bm, Cm)
    return torch.ops.repro_torch.mamba_scan(xh, dt, A, Bm, Cm, chunk)


def gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul [E,C,D] x [Ew,D,F] -> [E,C,F], slab ``e % Ew``."""
    _no_backward("gmm", x, w)
    if sharding.is_dtensor(x):
        # the local slabs line up only when x and w hold the same experts
        # (E == Ew); otherwise both go whole to every rank
        xp = sharding.follow(x.placements, {0: 0} if x.shape[0] == w.shape[0] else {})
        return sharding.local_map(gmm, xp, (xp, xp), x.device_mesh)(x, w)
    return torch.ops.repro_torch.gmm(x, w)
