"""Plain PyTorch oracles for the hand-written kernels (the correctness contract).

Line-for-line counterpart of ``repro/kernels/ref.py``: attention, the SSD
scan, the grouped matmul and the SwiGLU expert FFN.  Besides, the training
kernels' pair, which the reference leaves to XLA: causal self-attention
returning its log-sum-exp (:func:`causal_attention_fwd_ref`) and the closed
form of its gradient (:func:`causal_attention_bwd_ref`).
"""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, K, D]
    v: torch.Tensor,  # [B, T, K, D]
    causal: bool = True,
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    s = s / torch.sqrt(torch.tensor(D, dtype=torch.float32, device=q.device))
    if logit_softcap:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    s = torch.where(mask[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def _causal_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, K, G, S, S] f32 scores of causal self-attention over 1/sqrt(D),
    -1e30 above the diagonal, as ``attend_xla`` forms them."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, D).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    s = s / torch.sqrt(torch.tensor(D, dtype=torch.float32, device=q.device))
    pos = torch.arange(S, device=q.device)
    return torch.where(pos[None, :] <= pos[:, None], s, -1e30)


def causal_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal self-attention (S = T, positions from 0) with ``attend_xla``'s
    arithmetic: q [B,S,H,D], k [B,S,K,D], v [B,S,K,DV] -> (out [B,S,H,DV] in
    v's dtype, lse [B,H,S] f32, each row's log-sum-exp of its scaled
    scores)."""
    B, S, H, _ = q.shape
    s = _causal_scores(q, k)
    p = torch.softmax(s, dim=-1)
    # probs rounded to v's dtype before the PV product, as attend_xla does
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v).reshape(B, S, H, v.shape[-1])
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def causal_attention_bwd_ref(dout: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`causal_attention_fwd_ref` in closed form, from P
    recomputed from ``lse`` and Delta = rowsum(dout o out): dV = P^T dO,
    dP = dO V^T, dS = P o (dP - Delta), dQ = dS K / sqrt(D), dK = dS^T Q /
    sqrt(D), GQA's group summed into dK and dV; f32 sums.  D is q's and k's
    width, DV v's, dout's and out's.  P is rounded to q's dtype as dV's
    operand, as the forward rounds it for PV (a no-op in f32); dS stays f32,
    as the reference's is.  Returns (dq, dk, dv) in the inputs' dtypes."""
    B, S, H, D = q.shape
    K, DV = k.shape[2], v.shape[-1]
    G = H // K
    p = torch.exp(_causal_scores(q, k) - lse.reshape(B, K, G, S, 1))
    do = dout.reshape(B, S, K, G, DV).float()
    delta = (do * out.reshape(B, S, K, G, DV).float()).sum(-1).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgst,bskgd->btkd", p.to(q.dtype).float(), do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.float())
    ds = p * (dp - delta[..., None])
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32, device=q.device))
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()).reshape(B, S, H, D) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, q.reshape(B, S, K, G, D).float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mamba_scan_ref(
    xh: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,   # [B, S, H] (softplus'd)
    A: torch.Tensor,    # [H] (negative)
    Bm: torch.Tensor,   # [B, S, N]
    Cm: torch.Tensor,   # [B, S, N]
    h0: torch.Tensor | None = None,  # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Literal sequential SSD recurrence, one step at a time, in f32.

    Returns y [B, S, H, P] in xh's dtype and the final state [B, H, P, N] f32.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = h0.to(f32) if h0 is not None else torch.zeros((Bsz, H, P, N), dtype=f32,
                                                      device=xh.device)
    A = A.to(f32)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(f32)
        decay = torch.exp(dt_t * A[None, :])
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt_t, Bm[:, t].to(f32), xh[:, t].to(f32))
        h = decay[..., None, None] * h + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].to(f32), h))
    return torch.stack(ys, dim=1).to(xh.dtype), h


def gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (per-expert) matmul: [E,C,D] x [Ew,D,F] -> [E,C,F], slab
    ``e % Ew`` for group ``e`` (as the kernel indexes it), summed in f32 and
    cast to x's dtype."""
    slab = torch.arange(x.shape[0], device=x.device) % w.shape[0]
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()[slab]).to(x.dtype)


def expert_mlp_ref(x: torch.Tensor, experts: dict) -> torch.Tensor:
    """SwiGLU expert FFN over dispatched tokens [(G,)E,C,D]."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    h = torch.nn.functional.silu(
        torch.einsum("gecd,edf->gecf", x, experts["gate"].to(x.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", x, experts["up"].to(x.dtype))
    out = torch.einsum("gecf,efd->gecd", h, experts["down"].to(x.dtype))
    return out[0] if squeeze else out
