"""Mamba2 (SSD) block, the hybrid arch's (zamba2) sequence mixer.

Counterpart of ``repro/models/ssm.py``.  The sequence is cut into chunks: the
intra-chunk terms are dense products and only the per-chunk state summary is
carried sequentially (:func:`ssd_chunked`).  Under ``attention_impl="flash"``
the forward pass sends the scan to the hand-written CUDA kernel through
:func:`repro_torch.kernels.ops.mamba_scan` (its plain version on CPU); prefill
and decode stay plain PyTorch, as in the reference.

Recurrence (per head h, state N, head dim P):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t (x) x_t
    y_t = C_t . h_t + D_h * x_t
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import shard


def dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = ssm.n_heads or d_inner // ssm.head_dim
    return d_inner, n_heads, ssm.head_dim, ssm.state_dim, ssm.n_groups


def init_mamba(cfg: ModelConfig):
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, H, P, N, G = dims(cfg)
    conv_ch = d_inner + 2 * G * N
    proj_out = 2 * d_inner + 2 * G * N + H  # z, x, B, C, dt
    return {
        "in_proj": {"w": ParamSpec((d, proj_out), ("embed", "ssm_inner"))},
        "conv_w": ParamSpec((ssm.conv_width, conv_ch), ("conv", "ssm_inner")),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros"),
        "norm_scale": ParamSpec((d_inner,), ("ssm_inner",), init="ones"),
        "out_proj": {"w": ParamSpec((d_inner, d), ("ssm_inner", "embed"))},
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """z, x, B, C, dt: views of the in-projection (no copy)."""
    d_inner, H, P, N, G = dims(cfg)
    return torch.split(proj, [d_inner, d_inner, G * N, G * N, H], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq.  x [B,S,Ch]; w [W,Ch].  On DTensors it
    runs per rank on its batch rows (the sequence and channels whole): some
    DTensor versions fail to plan the pad's redistribution.  Each rank's
    gradient of w and b is then a partial sum over the ranks that split the
    batch."""
    if sharding.is_dtensor(x):
        xp = sharding.follow(x.placements, {0: 0})
        whole = sharding.follow(xp, {})
        grad = sharding.grad_placements(xp, {}, {0})
        return sharding.local_map(_causal_conv, xp, (xp, whole, whole), x.device_mesh,
                                  in_grad_placements=(None, grad, grad))(x, w, b)
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def ssd_chunked(
    xh: torch.Tensor,   # [B, S, H, P] inputs (per head)
    dt: torch.Tensor,   # [B, S, H] softplus'd step sizes
    A: torch.Tensor,    # [H] negative decay rates
    Bm: torch.Tensor,   # [B, S, N] input projections (G=1)
    Cm: torch.Tensor,   # [B, S, N] output projections
    chunk: int,
    h0: torch.Tensor | None = None,  # [B, H, P, N] initial state
    return_final_state: bool = False,
):
    """Chunkwise SSD, padded to a whole number of chunks.  Returns y [B,S,H,P]
    in xh's dtype (and the final state [B,H,P,N] f32 if requested).  On
    DTensors it runs per rank on its batch rows and heads
    (:func:`_ssd_per_shard`)."""
    if sharding.is_dtensor(xh):
        return _ssd_per_shard(xh, dt, A, Bm, Cm, chunk, h0, return_final_state)
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    if S % chunk:
        pad = chunk - S % chunk
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = xh.shape[1]
    nc = Sp // chunk
    f32 = torch.float32

    xc = xh.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, chunk, N).to(f32)

    a = dtc * A[None, None, None, :]          # [B,nc,Q,H] log-decay (<0)
    cum = torch.cumsum(a, dim=2)              # inclusive cumulative decay
    a_total = cum[:, :, -1, :]                # [B,nc,H]

    # --- intra-chunk (quadratic within chunk, dense products) --------------
    CB = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)           # [B,nc,Q,Q]
    qidx = torch.arange(chunk, device=xh.device)
    mask = qidx[:, None] >= qidx[None, :]                 # causal within chunk
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,S,H]
    # mask inside the exponent: s>t entries would overflow exp() and produce
    # inf*0=NaN if masked multiplicatively afterwards
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff, -torch.inf))
    Wdt = CB[..., None] * decay * dtc[:, :, None, :, :]    # dt applied at source
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", Wdt, xc)

    # --- chunk state summaries ---------------------------------------------
    decay_to_end = torch.exp(a_total[:, :, None, :] - cum)  # [B,nc,Q,H]
    Sc = torch.einsum("bcsh,bcshp,bcsn->bchpn", decay_to_end * dtc, xc, Bc)

    # --- inter-chunk recurrence (sequential over chunks only) ---------------
    h = h0.to(f32) if h0 is not None else torch.zeros((Bsz, H, P, N), dtype=f32,
                                                      device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = torch.exp(a_total[:, c])[..., None, None] * h + Sc[:, c]
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum),
                           torch.stack(h_prevs, dim=1))

    y = (y_intra + y_inter).reshape(Bsz, Sp, H, P)[:, :S].to(xh.dtype)
    if return_final_state:
        return y, h
    return y


def _ssd_per_shard(xh, dt, A, Bm, Cm, chunk, h0, return_final_state):
    """:func:`ssd_chunked` of DTensors on each rank's batch rows and heads
    (``ssm_heads`` over "model"): independent across both, and DTensor's
    einsums would fold sharded dims into one that some versions cannot
    split.  Bm and Cm, shared by the heads, are whole on every rank along the
    heads, so their gradients are partial sums there; A's is one along the
    batch."""
    xp = sharding.act_placements(xh, "batch", "seq", "ssm_heads", None)
    hp = sharding.follow(xp, {0: 0, 2: 1})
    ins = [xp, sharding.follow(xp, {0: 0, 2: 2}), sharding.follow(xp, {2: 0}),
           sharding.follow(xp, {0: 0}), sharding.follow(xp, {0: 0})]
    grads = [None, None, sharding.grad_placements(xp, {2: 0}, {0}),
             sharding.grad_placements(xp, {0: 0}, {2}), sharding.grad_placements(xp, {0: 0}, {2})]
    args = [xh, dt, A, Bm, Cm]
    if h0 is not None:
        ins.append(hp)
        grads.append(None)
        args.append(h0)

    def local(xh, dt, A, Bm, Cm, h0=None):
        return ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk, h0=h0,
                           return_final_state=return_final_state)

    out = (xp, hp) if return_final_state else xp
    return sharding.local_map(local, out, tuple(ins), xh.device_mesh,
                              in_grad_placements=tuple(grads))(*args)


def _conv_window(conv_in: torch.Tensor, width: int) -> torch.Tensor:
    """Last (width-1) conv inputs, left-padded: the decode conv cache."""
    S = conv_in.shape[1]
    w = width - 1
    if S >= w:
        return conv_in[:, S - w:, :]
    return F.pad(conv_in, (0, 0, w - S, 0))


def apply_mamba(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,               # [B, S, D]
    cache: dict | None = None,     # decode: {"h": [B,H,P,N], "conv": [B,W-1,Ch]}
    return_cache: bool = False,    # prefill: build the decode cache
) -> tuple[torch.Tensor, dict | None]:
    """Three routes: forward (the scan kernel under ``"flash"``, else
    :func:`ssd_chunked`), prefill (``return_cache``: ssd_chunked with the final
    state) and decode (``cache``: the conv-window roll and the single-step
    recurrence).  Returns (out, new_cache); the cache is a new dict."""
    d_inner, H, P, N, G = dims(cfg)
    ssm = cfg.ssm
    # whole along its columns, which mix z, x, B, C and dt: a gather whose
    # backward hands in_proj its columns of the gradient
    proj = sharding.unshard_dims(L.apply_dense(params["in_proj"], x), -1)
    z, xs, Bm, Cm, dt = _split_proj(cfg, proj)

    conv_in = torch.cat([xs, Bm, Cm], dim=-1)  # [B,S,Ch]
    if cache is None:
        conv_out = _causal_conv(conv_in, params["conv_w"].to(x.dtype),
                                params["conv_b"].to(x.dtype))
        conv_out = F.silu(conv_out)
        new_cache = {"conv": _conv_window(conv_in, ssm.conv_width)} if return_cache else None
    else:
        # decode: roll the conv window cache (x has S=1)
        window = torch.cat([cache["conv"], conv_in], dim=1)  # [B,W,Ch]
        conv_out = (torch.einsum("bwc,wc->bc", window, params["conv_w"].to(x.dtype))
                    + params["conv_b"].to(x.dtype))
        conv_out = F.silu(conv_out)[:, None, :]
        new_cache = {"conv": window[:, 1:]}
    xs, Bm, Cm = torch.split(conv_out, [d_inner, G * N, G * N], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())  # [B,S,H] f32
    A = -torch.exp(params["A_log"].float())                   # [H] f32
    xh = xs.reshape(xs.shape[0], xs.shape[1], H, P)
    xh = shard(xh, "batch", "seq", "ssm_heads", None)

    if cache is None:
        if return_cache:
            y, h_final = ssd_chunked(xh, dt, A, Bm, Cm, chunk=ssm.chunk_size,
                                     return_final_state=True)
            new_cache["h"] = h_final
        elif cfg.attention_impl == "flash":
            y = kernel_ops.mamba_scan(xh, dt, A, Bm, Cm, chunk=ssm.chunk_size)
        else:
            y = ssd_chunked(xh, dt, A, Bm, Cm, chunk=ssm.chunk_size)
    else:
        # single-step recurrence
        h = cache["h"].float()             # [B,H,P,N]
        dt1 = dt[:, 0]                     # [B,H]
        decay = torch.exp(dt1 * A[None, :])
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt1, Bm[:, 0].float(), xh[:, 0].float())
        h = decay[..., None, None] * h + dBx
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)
        y = y[:, None].to(x.dtype)         # [B,1,H,P]
        new_cache["h"] = h

    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(x.shape[0], x.shape[1], d_inner)
    # gated RMSNorm (in f32) then down-projection
    y = y * F.silu(z)
    y32 = y.float()
    var = torch.mean(torch.square(y32), dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps)).to(x.dtype)
    y = y * params["norm_scale"].to(x.dtype)
    return L.apply_dense(params["out_proj"], y), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    """Zeroed decode cache of one layer: f32 SSM state, conv window in ``dtype``."""
    d_inner, H, P, N, G = dims(cfg)
    conv_ch = d_inner + 2 * G * N
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba_cache_axes():
    return {
        "h": ("batch", "ssm_heads", None, None),
        "conv": ("batch", None, "ssm_inner"),
    }
