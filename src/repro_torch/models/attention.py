"""Grouped-query attention with RoPE, causal/sliding-window masking, KV
caches for decode, and cross-attention (enc-dec); multi-head latent
attention (DeepSeek-V3's, :func:`apply_mla`) for training.

Counterpart of ``repro/models/attention.py``.  Two implementations:

* ``xla``   - einsum + softmax (:func:`attend_xla`), the reference's name kept.
  Its causal self-attention of plain bf16 CUDA tensors (training's) runs as
  the hand-written kernels through
  :func:`repro_torch.kernels.ops.causal_attention`, forward and backward,
  the single pass XLA's fusion gives the reference's einsums;
* ``flash`` - the hand-written CUDA kernel through
  :func:`repro_torch.kernels.ops.flash_attention` (its plain version on CPU).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel.sharding import distribute_input, grad_as_forward, shard, unshard_dims


def init_attention(cfg: ModelConfig, d_model: int | None = None):
    if cfg.kv_lora_rank:
        return init_mla(cfg)
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "wq": L.init_dense(d, cfg.n_heads * hd, ("embed", "qkv"), cfg.use_qkv_bias),
        "wk": L.init_dense(d, cfg.n_kv_heads * hd, ("embed", "qkv"), cfg.use_qkv_bias),
        "wv": L.init_dense(d, cfg.n_kv_heads * hd, ("embed", "qkv"), cfg.use_qkv_bias),
        "wo": L.init_dense(cfg.n_heads * hd, d, ("qkv", "embed"), cfg.use_bias,
                           scale=1.0),
    }


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """[..., n_heads * head_dim] -> [..., n_heads, head_dim].  A DTensor whose
    last dim is split over more ranks than there are heads (2 kv heads on a
    model axis of 4) is gathered along it first: DTensor cannot split a
    shard below one head."""
    if isinstance(x, DTensor):
        ranks = 1
        for i, p in enumerate(x.placements):
            if p.is_shard(x.ndim - 1):
                ranks *= x.device_mesh.size(i)
        if n_heads % ranks:
            x = unshard_dims(x, -1)
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    return grad_as_forward(x.reshape(x.shape[:-2] + (-1,)))


def attend_xla(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, K, D]
    v: torch.Tensor,  # [B, T, K, D]
    *,
    causal: bool,
    q_positions: torch.Tensor | None = None,   # [B, S] or [S]
    kv_positions: torch.Tensor | None = None,  # [B, T] or [T]
    kv_valid: torch.Tensor | None = None,      # [B, T] bool: cache validity
    window: int | None = None,
    logit_softcap: float | None = None,
) -> torch.Tensor:
    """Softmax attention, GQA.  On DTensors it runs per rank on its batch
    rows and heads (:func:`repro_torch.kernels.ops.attention_per_shard`): it
    is independent across both, and DTensor's einsum would fold the sharded
    batch and head dims into one strided dim whose redistribution plans cost
    more than the whole product."""
    if isinstance(q, DTensor):
        def local(q, k, v, q_positions, kv_positions, kv_valid):
            return attend_xla(q, k, v, causal=causal, q_positions=q_positions,
                              kv_positions=kv_positions, kv_valid=kv_valid,
                              window=window, logit_softcap=logit_softcap)

        return kernel_ops.attention_per_shard(local, q, k, v, q_positions,
                                              kv_positions, kv_valid)
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / torch.sqrt(torch.tensor(D, dtype=torch.float32, device=q.device))
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)

    if causal or window is not None or kv_valid is not None:
        if q_positions is None:
            q_positions = torch.arange(S, device=q.device)
        if kv_positions is None:
            kv_positions = torch.arange(T, device=q.device)
        qp = q_positions.expand(B, S) if q_positions.dim() == 1 else q_positions
        kp = kv_positions.expand(B, T) if kv_positions.dim() == 1 else kv_positions
        ok = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kp[:, None, :] <= qp[:, :, None]
        if window is not None:
            ok &= (qp[:, :, None] - kp[:, None, :]) < window
        if kv_valid is not None:
            ok &= kv_valid[:, None, :]
        scores = torch.where(ok[:, None, None, :, :], scores, -1e30)  # [B,1,1,S,T]
    probs = torch.softmax(scores, dim=-1)
    # probs are rounded to v's dtype before the PV product, as in the reference
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, Dv)


def fused_causal(q, k, v, *, causal: bool, q_positions=None, kv_positions=None,
                 kv_valid=None, window: int | None = None,
                 logit_softcap: float | None = None) -> bool:
    """Whether :func:`attend_xla`'s function at these inputs is the training
    kernels' (:func:`repro_torch.kernels.ops.causal_attention`): causal
    attention with no cache mask, softcap or window narrower than S, with
    one 1-D position tensor for queries and keys (or none), on tensors the
    kernels take (:func:`repro_torch.kernels.ops.causal_attention_takes`).
    As on the flash route, those positions are taken to be arange(S): every
    caller passes that, and the kernels mask key j from query i by j > i
    alone."""
    return (causal and kv_valid is None and not logit_softcap
            and (window is None or window >= q.shape[1])
            and q_positions is kv_positions
            and (q_positions is None or q_positions.dim() == 1)
            and kernel_ops.causal_attention_takes(q, k, v))


def attend(cfg: ModelConfig, q, k, v, **kw) -> torch.Tensor:
    """Self-attention through the kernel that takes it: flash under
    ``attention_impl="flash"`` (without a cache mask), else the training
    kernels where :func:`fused_causal` holds, else :func:`attend_xla`.
    ``kw`` are :func:`attend_xla`'s."""
    if cfg.attention_impl == "flash" and kw.get("kv_valid") is None:
        return kernel_ops.flash_attention(
            q, k, v,
            causal=kw.get("causal", True),
            window=kw.get("window"),
            logit_softcap=kw.get("logit_softcap"),
        )
    if fused_causal(q, k, v, **kw):
        return kernel_ops.causal_attention(q, k, v)
    return attend_xla(q, k, v, **kw)


def init_kv_cache(cfg: ModelConfig, n: int, batch: int, max_len: int, dtype, device):
    """Zeroed KV caches stacked ``[n, batch, max_len, K, D]``: one per layer of
    a dense stack, one per application of zamba2's shared block.  Under an
    active mesh they are DTensors placed by ``("layers",) + kv_cache_axes()``."""
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    axes = kv_cache_axes()
    return {name: distribute_input(torch.zeros(shape, dtype=dtype, device=device),
                                   "layers", *axes[name]) for name in ("k", "v")}


def kv_cache_axes():
    """Logical axes of one layer's KV cache (the port stacks a leading layer
    axis in front of them)."""
    return {
        "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
    }


def clamped_start(start: int, size: int, length: int) -> int:
    """The start index ``jax.lax.dynamic_slice_in_dim`` and
    ``dynamic_update_slice_in_dim`` use: ``start`` clamped into
    ``[0, length - size]``, so that a slice of ``size`` fits.  Past the end
    (a decoder position at or beyond whisper's 448) the reference reads and
    writes the last ``size`` rows instead of raising."""
    return min(max(start, 0), length - size)


def attend_cache(q: torch.Tensor, cache: dict, positions: torch.Tensor, cache_position: int,
                 *, window: int | None = None,
                 logit_softcap: float | None = None) -> torch.Tensor:
    """q [B,S,H,D] at ``positions`` against the KV cache [B,T,K,D], its k and
    v already written at ``cache_position``: causal :func:`attend_xla` over
    the whole cache, each key before ``cache_position + S`` valid, as the
    reference attends over its cache (``repro/models/attention.py:149-166``)."""
    T = cache["k"].shape[1]
    kv_pos = torch.arange(T, device=q.device)
    valid = (kv_pos[None, :] < cache_position + q.shape[1]).expand(q.shape[0], T)
    return attend_xla(q, cache["k"], cache["v"], causal=True, q_positions=positions,
                      kv_positions=kv_pos, kv_valid=valid, window=window,
                      logit_softcap=logit_softcap)


def write_kv(cache: dict, k: torch.Tensor, v: torch.Tensor, cache_position: int) -> None:
    """Writes k, v [B,S,K,D] into ``cache`` [B,T,K,D] in place at
    ``cache_position``, clamped as the reference's
    ``dynamic_update_slice_in_dim`` clamps it; the reference returns a new
    array instead.  The cache may be a view of the stacked [L, ...] cache."""
    S = k.shape[1]
    start = clamped_start(cache_position, S, cache["k"].shape[1])
    for name, new in (("k", k), ("v", v)):
        dst = cache[name]
        if isinstance(dst, DTensor):
            # DTensor has no sharding strategy for a slice assignment: the new
            # rows take the cache's placements and each rank writes its shard
            new = new.redistribute(dst.device_mesh, dst.placements).to_local()
            dst = dst.to_local()
        dst[:, start:start + S] = new


def apply_attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,                    # [B, S, D_model]
    positions: torch.Tensor,            # [S] or [B, S]
    *,
    causal: bool = True,
    use_rope: bool = True,
    cache: dict | None = None,          # prefill/decode: KV cache for this layer
    cache_position: int | None = None,  # write offset into the cache
    window: int | None = None,
) -> tuple[torch.Tensor, dict | None]:
    """Self-attention (train/prefill/decode).  Returns (out, updated_cache).

    With a cache the attention is causal whatever ``causal`` says, as in the
    reference (``repro/models/attention.py:149-166``).  Latent attention
    (``kv_lora_rank``) has no cache yet: :func:`apply_mla`, training's."""
    if cfg.kv_lora_rank:
        if cache is not None:
            raise NotImplementedError("latent attention has no KV cache yet")
        return apply_mla(params, cfg, x, positions, window=window), None
    hd = cfg.resolved_head_dim
    q = _split_heads(L.apply_dense(params["wq"], x), cfg.n_heads, hd)
    k = _split_heads(L.apply_dense(params["wk"], x), cfg.n_kv_heads, hd)
    v = _split_heads(L.apply_dense(params["wv"], x), cfg.n_kv_heads, hd)
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    if use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        write_kv(cache, k, v, cache_position)
    if cache is None or (cfg.attention_impl == "flash" and isinstance(cache_position, int)
                         and cache_position == 0):
        # Without a cache the positions are arange(S) (every caller's), which
        # the flash route and the xla route's training kernels take them to
        # be.  A prefill into an empty cache under flash: the reference
        # attends over the whole cache with kv_valid = kv_pos < S
        # (attention.py:149-166), but at position 0 causality already
        # excludes every key at or past S (a score of -1e30 adds exactly 0),
        # so causal attention over the fresh K/V is the same function.
        out = attend(cfg, q, k, v, causal=causal or cache is not None, q_positions=positions,
                     kv_positions=positions, window=window, logit_softcap=cfg.attn_logit_softcap)
    else:
        out = attend_cache(q, cache, positions, cache_position, window=window,
                           logit_softcap=cfg.attn_logit_softcap)
    out = shard(out, "batch", "seq", "heads", "head_dim")
    return L.apply_dense(params["wo"], _merge_heads(out)), cache


def init_mla(cfg: ModelConfig):
    """Latent attention's weights: q, the latent down-projection to
    ``kv_lora_rank`` + the shared rotary key part, the latent's RMSNorm, its
    up-projection to each head's k_nope and v, and the output."""
    d, H, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": L.init_dense(d, H * (nope + rope), ("embed", "qkv")),
        "wkv_a": L.init_dense(d, r + rope, ("embed", "rank")),
        "kv_norm": {"scale": ParamSpec((r,), ("rank",), init="ones")},
        "wkv_b": L.init_dense(r, H * (nope + dv), ("rank", "qkv")),
        "wo": L.init_dense(H * dv, d, ("qkv", "embed")),
    }


def apply_mla(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor, *,
              window: int | None = None) -> torch.Tensor:
    """DeepSeek-V3's multi-head latent attention (arXiv:2412.19437 §2.1.1)
    without q compression, causal, at ``positions`` arange(S):

        q = W_q h, split per head into q_nope and q_pe;
        [c_kv; k_pe] = W_kva h, c_kv through its RMSNorm;
        [k_nope; v] = W_kvb c_kv, per head;
        q_pe and the one k_pe that every head shares rotated (split-half RoPE);
        softmax((q_nope k_nope + q_pe k_pe) / sqrt(nope + rope)) v, then W_o.

    The scores go through :func:`attend` once over the whole batch: on the
    ``xla`` route, training's bf16 CUDA tensors (q.k 192, v 128) run the
    training kernels (:func:`repro_torch.kernels.ops.causal_attention`),
    anything else :func:`attend_xla`.  Under ``attention_impl="flash"`` they
    take the flash route, as every attention does, which refuses them: the
    flash kernel takes one width up to 128 for q, k and v, and has no
    backward."""
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    with tracing.span("attention.mla"):
        q = _split_heads(L.apply_dense(params["wq"], x), H, nope + rope)
        c_kv, k_pe = torch.split(L.apply_dense(params["wkv_a"], x), [r, rope], dim=-1)
        c_kv = L.apply_norm(params["kv_norm"], c_kv, "rmsnorm", cfg.norm_eps)
        kv = _split_heads(L.apply_dense(params["wkv_b"], c_kv), H, nope + dv)
    q_nope, q_pe = torch.split(q, [nope, rope], dim=-1)
    k_nope, v = torch.split(kv, [nope, dv], dim=-1)
    q_pe = L.apply_rope(q_pe, positions, cfg.rope_theta)
    k_pe = L.apply_rope(k_pe.unsqueeze(-2), positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(*k_nope.shape[:-1], rope)], dim=-1)
    out = attend(cfg, q, k, v, causal=True, q_positions=positions, kv_positions=positions,
                 window=window, logit_softcap=cfg.attn_logit_softcap)
    return L.apply_dense(params["wo"], _merge_heads(out))


def init_cross_attention(cfg: ModelConfig):
    return init_attention(cfg)


def apply_cross_attention(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,   # [B, S_dec, D]
    enc_kv: dict,      # precomputed {"k","v"}: [B, S_enc, K, D]
) -> torch.Tensor:
    """Decoder queries against the encoder's keys and values: attend_xla,
    unmasked, under either ``attention_impl`` (as in the reference)."""
    hd = cfg.resolved_head_dim
    q = _split_heads(L.apply_dense(params["wq"], x), cfg.n_heads, hd)
    out = attend_xla(q, enc_kv["k"], enc_kv["v"], causal=False)
    return L.apply_dense(params["wo"], _merge_heads(out))


def precompute_cross_kv(params, cfg: ModelConfig, enc_out: torch.Tensor) -> dict:
    hd = cfg.resolved_head_dim
    k = _split_heads(L.apply_dense(params["wk"], enc_out), cfg.n_kv_heads, hd)
    v = _split_heads(L.apply_dense(params["wv"], enc_out), cfg.n_kv_heads, hd)
    return {"k": k, "v": v}
