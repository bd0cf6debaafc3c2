"""Decoder-only LM assembly: the dense, MoE (and VLM-prefix) stack, zamba2's
hybrid stack and the xLSTM stack.

Counterpart of ``repro/models/transformer.py:82-556``.  Block parameters stay
stacked with a leading layer axis ``[L, ...]``, as in the reference, so the
weight bridge is a copy; the reference's ``lax.scan`` over that axis becomes
a Python loop over layer views.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import distribute_input, shard


def stack_specs(spec, n: int, axis_name: str = "layers"):
    """Prepend a stacking dimension, logical axis ``axis_name``, to every
    ParamSpec in a tree."""
    return L.map_tree(
        lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale), spec)


def layer_params(stacked, i: int):
    """Views of layer ``i`` of a tree of stacked ``[L, ...]`` tensors."""
    return L.map_tree(lambda a: a[i], stacked)


def unstack(stacked, n: int) -> list:
    """The ``n`` per-layer trees of a tree of stacked ``[n, ...]`` tensors: views
    from one ``unbind`` a leaf.  Under autograd a leaf's gradient is then put
    together by one ``stack``, where ``n`` views ``a[i]`` would each scatter
    into a zeroed copy of the whole leaf and the ``n`` copies be summed (at
    internlm2-1.8b's 24 layers that took a third of a training step's device
    time)."""
    parts = L.map_tree(lambda a: a.unbind(0), stacked)
    return [L.map_tree(lambda leaf: leaf[i], parts) for i in range(n)]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# what "dots" keeps: the outputs of products without batch dimensions (the
# projections' ``x @ w``), as jax's checkpoint_dots_with_no_batch_dims does;
# the attention einsums run as bmm and are recomputed
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat_policy`` (``repro/models/transformer.py:46-52``):
    ``"none"`` a plain call, ``"dots"`` a checkpoint that saves only the
    outputs of ``_DOTS``, anything else a full checkpoint.  Without autograd
    (``torch.inference_mode``, ``torch.no_grad``) there is nothing to save and
    ``fn`` is called plainly."""
    if cfg.remat_policy == "none":
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if cfg.remat_policy == "dots":
            return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
                create_selective_checkpoint_contexts, _DOTS))
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped


# ---------------------------------------------------------------------------
# One transformer block (dense or MoE FFN)
# ---------------------------------------------------------------------------


def init_block(cfg: ModelConfig, dense: bool = False):
    """One block's spec; ``dense``: one of an MoE model's leading dense
    layers, its MLP ``dense_d_ff`` wide."""
    spec: dict[str, Any] = {
        "attn_norm": L.init_norm(cfg.d_model, cfg.norm_type, cfg.use_bias),
        "attn": attn.init_attention(cfg),
    }
    if not cfg.parallel_residual:
        spec["mlp_norm"] = L.init_norm(cfg.d_model, cfg.norm_type, cfg.use_bias)
    if not dense and (cfg.family == "moe" or (cfg.moe is not None and cfg.family != "dense")):
        spec["moe"] = moe_mod.init_moe(cfg)
    else:
        d_ff = cfg.dense_d_ff if dense else cfg.d_ff
        spec["mlp"] = L.init_mlp(cfg.d_model, d_ff, cfg.mlp_type, cfg.use_bias)
    return spec


def _ffn(params, cfg: ModelConfig, h: torch.Tensor, balance=None, layer: int | None = None):
    """(FFN output, aux loss): the MoE layer, called without ``use_gmm`` as the
    reference's block calls it (``balance`` and the layer's index among the
    MoE layers for a dropless one), or the dense MLP with aux 0.0 (a Python
    float, so prefill and decode of a dense stack launch nothing for it)."""
    if "moe" in params:
        return moe_mod.apply_moe(params["moe"], cfg, h, balance=balance,
                                 layer=(layer or 0) - cfg.first_dense_layers)
    return L.apply_mlp(params["mlp"], h, cfg.mlp_type), 0.0


def apply_block(
    params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: dict | None = None,
    cache_position: int | None = None,
    layer: int | None = None,
    balance=None,
):
    """Returns (x, new_cache, aux_loss); ``layer`` (the block's index) labels
    its spans; ``balance`` (:class:`repro_torch.models.moe.Balance`) is a
    dropless MoE layer's."""
    h = L.apply_norm(params["attn_norm"], x, cfg.norm_type, cfg.norm_eps)
    with tracing.span("block.attention", layer=layer) as s:
        attn_out, new_cache = attn.apply_attention(
            params["attn"], cfg, s.grad_in(h), positions,
            cache=cache, cache_position=cache_position,
            window=cfg.sliding_window,
        )
        attn_out = s.grad_out(attn_out)
    if cfg.parallel_residual:
        # command-r style: attention and FFN read the same normed input
        with tracing.span("block.ffn", layer=layer) as s:
            ffn_out, aux = _ffn(params, cfg, s.grad_in(h), balance, layer)
            ffn_out = s.grad_out(ffn_out)
        x = x + attn_out + ffn_out
    else:
        x = x + attn_out
        h = L.apply_norm(params["mlp_norm"], x, cfg.norm_type, cfg.norm_eps)
        with tracing.span("block.ffn", layer=layer) as s:
            ffn_out, aux = _ffn(params, cfg, s.grad_in(h), balance, layer)
            ffn_out = s.grad_out(ffn_out)
        x = x + ffn_out
    x = shard(x, "batch", "seq", "embed")
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------


def init_lm_shell(cfg: ModelConfig):
    spec = {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model),
        "final_norm": L.init_norm(cfg.d_model, cfg.norm_type, cfg.use_bias),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = {"w": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))}
    return spec


def embed_tokens(params, cfg: ModelConfig, tokens, pixel_embeds=None):
    x = L.apply_embedding(params["embed"], tokens, compute_dtype(cfg))
    if pixel_embeds is not None:
        # VLM stub frontend: precomputed patch embeddings occupy the first
        # n_image_tokens positions (InternVL-style prefix)
        k = pixel_embeds.shape[1]
        x = torch.cat([pixel_embeds.to(x.dtype), x[:, k:, :]], dim=1)
    return shard(x, "batch", "seq", "embed")


def lm_logits(params, cfg: ModelConfig, x):
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.apply_unembed(params["embed"], x, cfg.attn_logit_softcap)
    # the full-vocab product stays a plain matmul, as the reference leaves it to XLA
    return shard(L.apply_dense(params["lm_head"], x), "batch", "seq", "vocab")


# ---------------------------------------------------------------------------
# Dense / MoE LM: one stack, or an MoE model's leading dense layers then its
# MoE layers, each stack of one kind of block
# ---------------------------------------------------------------------------


def init_lm(cfg: ModelConfig):
    """``blocks`` [n_layers - first_dense_layers, ...], and before them
    ``dense_blocks`` [first_dense_layers, ...] where the model has any."""
    spec = init_lm_shell(cfg)
    if cfg.first_dense_layers:
        spec["dense_blocks"] = stack_specs(init_block(cfg, dense=True), cfg.first_dense_layers)
    spec["blocks"] = stack_specs(init_block(cfg), cfg.n_layers - cfg.first_dense_layers)
    return spec


def _lm_blocks(params, cfg: ModelConfig) -> list:
    """Every block's params in order, the leading dense stack's first."""
    n_dense = cfg.first_dense_layers
    dense = unstack(params["dense_blocks"], n_dense) if n_dense else []
    return dense + unstack(params["blocks"], cfg.n_layers - n_dense)


def forward_lm(params, cfg: ModelConfig, tokens: torch.Tensor,
               pixel_embeds: torch.Tensor | None = None, balance=None):
    """Training/eval forward.  Returns (logits, aux_loss): a softmax router's
    Switch loss averaged over the layers, a sigmoid router's sequence-wise
    balance loss summed over them (DeepSeek-V3 eq. 17), 0 for the dense stack.
    ``balance``: the dropless MoE layers' (:class:`repro_torch.models.moe.Balance`)."""
    x = embed_tokens(params, cfg, tokens, pixel_embeds)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def body(x, block_params, i):
        x, _, a = apply_block(block_params, cfg, x, positions, layer=i, balance=balance)
        return x, a

    body = _remat(body, cfg)
    aux = torch.zeros((), device=tokens.device)
    for i, block_params in enumerate(_lm_blocks(params, cfg)):
        x, a = body(x, block_params, i)
        aux = aux + a
    if cfg.moe is None or cfg.moe.score_func != "sigmoid":
        aux = aux / max(cfg.n_layers, 1)
    return lm_logits(params, cfg, x), aux


def prefill_lm(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
               pixel_embeds=None):
    """Prefill: forward + build the stacked KV cache, one slot a block in
    :func:`_lm_blocks`' order.  Returns (logits, cache) with logits of the
    last position only."""
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens, pixel_embeds)
    positions = torch.arange(S, device=tokens.device)
    caches = attn.init_kv_cache(cfg, cfg.n_layers, B, max_len, compute_dtype(cfg),
                                tokens.device)

    def body(x, block_params, cache, i):
        x, _, _ = apply_block(block_params, cfg, x, positions, cache=cache,
                              cache_position=0, layer=i)
        return x

    body = _remat(body, cfg)
    for i, block_params in enumerate(_lm_blocks(params, cfg)):
        x = body(x, block_params, layer_params(caches, i), i)
    return lm_logits(params, cfg, x[:, -1:, :]), caches


def decode_lm(params, cfg: ModelConfig, tokens_new: torch.Tensor, caches,
              position: int):
    """One decode step.  tokens_new [B,1]; caches stacked [L,...], updated in
    place and returned."""
    x = embed_tokens(params, cfg, tokens_new)
    positions = torch.full((tokens_new.shape[0], 1), position, dtype=torch.int32,
                           device=tokens_new.device)
    for i, block_params in enumerate(_lm_blocks(params, cfg)):
        x, _, _ = apply_block(block_params, cfg, x, positions, cache=layer_params(caches, i),
                              cache_position=position, layer=i)
    return lm_logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# Zamba2 hybrid: Mamba2 backbone + shared attention block with LoRA
# ---------------------------------------------------------------------------


def zamba_structure(cfg: ModelConfig):
    """(shared applications, Mamba2 layers per application, Mamba2 tail)."""
    period = cfg.zamba.shared_period
    n_groups = cfg.n_layers // period
    tail = cfg.n_layers - n_groups * period
    return n_groups, period, tail


def init_shared_block(cfg: ModelConfig):
    """The shared transformer block (attention + MLP), applied repeatedly."""
    return {
        "attn_norm": L.init_norm(cfg.d_model, cfg.norm_type),
        "attn": attn.init_attention(cfg),
        "mlp_norm": L.init_norm(cfg.d_model, cfg.norm_type),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_type),
    }


def init_lora(cfg: ModelConfig, n_apps: int):
    r = cfg.zamba.lora_rank
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    return {
        "qkv_a": ParamSpec((n_apps, d, r), ("blocks", "embed", "rank")),
        "qkv_b": ParamSpec((n_apps, r, (cfg.n_heads + 2 * cfg.n_kv_heads) * hd),
                           ("blocks", "rank", "qkv"), init="zeros"),
        "mlp_a": ParamSpec((n_apps, d, r), ("blocks", "embed", "rank")),
        "mlp_b": ParamSpec((n_apps, r, cfg.d_ff), ("blocks", "rank", "mlp"), init="zeros"),
    }


def init_zamba(cfg: ModelConfig):
    """Params: ``groups`` [n_groups, period, ...], ``tail`` [tail, ...] (when
    there is one), ``shared`` and per-application ``lora`` [n_groups, ...]."""
    n_groups, period, tail = zamba_structure(cfg)
    mamba_spec = {
        "norm": L.init_norm(cfg.d_model, cfg.norm_type),
        "mamba": ssm_mod.init_mamba(cfg),
    }
    spec = init_lm_shell(cfg)
    spec["groups"] = stack_specs(stack_specs(mamba_spec, period, "layers"), n_groups, "blocks")
    if tail:
        spec["tail"] = stack_specs(mamba_spec, tail, "layers")
    spec["shared"] = init_shared_block(cfg)
    spec["lora"] = init_lora(cfg, n_groups)
    return spec


def _apply_mamba_layer(p, cfg: ModelConfig, x, cache=None, prefill=False):
    h = L.apply_norm(p["norm"], x, cfg.norm_type, cfg.norm_eps)
    out, new_cache = ssm_mod.apply_mamba(p["mamba"], cfg, h, cache=cache,
                                         return_cache=prefill)
    return x + out, new_cache


def _plus_lora(base: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``base + delta`` with the partial sums of both reduced first: a
    projection's output may be a partial sum where the LoRA delta is
    sharded, and the add would turn the shard into a partial sum, a
    redistribution some DTensor versions lack (torch 2.11, zamba2-7b
    decode_32k on (16, 16))."""
    return sharding.reduce_partial(base) + sharding.reduce_partial(delta)


def _apply_shared_with_lora(shared, lora_slice, cfg: ModelConfig, x, positions,
                            cache=None, cache_position=None):
    """Shared attention block; LoRA delta on the fused QKV and MLP-up.

    Attention is always ``attend_xla``, as in the reference
    (``transformer.py:332,335``), under either ``attention_impl``.  With a
    cache, K/V are written into it in place."""
    hd = cfg.resolved_head_dim
    nq = cfg.n_heads * hd
    nk = cfg.n_kv_heads * hd
    h = L.apply_norm(shared["attn_norm"], x, cfg.norm_type, cfg.norm_eps)
    # base QKV + low-rank per-application delta
    delta = (h @ lora_slice["qkv_a"].to(h.dtype)) @ lora_slice["qkv_b"].to(h.dtype)
    dq, dk, dv = torch.split(delta, [nq, nk, nk], dim=-1)
    ap = shared["attn"]
    q = attn._split_heads(_plus_lora(L.apply_dense(ap["wq"], h), dq), cfg.n_heads, hd)
    k = attn._split_heads(_plus_lora(L.apply_dense(ap["wk"], h), dk), cfg.n_kv_heads, hd)
    v = attn._split_heads(_plus_lora(L.apply_dense(ap["wv"], h), dv), cfg.n_kv_heads, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        attn.write_kv(cache, k, v, cache_position)
        out = attn.attend_cache(q, cache, positions, cache_position)
    else:
        out = attn.attend_xla(q, k, v, causal=True, q_positions=positions,
                              kv_positions=positions)
    x = x + L.apply_dense(ap["wo"], attn._merge_heads(out))
    h = L.apply_norm(shared["mlp_norm"], x, cfg.norm_type, cfg.norm_eps)
    dup = (h @ lora_slice["mlp_a"].to(h.dtype)) @ lora_slice["mlp_b"].to(h.dtype)
    gate = F.silu(L.apply_dense(shared["mlp"]["gate"], h))
    up = _plus_lora(L.apply_dense(shared["mlp"]["up"], h), dup)
    return x + L.apply_dense(shared["mlp"]["down"], gate * up)


def _mamba_layers(params, cfg: ModelConfig):
    """Yields ``(g, [(l, layer params), ...])``: the Mamba2 layers before
    shared application ``g``, in order, then ``(None, ...)`` for the tail."""
    n_groups, period, tail = zamba_structure(cfg)
    for g, group in enumerate(unstack(params["groups"], n_groups)):
        yield g, list(enumerate(unstack(group, period)))
    if tail:
        yield None, list(enumerate(unstack(params["tail"], tail)))


def forward_zamba(params, cfg: ModelConfig, tokens: torch.Tensor):
    """Training/eval forward.  Returns (logits, aux_loss = 0)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    # each Mamba2 layer is rematerialised, the shared block is not
    # (repro/models/transformer.py:359,367)
    inner = _remat(lambda p, x: _apply_mamba_layer(p, cfg, x)[0], cfg)
    lora = unstack(params["lora"], zamba_structure(cfg)[0])
    for g, layers in _mamba_layers(params, cfg):
        for _, p in layers:
            x = inner(p, x)
        if g is not None:
            x = _apply_shared_with_lora(params["shared"], lora[g], cfg, x, positions)
    return lm_logits(params, cfg, x), torch.zeros((), device=tokens.device)


def init_zamba_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    """Zeroed decode caches: Mamba2 states stacked like the params
    (``groups`` [n_groups, period, ...], ``tail`` [tail, ...] or None) and one
    KV cache per shared application, ``shared`` [n_groups, B, max_len, K, D].
    Under an active mesh they are DTensors placed by their cache axes behind
    ``("blocks", "layers")``, ``("layers",)`` and ``("layers",)``."""
    n_groups, period, tail = zamba_structure(cfg)
    one = ssm_mod.init_mamba_cache(cfg, batch, dtype, device)
    axes = ssm_mod.mamba_cache_axes()

    def stack(*lead, names):
        return {k: distribute_input(v.expand(*lead, *v.shape).clone(), *names, *axes[k])
                for k, v in one.items()}

    return {
        "groups": stack(n_groups, period, names=("blocks", "layers")),
        "tail": stack(tail, names=("layers",)) if tail else None,
        "shared": attn.init_kv_cache(cfg, n_groups, batch, max_len, dtype, device),
    }


def _layer_cache(caches, g, l):
    stacked = caches["tail"] if g is None else layer_params(caches["groups"], g)
    return layer_params(stacked, l)


def _store(dst: dict, src: dict) -> None:
    for key, val in src.items():
        dst[key].copy_(val)


def prefill_zamba(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int):
    """Prompt pass building all decode caches (SSM states, conv windows and the
    shared KV caches).  Returns (logits of the last position, caches)."""
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(S, device=tokens.device)
    caches = init_zamba_cache(cfg, B, max_len, compute_dtype(cfg), tokens.device)
    for g, layers in _mamba_layers(params, cfg):
        for l, p in layers:
            x, cache = _apply_mamba_layer(p, cfg, x, prefill=True)
            _store(_layer_cache(caches, g, l), cache)
        if g is not None:
            x = _apply_shared_with_lora(params["shared"], layer_params(params["lora"], g),
                                        cfg, x, positions,
                                        cache=layer_params(caches["shared"], g),
                                        cache_position=0)
    return lm_logits(params, cfg, x[:, -1:, :]), caches


def decode_zamba(params, cfg: ModelConfig, tokens_new: torch.Tensor, caches,
                 position: int):
    """One decode step.  tokens_new [B,1]; caches updated in place and returned."""
    x = embed_tokens(params, cfg, tokens_new)
    positions = torch.full((tokens_new.shape[0], 1), position, dtype=torch.int32,
                           device=tokens_new.device)
    for g, layers in _mamba_layers(params, cfg):
        for l, p in layers:
            layer_cache = _layer_cache(caches, g, l)
            x, new_cache = _apply_mamba_layer(p, cfg, x, cache=layer_cache)
            _store(layer_cache, new_cache)
        if g is not None:
            x = _apply_shared_with_lora(params["shared"], layer_params(params["lora"], g),
                                        cfg, x, positions,
                                        cache=layer_params(caches["shared"], g),
                                        cache_position=position)
    return lm_logits(params, cfg, x), caches


# ---------------------------------------------------------------------------
# xLSTM stack: super-blocks of (slstm_every - 1) mLSTM blocks + 1 sLSTM block
# ---------------------------------------------------------------------------


def xlstm_structure(cfg: ModelConfig):
    """(super-blocks, mLSTM blocks per super-block)."""
    every = cfg.xlstm.slstm_every
    n_super = cfg.n_layers // every
    if n_super * every != cfg.n_layers:
        raise ValueError(f"xlstm layers must tile: {cfg.n_layers} % {every} != 0")
    return n_super, every - 1


def init_xlstm(cfg: ModelConfig):
    """Params: ``super/mlstm`` stacked twice [n_super, n_m, ...] and
    ``super/slstm`` [n_super, ...], as in the reference."""
    n_super, n_m = xlstm_structure(cfg)
    spec = init_lm_shell(cfg)
    spec["super"] = {
        "mlstm": stack_specs(stack_specs(xlstm_mod.init_mlstm_block(cfg), n_m, "layers"),
                             n_super, "blocks"),
        "slstm": stack_specs(xlstm_mod.init_slstm_block(cfg), n_super, "blocks"),
    }
    return spec


def _super_blocks(params, cfg: ModelConfig):
    """Yields ``(s, [mLSTM block params, ...], sLSTM block params)`` per super-block."""
    n_super, n_m = xlstm_structure(cfg)
    mlstm = unstack(params["super"]["mlstm"], n_super)
    slstm = unstack(params["super"]["slstm"], n_super)
    for s in range(n_super):
        yield s, unstack(mlstm[s], n_m), slstm[s]


def forward_xlstm(params, cfg: ModelConfig, tokens: torch.Tensor):
    """Training/eval forward.  Returns (logits, aux_loss = 0).  Each mLSTM
    block is rematerialised, the sLSTM blocks are not (as in the reference)."""
    x = embed_tokens(params, cfg, tokens)
    inner = _remat(lambda p, x: xlstm_mod.apply_mlstm_block(p, cfg, x)[0], cfg)
    for _, mlstm, slstm in _super_blocks(params, cfg):
        for p in mlstm:
            x = inner(p, x)
        x, _ = xlstm_mod.apply_slstm_block(slstm, cfg, x)
    return lm_logits(params, cfg, x), torch.zeros((), device=tokens.device)


def init_xlstm_cache(cfg: ModelConfig, batch: int, dtype, device):
    """Zeroed decode caches stacked like the params: ``mlstm`` {conv, C, n, m}
    [n_super, n_m, ...] and ``slstm`` {"state": (h, c, n, m)} [n_super, ...].
    Under an active mesh they are DTensors placed by their cache axes behind
    ``("blocks", "layers")`` and ``("blocks",)``, the mLSTM's state where
    its value split keeps it (``xlstm.mlstm_state_sharding``)."""
    n_super, n_m = xlstm_structure(cfg)
    one = xlstm_mod.init_mlstm_cache(cfg, batch, dtype, device)
    state = xlstm_mod.init_slstm_state(cfg, batch, device)
    s_axes = xlstm_mod.slstm_state_axes()
    return {
        "mlstm": {k: xlstm_mod.distribute_mlstm_cache(cfg, k, v.expand(n_super, n_m, *v.shape)
                                                      .clone(), "blocks", "layers")
                  for k, v in one.items()},
        "slstm": {"state": tuple(distribute_input(t.expand(n_super, *t.shape).clone(),
                                                  "blocks", *a)
                                 for t, a in zip(state, s_axes))},
    }


def _slstm_cache(caches, s: int) -> dict:
    return {"state": tuple(t[s] for t in caches["slstm"]["state"])}


def _store_slstm(dst: dict, src: dict) -> None:
    for d, v in zip(dst["state"], src["state"]):
        d.copy_(v)


def prefill_xlstm(params, cfg: ModelConfig, tokens: torch.Tensor):
    """Prompt pass building the mLSTM (C, n, m, conv) and sLSTM states.
    Returns (logits of the last position, caches)."""
    x = embed_tokens(params, cfg, tokens)
    caches = init_xlstm_cache(cfg, tokens.shape[0], compute_dtype(cfg), tokens.device)
    for s, mlstm, slstm in _super_blocks(params, cfg):
        for i, p in enumerate(mlstm):
            x, cache = xlstm_mod.apply_mlstm_block(p, cfg, x, return_cache=True)
            _store(layer_params(layer_params(caches["mlstm"], s), i), cache)
        x, cache = xlstm_mod.apply_slstm_block(slstm, cfg, x, return_cache=True)
        _store_slstm(_slstm_cache(caches, s), cache)
    return lm_logits(params, cfg, x[:, -1:, :]), caches


def decode_xlstm(params, cfg: ModelConfig, tokens_new: torch.Tensor, caches, position: int):
    """One decode step; ``position`` is unused (the state carries it), as in
    the reference.  Caches are updated in place and returned."""
    x = embed_tokens(params, cfg, tokens_new)
    for s, mlstm, slstm in _super_blocks(params, cfg):
        for i, p in enumerate(mlstm):
            layer_cache = layer_params(layer_params(caches["mlstm"], s), i)
            x, new_cache = xlstm_mod.apply_mlstm_block(p, cfg, x, cache=layer_cache)
            _store(layer_cache, new_cache)
        slstm_cache = _slstm_cache(caches, s)
        x, new_cache = xlstm_mod.apply_slstm_block(slstm, cfg, x, cache=slstm_cache)
        _store_slstm(slstm_cache, new_cache)
    return lm_logits(params, cfg, x), caches
