"""Whisper-style encoder-decoder backbone.

Counterpart of ``repro/models/encdec.py``.  The conv/log-mel frontend is a
stub, as in the reference: callers supply precomputed frame embeddings
[B, S_enc, d_model] (what the two conv layers would emit).  Encoder:
bidirectional attention (``causal=False``, through the flash kernel under
``attention_impl="flash"``) and sinusoidal positions.  Decoder: causal
self-attention with learned positions capped at ``max_target_positions``
(448) and cross-attention to the encoder output.  Decode serves one token
against a self-KV cache (448 long) and a cross-KV cache over the whole
encoder sequence.

Blocks stay stacked ``[L, ...]`` as in the reference; its ``lax.scan`` over
the stack becomes a loop over :func:`repro_torch.models.transformer.unstack`.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamSpec
from repro_torch.parallel.sharding import shard
from repro_torch.models.transformer import _remat, compute_dtype, layer_params, stack_specs, unstack


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """[length, dim] f32: sines of the first dim/2 timescales, then cosines."""
    f32 = torch.float32
    log_timescale = torch.log(torch.tensor(10_000.0, dtype=f32, device=device)) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2, dtype=f32, device=device))
    scaled = torch.arange(length, dtype=f32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def init_encoder_block(cfg: ModelConfig):
    return {
        "attn_norm": L.init_norm(cfg.d_model, "layernorm", True),
        "attn": attn.init_attention(cfg),
        "mlp_norm": L.init_norm(cfg.d_model, "layernorm", True),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, "gelu", True),
    }


def init_decoder_block(cfg: ModelConfig):
    return {
        "self_norm": L.init_norm(cfg.d_model, "layernorm", True),
        "self_attn": attn.init_attention(cfg),
        "cross_norm": L.init_norm(cfg.d_model, "layernorm", True),
        "cross_attn": attn.init_cross_attention(cfg),
        "mlp_norm": L.init_norm(cfg.d_model, "layernorm", True),
        "mlp": L.init_mlp(cfg.d_model, cfg.d_ff, "gelu", True),
    }


def init_encdec(cfg: ModelConfig):
    return {
        "embed": L.init_embedding(cfg.vocab_size, cfg.d_model),
        "pos_embed": ParamSpec((cfg.max_target_positions, cfg.d_model), (None, "embed"),
                               scale=1.0),
        "encoder": stack_specs(init_encoder_block(cfg), cfg.n_encoder_layers),
        "enc_final_norm": L.init_norm(cfg.d_model, "layernorm", True),
        "decoder": stack_specs(init_decoder_block(cfg), cfg.n_layers),
        "dec_final_norm": L.init_norm(cfg.d_model, "layernorm", True),
    }


def _enc_block(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(p["attn_norm"], x, "layernorm", cfg.norm_eps)
    out, _ = attn.apply_attention(p["attn"], cfg, h, torch.arange(x.shape[1], device=x.device),
                                  causal=False, use_rope=False)
    x = x + out
    h = L.apply_norm(p["mlp_norm"], x, "layernorm", cfg.norm_eps)
    x = x + L.apply_mlp(p["mlp"], h, "gelu")
    return shard(x, "batch", "seq", "embed")


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, S_enc, D], the stub frontend's output -> [B, S_enc, D]."""
    x = frames.to(compute_dtype(cfg))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
    x = shard(x, "batch", "seq", "embed")
    body = _remat(lambda p, x: _enc_block(p, cfg, x), cfg)
    for p in unstack(params["encoder"], cfg.n_encoder_layers):
        x = body(p, x)
    return L.apply_norm(params["enc_final_norm"], x, "layernorm", cfg.norm_eps)


def _dec_block(p, cfg: ModelConfig, x, positions, enc_kv, self_cache=None,
               cache_position=None):
    h = L.apply_norm(p["self_norm"], x, "layernorm", cfg.norm_eps)
    out, new_cache = attn.apply_attention(
        p["self_attn"], cfg, h, positions, causal=True, use_rope=False,
        cache=self_cache, cache_position=cache_position,
    )
    x = x + out
    h = L.apply_norm(p["cross_norm"], x, "layernorm", cfg.norm_eps)
    x = x + attn.apply_cross_attention(p["cross_attn"], cfg, h, enc_kv)
    h = L.apply_norm(p["mlp_norm"], x, "layernorm", cfg.norm_eps)
    x = x + L.apply_mlp(p["mlp"], h, "gelu")
    return shard(x, "batch", "seq", "embed"), new_cache


def _dec_embed(params, cfg: ModelConfig, tokens: torch.Tensor, position0: int) -> torch.Tensor:
    """Token embeddings plus the learned positions from ``position0`` on; the
    start is clamped as ``jax.lax.dynamic_slice_in_dim`` clamps it, so past
    ``max_target_positions`` the last rows are reused (the reference's
    behaviour, not an error)."""
    x = L.apply_embedding(params["embed"], tokens, compute_dtype(cfg))
    pos = params["pos_embed"].to(x.dtype)
    S = tokens.shape[1]
    if S > pos.shape[0]:  # jax.lax.dynamic_slice_in_dim refuses it too
        raise ValueError(f"{S} decoder tokens exceed max_target_positions {pos.shape[0]}")
    start = attn.clamped_start(position0, S, pos.shape[0])
    return shard(x + pos[start:start + S][None], "batch", "seq", "embed")


def forward_encdec(params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor):
    """Training/eval forward.  Returns (decoder logits, aux = 0)."""
    enc_out = encode(params, cfg, frames)
    x = _dec_embed(params, cfg, tokens, 0)
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def body(p, x):
        enc_kv = attn.precompute_cross_kv(p["cross_attn"], cfg, enc_out)
        return _dec_block(p, cfg, x, positions, enc_kv)[0]

    body = _remat(body, cfg)
    for p in unstack(params["decoder"], cfg.n_layers):
        x = body(p, x)
    x = L.apply_norm(params["dec_final_norm"], x, "layernorm", cfg.norm_eps)
    return L.apply_unembed(params["embed"], x), torch.zeros((), device=tokens.device)


def init_encdec_cache(cfg: ModelConfig, batch: int, enc_len: int, dtype, device):
    """Zeroed caches stacked over the decoder layers: ``self`` {k, v}
    [L, B, max_target_positions, K, D] and ``cross_kv`` {k, v} [L, B, enc_len, K, D].
    Under an active mesh they are DTensors placed by ``("layers",) +
    kv_cache_axes()``, as the reference's cache specs place them."""
    return {
        "self": attn.init_kv_cache(cfg, cfg.n_layers, batch, cfg.max_target_positions,
                                   dtype, device),
        "cross_kv": attn.init_kv_cache(cfg, cfg.n_layers, batch, enc_len, dtype, device),
    }


def prefill_encdec(params, cfg: ModelConfig, frames: torch.Tensor, tokens: torch.Tensor):
    """Encode + decoder prefill.  Returns (logits of the last position,
    caches); the self cache is ``max_target_positions`` long whatever the
    caller's max_len, as in the reference."""
    enc_out = encode(params, cfg, frames)
    B, S = tokens.shape
    x = _dec_embed(params, cfg, tokens, 0)
    positions = torch.arange(S, device=tokens.device)
    caches = init_encdec_cache(cfg, B, frames.shape[1], compute_dtype(cfg), tokens.device)
    for i, p in enumerate(unstack(params["decoder"], cfg.n_layers)):
        enc_kv = attn.precompute_cross_kv(p["cross_attn"], cfg, enc_out)
        for key, val in enc_kv.items():
            caches["cross_kv"][key][i].copy_(val)
        x, _ = _dec_block(p, cfg, x, positions, enc_kv,
                          self_cache=layer_params(caches["self"], i), cache_position=0)
    x = L.apply_norm(params["dec_final_norm"], x[:, -1:], "layernorm", cfg.norm_eps)
    return L.apply_unembed(params["embed"], x), caches


def decode_encdec(params, cfg: ModelConfig, tokens_new: torch.Tensor, caches, position: int):
    """One decoder token against the self cache (written in place) and the
    cross KV of the whole encoder sequence.  Returns (logits, caches)."""
    x = _dec_embed(params, cfg, tokens_new, position)
    positions = torch.full((tokens_new.shape[0], 1), position, dtype=torch.int32,
                           device=tokens_new.device)
    for i in range(cfg.n_layers):
        x, _ = _dec_block(layer_params(params["decoder"], i), cfg, x, positions,
                          layer_params(caches["cross_kv"], i),
                          self_cache=layer_params(caches["self"], i), cache_position=position)
    x = L.apply_norm(params["dec_final_norm"], x, "layernorm", cfg.norm_eps)
    return L.apply_unembed(params["embed"], x), caches
