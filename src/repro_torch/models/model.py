"""Model facade: one interface over the ported families.

    model = Model(config)
    params = model.init(generator, device="cuda")
    logits, aux = model.forward(params, batch)
    loss = model.loss(params, batch)
    logits, cache = model.prefill(params, batch, max_len)
    logits, cache = model.decode_step(params, tokens, cache, position)

Counterpart of ``repro/models/model.py`` for every family.  ``batch`` keys:

    dense / moe / ssm / hybrid : tokens [B,S] (and labels [B,S], optionally
                                 loss_mask [B,S], for ``loss``)
    vlm                        : + pixel_embeds [B,K,D]
    encdec                     : frames [B,S_enc,D], tokens [B,S_dec], labels

For ``encdec``, ``prefill`` ignores ``max_len`` (the decoder cache is
``max_target_positions`` long) and ``init_cache(batch, max_len)`` takes
``max_len`` as the encoder length; ``ssm`` ignores it in both, as the
reference does.
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm

PORTED_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.arch}) is not ported yet; see ROADMAP.md"
        )


def init_spec(cfg: ModelConfig):
    _require_ported(cfg)
    if cfg.family == "encdec":
        return encdec_mod.init_encdec(cfg)
    if cfg.family == "ssm":
        return tfm.init_xlstm(cfg)
    if cfg.family == "hybrid":
        return tfm.init_zamba(cfg)
    return tfm.init_lm(cfg)


def param_axes(cfg: ModelConfig):
    """The params' logical axes: nested dicts of tuples, no tensor made."""
    return L.spec_axes(init_spec(cfg))


def param_shapes(cfg: ModelConfig):
    """The params' shapes: nested dicts of tuples, no tensor made."""
    return L.spec_shapes(init_spec(cfg))


def count_params_analytic(cfg: ModelConfig) -> int:
    total = 0
    for _, spec in L.flatten_specs(init_spec(cfg)):
        n = 1
        for d in spec.shape:
            n *= d
        total += n
    return total


def active_params_analytic(cfg: ModelConfig) -> int:
    """MoE: parameters touched per token (for 6·N_active·D roofline FLOPs)."""
    total = count_params_analytic(cfg)
    if cfg.moe is None:
        return total
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    per_expert = 3 * cfg.d_model * cfg.moe.d_ff
    expert_total = cfg.n_layers * e * per_expert
    expert_active = cfg.n_layers * k * per_expert
    return total - expert_total + expert_active


class Model:
    def __init__(self, cfg: ModelConfig):
        _require_ported(cfg)
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, device=None):
        """Random params on ``device`` (default CUDA) drawn from ``generator``,
        which must live on the same device."""
        dev = resolve_device(device)
        return L.materialize(generator, init_spec(self.cfg),
                             getattr(torch, self.cfg.param_dtype), dev)

    # --------------------------------------------------------------- forward
    def forward(self, params, batch):
        if self.cfg.family == "encdec":
            return encdec_mod.forward_encdec(params, self.cfg, batch["frames"], batch["tokens"])
        if self.cfg.family == "ssm":
            return tfm.forward_xlstm(params, self.cfg, batch["tokens"])
        if self.cfg.family == "hybrid":
            return tfm.forward_zamba(params, self.cfg, batch["tokens"])
        return tfm.forward_lm(params, self.cfg, batch["tokens"],
                              batch.get("pixel_embeds"))

    def loss(self, params, batch):
        """Mean next-token cross-entropy in f32, plus the weighted router aux
        loss for MoE configs."""
        logits, aux = self.forward(params, batch)
        ce = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        if self.cfg.moe is not None:
            ce = ce + self.cfg.moe.aux_loss_weight * aux
        return ce

    # --------------------------------------------------------------- serving
    def prefill(self, params, batch, max_len: int | None):
        if self.cfg.family == "encdec":
            return encdec_mod.prefill_encdec(params, self.cfg, batch["frames"], batch["tokens"])
        if self.cfg.family == "ssm":
            return tfm.prefill_xlstm(params, self.cfg, batch["tokens"])
        if self.cfg.family == "hybrid":
            return tfm.prefill_zamba(params, self.cfg, batch["tokens"], max_len)
        return tfm.prefill_lm(params, self.cfg, batch["tokens"], max_len,
                              batch.get("pixel_embeds"))

    def init_cache(self, batch_size: int, max_len: int, device=None):
        cfg, dev = self.cfg, resolve_device(device)
        dtype = tfm.compute_dtype(cfg)
        if cfg.family == "encdec":
            return encdec_mod.init_encdec_cache(cfg, batch_size, max_len, dtype, dev)
        if cfg.family == "ssm":
            return tfm.init_xlstm_cache(cfg, batch_size, dtype, dev)
        if cfg.family == "hybrid":
            return tfm.init_zamba_cache(cfg, batch_size, max_len, dtype, dev)
        return attn_mod.init_kv_cache(cfg, cfg.n_layers, batch_size, max_len, dtype, dev)

    def decode_step(self, params, tokens_new, cache, position: int):
        if self.cfg.family == "encdec":
            return encdec_mod.decode_encdec(params, self.cfg, tokens_new, cache, position)
        if self.cfg.family == "ssm":
            return tfm.decode_xlstm(params, self.cfg, tokens_new, cache, position)
        if self.cfg.family == "hybrid":
            return tfm.decode_zamba(params, self.cfg, tokens_new, cache, position)
        return tfm.decode_lm(params, self.cfg, tokens_new, cache, position)
