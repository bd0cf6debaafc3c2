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
from repro_torch.models import moe as moe_mod
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
    n_moe = cfg.n_layers - cfg.first_dense_layers
    expert_total = n_moe * e * per_expert
    expert_active = n_moe * k * per_expert
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

    def init_buffers(self, device=None) -> dict:
        """State that training keeps beside the params, which no gradient
        reaches: for a router that moves a correction bias, ``router_bias``
        [MoE layers, router outputs] f32 zeros; else nothing."""
        moe = self.cfg.moe
        if moe is None or not moe.bias_update:
            return {}
        n_moe = self.cfg.n_layers - self.cfg.first_dense_layers
        return {"router_bias": torch.zeros((n_moe, moe.n_router), dtype=torch.float32,
                                           device=resolve_device(device))}

    def balance(self, buffers: dict) -> moe_mod.Balance | None:
        """The :class:`repro_torch.models.moe.Balance` over ``buffers``'s bias
        (updated in place), or None where they hold none."""
        return moe_mod.Balance(buffers["router_bias"]) if "router_bias" in buffers else None

    # --------------------------------------------------------------- forward
    def forward(self, params, batch, balance=None):
        """``balance``: the dropless MoE routers' (:meth:`balance`), whose bias
        picks the experts and whose counts the forward writes."""
        if self.cfg.family == "encdec":
            return encdec_mod.forward_encdec(params, self.cfg, batch["frames"], batch["tokens"])
        if self.cfg.family == "ssm":
            return tfm.forward_xlstm(params, self.cfg, batch["tokens"])
        if self.cfg.family == "hybrid":
            return tfm.forward_zamba(params, self.cfg, batch["tokens"])
        return tfm.forward_lm(params, self.cfg, batch["tokens"],
                              batch.get("pixel_embeds"), balance)

    def loss(self, params, batch, balance=None):
        """Mean next-token cross-entropy in f32, plus forward's router aux loss
        for MoE configs, times ``balance_alpha`` for a sigmoid router and
        ``aux_loss_weight`` for a softmax one."""
        logits, aux = self.forward(params, batch, balance)
        ce = L.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
        moe = self.cfg.moe
        if moe is not None:
            weight = moe.balance_alpha if moe.score_func == "sigmoid" else moe.aux_loss_weight
            ce = ce + weight * aux
        return ce

    # --------------------------------------------------------------- serving
    def _require_cache(self) -> None:
        if self.cfg.kv_lora_rank:
            raise NotImplementedError(
                f"{self.cfg.arch}: latent attention has no KV cache yet, so it trains "
                "and does not serve; see ROADMAP.md")

    def prefill(self, params, batch, max_len: int | None):
        self._require_cache()
        if self.cfg.family == "encdec":
            return encdec_mod.prefill_encdec(params, self.cfg, batch["frames"], batch["tokens"])
        if self.cfg.family == "ssm":
            return tfm.prefill_xlstm(params, self.cfg, batch["tokens"])
        if self.cfg.family == "hybrid":
            return tfm.prefill_zamba(params, self.cfg, batch["tokens"], max_len)
        return tfm.prefill_lm(params, self.cfg, batch["tokens"], max_len,
                              batch.get("pixel_embeds"))

    def init_cache(self, batch_size: int, max_len: int, device=None):
        self._require_cache()
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
        self._require_cache()
        if self.cfg.family == "encdec":
            return encdec_mod.decode_encdec(params, self.cfg, tokens_new, cache, position)
        if self.cfg.family == "ssm":
            return tfm.decode_xlstm(params, self.cfg, tokens_new, cache, position)
        if self.cfg.family == "hybrid":
            return tfm.decode_zamba(params, self.cfg, tokens_new, cache, position)
        return tfm.decode_lm(params, self.cfg, tokens_new, cache, position)
