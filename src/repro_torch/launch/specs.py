"""Input stand-ins for every (arch x shape) dry-run cell: counterpart of
``repro/launch/specs.py``.

The reference's ``jax.ShapeDtypeStruct`` carries a global shape, a dtype and a
``NamedSharding``; here a spec is a *fake* ``DTensor``: a
``FakeTensorMode`` tensor of the global shape and dtype, placed on a
``DeviceMesh`` by the placements that
:func:`repro_torch.parallel.sharding.param_shardings` and
:func:`repro_torch.parallel.sharding.logical_spec` give.  Each rank's local
shard is a fake tensor too, so nothing is allocated at any size.

Every function makes its fake tensors in the ``FakeTensorMode`` that is
active, or in a new one: a caller that traces a step over the specs makes
them and traces inside one mode (:func:`fake_mode`).  ``input_specs(cfg,
shape, mesh)`` returns the step function's arguments by name, as the
reference does.  The decode ``position`` is a 0-dim int32 spec, as the
reference's; the port's ``decode_step`` takes a Python int, which the
dry-run passes in its place.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.model import Model, param_axes, param_shapes
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (
    ACT_RULES,
    PARAM_RULES,
    ShardingRules,
    logical_spec,
    param_shardings,
)
from repro_torch.train.loop import TrainState
from repro_torch.train.optimizer import AdamWState, init_adamw

#: whisper's architectural decoder-position cap
WHISPER_DECODER_LEN = 448


@contextlib.contextmanager
def fake_mode():
    """The active ``FakeTensorMode``, or a new one entered for the block."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = detect_fake_mode()
    if mode is not None:
        yield mode
        return
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode


def _device(mesh) -> torch.device:
    return torch.device(mesh.device_type)


def act_rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  overrides: dict | None = None) -> ShardingRules:
    """Activation rules, adapted per cell.

    long_500k (batch=1) cannot shard the batch axis: shard the KV/sequence
    axis over "data" instead (sequence parallelism for the cache)."""
    data_size = 1
    sizes = sh.mesh_axis_sizes(mesh)
    for ax in ("pod", "data"):
        data_size *= sizes.get(ax, 1)
    rules = ACT_RULES
    if shape.global_batch < data_size:
        rules = rules.merged({"kv_seq": ("pod", "data"), "seq": None})
    if overrides:
        rules = rules.merged(overrides)
    return rules


def _effective(rules: ShardingRules, mesh) -> ShardingRules:
    return sh._effective(rules, set(mesh.mesh_dim_names))


def _place(t: torch.Tensor, sharding: sh.Sharding) -> torch.Tensor:
    """Fake global tensor ``t`` as a fake DTensor placed by ``sharding``."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)


def _at(mesh, spec: tuple) -> sh.Sharding:
    return sh.Sharding(mesh, sh.placements(spec, mesh))


def _sds(shape, dtype, mesh, spec: tuple) -> torch.Tensor:
    with fake_mode():
        return _place(torch.empty(shape, dtype=dtype, device=_device(mesh)), _at(mesh, spec))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                seq_len: int | None = None, overrides: dict | None = None) -> dict:
    """Training/prefill batch specs."""
    rules = _effective(act_rules_for(cfg, shape, mesh, overrides), mesh)
    B = shape.global_batch
    S = seq_len if seq_len is not None else shape.seq_len

    def bspec(shp, axes, dtype=torch.int32):
        return _sds(shp, dtype, mesh, logical_spec(axes, rules, shp, mesh))

    compute = getattr(torch, cfg.compute_dtype)
    if cfg.family == "encdec":
        dec = min(S, cfg.max_target_positions or S)
        batch = {
            "frames": bspec((B, S, cfg.d_model), ("batch", "seq", "embed"), compute),
            "tokens": bspec((B, dec), ("batch", "seq")),
            "labels": bspec((B, dec), ("batch", "seq")),
        }
    else:
        batch = {
            "tokens": bspec((B, S), ("batch", "seq")),
            "labels": bspec((B, S), ("batch", "seq")),
        }
        if cfg.family == "vlm":
            batch["pixel_embeds"] = bspec((B, cfg.n_image_tokens, cfg.d_model),
                                          ("batch", "seq", "embed"), compute)
    if shape.kind != "train":
        batch.pop("labels", None)
    return batch


def _place_tree(tree, shardings):
    return sh._map_axes(lambda s, t: _place(t, s), shardings, tree)


def _fake_params(cfg: ModelConfig, dtype, device) -> dict:
    return L.map_tree(lambda shape: torch.empty(shape, dtype=dtype, device=device),
                      param_shapes(cfg))


def state_specs(cfg: ModelConfig, mesh, rules: ShardingRules = PARAM_RULES) -> TrainState:
    """TrainState specs with the FSDP/TP placements (the reference's
    ``eval_shape`` of ``init_state``).  ``Model.init`` draws truncated normals
    through host scalars, which a fake tensor cannot give, so the params are
    fake tensors of ``param_shapes`` in ``param_dtype``, what ``init`` makes,
    and the AdamW state is ``init_adamw``'s on them, as ``init_state``
    builds it."""
    p_sh = param_shardings(param_axes(cfg), mesh, rules, param_shapes=param_shapes(cfg))
    with fake_mode():
        params = _fake_params(cfg, getattr(torch, cfg.param_dtype), _device(mesh))
        opt = init_adamw(params)
        return TrainState(params=_place_tree(params, p_sh),
                          opt=AdamWState(step=_place(opt.step, _at(mesh, ())),
                                         m=_place_tree(opt.m, p_sh), v=_place_tree(opt.v, p_sh)))


def param_specs(cfg: ModelConfig, mesh, rules: ShardingRules = PARAM_RULES, dtype=None):
    """Parameter-only specs (serving paths), in ``dtype`` if given."""
    p_sh = param_shardings(param_axes(cfg), mesh, rules, param_shapes=param_shapes(cfg))
    with fake_mode():
        return _place_tree(_fake_params(cfg, dtype or getattr(torch, cfg.param_dtype),
                                        _device(mesh)), p_sh)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _is_axes(v) -> bool:
    return isinstance(v, tuple) and all(isinstance(e, (str, type(None))) for e in v)


def _map_cache(fn, tree, *others):
    """``fn`` over the leaves of a cache tree (dicts, tuples, None), with
    ``others`` of the same structure; an axes tuple is a leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_cache(fn, tree[k], *(o[k] for o in others)) for k in tree}
    if isinstance(tree, tuple) and not _is_axes(tree) and not isinstance(tree, torch.Tensor):
        return tuple(_map_cache(fn, t, *(o[i] for o in others)) for i, t in enumerate(tree))
    return fn(tree, *others)


def _stackN(axes_tree, *prefix):
    return _map_cache(lambda axes: tuple(prefix) + tuple(axes), axes_tree)


def cache_axes(cfg: ModelConfig) -> object:
    if cfg.family == "encdec":
        kv = attn_mod.kv_cache_axes()
        return {"self": _stackN(kv, "layers"), "cross_kv": _stackN(kv, "layers")}
    if cfg.family == "ssm":
        return {
            "mlstm": _stackN(xlstm_mod.mlstm_cache_axes(), "blocks", "layers"),
            "slstm": {"state": _stackN(xlstm_mod.slstm_state_axes(), "blocks")},
        }
    if cfg.family == "hybrid":
        from repro_torch.models.transformer import zamba_structure

        _, _, tail = zamba_structure(cfg)
        return {
            "groups": _stackN(ssm_mod.mamba_cache_axes(), "blocks", "layers"),
            "shared": _stackN(attn_mod.kv_cache_axes(), "blocks"),
            "tail": _stackN(ssm_mod.mamba_cache_axes(), "layers") if tail else None,
        }
    return _stackN(attn_mod.kv_cache_axes(), "layers")


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                overrides: dict | None = None) -> object:
    rules = _effective(act_rules_for(cfg, shape, mesh, overrides), mesh)
    # cache stacking axes replicate
    rules = rules.merged({"layers": None, "blocks": None})
    with fake_mode():
        caches = Model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device=_device(mesh))
        placed = _map_cache(
            lambda t, ax: _place(t, _at(mesh, logical_spec(ax, rules, tuple(t.shape), mesh))),
            caches, cache_axes(cfg))
        if cfg.family == "ssm":
            # the mLSTM's state where its value split keeps it, as a step leaves it
            with sh.use_rules(PARAM_RULES, rules):
                for name in ("C", "n", "m"):
                    t = caches["mlstm"][name]
                    where = xlstm_mod.mlstm_state_sharding(cfg, name, tuple(t.shape), mesh)
                    if where is not None:
                        placed["mlstm"][name] = _place(t, where)
        return placed


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 overrides: dict | None = None) -> dict:
    rules = _effective(act_rules_for(cfg, shape, mesh, overrides), mesh)
    B = shape.global_batch
    return {
        "params": param_specs(cfg, mesh, dtype=getattr(torch, cfg.compute_dtype)),
        "tokens_new": _sds((B, 1), torch.int32, mesh,
                           logical_spec(("batch", "seq"), rules, (B, 1), mesh)),
        "cache": cache_specs(cfg, shape, mesh, overrides),
        "position": _sds((), torch.int32, mesh, ()),
    }


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                overrides: dict | None = None) -> dict:
    """All step-function argument specs for one dry-run cell."""
    if shape.kind == "train":
        return {
            "state": state_specs(cfg, mesh),
            "batch": batch_specs(cfg, shape, mesh, overrides=overrides),
        }
    if shape.kind == "prefill":
        return {
            "params": param_specs(cfg, mesh, dtype=getattr(torch, cfg.compute_dtype)),
            "batch": batch_specs(cfg, shape, mesh, overrides=overrides),
        }
    return decode_specs(cfg, shape, mesh, overrides)
