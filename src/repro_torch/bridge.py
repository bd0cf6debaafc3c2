"""Weight bridge between the JAX package's param trees and the port's.

Both packages keep the same nested-dict keys and the same layouts (dense
weights ``[d_in, d_out]``, blocks stacked ``[L, ...]``), so the bridge is a
copy.  It takes and gives numpy arrays (convert a JAX tree with
``jax.tree_util.tree_map(np.asarray, params)``), so it imports no JAX, and it
checks the leaf count and every shape against the config's spec.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import init_spec


def _check(tree, cfg: ModelConfig, shape_of) -> list:
    specs = list(L.flatten_specs(init_spec(cfg)))
    leaves = list(L.flatten_specs(tree))
    if len(leaves) != len(specs):
        raise ValueError(f"{cfg.arch}: tree has {len(leaves)} leaves, the "
                         f"config's spec has {len(specs)}")
    for (path, leaf), (spec_path, spec) in zip(leaves, specs):
        if path != spec_path:
            raise ValueError(f"{cfg.arch}: leaf {'/'.join(path)} where the spec "
                             f"has {'/'.join(spec_path)}")
        if tuple(shape_of(leaf)) != tuple(spec.shape):
            raise ValueError(f"{cfg.arch}: {'/'.join(path)} has shape "
                             f"{tuple(shape_of(leaf))}, the spec {spec.shape}")
    return leaves


def params_from_jax(tree, cfg: ModelConfig, device=None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)
    leaves = _check(tree, cfg, np.shape)
    return L.unflatten(
        (path, torch.from_numpy(np.array(leaf, copy=True)).to(dev))
        for path, leaf in leaves
    )


def params_to_jax(params, cfg: ModelConfig) -> dict:
    """Nested dict of tensors -> nested dict of numpy arrays (on the host)."""
    leaves = _check(params, cfg, lambda t: t.shape)
    return L.unflatten((path, t.detach().cpu().numpy()) for path, t in leaves)
